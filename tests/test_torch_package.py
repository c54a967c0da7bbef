"""mxnet_tpu_torch's package surface against the JAX package's, and the
kernel build's failure logs, on the CPU.

- Every public name the reference's `mxnet_tpu/__init__.py` binds is
  bound by the port too, or stands in MISSING with the ROADMAP.md item
  that queues it. A slice that ports a name removes it from MISSING (the
  test fails while a listed name already resolves).
- A kernel library whose nvcc fails, or which fails to load, leaves the
  compiler's output or the loader's error in `<library>.fail.txt` beside
  its library, and the raised MXNetError names that file.
"""
import ast
import os
import stat

import pytest

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import kernels
from mxnet_tpu_torch.base import MXNetError

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# reference names the port does not bind yet -> the ROADMAP.md item
MISSING = {
    "exec_cache": "A.8",
    "recordio": "A.7", "data": "A.7", "image": "A.7", "image_det": "A.7",
    "profiler": "A.4", "Monitor": "A.4", "numerics": "A.4",
    "NumericsMonitor": "A.4",
    "Predictor": "A.5", "predictor": "A.5",
    "rnn": "A.6",
    "kv": "A.9", "kvstore": "A.9", "sharding": "A.9", "ShardingPlan": "A.9",
    "checkpoint_sharded": "A.9", "load_sharded": "A.9",
    "save_sharded": "A.9",
    "fault": "A.10", "fleet": "A.10", "elastic": "A.10",
    "engine": "A.11", "native": "A.11", "torch_bridge": "A.11",
    "th": "A.11", "caffe_bridge": "A.11",
    "analysis": "A.12",
    "visualization": "A.13", "viz": "A.13",
    "num_devices": "A.13", "memory_stats": "A.13",
    "set_memory_fraction": "A.13", "cpu_pinned": "A.13",
    "tpu": "C (no TPU device in the port)",
}


def _reference_names():
    """The public names `mxnet_tpu/__init__.py` binds, read from its
    source (importing it would depend on what other tests imported)."""
    with open(os.path.join(ROOT, "mxnet_tpu", "__init__.py")) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            for a in node.names:
                names.add((a.asname or a.name).split(".")[0])
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
    return {n for n in names if not n.startswith("_")} | {"__version__"}


def test_top_level_names_match_the_reference():
    ref = _reference_names()
    missing = sorted(n for n in ref if not hasattr(mx, n))
    unlisted = [n for n in missing if n not in MISSING]
    assert not unlisted, f"reference names the port lacks: {unlisted}"
    ported = sorted(n for n in MISSING if hasattr(mx, n))
    assert not ported, f"ported now, take them off MISSING: {ported}"
    stale = sorted(n for n in MISSING if n not in ref)
    assert not stale, f"MISSING names the reference does not bind: {stale}"


@pytest.mark.parametrize("name", ["NDArray", "Variable", "Group",
                                  "AttrScope", "Executor", "Speedometer",
                                  "__version__"])
def test_reexports_are_the_ported_objects(name):
    """The names ROADMAP C.1 found missing resolve to the port's own
    objects, and each is in __all__."""
    import mxnet_tpu

    home = {"NDArray": mx.ndarray, "Variable": mx.symbol,
            "Group": mx.symbol, "AttrScope": mx.symbol,
            "Executor": mx.executor, "Speedometer": mx.callback}
    if name == "__version__":
        assert mx.__version__ == mxnet_tpu.__version__
    else:
        assert getattr(mx, name) is getattr(home[name], name)
    assert name in mx.__all__


def test_attr_scope_as_the_reference():
    """examples/model_parallel/lstm_layers.py's use: variables made in
    `mx.AttrScope(ctx_group=...)` carry the group, in both packages."""
    import mxnet_tpu

    got = []
    for pkg in (mx, mxnet_tpu):
        with pkg.AttrScope(ctx_group="dev1"):
            v = pkg.Variable("data")
        got.append(v.attr("__ctx_group__"))
    assert got == ["dev1", "dev1"]


@pytest.fixture
def build_dir(tmp_path, monkeypatch):
    """Kernel builds go to a temporary _build, with no library cached."""
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(kernels, "_libs", {})
    return tmp_path / "_build"


def test_failed_nvcc_leaves_its_log(build_dir, tmp_path, monkeypatch):
    """A stub nvcc on PATH that exits 1: the build raises MXNetError
    naming `_build/<library>.fail.txt`, which holds its output."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text("#!/bin/sh\necho 'stub nvcc: error 42 in' \"$@\"\n"
                    "exit 1\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}"
                       + os.environ.get("PATH", ""))
    assert kernels.nvcc_path() == str(nvcc)
    with pytest.raises(MXNetError) as e:
        kernels.load("paged_attention")
    path = str(build_dir / "paged_attention.fail.txt")
    assert path in str(e.value)
    with open(path) as f:
        log = f.read()
    assert "stub nvcc: error 42" in log
    assert "paged_attention.cu" in log and "exit 1" in log
    assert not os.path.exists(kernels.library_path("paged_attention"))


def test_failed_load_leaves_its_log(build_dir):
    """A library file that is not a shared object: the load raises
    MXNetError naming the fail file, which holds the OSError."""
    lib = kernels.library_path("paged_attention")
    os.makedirs(os.path.dirname(lib))
    with open(lib, "w") as f:
        f.write("not a shared object\n")
    with pytest.raises(MXNetError) as e:
        kernels.load("paged_attention")
    path = str(build_dir / "paged_attention.fail.txt")
    assert path in str(e.value)
    with open(path) as f:
        log = f.read()
    assert "ctypes.CDLL" in log and lib in log
    assert "paged_attention" not in kernels._libs


def test_build_all_finds_generated_sources_while_libraries_compile(
        build_dir, tmp_path, monkeypatch):
    """`build_all(generated=fn)` starts every library's nvcc, then calls
    fn, then compiles its texts beside them: each nvcc started is
    recorded, and a stub nvcc writes its output."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        "while [ $# -gt 1 ]; do\n"
        "  if [ \"$1\" = -o ]; then touch \"$2\"; fi\n"
        "  shift\n"
        "done\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}"
                       + os.environ.get("PATH", ""))
    monkeypatch.setattr(kernels, "GEN_DIR", str(build_dir / "gen"))
    events = []
    popen = kernels.subprocess.Popen

    def recorded(cmd, **kw):
        events.append(os.path.basename(cmd[-1]))
        return popen(cmd, **kw)

    monkeypatch.setattr(kernels.subprocess, "Popen", recorded)

    def found():
        events.append("found")
        return [("fusion_t_0", "// a generated source\n")]

    kernels.build_all(["nms", "paged_attention"], generated=found)
    assert events[:3] in (["nms.cu", "paged_attention.cu", "found"],
                          ["paged_attention.cu", "nms.cu", "found"])
    assert len(events) == 4 and events[3].startswith("fusion_t_0")
    assert os.path.exists(kernels.library_path("nms"))
    assert os.path.exists(kernels.generated_paths(
        "fusion_t_0", "// a generated source\n")[1])
