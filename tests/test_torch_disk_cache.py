"""The port's exec-cache disk tier (mxnet_tpu_torch/exec_cache_disk.py)
against the JAX package's contract, on the CPU.

- tests/test_disk_cache.py replayed on the port (the reference source
  with the module name `mxnet_tpu` read as `mxnet_tpu_torch`, under
  `with mx.cpu():`, after its fixture: a fresh disk root and zeroed
  counters a test): the record layer's hit/miss/stale counts, the
  quarantine of a torn record and of a corrupt library blob at
  `exe_path`, the self-written skip, the LRU cap, the two-child restart
  (the second child builds no plan, compiles nothing and answers bit
  for bit the same) and the bundle cases. The restart child builds its
  input on the host (`mx.nd.array(x, ctx=mx.cpu())`: the port's arrays
  default to the card). REWRITTEN: the stale-fingerprint case ages the
  port's fingerprint (`torch`, in the record and in each blob's
  metadata) where the reference ages jaxlib's.
- A record of another layout (device, sharding digest, fusion decisions,
  walk order) is counted `disk_stale` and never runs: the bind builds its
  own plan.
- A library blob in a mounted root is loaded in place with ctypes and no
  nvcc starts; a blob whose bytes do not hash to its metadata is
  quarantined, never loaded.
- The port's records are stale to the JAX package's `lookup_record`, and
  the JAX package's to the port's.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import _ctypes  # noqa: E402
import inspect  # noqa: E402
import pathlib  # noqa: E402
import re  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch import exec_cache as tcache  # noqa: E402
from mxnet_tpu_torch import exec_cache_disk as tdisk  # noqa: E402
from mxnet_tpu_torch import kernels  # noqa: E402
from mxnet_tpu_torch.utils.persist import (atomic_write_json,  # noqa: E402
                                           read_json)

ROOT = pathlib.Path(__file__).resolve().parents[1]

REWRITTEN = {
    "test_stale_version_entry_retraces":
        "the port's fingerprint has torch where the JAX package's has "
        "jaxlib, and its blobs keep theirs in a JSON beside them",
}


def _replay(test_file):
    path = ROOT / "tests" / test_file
    src = re.sub(r"\bmxnet_tpu\b", "mxnet_tpu_torch", path.read_text())
    # the restart child runs outside `with mx.cpu():`
    src = src.replace("mx.nd.array(x))", "mx.nd.array(x, ctx=mx.cpu()))")
    ns = {"__name__": f"replay_{path.stem}", "__file__": str(path)}
    exec(compile(src, str(path), "exec"), ns)
    return ns


DISK = _replay("test_disk_cache.py")
ALL_TESTS = sorted(n for n in DISK if n.startswith("test_"))
REPLAYED = [n for n in ALL_TESTS if n not in REWRITTEN]


@pytest.fixture(autouse=True)
def _fresh(monkeypatch, tmp_path):
    """The reference file's fixture: a disk root of the test's own and
    zeroed counters."""
    monkeypatch.setenv("MXNET_EXEC_CACHE_DIR", str(tmp_path / "root"))
    monkeypatch.delenv("MXNET_EXEC_CACHE_DISK_BYTES", raising=False)
    tcache.clear()
    tcache.reset_stats()
    tdisk.clear_overlays()
    yield
    tcache.clear()
    tcache.reset_stats()
    tdisk.clear_overlays()


def test_every_reference_case_is_accounted_for():
    assert len(ALL_TESTS) == 12, ALL_TESTS
    assert set(REWRITTEN) <= set(ALL_TESTS)


@pytest.mark.parametrize("name", REPLAYED)
def test_disk_cache_replayed(name, tmp_path, monkeypatch):
    fn = DISK[name]
    params = inspect.signature(fn).parameters
    kwargs = {k: v for k, v in (("tmp_path", tmp_path),
                                ("monkeypatch", monkeypatch))
              if k in params}
    with tmx.cpu():
        fn(**kwargs)


def test_stale_version_entry_retraces(tmp_path):
    """REWRITTEN: another torch (the fingerprints of the records and of
    the blobs' metadata aged) falls back to a plain bind, counted
    disk_stale, no error."""
    cache = tmp_path / "disk"
    DISK["_run_child"](cache)
    entries = os.path.join(str(cache), "entries")
    for digest in os.listdir(entries):
        edir = os.path.join(entries, digest)
        for fn in os.listdir(edir):
            if fn == "record.json" or (fn.startswith("exe-")
                                       and fn.endswith(".json")):
                path = os.path.join(edir, fn)
                rec = read_json(path)
                rec["env"]["torch"] = "0.0.0"
                atomic_write_json(path, rec)
    restore = DISK["_run_child"](cache)
    assert restore["traces"] == 1 and restore["compiles"] == 1, restore
    assert restore["disk_stale"] > 0, restore


def test_env_fingerprint_fields():
    env = tdisk.env_fingerprint()
    assert sorted(env) == ["capability", "cuda", "device", "format",
                           "framework", "framework_version", "torch"]
    assert env["framework"] == "mxnet_tpu_torch"
    assert env["format"] == tdisk.RECORD_VERSION
    assert tdisk._compatible(env)
    for field in env:
        assert not tdisk._compatible(dict(env, **{field: "other"}))
    assert not tdisk._compatible(dict(env, jaxlib="0.4.0"))


# ------------------------------------------------ another layout is stale
def _mlp():
    data = tmx.sym.Variable("data")
    fc = tmx.sym.FullyConnected(data, num_hidden=5, name="fc")
    return tmx.sym.SoftmaxOutput(fc, name="softmax")


_DOCTOR = {
    "none": lambda rec: None,
    "device": lambda rec: rec["layout"].update(device="cuda:0"),
    "sharding": lambda rec: rec["layout"].update(sharding="0123abcd4567"),
    "fusion": lambda rec: rec.update(fusion=[["g0", "kernel:feedface"]]),
    "walk": lambda rec: rec.update(walk=rec["walk"][::-1]),
}


@pytest.mark.parametrize("field", sorted(_DOCTOR))
def test_record_of_another_layout_is_stale(field, tmp_path):
    """A record under this bind's digest whose layout or plan is not this
    bind's is counted disk_stale, and the bind builds its own plan; the
    untouched record restores ("none")."""
    x = np.random.RandomState(0).rand(4, 3).astype(np.float32)
    with tmx.cpu():
        exe = _mlp().simple_bind(tmx.cpu(), data=(4, 3))
        want = exe.forward(data=tmx.nd.array(x))[0].asnumpy()
        digest = exe._compiled.digest
        rec = read_json(os.path.join(tdisk.entry_dir(
            tdisk.cache_dir(), digest), "record.json"))
        _DOCTOR[field](rec)
        overlay = str(tmp_path / "overlay")
        atomic_write_json(os.path.join(tdisk.entry_dir(overlay, digest),
                                       "record.json"), rec)
        tdisk.add_overlay(overlay)
        tcache.clear()
        tcache.reset_stats()
        exe2 = _mlp().simple_bind(tmx.cpu(), data=(4, 3))
        got = exe2.forward(data=tmx.nd.array(x))[0].asnumpy()
    s = tcache.cache_stats()
    assert s["disk_hits"] == 1, s
    restored = field == "none"
    assert exe2._compiled.from_disk is restored
    assert s["traces"] == (0 if restored else 1), s
    assert s["disk_stale"] == (0 if restored else 1), s
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------ library blobs
def test_library_blob_loaded_in_place_and_corrupt_blob_quarantined(
        tmp_path, monkeypatch):
    """A library missing from _build/ whose blob a mounted root holds:
    kernels starts no nvcc and loads the blob in place with ctypes (a
    shared object stands in for a built kernel library). A blob whose
    bytes no longer hash to its metadata is quarantined, never
    returned."""
    tag, sighash = "fusion_elementwise_cafe", "0123456789abcdef"
    overlay = str(tmp_path / "overlay")
    blob = tdisk.store_executable("e0", tag, sighash, _ctypes.__file__,
                                  root=overlay)
    assert blob == tdisk.exe_path(overlay, "e0", tag, sighash)
    tdisk.add_overlay(overlay)
    out = os.path.join(str(tmp_path), f"lib{tag}-{sighash}.so")

    def no_nvcc():
        raise AssertionError("nvcc asked for")

    monkeypatch.setattr(kernels, "nvcc_path", no_nvcc)
    runs = kernels.nvcc_runs()
    try:
        with kernels._lock:
            assert kernels._start([(tag, "unused.cu", out, ())]) == []
            kernels._load_library(tag, out)
        assert kernels.nvcc_runs() == runs
        assert kernels.library_file(out) == blob
        assert kernels.loaded()[tag] == blob
        assert tdisk.load_executable("e0", tag, sighash) == blob
    finally:
        with kernels._lock:
            kernels._LOCATED.pop(out, None)
            kernels._LOADED.pop(tag, None)
    with open(blob, "r+b") as f:
        f.seek(100)
        f.write(b"\x00\x01\x02\x03")
    before = tdisk.counters()["disk_quarantined"]
    assert tdisk.find_executable(tag, sighash) is None
    assert tdisk.counters()["disk_quarantined"] == before + 1
    assert not os.path.exists(blob)
    assert os.listdir(os.path.join(overlay, "quarantine"))


# ---------------------------------------------------- across the packages
def test_records_are_stale_across_packages(tmp_path, monkeypatch):
    """Both packages lay records out alike; each counts the other's as
    stale and does not read it."""
    from mxnet_tpu import exec_cache_disk as jdisk

    root = str(tmp_path / "shared")
    tdisk.write_record("port00000000", root=root)
    jdisk.write_record("jax000000000", root=root)
    monkeypatch.setenv("MXNET_EXEC_CACHE_DIR", root)
    jdisk.reset_counters()
    tdisk.reset_counters()
    assert jdisk.lookup_record("port00000000") is None
    assert jdisk.counters()["disk_stale"] == 1
    assert tdisk.lookup_record("jax000000000") is None
    assert tdisk.counters()["disk_stale"] == 1
    assert jdisk.lookup_record("jax000000000") is not None
    assert tdisk.lookup_record("port00000000") is not None
    jdisk.reset_counters()
