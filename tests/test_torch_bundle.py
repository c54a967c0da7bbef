"""The port's serving bundles (mxnet_tpu_torch/serving/bundle.py) and
their weight-only int8 (serving/quant.py) against the JAX package's, on
the CPU.

- `quantize_params` / `dequantize_params`: the stored int8 arrays, their
  scales, the record's name lists and the dequantized arrays are the JAX
  package's bit for bit on the same seeded dict.
- `param_content_hash` is equal across packages for the same served
  (arg:/aux:) weights and the same decoder weights, and a port bundle's
  manifest hash is the JAX package's hash of the stored arrays.
- A DecodedModel at tests/test_quant.py's size (kv_dtype="int8") saved
  with quantize="int8" and restored through
  `ModelRegistry().load_bundle` under `with mx.cpu():` gives, token for
  token, the stream of the JAX package's decoder built from the same
  dequantized weights, and of the port's.
- `ModelServer.load_bundle` restores a served bundle behind its lane.
- A served model saved as a bundle in one child and restored in another
  (no disk root of its own) builds no plan there (0 traces, 0 compiles,
  a disk hit and a disk load a bind, no nvcc) and answers bit for bit as
  the first did; its records carry the fusion decisions and the layout.
- tests/test_quant.py's four bundle cases and its fleet case
  (`test_affinity_never_matches_across_dtypes`, on the port's
  AffinityIndex) replayed on the port (its
  imports, config and `_model`, and those cases, with the module name
  `mxnet_tpu` read as `mxnet_tpu_torch`; the decoders it builds get
  device="cpu", the port's default being the card). The one the
  reference marks slow keeps the mark.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import ast  # noqa: E402
import functools  # noqa: E402
import inspect  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import re  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu import decoding as jdec  # noqa: E402
from mxnet_tpu import exec_cache_disk as jdisk  # noqa: E402
from mxnet_tpu.serving import bundle as jbundle  # noqa: E402
from mxnet_tpu.serving import quant as jwq  # noqa: E402
from mxnet_tpu_torch import decoding as tdec  # noqa: E402
from mxnet_tpu_torch import exec_cache as tcache  # noqa: E402
from mxnet_tpu_torch import exec_cache_disk as tdisk  # noqa: E402
from mxnet_tpu_torch import serving as tserving  # noqa: E402
from mxnet_tpu_torch.serving import bundle as tbundle  # noqa: E402
from mxnet_tpu_torch.serving import quant as twq  # noqa: E402
from mxnet_tpu_torch.utils.persist import read_json  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]

CFG_KW = dict(vocab=32, d_model=16, n_layers=2, n_heads=2, d_ff=32,
              max_len=64)
MODEL_KW = dict(max_batch=2, page_size=4, num_pages=32,
                page_buckets=(1, 2, 4), max_tokens=8, kv_dtype="int8",
                prefix_cache=False)
JPARAMS = jdec.init_decoder_params(jdec.DecoderConfig(**CFG_KW), seed=0)

BUNDLE_CASES = ("test_weight_quantize_roundtrip_vs_numpy",
                "test_quantized_bundle_roundtrip",
                "test_bundle_precision_mismatch_refused",
                "test_save_bundle_env_default_and_bad_scheme")
FLEET_CASES = ("test_affinity_never_matches_across_dtypes",)
_ENV = ("MXNET_BUNDLE_QUANTIZE", "MXNET_BUNDLE_QUANTIZE_OVERRIDE",
        "MXNET_BUNDLE_STRICT", "MXNET_BUNDLE_VERIFY")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """tests/test_quant.py's fixture: no decode or bundle knob set."""
    for var in list(os.environ):
        if var.startswith("MXNET_DECODE_") or var in _ENV:
            monkeypatch.delenv(var, raising=False)
    tdec.stats._registry.clear()
    yield
    tdisk.clear_overlays()


def _np(params):
    return {k: np.asarray(v) for k, v in params.items()}


# -------------------------------------------------- int8, bit for bit
def test_quantize_params_bit_exact_against_the_jax_package():
    rs = np.random.RandomState(3)
    params = {"w": (rs.randn(6, 16) * 3).astype(np.float32),
              "conv": rs.randn(8, 3, 3, 3).astype(np.float32),
              "emb": rs.randn(32, 8).astype(np.float64),
              "half": rs.randn(4, 5).astype(np.float16),
              "zero": np.zeros((3, 4), np.float32),
              "ln": rs.randn(16).astype(np.float32),
              "steps": np.asarray(7, np.int64),
              "ids": rs.randint(0, 9, (4, 4)).astype(np.int32)}
    jstored, jrec = jwq.quantize_params(params)
    tstored, trec = twq.quantize_params(params)
    assert trec == jrec
    assert sorted(tstored) == sorted(jstored)
    for name in jstored:
        assert tstored[name].dtype == jstored[name].dtype, name
        np.testing.assert_array_equal(tstored[name], jstored[name])
    jback = jwq.dequantize_params(jstored, jrec)
    tback = twq.dequantize_params(tstored, trec)
    for name in jback:
        assert tback[name].dtype == jback[name].dtype, name
        np.testing.assert_array_equal(tback[name], jback[name])
    # without a record: every array with a scale companion
    for name, arr in twq.dequantize_params(tstored).items():
        np.testing.assert_array_equal(arr, tback[name])
    assert twq.is_quantized(tstored) and not twq.is_quantized(params)
    assert (twq.SCALE_SUFFIX, twq.SCHEMES) == (jwq.SCALE_SUFFIX,
                                               jwq.SCHEMES)
    with pytest.raises(ValueError, match="scheme"):
        twq.quantize_params(params, scheme="int4")


# ------------------------------------------------------ content hashes
def test_param_content_hash_equal_across_packages():
    rs = np.random.RandomState(5)
    served = {"arg:fc_weight": rs.randn(5, 3).astype(np.float32),
              "arg:fc_bias": rs.randn(5).astype(np.float32),
              "aux:bn_moving_var": rs.rand(5).astype(np.float32)}
    want = jbundle.param_content_hash(served)
    assert tbundle.param_content_hash(served) == want
    with tmx.cpu():
        nd = {k: tmx.nd.array(v) for k, v in served.items()}
    assert tbundle.param_content_hash(nd) == want
    # the decoder's flat names, read back from the port's module
    decoder = tdec.model.params_from_jax(JPARAMS, tdec.DecoderConfig(
        **CFG_KW))
    assert tbundle.param_content_hash(decoder.flat_params()) == \
        jbundle.param_content_hash(_np(JPARAMS))
    stored, _ = jwq.quantize_params(_np(JPARAMS))
    assert tbundle.param_content_hash(stored) == \
        jbundle.param_content_hash(stored)


# ----------------------------------------- the int8 decoder's roundtrip
def test_int8_decoder_bundle_matches_the_jax_package(tmp_path,
                                                      monkeypatch):
    """save_bundle(quantize="int8") of a kv int8 decoder, restored by a
    fresh registry on the host: the manifest says int8 twice, the stored
    weights and their hash are the JAX package's quantization of the
    same weights, and the restored stream equals, token for token, the
    JAX package's decoder and the port's, both built from the
    dequantized weights. The JAX reference builds under an empty disk
    root of its own with no bundle overlay mounted: tests/test_quant.py's
    decoder has this config, and a program it left in the worker's
    shared root (tests/conftest.py) or in a bundle whose overlay a
    failed load left mounted, built for the suite's 8 virtual devices,
    must not be replayed."""
    cfg = tdec.DecoderConfig(**CFG_KW)
    m = tdec.DecodedModel("lm8", 1, JPARAMS, cfg, device="cpu", **MODEL_KW)
    out_dir = str(tmp_path / "lm8.bundle")
    try:
        tserving.save_bundle(m, out_dir, quantize="int8")
    finally:
        m.close()
    manifest = tserving.read_manifest(out_dir)
    assert manifest["kind"] == "decoded"
    assert manifest["quantization"]["scheme"] == "int8"
    assert manifest["kv_dtype"] == "int8"
    assert manifest["kernel"] == "plain"
    with np.load(os.path.join(out_dir, "params.npz")) as z:
        stored = {k: z[k] for k in z.files}
    jstored, jrec = jwq.quantize_params(_np(JPARAMS))
    assert manifest["quantization"] == jrec
    for name in jstored:
        np.testing.assert_array_equal(stored[name], jstored[name])
    assert manifest["params"]["content_hash"] == \
        jbundle.param_content_hash(jstored)
    deq = jwq.dequantize_params(jstored, jrec)

    prompt, n = [5, 6, 7], 6
    monkeypatch.setenv("MXNET_EXEC_CACHE_DIR", str(tmp_path / "jax_cache"))
    monkeypatch.setattr(jdisk, "_overlays", [])
    jref = jdec.DecodedModel("ref", 1, deq, jdec.DecoderConfig(**CFG_KW),
                             **MODEL_KW)
    try:
        want = jref.generate(prompt, max_new_tokens=n, timeout=60)
    finally:
        jref.close()
    tref = tdec.DecodedModel("tref", 1, deq, cfg, device="cpu",
                             **MODEL_KW)
    try:
        assert tref.generate(prompt, max_new_tokens=n, timeout=60) == want
    finally:
        tref.close()
    with tmx.cpu():
        m2 = tserving.ModelRegistry().load_bundle(out_dir)
    try:
        assert m2.engine.device.type == "cpu"
        assert m2.engine.kv_dtype == "int8"
        assert m2.generate(prompt, max_new_tokens=n, timeout=60) == want
    finally:
        m2.close()


def test_model_server_restores_a_served_bundle(tmp_path):
    data = tmx.sym.Variable("data")
    net = tmx.sym.SoftmaxOutput(
        tmx.sym.FullyConnected(data, num_hidden=5, name="fc"),
        name="softmax")
    rs = np.random.RandomState(0)
    params = {"arg:fc_weight": rs.rand(5, 3).astype(np.float32),
              "arg:fc_bias": rs.rand(5).astype(np.float32)}
    x = rs.rand(3).astype(np.float32)
    with tmx.cpu():
        reg = tserving.ModelRegistry()
        model = reg.load("clf", net.tojson(), params, {"data": (3,)},
                         batch_buckets=(1, 2))
        out_dir = tserving.save_bundle(model, str(tmp_path / "clf.bundle"))
        want = np.asarray(model.infer({"data": x[None]}, 1, 0)[0])[0]
        tcache.clear()
        server = tserving.ModelServer()
        try:
            restored = server.load_bundle(out_dir, name="clf2")
            got = server.predict("clf2", {"data": x}, timeout=30)
        finally:
            server.stop()
    assert restored.key == "clf2:1"
    np.testing.assert_array_equal(np.asarray(got[0]), want)


# --------------------------------------- tests/test_quant.py, replayed
def _replay_quant():
    """tests/test_quant.py's imports, its module constants and `_model`,
    the bundle cases and the fleet's affinity case."""
    path = ROOT / "tests" / "test_quant.py"
    tree = ast.parse(path.read_text())
    keep = []
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            keep.append(node)
        elif isinstance(node, ast.Assign) or (
                isinstance(node, ast.FunctionDef)
                and (node.name == "_model"
                     or node.name in BUNDLE_CASES + FLEET_CASES)):
            keep.append(node)
    src = "\n\n".join(ast.unparse(n) for n in keep)
    src = re.sub(r"\bmxnet_tpu\b", "mxnet_tpu_torch", src)
    ns = {"__name__": f"replay_{path.stem}", "__file__": str(path)}
    exec(compile(src, str(path), "exec"), ns)
    # the port's decoders run on the card unless told the host
    dec = types.ModuleType("dec")
    dec.__dict__.update(vars(tdec))
    dec.DecodedModel = functools.partial(tdec.DecodedModel, device="cpu")
    ns["dec"] = dec
    return ns


QUANT = _replay_quant()


def _case(name):
    marks = [m for m in getattr(QUANT[name], "pytestmark", [])
             if m.name == "slow"]
    return pytest.param(name, marks=marks, id=name)


def test_bundle_cases_present():
    assert all(name in QUANT for name in BUNDLE_CASES + FLEET_CASES)
    assert [m.name for m in QUANT[
        "test_quantized_bundle_roundtrip"].pytestmark] == ["slow"]


@pytest.mark.parametrize("name", [_case(n) for n in BUNDLE_CASES])
def test_quant_bundle_replayed(name, tmp_path, monkeypatch):
    fn = QUANT[name]
    params = inspect.signature(fn).parameters
    kwargs = {k: v for k, v in (("tmp_path", tmp_path),
                                ("monkeypatch", monkeypatch))
              if k in params}
    with tmx.cpu():
        fn(**kwargs)


@pytest.mark.parametrize("name", FLEET_CASES)
def test_quant_fleet_replayed(name):
    """The fleet half of tests/test_quant.py: the port's AffinityIndex
    never matches a prompt chain across KV dtypes."""
    assert QUANT["AffinityIndex"].__module__ == \
        "mxnet_tpu_torch.fleet.affinity"
    QUANT[name]()


# --------------------------------------------- a served bundle, restored
_SERVE_CHILD = """
import json, sys
import numpy as np
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import exec_cache, kernels, serving
from mxnet_tpu_torch.profiling import device_stats

mode, path = sys.argv[1], sys.argv[2]
data = mx.sym.Variable("data")
h = mx.sym.FullyConnected(data, num_hidden=16, name="fc1")
h = mx.sym.BatchNorm(h, name="bn")
h = mx.sym.relu(h * 0.5 + 1.0)
net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(h, num_hidden=4,
                                                 name="fc2"),
                           name="softmax")
rs = np.random.RandomState(0)
params = {"arg:fc1_weight": rs.randn(16, 8).astype("float32"),
          "arg:fc1_bias": rs.randn(16).astype("float32"),
          "arg:bn_gamma": rs.rand(16).astype("float32") + 0.5,
          "arg:bn_beta": rs.randn(16).astype("float32"),
          "aux:bn_moving_mean": rs.randn(16).astype("float32"),
          "aux:bn_moving_var": rs.rand(16).astype("float32") + 0.5,
          "arg:fc2_weight": rs.randn(4, 16).astype("float32"),
          "arg:fc2_bias": rs.randn(4).astype("float32")}
with mx.cpu():
    if mode == "save":
        model = serving.ModelRegistry().load(
            "clf", net.tojson(), params, {"data": (8,)},
            batch_buckets=(1, 4))
        serving.save_bundle(model, path)
    else:
        model = serving.ModelRegistry().load_bundle(path)
    x = np.random.RandomState(1).rand(4, 8).astype("float32")
    out = np.asarray(model.infer({"data": x}, 4, 0)[0])
s = exec_cache.cache_stats()
t = device_stats().get("totals", {})
print(json.dumps({
    "traces": s["traces"], "disk_hits": s["disk_hits"],
    "compiles": t.get("compiles", 0), "disk_loads": t.get("disk_loads", 0),
    "nvcc_runs": kernels.nvcc_runs(),
    "out": out.ravel().tobytes().hex()}))
"""


def _serve_child(mode, path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("MXNET_EXEC_CACHE_DIR", None)
    proc = subprocess.run([sys.executable, "-c", _SERVE_CHILD, mode,
                           str(path)], env=env, capture_output=True,
                          text=True, timeout=300, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_served_bundle_restores_in_a_fresh_process(tmp_path):
    """Saved in one child, restored in another with no disk root of its
    own: the restore builds no plan (0 traces, 0 compiles, one disk hit
    and one disk load a bind) and its outputs equal the saver's bit for
    bit."""
    bundle = tmp_path / "clf.bundle"
    saved = _serve_child("save", bundle)
    assert saved["traces"] == 2 and saved["compiles"] == 2, saved
    restored = _serve_child("restore", bundle)
    assert restored["traces"] == 0 and restored["compiles"] == 0, restored
    assert restored["disk_hits"] == 2 and restored["disk_loads"] == 2
    assert restored["nvcc_runs"] == 0
    assert restored["out"] == saved["out"]
    manifest = tserving.read_manifest(str(bundle))
    kinds = sorted(p["kind"] for p in manifest["programs"])
    assert kinds == ["record", "record"]
    rec = read_json(os.path.join(str(bundle), manifest["programs"][0]["file"]))
    # the fusion group (mul, add, relu) is among the record's decisions
    assert any(d.startswith("kernel:") for _, d in rec["fusion"]), rec
    assert rec["layout"]["device"] == "cpu"
