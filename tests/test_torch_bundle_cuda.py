"""Serving bundles on the card (mxnet_tpu_torch/serving/bundle.py,
exec_cache_disk.py, kernels.py). Marked `cuda`: these skip where
torch.cuda.is_available() is false. This file does not import jax:

    python -m pytest tests/test_torch_bundle_cuda.py -q

- A served bundle of a small net with a generated fusion group (B2's
  scale_bias_act), saved here, is restored in a child process that
  imports a copy of the package with no _build/ and finds no nvcc on its
  PATH or under CUDA_HOME (its kernels.nvcc_path refuses): no plan built,
  no nvcc run, every library loaded from the bundle's exec_cache/, the
  outputs equal this process's bit for bit.
- The same bundle with its library blob's bytes corrupted: the child
  (with nvcc this time) quarantines the blob, counts the record stale,
  builds the plan and compiles the library into its own _build/, and
  never loads the blob; the outputs are still equal bit for bit.
"""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


_CHILD = """
import json, os, sys
import numpy as np
import torch
torch.backends.cudnn.allow_tf32 = False
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import exec_cache, kernels, passes
from mxnet_tpu_torch.base import MXNetError

path, allow_nvcc = sys.argv[1], sys.argv[2] == "1"
assert not os.path.exists(kernels.BUILD_DIR), kernels.BUILD_DIR
if not allow_nvcc:
    def refuse():
        raise MXNetError("no nvcc here")
    kernels.nvcc_path = refuse
server = mx.serving.ModelServer(max_batch=4)
model = server.load_bundle(path)
x = np.load(os.path.join(os.path.dirname(path), "x.npy"))
out = np.asarray(model.infer({"data": x}, 4, 0)[0])
server.stop()
s = exec_cache.cache_stats()
print(json.dumps({"traces": s["traces"], "disk_hits": s["disk_hits"],
                  "disk_stale": s["disk_stale"],
                  "quarantined": s["disk_quarantined"],
                  "nvcc_runs": kernels.nvcc_runs(),
                  "loaded": kernels.loaded(),
                  "launches": passes.launch_counts(),
                  "package": os.path.dirname(mx.__file__),
                  "out": out.tobytes().hex()}))
"""


def _net(mx):
    data = mx.sym.Variable("data")
    h = mx.sym.FullyConnected(data, num_hidden=256, name="fc1")
    h = mx.sym.relu(h * 0.5 + 1.0)
    return mx.sym.SoftmaxOutput(
        mx.sym.FullyConnected(h, num_hidden=8, name="fc2"), name="softmax")


def _child(tmp_path, bundle, allow_nvcc):
    """The child in a copy of the package with no _build/ (and, unless
    `allow_nvcc`, no nvcc on PATH nor CUDA_HOME)."""
    pkg = tmp_path / f"pkg{int(allow_nvcc)}"
    shutil.copytree(os.path.join(ROOT, "mxnet_tpu_torch"),
                    pkg / "mxnet_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    env = dict(os.environ)
    env.pop("MXNET_EXEC_CACHE_DIR", None)
    if not allow_nvcc:
        for var in ("CUDA_HOME", "CUDA_PATH"):
            env.pop(var, None)
        env["PATH"] = os.pathsep.join(
            d for d in env.get("PATH", "").split(os.pathsep)
            if d and not os.path.exists(os.path.join(d, "nvcc")))
    res = subprocess.run(
        [sys.executable, "-c", _CHILD, str(bundle), str(int(allow_nvcc))],
        cwd=str(pkg), env=env, capture_output=True, text=True,
        timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["package"] == str(pkg / "mxnet_tpu_torch")
    return got


def _saved(tmp_path):
    import mxnet_tpu_torch as mx

    rs = np.random.RandomState(0)
    params = {"arg:fc1_weight": rs.randn(256, 64).astype(np.float32) * 0.1,
              "arg:fc1_bias": rs.randn(256).astype(np.float32),
              "arg:fc2_weight": rs.randn(8, 256).astype(np.float32) * 0.1,
              "arg:fc2_bias": rs.randn(8).astype(np.float32)}
    x = rs.rand(4, 64).astype(np.float32)
    np.save(tmp_path / "x.npy", x)
    reg = mx.serving.ModelRegistry()
    model = reg.load("clf", _net(mx).tojson(), params, {"data": (64,)},
                     batch_buckets=(1, 4), ctx=mx.gpu(0))
    want = np.asarray(model.infer({"data": x}, 4, 0)[0])
    bundle = mx.serving.save_bundle(model, str(tmp_path / "clf.bundle"))
    reg.unload("clf")
    return bundle, want


def test_bundle_restores_without_build_dir_or_nvcc(card, tmp_path):
    bundle, want = _saved(tmp_path)
    got = _child(tmp_path, bundle, allow_nvcc=False)
    assert got["traces"] == 0 and got["nvcc_runs"] == 0, got
    assert got["disk_hits"] == 2, got
    root = os.path.join(bundle, "exec_cache") + os.sep
    assert got["loaded"] and all(p.startswith(root)
                                 for p in got["loaded"].values()), got
    assert got["launches"]["scale_bias_act"] > 0, got
    assert bytes.fromhex(got["out"]) == want.tobytes()


def test_corrupt_blob_is_quarantined_and_rebuilt(card, tmp_path):
    bundle, want = _saved(tmp_path)
    blobs = [os.path.join(d, f) for d, _, files in os.walk(bundle)
             for f in files if f.startswith("exe-") and f.endswith(".bin")]
    assert blobs
    for blob in blobs:
        with open(blob, "r+b") as f:
            f.seek(64)
            f.write(b"\xff" * 16)
    got = _child(tmp_path, bundle, allow_nvcc=True)
    assert got["traces"] == 2 and got["disk_stale"] >= 1, got
    assert got["quarantined"] >= 1 and got["nvcc_runs"] >= 1, got
    assert not any(p.startswith(bundle) for p in got["loaded"].values())
    assert not any(os.path.exists(b) for b in blobs)
    assert bytes.fromhex(got["out"]) == want.tobytes()
