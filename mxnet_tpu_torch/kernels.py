"""Build and load the package's hand-written CUDA kernels.

Each kernel source `csrc/<name>.cu` has a plain C interface. At first
use it is compiled with nvcc for Hopper (`sm_90a`) into a shared
library under `mxnet_tpu_torch/_build/` (named by a digest of the
source and flags, so an edited source rebuilds) and loaded with
ctypes. Nothing is compiled when the package is imported, and nothing
outside the package's sources is used.

    kernels.build_all()              # every source, one nvcc each, in parallel
    lib = kernels.load("paged_attention")

Generated sources (the fusion-group kernels of passes/codegen.py) go
through the same compiler: `build_generated([(tag, text), ...])` writes
each text to `_build/gen/`, starts one nvcc per source not built yet,
all together, and `load_generated(tag, text)` loads its library. Their
libraries are named by a digest of the text, the headers under `csrc/`
and the flags, so equal sources share one build.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

from .base import MXNetError

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")

SOURCES = ("paged_attention", "flash_attention")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# Generated fusion kernels compile without multiply-add contraction, so
# a chain rounds after every op as its plain version (one PyTorch kernel
# per op) does, and the two agree bit for bit on +, -, * and /.
GEN_NVCC_FLAGS = NVCC_FLAGS + ("-fmad=false",)

_lock = threading.Lock()
_libs = {}


def nvcc_path():
    """The nvcc to build with: $CUDA_HOME/bin/nvcc, nvcc on PATH, or
    /usr/local/cuda/bin/nvcc."""
    cands = []
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        cands.append(os.path.join(home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise MXNetError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of mxnet_tpu_torch are built from source at first use")


def _source(name):
    if name not in SOURCES:
        raise MXNetError(f"unknown kernel source {name!r}")
    return os.path.join(CSRC_DIR, f"{name}.cu")


def library_path(name):
    """Where the built library of `name` lives (digest of source +
    flags in the file name)."""
    with open(_source(name), "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def _compile(jobs):
    """Start one nvcc per (source, library, flags) whose library is not
    built yet, all together, and wait for every one. Raises MXNetError
    with the compiler's output of each failure. Called with _lock
    held."""
    nvcc = nvcc_path()
    started, seen = [], set()
    for src, out, flags in jobs:
        if out in seen or os.path.exists(out):
            continue
        seen.add(out)
        os.makedirs(os.path.dirname(out), exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.Popen([nvcc, *flags, "-o", tmp, src],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started.append((src, proc, tmp, out))
    errors = []
    for src, proc, tmp, out in started:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.unlink(tmp)
            errors.append(f"nvcc failed for {os.path.basename(src)}:\n{log}")
        else:
            os.replace(tmp, out)
    if errors:
        raise MXNetError("\n".join(errors))


def _job(name):
    return _source(name), library_path(name), NVCC_FLAGS


def build_all(names=SOURCES):
    """Compile every named source that is not built yet, one nvcc
    process per source, all started together. Returns the wall
    seconds spent."""
    t0 = time.perf_counter()
    with _lock:
        _compile([_job(n) for n in names])
    return time.perf_counter() - t0


def load(name):
    """The ctypes handle of kernel library `name`, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _compile([_job(name)])
            lib = _libs[name] = ctypes.CDLL(library_path(name))
        return lib


# ------------------------------------------------------ generated sources
GEN_DIR = os.path.join(BUILD_DIR, "gen")


def _headers_digest():
    h = hashlib.sha256()
    for fname in sorted(os.listdir(CSRC_DIR)):
        if fname.endswith(".cuh"):
            with open(os.path.join(CSRC_DIR, fname), "rb") as f:
                h.update(fname.encode() + f.read())
    return h.hexdigest()


def generated_paths(tag, text):
    """(source path, library path) of a generated source."""
    digest = hashlib.sha256(
        text.encode() + _headers_digest().encode()
        + " ".join(GEN_NVCC_FLAGS).encode()).hexdigest()[:16]
    stem = f"{tag}-{digest}"
    return (os.path.join(GEN_DIR, f"{stem}.cu"),
            os.path.join(GEN_DIR, f"lib{stem}.so"))


def _generated_job(tag, text):
    """The compile job of a generated source, written to `_build/gen/`
    unless its library is built."""
    src, out = generated_paths(tag, text)
    if not os.path.exists(out):
        os.makedirs(GEN_DIR, exist_ok=True)
        with open(src, "w") as f:
            f.write(text)
    return src, out, GEN_NVCC_FLAGS + ("-I", CSRC_DIR)


def build_generated(items):
    """Compile every (tag, text) whose library is missing: one nvcc
    process per source, all started together. Raises MXNetError with
    the compiler's output when any fails. Returns the wall seconds."""
    t0 = time.perf_counter()
    with _lock:
        _compile([_generated_job(tag, text) for tag, text in items])
    return time.perf_counter() - t0


def load_generated(tag, text):
    """The ctypes handle of a generated source, built on first use."""
    _, out = generated_paths(tag, text)
    with _lock:
        lib = _libs.get(out)
        if lib is None:
            _compile([_generated_job(tag, text)])
            lib = _libs[out] = ctypes.CDLL(out)
        return lib
