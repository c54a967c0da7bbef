"""Build and load the package's hand-written CUDA kernels.

Each kernel library has a plain C interface. At first use its source
`csrc/<source>.cu` is compiled with nvcc for Hopper (`sm_90a`) into a
shared library under `mxnet_tpu_torch/_build/` (named by a digest of
the source, the headers under `csrc/` and the flags, so an edited
source rebuilds) and loaded with ctypes. A library is named after its
source, or builds one source with its own flags (`LIBRARIES`: the
flash-attention forward once a dtype, so its instances compile in three
processes; NMS without multiply-add contraction). Nothing is compiled
when the package is imported, and nothing outside the package's sources
is used.

    kernels.build_all()              # every library, one nvcc each, in parallel
    lib = kernels.load("paged_attention")

Each build keeps the compiler's output (ptxas's registers, spills and
shared memory of every kernel, from `-Xptxas -v`) beside its library:
`build_report(name)` reads it. A build that fails leaves the compiler's
output, and a library that fails to load leaves the loader's error, in
`_build/<library>.fail.txt` (`_build/gen/<tag>.fail.txt` for a
generated source), and the raised MXNetError names that file.

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

# library name -> (source under csrc/, extra nvcc flags)
LIBRARIES = {
    "paged_attention": ("paged_attention", ()),
    "flash_attention_f32": ("flash_attention", ("-DMX_FLASH_DTYPE=0",)),
    "flash_attention_bf16": ("flash_attention", ("-DMX_FLASH_DTYPE=1",)),
    "flash_attention_f16": ("flash_attention", ("-DMX_FLASH_DTYPE=2",)),
    # greedy NMS: no contraction, so each IoU rounds as the plain version's
    "nms": ("nms", ("-fmad=false",)),
}

_BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# the hand-written sources hold many template instances: nvcc optimizes
# them in parallel threads
NVCC_FLAGS = _BASE_FLAGS + ("-split-compile=0",)

# Generated fusion kernels compile without multiply-add contraction, so
# a chain rounds after every op as its plain version (one PyTorch kernel
# per op) does, and the two agree bit for bit on +, -, * and /.
GEN_NVCC_FLAGS = _BASE_FLAGS + ("-fmad=false",)

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
    """(source path, nvcc flags) of library `name`."""
    if name not in LIBRARIES:
        raise MXNetError(f"unknown kernel library {name!r}")
    src, defines = LIBRARIES[name]
    return os.path.join(CSRC_DIR, f"{src}.cu"), NVCC_FLAGS + defines


def library_path(name):
    """Where the built library of `name` lives (digest of source,
    headers and flags in the file name)."""
    src, flags = _source(name)
    with open(src, "rb") as f:
        digest = hashlib.sha256(
            f.read() + _headers_digest().encode()
            + " ".join(flags).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def report_path(lib):
    """Where the compiler's output for library `lib` is kept."""
    return os.path.splitext(lib)[0] + ".ptxas.txt"


def build_report(name):
    """The compiler's output of kernel library `name`'s build, or None
    when the library was built without one kept."""
    path = report_path(library_path(name))
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return f.read()


def _write_fail(name, out, text):
    """Keep the log of library `name`'s failed build or load in
    `<name>.fail.txt` beside its library; returns the file's path."""
    path = os.path.join(os.path.dirname(out), f"{name}.fail.txt")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)
    return path


def _compile(jobs):
    """Start one nvcc per (name, source, library, flags) whose library is
    not built yet, all together, and wait for every one. Raises
    MXNetError with the compiler's output of each failure, which is also
    written to the library's fail file. Called with _lock held."""
    _wait(_start(jobs))


def _start(jobs):
    """Start the nvcc of each job whose library is missing; returns what
    `_wait` takes."""
    pending, seen = [], set()
    for name, src, out, flags in jobs:
        if out not in seen and not os.path.exists(out):
            seen.add(out)
            pending.append((name, src, out, flags))
    if not pending:
        return []
    nvcc = nvcc_path()
    started = []
    for name, src, out, flags in pending:
        os.makedirs(os.path.dirname(out), exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *flags, "-o", tmp, src]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started.append((name, src, proc, tmp, out, cmd))
    return started


def _wait(started):
    """Wait for every started nvcc; keep each report, or raise
    MXNetError with the output of each failure."""
    errors = []
    for name, src, proc, tmp, out, cmd in started:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.unlink(tmp)
            path = _write_fail(
                name, out, f"{' '.join(cmd)}\nexit {proc.returncode}\n{log}")
            errors.append(f"nvcc failed for {os.path.basename(src)} "
                          f"(log: {path}):\n{log}")
        else:
            with open(report_path(out), "w") as f:
                f.write(log)
            os.replace(tmp, out)
    if errors:
        raise MXNetError("\n".join(errors))


def _load_library(name, out):
    """ctypes.CDLL of a built library; a failure leaves the loader's
    error in the library's fail file and raises MXNetError naming it."""
    try:
        return ctypes.CDLL(out)
    except OSError as e:
        path = _write_fail(name, out, f"ctypes.CDLL({out!r}) failed:\n{e}\n")
        raise MXNetError(
            f"kernel library {name} failed to load (log: {path}): {e}"
        ) from e


def _job(name):
    src, flags = _source(name)
    return name, src, library_path(name), flags


def build_all(names=tuple(LIBRARIES), generated=None):
    """Compile every named library that is not built yet, one nvcc
    process per library, all running together; with `generated`, a
    function returning (tag, text) pairs of generated sources, called
    once the libraries' compilers are running (so that finding the texts
    overlaps them), each text whose library is missing compiles beside
    them. Returns the wall seconds spent."""
    t0 = time.perf_counter()
    with _lock:
        started = _start([_job(n) for n in names])
        try:
            items = generated() if generated else ()
            started += _start([_generated_job(tag, text)
                               for tag, text in items])
        except BaseException:
            for proc in (x[2] for x in started):
                proc.kill()
                proc.communicate()
            raise
        _wait(started)
    return time.perf_counter() - t0


def load(name):
    """The ctypes handle of kernel library `name`, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _compile([_job(name)])
            lib = _libs[name] = _load_library(name, library_path(name))
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
    return tag, src, out, GEN_NVCC_FLAGS + ("-I", CSRC_DIR)


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
            lib = _libs[out] = _load_library(tag, out)
        return lib
