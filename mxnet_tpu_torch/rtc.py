"""Runtime-compiled CUDA kernels: user device code launched on NDArrays.

The counterpart of mxnet_tpu/rtc.py, whose `PallasKernel.push` wraps a
user Pallas body for the TPU. On the card, user device code is CUDA C++
source text, as in the reference MXNet (src/common/mxrtc.cc, NVRTC):

    src = r'''
    extern "C" __global__ void double_f32(const float* x, float* out,
                                          long long n) {
      for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
           i < n; i += (long long)gridDim.x * blockDim.x)
        out[i] = x[i] * 2.0f;
    }'''
    k = mx.rtc.CudaKernel("double", src, "double_f32")
    (y,) = k.push([x], out_shapes=[x.shape])      # x an NDArray on the card

The kernel's arguments are pointers to the inputs, then to the outputs,
then one int64: the element count of the first output. `push` allocates
the outputs on the inputs' device (float32 unless `out_dtypes` says
otherwise) and launches `block=256`, `grid=ceil(n / 256)` unless given
`grid`/`block` (what `pallas_kwargs` `grid=` is to the Pallas call);
`push_into` writes into given outputs (the C API's MXTpuRtcPush).

At the first push the source is compiled with NVRTC for Hopper
(`--gpu-architecture=sm_90a`) to a cubin, not PTX: a PTX from an NVRTC
newer than the driver would not load, and `sm_90a` code needs a cubin.
The cubin is cached in memory and under `_build/rtc/<digest>.cubin`
(the digest covers the source, the options and the NVRTC version), so
each source compiles once. It is loaded with the CUDA driver API, one
module per (device, digest), and launched with `cuLaunchKernel` on
torch's current stream of the tensors' device, with that device's
primary context (torch's) made current on the calling thread for the
call. The bindings to `libnvrtc` and `libcuda.so.1` are ctypes, loaded
at first use.

There is no fallback: CPU tensors, non-contiguous tensors, tensors on
two devices, a source without `fn_name` (checked before compiling, as
the C API's rtc_create checks) and a failed compile (with NVRTC's log)
raise MXNetError.

`stats()` counts launches, NVRTC compiles and cubin cache hits over the
process; each kernel also counts its own `launches`.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import threading
import time

import torch

from .base import MXNetError
from .ndarray import NDArray
from .ops.shape_infer import torch_dtype

_HERE = os.path.dirname(os.path.abspath(__file__))
CUBIN_DIR = os.path.join(_HERE, "_build", "rtc")
NVRTC_OPTIONS = ("--gpu-architecture=sm_90a", "-std=c++17")
DEFAULT_BLOCK = 256
_MAX_THREADS = 1024

_lock = threading.Lock()
_libs = {}          # "nvrtc" / "cuda" -> ctypes.CDLL
_cubins = {}        # digest -> cubin bytes
_modules = {}       # (device index, digest) -> CUmodule
_contexts = {}      # device index -> primary CUcontext
_stats = {"launches": 0, "compiles": 0, "cache_hits": 0}


def stats():
    """{'launches', 'compiles', 'cache_hits'} over the process: kernel
    launches, NVRTC compiles, and cubins found in the memory or disk
    cache instead of compiled."""
    with _lock:
        return dict(_stats)


def reset_stats():
    with _lock:
        for k in _stats:
            _stats[k] = 0


# ------------------------------------------------------------ libraries
def _nvrtc_dirs():
    """$CUDA_HOME/lib64 (or $CUDA_PATH, or /usr/local/cuda), then the
    NVRTC that PyTorch's CUDA wheels bring (nvidia/cuda_nvrtc/lib)."""
    home = (os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
            or "/usr/local/cuda")
    site = os.path.dirname(os.path.dirname(os.path.abspath(torch.__file__)))
    return [os.path.join(home, "lib64"),
            os.path.join(site, "nvidia", "cuda_nvrtc", "lib")]


def _load_nvrtc():
    for d in _nvrtc_dirs():
        found = sorted(glob.glob(os.path.join(d, "libnvrtc.so*")), key=len)
        if not found:
            continue
        # NVRTC dlopens its builtins library by name; loading it first
        # from the same directory makes that name resolve here.
        for builtins in sorted(glob.glob(
                os.path.join(d, "libnvrtc-builtins.so*")), key=len)[:1]:
            ctypes.CDLL(builtins, mode=ctypes.RTLD_GLOBAL)
        lib = ctypes.CDLL(found[0])
        lib.nvrtcGetErrorString.restype = ctypes.c_char_p
        lib.nvrtcGetErrorString.argtypes = [ctypes.c_int]
        for name, args in (
                ("nvrtcVersion", [ctypes.POINTER(ctypes.c_int)] * 2),
                ("nvrtcCreateProgram",
                 [ctypes.POINTER(ctypes.c_void_p), ctypes.c_char_p,
                  ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p,
                  ctypes.c_void_p]),
                ("nvrtcCompileProgram",
                 [ctypes.c_void_p, ctypes.c_int,
                  ctypes.POINTER(ctypes.c_char_p)]),
                ("nvrtcGetProgramLogSize",
                 [ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)]),
                ("nvrtcGetProgramLog", [ctypes.c_void_p, ctypes.c_char_p]),
                ("nvrtcGetCUBINSize",
                 [ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)]),
                ("nvrtcGetCUBIN", [ctypes.c_void_p, ctypes.c_char_p]),
                ("nvrtcDestroyProgram", [ctypes.POINTER(ctypes.c_void_p)])):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, ctypes.c_int
        return lib
    raise MXNetError(
        "libnvrtc not found under " + " or ".join(_nvrtc_dirs())
        + ": CUDA source is compiled with NVRTC (set CUDA_HOME)")


def _load_cuda():
    try:
        lib = ctypes.CDLL("libcuda.so.1")
    except OSError as e:
        raise MXNetError(f"the CUDA driver (libcuda.so.1) is not "
                         f"loadable: {e}") from None
    vp, p = ctypes.c_void_p, ctypes.POINTER
    for name, args in (
            ("cuInit", [ctypes.c_uint]),
            ("cuDeviceGet", [p(ctypes.c_int), ctypes.c_int]),
            ("cuDevicePrimaryCtxRetain", [p(vp), ctypes.c_int]),
            ("cuCtxGetCurrent", [p(vp)]),
            ("cuCtxSetCurrent", [vp]),
            ("cuModuleLoadData", [p(vp), ctypes.c_char_p]),
            ("cuModuleGetFunction", [p(vp), vp, ctypes.c_char_p]),
            ("cuLaunchKernel", [vp] + [ctypes.c_uint] * 7
             + [vp, p(vp), p(vp)]),
            ("cuGetErrorName", [ctypes.c_int, p(ctypes.c_char_p)]),
            ("cuGetErrorString", [ctypes.c_int, p(ctypes.c_char_p)])):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, ctypes.c_int
    _cu_check(lib, lib.cuInit(0), "cuInit")
    return lib


def _lib(which):
    """The ctypes handle of 'nvrtc' or 'cuda', loaded at first use.
    Called with _lock held."""
    lib = _libs.get(which)
    if lib is None:
        lib = _libs[which] = (_load_nvrtc() if which == "nvrtc"
                              else _load_cuda())
    return lib


def _cu_check(lib, res, what):
    if res != 0:
        name, text = ctypes.c_char_p(), ctypes.c_char_p()
        lib.cuGetErrorName(res, ctypes.byref(name))
        lib.cuGetErrorString(res, ctypes.byref(text))
        raise MXNetError(
            f"{what} failed: CUDA error {res} "
            f"{(name.value or b'').decode()}: "
            f"{(text.value or b'').decode()}")


def _nvrtc_check(lib, res, what):
    if res != 0:
        raise MXNetError(f"{what} failed: "
                         f"{lib.nvrtcGetErrorString(res).decode()}")


# ------------------------------------------------------------ compiling
def _digest(source):
    """Digest of the source, the options and the NVRTC version. Called
    with _lock held."""
    lib = _lib("nvrtc")
    major, minor = ctypes.c_int(), ctypes.c_int()
    _nvrtc_check(lib, lib.nvrtcVersion(ctypes.byref(major),
                                       ctypes.byref(minor)), "nvrtcVersion")
    key = "\0".join((source, " ".join(NVRTC_OPTIONS),
                     f"nvrtc {major.value}.{minor.value}"))
    return hashlib.sha256(key.encode()).hexdigest()[:16]


def _nvrtc_compile(name, source):
    """The cubin of `source`; raises MXNetError with NVRTC's log when
    the compile fails. Called with _lock held."""
    lib = _lib("nvrtc")
    prog = ctypes.c_void_p()
    _nvrtc_check(lib, lib.nvrtcCreateProgram(
        ctypes.byref(prog), source.encode(), f"{name}.cu".encode(), 0,
        None, None), "nvrtcCreateProgram")
    try:
        opts = (ctypes.c_char_p * len(NVRTC_OPTIONS))(
            *[o.encode() for o in NVRTC_OPTIONS])
        res = lib.nvrtcCompileProgram(prog, len(NVRTC_OPTIONS), opts)
        if res != 0:
            size = ctypes.c_size_t()
            lib.nvrtcGetProgramLogSize(prog, ctypes.byref(size))
            log = ctypes.create_string_buffer(size.value)
            lib.nvrtcGetProgramLog(prog, log)
            raise MXNetError(
                f"NVRTC failed to compile {name!r} "
                f"({lib.nvrtcGetErrorString(res).decode()}):\n"
                f"{log.value.decode(errors='replace')}")
        size = ctypes.c_size_t()
        _nvrtc_check(lib, lib.nvrtcGetCUBINSize(prog, ctypes.byref(size)),
                     "nvrtcGetCUBINSize")
        buf = ctypes.create_string_buffer(size.value)
        _nvrtc_check(lib, lib.nvrtcGetCUBIN(prog, buf), "nvrtcGetCUBIN")
        return buf.raw
    finally:
        lib.nvrtcDestroyProgram(ctypes.byref(prog))


def _cubin(name, source):
    """(digest, cubin, ms of the NVRTC compile or None on a cache hit).
    Called with _lock held."""
    digest = _digest(source)
    cubin = _cubins.get(digest)
    path = os.path.join(CUBIN_DIR, f"{digest}.cubin")
    if cubin is None and os.path.exists(path):
        with open(path, "rb") as f:
            cubin = f.read()
    if cubin is not None:
        _cubins[digest] = cubin
        _stats["cache_hits"] += 1
        return digest, cubin, None
    t0 = time.perf_counter()
    cubin = _nvrtc_compile(name, source)
    ms = (time.perf_counter() - t0) * 1e3
    _stats["compiles"] += 1
    _cubins[digest] = cubin
    os.makedirs(CUBIN_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(cubin)
    os.replace(tmp, path)
    return digest, cubin, ms


# ------------------------------------------------------------ launching
def _primary_context(index):
    """The device's primary context (the one torch's runtime uses),
    retained once. Called with _lock held."""
    ctx = _contexts.get(index)
    if ctx is None:
        torch.cuda.init()
        cu = _lib("cuda")
        dev = ctypes.c_int()
        _cu_check(cu, cu.cuDeviceGet(ctypes.byref(dev), index),
                  "cuDeviceGet")
        ctx = ctypes.c_void_p()
        _cu_check(cu, cu.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), dev),
                  "cuDevicePrimaryCtxRetain")
        _contexts[index] = ctx
    return ctx


class _CurrentContext:
    """Make `ctx` current on this thread for a block, restoring the
    thread's previous context after it."""

    def __init__(self, cu, ctx):
        self._cu, self._ctx, self._prev = cu, ctx, None

    def __enter__(self):
        prev = ctypes.c_void_p()
        _cu_check(self._cu, self._cu.cuCtxGetCurrent(ctypes.byref(prev)),
                  "cuCtxGetCurrent")
        if prev.value != self._ctx.value:
            _cu_check(self._cu, self._cu.cuCtxSetCurrent(self._ctx),
                      "cuCtxSetCurrent")
            self._prev = prev
        return self

    def __exit__(self, *_):
        if self._prev is not None:
            self._cu.cuCtxSetCurrent(self._prev)


def _dims(v, what):
    dims = (v,) if isinstance(v, int) else tuple(int(x) for x in v)
    if not 1 <= len(dims) <= 3 or any(d < 0 for d in dims):
        raise MXNetError(f"{what} must be 1 to 3 non-negative sizes, "
                         f"got {v!r}")
    return dims + (1,) * (3 - len(dims))


def launch_geometry(n, grid=None, block=None):
    """((gx, gy, gz), (bx, by, bz)) of a launch over `n` elements:
    block 256 and grid ceil(n / 256) unless given."""
    block = _dims(DEFAULT_BLOCK if block is None else block, "block")
    threads = block[0] * block[1] * block[2]
    if not 1 <= threads <= _MAX_THREADS:
        raise MXNetError(f"block {block} has {threads} threads; a block "
                         f"takes 1 to {_MAX_THREADS}")
    if grid is None:
        grid = -(-int(n) // threads)
    return _dims(grid, "grid"), block


def _tensor(a):
    return a._data if isinstance(a, NDArray) else a


def _check_tensors(name, tensors):
    """The one CUDA device every tensor lies on; raises on anything the
    launch does not take."""
    for t in tensors:
        if not isinstance(t, torch.Tensor):
            raise MXNetError(f"{name}: arguments must be NDArrays or "
                             f"tensors, got {type(t).__name__}")
        if not t.is_contiguous():
            raise MXNetError(f"{name}: a tensor of shape {tuple(t.shape)} "
                             "is not contiguous")
    devices = {t.device for t in tensors}
    if len(devices) > 1:
        raise MXNetError(f"{name}: tensors on different devices "
                         f"{sorted(str(d) for d in devices)}")
    dev = next(iter(devices)) if devices else None
    if dev is None or dev.type != "cuda":
        raise MXNetError(
            f"{name}: CUDA source runs on the card, and these tensors lie "
            f"on {dev}; move them to a gpu context (there is no CPU mode)")
    return dev


class CudaKernel:
    """User CUDA source, compiled with NVRTC and launched on NDArrays.

    `source` defines `extern "C" __global__ void <fn_name>(ins...,
    outs..., long long n)`.
    """

    def __init__(self, name, source, fn_name):
        if "__global__" not in source or not re.search(
                r"\b" + re.escape(fn_name) + r"\s*\(", source):
            raise MXNetError(f"rtc source of {name!r} defines no "
                             f"__global__ function {fn_name!r}")
        self.name = name
        self.source = source
        self.fn_name = fn_name
        self.launches = 0
        self.compile_ms = None      # of the NVRTC run, if this kernel ran it
        self._digest = None
        self._functions = {}        # device index -> CUfunction

    def compile(self):
        """Compile (or take from the cache) the cubin; returns it."""
        with _lock:
            return self._compile_locked()

    def _compile_locked(self):
        digest, cubin, ms = _cubin(self.name, self.source)
        self._digest = digest
        if ms is not None:
            self.compile_ms = ms
        return cubin

    def _function(self, index):
        """The CUfunction on device `index`. Called with _lock held."""
        fn = self._functions.get(index)
        if fn is not None:
            return fn
        cubin = self._compile_locked() if self._digest is None \
            else _cubins[self._digest]
        cu = _lib("cuda")
        ctx = _primary_context(index)
        with _CurrentContext(cu, ctx):
            mod = _modules.get((index, self._digest))
            if mod is None:
                mod = ctypes.c_void_p()
                _cu_check(cu, cu.cuModuleLoadData(ctypes.byref(mod), cubin),
                          f"cuModuleLoadData({self.name!r})")
                _modules[(index, self._digest)] = mod
            fn = ctypes.c_void_p()
            res = cu.cuModuleGetFunction(ctypes.byref(fn), mod,
                                         self.fn_name.encode())
            if res != 0:
                _cu_check(cu, res, f"cuModuleGetFunction({self.fn_name!r}) "
                          "(is the kernel declared extern \"C\"?)")
        self._functions[index] = fn
        return fn

    def push(self, ins, out_shapes, out_dtypes=None, grid=None, block=None):
        """Launch on a list of NDArrays (or tensors) on one CUDA device;
        returns new NDArrays of `out_shapes`/`out_dtypes` (float32 by
        default) on that device."""
        ins = [_tensor(a) for a in ins]
        dev = _check_tensors(self.name, ins)
        if out_dtypes is None:
            out_dtypes = [torch.float32] * len(out_shapes)
        outs = [torch.empty(tuple(s), dtype=torch_dtype(d), device=dev)
                for s, d in zip(out_shapes, out_dtypes)]
        self._launch(dev, ins, outs, grid, block)
        return [NDArray(o) for o in outs]

    def push_into(self, ins, outs, grid=None, block=None):
        """Launch writing into the given output NDArrays (or tensors)."""
        ins = [_tensor(a) for a in ins]
        out_t = [_tensor(a) for a in outs]
        dev = _check_tensors(self.name, ins + out_t)
        self._launch(dev, ins, out_t, grid, block)
        return outs

    def _launch(self, dev, ins, outs, grid, block):
        n = outs[0].numel() if outs else 0
        (gx, gy, gz), (bx, by, bz) = launch_geometry(n, grid, block)
        if gx * gy * gz == 0:
            return
        index = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        with _lock:
            fn = self._function(index)
            ctx = _contexts[index]
            cu = _libs["cuda"]
        vals = [ctypes.c_void_p(t.data_ptr()) for t in ins + outs]
        vals.append(ctypes.c_int64(n))
        params = (ctypes.c_void_p * len(vals))(
            *[ctypes.addressof(v) for v in vals])
        stream = torch.cuda.current_stream(dev).cuda_stream
        with _CurrentContext(cu, ctx):
            res = cu.cuLaunchKernel(fn, gx, gy, gz, bx, by, bz, 0,
                                    ctypes.c_void_p(stream), params, None)
        _cu_check(cu, res, f"cuLaunchKernel({self.name!r}, grid "
                  f"{(gx, gy, gz)}, block {(bx, by, bz)})")
        self.launches += 1
        with _lock:
            _stats["launches"] += 1


class PallasKernel:
    """The JAX package's Pallas entry point: refused here."""

    def __init__(self, name, kernel_fn=None, **pallas_kwargs):
        raise MXNetError(
            "PallasKernel wraps a Pallas body for the TPU; on the card "
            "write the kernel as CUDA source and wrap it in "
            "mxnet_tpu_torch.rtc.CudaKernel(name, source, fn_name)")


class MXRtc:
    """The reference API's body-only CUDA wrapper (python/mxnet/rtc.py:
    __init__(name, inputs, outputs, kernel)): refused, as in the JAX
    package."""

    def __init__(self, name, inputs, outputs, kernel):
        raise MXNetError(
            "MXRtc (a kernel body wrapped in a generated signature) is not "
            "supported; write the whole extern \"C\" __global__ function "
            "and wrap it in mxnet_tpu_torch.rtc.CudaKernel(name, source, "
            "fn_name)")
