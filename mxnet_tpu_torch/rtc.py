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
`push_into` writes into given outputs (the C API's MXTpuRtcPush). A
kernel built with `items_per_thread=k` declares that it loops over n with
a grid stride and moves k elements a thread in each pass; its default
grid is ceil(n / (256 * k)).

At the first push the source is compiled with NVRTC for Hopper
(`--gpu-architecture=sm_90a`) to a cubin, not PTX: a PTX from an NVRTC
newer than the driver would not load, and `sm_90a` code needs a cubin.
The cubin and NVRTC's log (`--ptxas-options=-v`: each entry point's
registers, shared memory and spills; `CudaKernel.build_log`) are cached
in memory and under `_build/rtc/<digest>.cubin` / `.log` (the digest
covers the source, the options and the NVRTC version), so each source
compiles once. It is loaded with the CUDA driver API, one module per
(device, digest). The bindings to `libnvrtc` and `libcuda.so.1` are
ctypes, loaded at first use.

The host path of a push is short. Everything that does not change from
call to call is looked up once per (kernel, device) and kept in a
`_Target`: the CUfunction, the device's primary context (torch's), the
driver library, torch's stream accessor (`_cuda_getCurrentRawStream`,
no Stream object a call) and the outputs' Context. The arguments go into a per-thread parameter block of 8-byte
values, one for each arity, reused launch after launch (cuLaunchKernel
copies them at the call). A thread that holds the device's primary
context (checked at its first push, kept in a thread-local) launches
with no context calls; one that holds none takes the primary context
and keeps it, as torch's runtime would; one that holds another context
gets the primary one for the launch and its own back after it. A launch
refused for its context clears the thread's mark and is retried once
through the check. The lock is taken to build a target and to count
the launch, nowhere else.

There is no fallback: CPU tensors, non-contiguous tensors, tensors on
two devices, a source without `fn_name` (checked before compiling, as
the C API's rtc_create checks) and a failed compile (with NVRTC's log)
raise MXNetError. A push with no elements (and no `grid`) launches
nothing.

`stats()` counts launches, NVRTC compiles and cubin cache hits over the
process; each kernel also counts its own `launches`.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import struct
import threading
import time

import torch

from .base import MXNetError
from .context import gpu
from .ndarray import NDArray
from .ops.shape_infer import torch_dtype

_HERE = os.path.dirname(os.path.abspath(__file__))
CUBIN_DIR = os.path.join(_HERE, "_build", "rtc")
NVRTC_OPTIONS = ("--gpu-architecture=sm_90a", "-std=c++17",
                 "--ptxas-options=-v")
DEFAULT_BLOCK = 256
_MAX_THREADS = 1024
# CUDA_ERROR_INVALID_CONTEXT, _INVALID_HANDLE, _CONTEXT_IS_DESTROYED: a
# launch under a context other than the function's
_CONTEXT_ERRORS = (201, 400, 709)

_lock = threading.Lock()
_tls = threading.local()    # .ctx: the device index whose primary context
                            # this thread holds; .blocks: parameter blocks
_libs = {}          # "nvrtc" / "cuda" -> ctypes.CDLL
_cubins = {}        # digest -> cubin bytes
_logs = {}          # digest -> NVRTC's log of the compile
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
    """(cubin, log) of `source`; raises MXNetError with NVRTC's log when
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
        size = ctypes.c_size_t()
        lib.nvrtcGetProgramLogSize(prog, ctypes.byref(size))
        buf = ctypes.create_string_buffer(size.value)
        lib.nvrtcGetProgramLog(prog, buf)
        log = buf.value.decode(errors="replace")
        if res != 0:
            raise MXNetError(
                f"NVRTC failed to compile {name!r} "
                f"({lib.nvrtcGetErrorString(res).decode()}):\n{log}")
        _nvrtc_check(lib, lib.nvrtcGetCUBINSize(prog, ctypes.byref(size)),
                     "nvrtcGetCUBINSize")
        buf = ctypes.create_string_buffer(size.value)
        _nvrtc_check(lib, lib.nvrtcGetCUBIN(prog, buf), "nvrtcGetCUBIN")
        return buf.raw, log
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
        if os.path.exists(path[:-5] + "log"):
            with open(path[:-5] + "log") as f:
                _logs[digest] = f.read()
    if cubin is not None:
        _cubins[digest] = cubin
        _stats["cache_hits"] += 1
        return digest, cubin, None
    t0 = time.perf_counter()
    cubin, log = _nvrtc_compile(name, source)
    ms = (time.perf_counter() - t0) * 1e3
    _stats["compiles"] += 1
    _cubins[digest], _logs[digest] = cubin, log
    os.makedirs(CUBIN_DIR, exist_ok=True)
    for data, dst in ((log.encode(), path[:-5] + "log"), (cubin, path)):
        tmp = f"{dst}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, dst)
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


_DEFAULT_BLOCK = (DEFAULT_BLOCK, 1, 1)


def launch_geometry(n, grid=None, block=None, items_per_thread=1):
    """((gx, gy, gz), (bx, by, bz)) of a launch over `n` elements:
    block 256 and grid ceil(n / (256 * items_per_thread)) unless
    given."""
    if block is None:
        block, threads = _DEFAULT_BLOCK, DEFAULT_BLOCK
    elif type(block) is int and 1 <= block <= _MAX_THREADS:
        block, threads = (block, 1, 1), block
    else:
        block = _dims(block, "block")
        threads = block[0] * block[1] * block[2]
        if not 1 <= threads <= _MAX_THREADS:
            raise MXNetError(f"block {block} has {threads} threads; a "
                             f"block takes 1 to {_MAX_THREADS}")
    if grid is None:
        return (-(-int(n) // (threads * items_per_thread)), 1, 1), block
    if type(grid) is int and grid >= 0:
        return (grid, 1, 1), block
    return _dims(grid, "grid"), block


def _check_tensors(name, tensors):
    """The one CUDA device every tensor lies on; raises on anything the
    launch does not take."""
    dev = None
    for t in tensors:
        if not isinstance(t, torch.Tensor):
            raise MXNetError(f"{name}: arguments must be NDArrays or "
                             f"tensors, got {type(t).__name__}")
        if not t.is_contiguous():
            raise MXNetError(f"{name}: a tensor of shape {tuple(t.shape)} "
                             "is not contiguous")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise MXNetError(f"{name}: tensors on different devices "
                             f"{sorted({str(u.device) for u in tensors})}")
    if dev is None or dev.type != "cuda":
        raise MXNetError(
            f"{name}: CUDA source runs on the card, and these tensors lie "
            f"on {dev}; move them to a gpu context (there is no CPU mode)")
    return dev


def _param_block(count):
    """This thread's parameter block for `count` kernel arguments: an
    array of 8-byte values, the array of their addresses that
    cuLaunchKernel reads (it copies the values at the call, so the block
    is reused by the thread's next launch of the same arity), and the
    `pack_into` that writes the values in one call."""
    blocks = getattr(_tls, "blocks", None)
    if blocks is None:
        blocks = _tls.blocks = {}
    block = blocks.get(count)
    if block is None:
        vals = (ctypes.c_uint64 * count)()
        base = ctypes.addressof(vals)
        block = blocks[count] = (vals, (ctypes.c_void_p * count)(
            *range(base, base + 8 * count, 8)),
            struct.Struct(f"={count}Q").pack_into)
    return block


class _Target:
    """What a push of one kernel on one device needs, looked up once:
    the CUfunction, the device's primary context, the driver library,
    torch's stream accessor and the Context of the outputs."""

    __slots__ = ("index", "fn", "ctx", "cu", "stream", "context")

    def __init__(self, index, fn, ctx, cu, stream, context):
        self.index, self.fn, self.ctx, self.cu = index, fn, ctx, cu
        self.stream, self.context = stream, context


def _stream_accessor():
    """index -> the raw handle of torch's current stream on that device:
    torch._C._cuda_getCurrentRawStream where torch has it (no Stream
    object a call), else torch.cuda.current_stream(index).cuda_stream."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw
    return lambda index: torch.cuda.current_stream(index).cuda_stream


def _hold_context(target):
    """Make the target's primary context current on this thread for a
    launch. Returns the context to restore after it, or None: a thread
    that already holds it, or holds none (then it keeps the primary
    context, as torch's runtime would), is marked in `_tls.ctx` and
    takes no switch again."""
    cu = target.cu
    prev = ctypes.c_void_p()
    _cu_check(cu, cu.cuCtxGetCurrent(ctypes.byref(prev)), "cuCtxGetCurrent")
    if prev.value == target.ctx.value:
        _tls.ctx = target.index
        return None
    _cu_check(cu, cu.cuCtxSetCurrent(target.ctx), "cuCtxSetCurrent")
    if not prev.value:
        _tls.ctx = target.index
        return None
    _tls.ctx = None
    return prev


class CudaKernel:
    """User CUDA source, compiled with NVRTC and launched on NDArrays.

    `source` defines `extern "C" __global__ void <fn_name>(ins...,
    outs..., long long n)`. `items_per_thread`, for a kernel that loops
    over n with a grid stride (any grid covers n) and moves that many
    elements a thread in each pass, divides the default grid by it.
    """

    def __init__(self, name, source, fn_name, items_per_thread=1):
        if "__global__" not in source or not re.search(
                r"\b" + re.escape(fn_name) + r"\s*\(", source):
            raise MXNetError(f"rtc source of {name!r} defines no "
                             f"__global__ function {fn_name!r}")
        self.name = name
        self.source = source
        self.fn_name = fn_name
        self.items_per_thread = items_per_thread
        self.launches = 0
        self.compile_ms = None      # of the NVRTC run, if this kernel ran it
        self._digest = None
        self._targets = {}          # device index -> _Target

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

    @property
    def build_log(self):
        """NVRTC's log of this source's compile (ptxas's registers,
        shared memory and spills of each entry point), or None before
        the first compile."""
        return _logs.get(self._digest)

    def _target(self, index):
        """The launch target on device `index`: compiles (or finds the
        cubin), loads the module and looks up the function at the first
        push there."""
        with _lock:
            target = self._targets.get(index)
            if target is not None:
                return target
            cubin = self._compile_locked() if self._digest is None \
                else _cubins[self._digest]
            cu = _lib("cuda")
            ctx = _primary_context(index)
            with _CurrentContext(cu, ctx):
                mod = _modules.get((index, self._digest))
                if mod is None:
                    mod = ctypes.c_void_p()
                    _cu_check(cu, cu.cuModuleLoadData(ctypes.byref(mod),
                                                      cubin),
                              f"cuModuleLoadData({self.name!r})")
                    _modules[(index, self._digest)] = mod
                fn = ctypes.c_void_p()
                res = cu.cuModuleGetFunction(ctypes.byref(fn), mod,
                                             self.fn_name.encode())
                if res != 0:
                    _cu_check(cu, res, f"cuModuleGetFunction("
                              f"{self.fn_name!r}) (is the kernel declared "
                              "extern \"C\"?)")
            target = self._targets[index] = _Target(
                index, fn, ctx, cu, _stream_accessor(), gpu(index))
            return target

    def push(self, ins, out_shapes, out_dtypes=None, grid=None, block=None):
        """Launch on a list of NDArrays (or tensors) on one CUDA device;
        returns new NDArrays of `out_shapes`/`out_dtypes` (float32 by
        default) on that device."""
        ins = [a._data if isinstance(a, NDArray) else a for a in ins]
        dev = _check_tensors(self.name, ins)
        if out_dtypes is None:
            outs = [torch.empty(s, dtype=torch.float32, device=dev)
                    for s in out_shapes]
        else:
            outs = [torch.empty(tuple(s), dtype=torch_dtype(d), device=dev)
                    for s, d in zip(out_shapes, out_dtypes)]
        target = self._launch(dev, ins, outs, grid, block)
        ctx = target.context if target is not None else None
        return [NDArray(o, ctx) for o in outs]

    def push_into(self, ins, outs, grid=None, block=None):
        """Launch writing into the given output NDArrays (or tensors)."""
        ins = [a._data if isinstance(a, NDArray) else a for a in ins]
        out_t = [a._data if isinstance(a, NDArray) else a for a in outs]
        dev = _check_tensors(self.name, ins + out_t)
        self._launch(dev, ins, out_t, grid, block)
        return outs

    def _launch(self, dev, ins, outs, grid, block):
        """Launch on `dev`; returns its _Target, or None when there was
        nothing to run."""
        n = outs[0].numel() if outs else 0
        if grid is None and n == 0:
            return None
        index = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        target = self._targets.get(index) or self._target(index)
        g, b = launch_geometry(n, grid, block, self.items_per_thread)
        if g[0] * g[1] * g[2] == 0:
            return target
        vals, params, pack = _param_block(len(ins) + len(outs) + 1)
        pack(vals, 0, *[t.data_ptr() for t in ins],
             *[t.data_ptr() for t in outs], n)
        stream = target.stream(index)
        res = None
        if getattr(_tls, "ctx", None) == index:
            res = self._call(target, g, b, stream, params)
            if res in _CONTEXT_ERRORS:      # the thread's context moved
                _tls.ctx, res = None, None
        if res is None:
            prev = _hold_context(target)
            try:
                res = self._call(target, g, b, stream, params)
            finally:
                if prev is not None:
                    target.cu.cuCtxSetCurrent(prev)
        if res != 0:
            _cu_check(target.cu, res, f"cuLaunchKernel({self.name!r}, grid "
                      f"{g}, block {b})")
        with _lock:
            self.launches += 1
            _stats["launches"] += 1
        return target

    @staticmethod
    def _call(target, g, b, stream, params):
        """The driver's launch; returns its CUresult."""
        return target.cu.cuLaunchKernel(target.fn, g[0], g[1], g[2], b[0],
                                        b[1], b[2], 0, stream, params, None)


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
