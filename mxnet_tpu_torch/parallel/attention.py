"""Attention on (B, T, H, D) tensors: the plain reference and the
blockwise (flash) forward, as mxnet_tpu/parallel/attention.py.

`attention(q, k, v, causal, scale, impl)` is the entry point:

  impl="xla"    `attention_reference`: einsum, mask, softmax, einsum, in
                stock torch. Its causal mask is aligned bottom-right
                (`tril(..., k=Tk - Tq)`) with -1e30, so a row that sees
                no key gets uniform weights.
  impl="flash"  the flash forward, with a backward that recomputes
                `attention_reference` under autograd (the JAX package's
                `_flash_bwd_rule`; it has no backward kernel). The device
                of the tensors picks the forward, and nothing else does:

    CUDA tensor  `flash_forward`, the hand-written kernel
                 csrc/flash_attention.cu; a tensor it does not take
                 raises, there is no fallback.
    CPU tensor   `flash_forward_plain`.

The flash forward aligns its causal mask top-left (`q_pos >= k_pos`), as
the TPU kernel does, while the reference and the flash backward align it
bottom-right. With Tq == Tk the two are the same; with Tq != Tk the
flash forward and the reference differ, in the JAX package and in the
port alike.

`block_q` and `block_k` decide the reference's divisibility check (Tq
and Tk must divide by min(block, T)), so the same inputs are taken and
refused. `block_k` is also the key block over which p is rounded against
the running max, as in the TPU kernel: the plain version's blocks on the
CPU, and on the card the kernel's key tile where it is 64 or 128 (or
covers all of Tk <= 128); any other `block_k` runs the kernel in 64-key
tiles, and its bf16/f16 rounding of p then follows 64-key blocks
(`kernel_block_k`, the one place that maps a block onto a tile). Every
entry point defaults to 128, the TPU kernel's block. The kernel's query
tiles are its own (64 or 128 rows).

`flash_forward.launches` counts the kernel's launches, so a run can show
that its path went through the kernel.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..base import MXNetError

NEG_INF = -1e30

# the kernel's head_dim instances go up to 256 (csrc/flash_attention.cu)
MAX_HEAD_DIM = 256
# the kernel's library for each dtype (csrc/flash_attention.cu, built once
# a dtype)
KERNEL_LIBRARIES = {torch.float32: "flash_attention_f32",
                    torch.bfloat16: "flash_attention_bf16",
                    torch.float16: "flash_attention_f16"}
_TILE_Q = 64          # the kernel's smallest query tile: the grid check
_MAX_GRID_Y = 65535
# the kernel's key tiles (csrc/flash_attention.cu)
_KERNEL_TILES = (64, 128)


def _default_scale(q, scale):
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale


def attention_reference(q, k, v, causal=False, scale=None):
    """(B, T, H, D) attention through stock torch ops; bottom-right
    causal mask with -1e30."""
    tq, tk = q.shape[1], k.shape[1]
    scale = _default_scale(q, scale)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        mask = torch.ones((tq, tk), dtype=torch.bool,
                          device=q.device).tril(tk - tq)
        s = torch.where(mask[None, None], s,
                        torch.full((), NEG_INF, dtype=s.dtype,
                                   device=s.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def flash_forward_plain(q, k, v, causal=False, scale=None, block_k=128):
    """Plain PyTorch version of the flash forward, with its arithmetic:
    float32 scores, the top-left causal mask with -1e30, and the online
    softmax over blocks of `block_k` keys written out. p is exp(s - m) at
    the running max m of the blocks so far, rounded to v's dtype before
    the PV product (the TPU kernel's p.astype(v.dtype)), then carried to
    the final max by exp(m - m_final) in float32, as the kernel's
    correction factors carry it; l sums the unrounded p; the output is
    divided by l and cast to q's dtype. `attention` passes its block_k,
    the TPU kernel's; the CUDA kernel's key tile follows it
    (`kernel_block_k`). In float32 the blocks change nothing but
    rounding.
    Holds the (B, H, Tq, Tk) scores: O(T^2) memory. Runs on any device;
    the package takes it only for CPU tensors."""
    tq, tk = q.shape[1], k.shape[1]
    scale = _default_scale(q, scale)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                     k.to(torch.float32))
    s.mul_(scale)
    if causal:
        keep = torch.ones((tq, tk), dtype=torch.bool,
                          device=q.device).tril()
        s.masked_fill_(~keep, NEG_INF)
    blocks = s.split(block_k, dim=-1)           # views of s
    m_run = torch.stack([c.amax(dim=-1) for c in blocks], -1).cummax(-1)[0]
    for i, c in enumerate(blocks):              # s becomes p, in place
        c.sub_(m_run[..., i:i + 1]).exp_()
    corr = torch.exp(m_run - m_run[..., -1:])   # (B, H, Tq, blocks)
    denom = (torch.stack([c.sum(dim=-1) for c in blocks], -1)
             * corr).sum(dim=-1)
    if v.dtype != torch.float32:
        s.copy_(s.to(v.dtype))
    for i, c in enumerate(blocks):
        c.mul_(corr[..., i:i + 1])
    out = torch.einsum("bhqk,bkhd->bqhd", s, v.to(torch.float32))
    out.div_(denom.transpose(1, 2)[..., None])
    return out.to(q.dtype)


# ------------------------------------------------------------------ cuda
_libs = {}


def _kernel_lib(dtype):
    """The ctypes handle of the kernel's library for `dtype`, built on
    first use."""
    lib = _libs.get(dtype)
    if lib is None:
        from .. import kernels

        lib = kernels.load(KERNEL_LIBRARIES[dtype])
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_forward.argtypes = (
            [ptr] * 5 + [i32] * 5 + [ctypes.c_float, i32, i32, ptr])
        lib.flash_attention_forward.restype = i32
        lib.flash_attention_instance.argtypes = [i32, i32, ptr]
        lib.flash_attention_instance.restype = i32
        lib.flash_attention_whole_chunks.argtypes = [ptr] * 5 + [i32]
        lib.flash_attention_whole_chunks.restype = i32
        _libs[dtype] = lib
    return lib


def _check_cuda(q, k, v):
    dev = q.device
    if dev.type != "cuda":
        raise MXNetError(
            f"the CUDA flash attention kernel takes CUDA tensors, got {dev}")
    for name, t in (("k", k), ("v", v)):
        if t.device != dev:
            raise MXNetError(f"flash attention: {name} is on {t.device}, "
                             f"q on {dev}")
        if t.dtype != q.dtype:
            raise MXNetError(f"flash attention: {name} is {t.dtype}, q is "
                             f"{q.dtype}")
    if q.dtype not in KERNEL_LIBRARIES:
        raise MXNetError(
            f"flash attention kernel takes float32, bfloat16 or float16, "
            f"got {q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or tuple(k.shape) != tuple(v.shape):
        raise MXNetError(
            f"flash attention: q (B, Tq, H, D) and k, v (B, Tk, H, D) "
            f"expected, got {tuple(q.shape)}, {tuple(k.shape)}, "
            f"{tuple(v.shape)}")
    b, tq, h, d = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, h, d):
        raise MXNetError(
            f"flash attention: k/v {tuple(k.shape)} do not match q "
            f"{tuple(q.shape)} in batch, heads or head_dim")
    if d > MAX_HEAD_DIM:
        raise MXNetError(
            f"flash attention kernel takes head_dim <= {MAX_HEAD_DIM}, got "
            f"{d}")
    if -(-tq // _TILE_Q) > _MAX_GRID_Y or b * h >= 2 ** 31:
        raise MXNetError(
            f"flash attention kernel: shape {tuple(q.shape)} exceeds its "
            "launch grid")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.numel() and t.stride(-1) != 1:
            raise MXNetError(f"flash attention: {name}'s head_dim axis is "
                             "not contiguous")


def kernel_block_k(block_k, tk):
    """The kernel's key tile for a key block of `block_k` over Tk keys:
    `block_k` where it is 64 or 128; the smallest tile that holds all
    of Tk where `block_k` does (one block either way); else 64. The
    plain version at `block_k` rounds p over the same blocks as the
    kernel at this tile (float32 at D > 128 takes 64-key tiles whatever
    this says, and rounds nothing: `kernel_instance`)."""
    if block_k in _KERNEL_TILES:
        return block_k
    if block_k >= tk:
        for tile in _KERNEL_TILES:
            if tile >= tk:
                return tile
    return _KERNEL_TILES[0]


def kernel_instance(dtype, head_dim, tile_k=128):
    """The kernel instance a call at key tile `tile_k` (64 or 128,
    `kernel_block_k`) takes, as its library reports it: {"d": padded
    head_dim, "tile_k", "stages", "smem_bytes", "warps"}. Loads (and, the
    first time, builds) the library."""
    out = (ctypes.c_int * 5)()
    err = _kernel_lib(dtype).flash_attention_instance(head_dim, tile_k, out)
    if err != 0:
        raise MXNetError(f"flash attention: no instance for {dtype}, "
                         f"head_dim {head_dim}, tile_k {tile_k}")
    return dict(zip(("d", "tile_k", "stages", "smem_bytes", "warps"), out))


def _strides(*tensors):
    return (ctypes.c_int64 * 12)(*[s for t in tensors for s in t.stride()[:3]])


def kernel_staging(q, k, v, out):
    """How the kernel stages these CUDA tensors, as its library decides:
    "cp.async" (whole 16-byte chunks: head_dim, every stride and every
    base address a multiple of 16 bytes) or "element" (element by
    element into the zero-padded tile)."""
    whole = _kernel_lib(q.dtype).flash_attention_whole_chunks(
        *[ctypes.c_void_p(t.data_ptr()) for t in (q, k, v, out)],
        _strides(q, k, v, out), q.shape[-1])
    return "cp.async" if whole else "element"


def flash_forward(q, k, v, causal=False, scale=None, block_k=128):
    """Launch the flash forward kernel on CUDA tensors in the (B, T, H, D)
    layout (read through their strides; the head_dim axis contiguous),
    in key tiles of `kernel_block_k(block_k, Tk)`."""
    _check_cuda(q, k, v)
    b, tq, h, d = q.shape
    tk = k.shape[1]
    scale = _default_scale(q, scale)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if out.numel() == 0:
        return out
    if tk == 0:
        raise MXNetError("flash attention: no keys (Tk == 0)")
    strides = _strides(q, k, v, out)
    fn = _kernel_lib(q.dtype).flash_attention_forward
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k.data_ptr()),
                 ctypes.c_void_p(v.data_ptr()),
                 ctypes.c_void_p(out.data_ptr()), strides, b, h, tq, tk, d,
                 float(scale), int(bool(causal)), kernel_block_k(block_k, tk),
                 ctypes.c_void_p(stream))
    if err != 0:
        raise MXNetError(f"flash_attention_forward launch failed: CUDA "
                         f"error {err}")
    flash_forward.launches += 1
    return out


flash_forward.launches = 0


def reset_launch_counts():
    flash_forward.launches = 0


def launch_counts():
    return {"flash_attention": flash_forward.launches}


# ----------------------------------------------------------- entry points
def _flash_forward(q, k, v, causal, scale, block_k):
    """The CUDA kernel for CUDA tensors, the plain version for CPU
    tensors, both over key blocks of `block_k` (the TPU kernel's)."""
    if q.device.type == "cpu":
        return flash_forward_plain(q, k, v, causal, scale, block_k)
    if q.device.type != "cuda":
        raise MXNetError(f"flash attention has no kernel for {q.device}")
    return flash_forward(q, k, v, causal, scale, block_k)


class _FlashAttention(torch.autograd.Function):
    """Flash forward; the backward recomputes `attention_reference`
    (bottom-right mask) under autograd and differentiates it, as the
    JAX package's `_flash_bwd_rule` does. Only q, k and v are saved."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, block_k):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.scale = causal, scale
        return _flash_forward(q, k, v, causal, scale, block_k)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = attention_reference(*leaves, causal=ctx.causal,
                                      scale=ctx.scale)
            grads = torch.autograd.grad(out, leaves, g)
        return (*grads, None, None, None)


def attention(q, k, v, causal=False, scale=None, impl="xla", block_q=128,
              block_k=128):
    """Multi-head attention on (B, T, H, D) tensors (module docstring)."""
    scale = _default_scale(q, scale)
    if impl == "xla":
        return attention_reference(q, k, v, causal=causal, scale=scale)
    if impl == "flash":
        tq, tk = q.shape[1], k.shape[1]
        block_q, block_k = min(block_q, tq), min(block_k, tk)
        # the reference's assertion, type and message (kept under -O)
        if tq % block_q or tk % block_k:
            raise AssertionError(
                "flash attention: sequence lengths must divide block sizes")
        return _FlashAttention.apply(q, k, v, bool(causal), float(scale),
                                     block_k)
    raise ValueError(f"unknown attention impl {impl!r}")
