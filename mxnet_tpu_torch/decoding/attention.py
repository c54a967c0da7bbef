"""Page-table attention: one decode step's attention over the paged KV
pool (the device half of Ragged Paged Attention).

Contract:

  q           (B, H, D)        float32, one query token per batch row
  k_pages     (N, P, H, D)     one layer's K pages — a bare float
                               tensor or a quant.KVPool, whose int8
                               pages dequantize inside the kernel
  v_pages     (N, P, H, D)     one layer's V pages
  page_table  (B, Bp) int32    per-row page ids, seq-ordered; padding
                               entries point at the scratch page 0
  lengths     (B,) int32       valid context tokens per row
  -> out      (B, H, D)        float32

`paged_attention` is the entry point. The device of the tensors picks
the implementation, and nothing else does:

  CUDA tensor  the hand-written kernel csrc/paged_attention.cu: split-K
               over fixed chunks of CHUNK_PAGES table entries, one
               block per (row, head group, chunk) staging its pages by
               cp.async, then a merge of each row's chunks in order;
               int8 pages go through its int8 entry point with the two
               scale planes. A tensor the kernel does not take raises;
               there is no fallback.
  CPU tensor   `paged_attention_plain`: gather the Bp pages of every
               row into a (B, Bp*P, H, D) context (dequantizing int8
               pages) and run a masked softmax over it.

A row's result depends only on its own q, pages and length, not on Bp
or on the other rows of the batch (the length-0 row, uniform over all
Bp*P positions, excepted): the chunks are fixed and merged in order.
`paged_attention_chunked_plain` is the kernel's algorithm in plain
PyTorch, for the tests.

`ragged_paged_attention` serves the merged prefill+decode step: a
decode row passes its full context length, a tail-prefill row passes
`position + 1` of the prompt token it processes, and per-row length
masking does the rest, so both kinds of rows share one kernel.

`paged_attention_multi` is the multi-query path of the split-grid tail
prefill and of the speculative verify step: S queries a row, each masked
by its own absolute position. The JAX package computes it with lax ops
and no Pallas body (both of its kernel names resolve to that one
function), so here it is plain PyTorch on every device, not a kernel's
plain version; `get_multi_kernel` returns it.

Each CUDA entry point counts its calls in a plain integer attribute
(`paged_attention_float_cuda.launches`,
`paged_attention_int8_cuda.launches`): one per attention call, whether
it took one CUDA launch (Bp <= CHUNK_PAGES) or two (split and merge), so
a run can show that its main path went through the kernel. A call made
while its stream is capturing a CUDA graph launches nothing then: it is
noted in the capture's record (`recording_launches`), and the graph's
owner credits that record at each replay (`credit_launches`), when the
kernel does launch.
"""
from __future__ import annotations

import contextlib
import ctypes
import math

import torch

from ..base import MXNetError
from . import quant as _quant

NEG_INF = -1e30

# table entries of one split of the kernel (kChunkPages in
# csrc/paged_attention.cu): fixed, so no result depends on Bp
CHUNK_PAGES = 8
# what the kernel takes: lane t scores slots t and t + 32 and sums dims
# t + 32 i (i < 4); the chunk index is the grid's z (at most 65535)
_MAX_HEAD_DIM = 128
_MAX_PAGE_SIZE = 64
MAX_TABLE_PAGES = 65535 * CHUNK_PAGES


def _check_shapes(q, k_pages, v_pages, page_table, lengths):
    b, h, d = q.shape
    n, p, hh, dd = k_pages.shape
    if tuple(k_pages.shape) != tuple(v_pages.shape):
        raise ValueError("k_pages/v_pages shape mismatch")
    if (hh, dd) != (h, d):
        raise ValueError(
            f"pool heads/dim {(hh, dd)} != query {(h, d)}")
    if page_table.shape[0] != b or tuple(lengths.shape) != (b,):
        raise ValueError("page_table/lengths batch mismatch")
    return b, h, d, n, p, page_table.shape[1]


def _check_scale(scale, d):
    if scale is not None and not math.isclose(scale, 1.0 / math.sqrt(d)):
        raise ValueError("paged attention fixes scale=1/sqrt(head_dim)")


def paged_attention_plain(q, k_pages, v_pages, page_table, lengths,
                          scale=None):
    """Plain PyTorch version: gather-based masked softmax (see module
    docstring). Runs on any device; the package takes it only for CPU
    tensors."""
    k_pages = _quant.as_pool(k_pages)
    v_pages = _quant.as_pool(v_pages)
    b, h, d, _, p, bp = _check_shapes(
        q, k_pages, v_pages, page_table, lengths)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    t = bp * p
    # (B, Bp, P, H, D) -> (B, T, H, D): pages are seq-ordered, so the
    # flattened axis is the token axis (positions >= length masked)
    k_ctx = _quant.gather_ctx(k_pages, page_table).reshape(b, t, h, d)
    v_ctx = _quant.gather_ctx(v_pages, page_table).reshape(b, t, h, d)
    s = torch.einsum("bhd,bthd->bht", q.to(torch.float32), k_ctx) * scale
    mask = (torch.arange(t, device=q.device)[None, :]
            < lengths.to(q.device)[:, None])
    s = torch.where(mask[:, None, :], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    w = e / e.sum(dim=-1, keepdim=True)
    out = torch.einsum("bht,bthd->bhd", w, v_ctx)
    return out.to(q.dtype)


def paged_attention_multi(q, k_pages, v_pages, page_table, q_positions,
                          scale=None):
    """Multi-query variant: S queries per row over the same paged
    context, each masked by its OWN absolute position.

      q            (B, S, H, D)   queries (tail prefill / verify)
      q_positions  (B, S) int     absolute position of each query;
                                  query j attends context positions
                                  <= q_positions[b, j]

    Gathers the table's pages into a (B, Bp*P, H, D) context
    (dequantizing int8 pages), applies the per-query causal mask and
    takes a float32 softmax. Shapes are a function of (B, S, pages
    bucket) only."""
    k_pages = _quant.as_pool(k_pages)
    v_pages = _quant.as_pool(v_pages)
    b, s, h, d = q.shape
    _, p, hh, dd = k_pages.shape
    if (hh, dd) != (h, d):
        raise ValueError(
            f"pool heads/dim {(hh, dd)} != query {(h, d)}")
    if page_table.shape[0] != b or tuple(q_positions.shape) != (b, s):
        raise ValueError("page_table/q_positions batch mismatch")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    t = page_table.shape[1] * p
    k_ctx = _quant.gather_ctx(k_pages, page_table).reshape(b, t, h, d)
    v_ctx = _quant.gather_ctx(v_pages, page_table).reshape(b, t, h, d)
    sc = torch.einsum("bshd,bthd->bhst", q.to(torch.float32), k_ctx) * scale
    mask = (torch.arange(t, device=q.device)[None, None, :]
            <= q_positions[:, :, None])             # (B, S, T)
    sc = torch.where(mask[:, None], sc, torch.full_like(sc, NEG_INF))
    m = sc.amax(dim=-1, keepdim=True)
    e = torch.exp(sc - m)
    w = e / e.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhst,bthd->bshd", w, v_ctx)
    return out.to(q.dtype)


def get_multi_kernel(name=None):
    """The multi-query implementation (`paged_attention_multi`). The
    JAX package resolves MXNET_DECODE_KERNEL here; both of its choices
    name one lax function, and so does every name here."""
    if name not in (None, "lax", "pallas"):
        raise ValueError(f"unknown decode kernel {name!r} "
                         "(choices: ['lax', 'pallas'])")
    return paged_attention_multi


def paged_attention_chunked_plain(q, k_pages, v_pages, page_table, lengths,
                                  scale=None, chunk_pages=CHUNK_PAGES):
    """The kernel's algorithm in plain PyTorch, for the tests: for each
    row, the online-softmax partial (m, l, acc) of every chunk of
    `chunk_pages` table entries up to the row's last page (ceil(len/P),
    or Bp for a row of length 0; later chunks are skipped), then the
    chunks merged in ascending order: M = max m_c, w_c = exp(m_c - M),
    out = sum(acc_c w_c) / sum(l_c w_c). Rows are computed one at a
    time, so a row's output depends only on its own inputs."""
    k_pages = _quant.as_pool(k_pages)
    v_pages = _quant.as_pool(v_pages)
    b, h, d, _, p, bp = _check_shapes(
        q, k_pages, v_pages, page_table, lengths)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    out = torch.empty((b, h, d), dtype=torch.float32, device=q.device)
    lens = [int(x) for x in lengths.tolist()]
    for row in range(b):
        n = min(-(-lens[row] // p), bp) if lens[row] > 0 else bp
        parts = []
        for first in range(0, n, chunk_pages):
            ids = page_table[row, first:min(first + chunk_pages, n)]
            t = ids.shape[0] * p
            k = _quant.gather_ctx(k_pages, ids).reshape(t, h, d)
            v = _quant.gather_ctx(v_pages, ids).reshape(t, h, d)
            s = torch.einsum("hd,thd->ht", q[row].to(torch.float32),
                             k) * scale
            pos = first * p + torch.arange(t, device=q.device)
            s = torch.where(pos[None, :] < lens[row], s,
                            torch.full_like(s, NEG_INF))
            m = s.amax(dim=-1)
            e = torch.exp(s - m[:, None])
            parts.append((m, e.sum(dim=-1),
                          torch.einsum("ht,thd->hd", e, v)))
        big_m = parts[0][0]
        for m, _, _ in parts[1:]:
            big_m = torch.maximum(big_m, m)
        w = torch.exp(parts[0][0] - big_m)
        o, den = parts[0][2] * w[:, None], parts[0][1] * w
        for m, l_c, acc in parts[1:]:
            w = torch.exp(m - big_m)
            o = o + acc * w[:, None]
            den = den + l_c * w
        out[row] = o / den[:, None]
    return out.to(q.dtype)


# ------------------------------------------------------------------ cuda
_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        from .. import kernels

        _lib = bind_library(kernels.load("paged_attention"))
    return _lib


def bind_library(lib):
    """Declare the C interface of a built csrc/paged_attention.cu on its
    ctypes handle (tools/bench_kernels.py paged binds other builds of
    the source the same way) and check its chunk size."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    failed = ctypes.POINTER(ctypes.c_int)
    lib.paged_attention_float.argtypes = (
        [ptr] * 7 + [i32] * 6 + [ptr, failed])
    lib.paged_attention_float.restype = i32
    lib.paged_attention_int8.argtypes = (
        [ptr] * 9 + [i32] * 5 + [ptr, failed])
    lib.paged_attention_int8.restype = i32
    lib.paged_attention_instance.argtypes = (
        [i32] * 4 + [ctypes.POINTER(ctypes.c_int)])
    lib.paged_attention_instance.restype = i32
    lib.paged_attention_error_string.argtypes = [i32]
    lib.paged_attention_error_string.restype = ctypes.c_char_p
    chunk = lib.paged_attention_chunk_pages()
    if chunk != CHUNK_PAGES:
        raise MXNetError(
            f"paged attention library splits {chunk} pages, the "
            f"wrapper {CHUNK_PAGES}: rebuild it")
    return lib


_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def kernel_instance(page_dtype, heads, head_dim, page_size):
    """The kernel instance a call with these pages takes: whether it is
    the serving instance (P = 16, D = 64, heads a multiple of 4) or the
    generic one, the heads a block, the stages of its cp.async ring, its
    dynamic shared memory and the bytes of one copy."""
    out = (ctypes.c_int * 5)()
    err = _kernel_lib().paged_attention_instance(
        _KINDS[page_dtype], heads, head_dim, page_size, out)
    if err != 0:
        raise MXNetError(
            f"paged attention kernel takes no {page_dtype} pages of "
            f"{(page_size, heads, head_dim)}")
    return {"serving": bool(out[0]), "heads_per_block": out[1],
            "stages": out[2], "smem_bytes": out[3], "copy_bytes": out[4]}


def _check_cuda(q, k_pages, v_pages, page_table, lengths, quantized):
    dev = q.device
    if dev.type != "cuda":
        raise MXNetError(
            f"the CUDA paged attention kernel takes CUDA tensors, got {dev}")
    tensors = [("q", q), ("k_pages", k_pages.data),
               ("v_pages", v_pages.data), ("page_table", page_table),
               ("lengths", lengths)]
    if quantized:
        tensors += [("k_scale", k_pages.scale), ("v_scale", v_pages.scale)]
    for name, t in tensors:
        if t.device != dev:
            raise MXNetError(
                f"paged attention: {name} is on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise MXNetError(f"paged attention: {name} is not contiguous")
    if q.dtype != torch.float32:
        raise MXNetError(
            f"paged attention kernel takes float32 queries, got {q.dtype}")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise MXNetError(
            "paged attention kernel takes int32 page_table and lengths")
    want = (torch.int8,) if quantized else (torch.float32, torch.bfloat16)
    if k_pages.data.dtype not in want \
            or v_pages.data.dtype != k_pages.data.dtype:
        raise MXNetError(
            f"paged attention kernel: page dtypes {k_pages.data.dtype}/"
            f"{v_pages.data.dtype} not in {want}")
    if quantized:
        n, p, h, _ = k_pages.data.shape
        for name, s in (("k_scale", k_pages.scale),
                        ("v_scale", v_pages.scale)):
            if s.dtype != torch.float32 or tuple(s.shape) != (n, p, h):
                raise MXNetError(
                    f"paged attention kernel: {name} must be float32 "
                    f"{(n, p, h)}, got {s.dtype} {tuple(s.shape)}")
    d, p = q.shape[-1], k_pages.data.shape[1]
    row_bytes = d * k_pages.data.element_size()
    if d > _MAX_HEAD_DIM or p > _MAX_PAGE_SIZE or row_bytes % 4:
        raise MXNetError(
            f"paged attention kernel takes head_dim <= {_MAX_HEAD_DIM}, "
            f"page_size <= {_MAX_PAGE_SIZE} and head_dim * itemsize a "
            f"multiple of 4 bytes, got {d}, {p} and {row_bytes}")
    unit = 16 if row_bytes % 16 == 0 else 8 if row_bytes % 8 == 0 else 4
    serving = (p, d) == (16, 64) and q.shape[1] % 4 == 0
    aligned = [("q", q, 16), ("k_pages", k_pages.data, unit),
               ("v_pages", v_pages.data, unit)]
    if quantized:
        aligned += [(name, s, 16 if serving else 4) for name, s in
                    (("k_scale", k_pages.scale), ("v_scale", v_pages.scale))]
    for name, t, align in aligned:
        if t.data_ptr() % align:
            raise MXNetError(
                f"paged attention kernel: {name} is not {align}-byte "
                f"aligned")
    bp = page_table.shape[1]
    if not 1 <= bp <= MAX_TABLE_PAGES:
        raise MXNetError(
            f"paged attention kernel takes tables of 1 to "
            f"{MAX_TABLE_PAGES} pages a row, got {bp}")


def _ptr(t):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _scratch(b, h, d, bp, device):
    """The split kernel's (B, H, ceil(Bp / C), D + 2) partials, or None
    when Bp <= C (one chunk: the split kernel writes out itself)."""
    n_chunks = -(-bp // CHUNK_PAGES)
    if n_chunks == 1:
        return None
    return torch.empty((b, h, n_chunks, d + 2), dtype=torch.float32,
                       device=device)


def _launch(name, q, k_pages, v_pages, page_table, lengths, quantized):
    """Check the tensors and launch entry point `name` of the library:
    the split kernel, and the merge where Bp > CHUNK_PAGES. Reads
    nothing back to the host; the grid and the scratch come from shapes
    alone."""
    k_pages = _quant.as_pool(k_pages)
    v_pages = _quant.as_pool(v_pages)
    b, h, d, _, p, bp = _check_shapes(
        q, k_pages, v_pages, page_table, lengths)
    if quantized and (k_pages.scale is None or v_pages.scale is None):
        raise MXNetError("float pages go through paged_attention_float_cuda")
    if not quantized and (k_pages.scale is not None
                          or v_pages.scale is not None):
        raise MXNetError("int8 pages go through paged_attention_int8_cuda")
    _check_cuda(q, k_pages, v_pages, page_table, lengths, quantized)
    out = torch.empty((b, h, d), dtype=torch.float32, device=q.device)
    if b == 0:
        return out
    lib = _kernel_lib()
    partial = _scratch(b, h, d, bp, q.device)
    failed = ctypes.c_int(0)
    if quantized:
        pages = (_ptr(k_pages.data), _ptr(k_pages.scale),
                 _ptr(v_pages.data), _ptr(v_pages.scale))
        kind = ()
    else:
        pages = (_ptr(k_pages.data), _ptr(v_pages.data))
        kind = (int(k_pages.data.dtype == torch.bfloat16),)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, name)(
            _ptr(q), *pages, _ptr(page_table), _ptr(lengths), _ptr(out),
            _ptr(partial), b, h, d, p, bp, *kind, ctypes.c_void_p(stream),
            ctypes.byref(failed))
    if err != 0:
        which = {1: "split kernel", 2: "merge kernel"}.get(
            failed.value, "argument check")
        msg = lib.paged_attention_error_string(err)
        raise MXNetError(f"{name} failed ({which}): CUDA error {err} "
                         f"({msg.decode() if msg else '?'})")
    return out


_recording = None     # {entry: calls} of the graph being captured


def _count(entry, name):
    if _recording is not None and torch.cuda.is_current_stream_capturing():
        _recording[name] = _recording.get(name, 0) + 1
    else:
        entry.launches += 1


def paged_attention_float_cuda(q, k_pages, v_pages, page_table, lengths):
    """Launch the float32/bfloat16-page kernel on CUDA tensors. Counts
    one call in `launches` whatever the number of CUDA launches."""
    out = _launch("paged_attention_float", q, k_pages, v_pages, page_table,
                  lengths, False)
    if out.shape[0]:
        _count(paged_attention_float_cuda, "paged_attention_float")
    return out


paged_attention_float_cuda.launches = 0


def paged_attention_int8_cuda(q, k_pages, v_pages, page_table, lengths):
    """Launch the int8-page kernel (scale planes dequantized in the
    kernel) on CUDA tensors; counts as paged_attention_float_cuda."""
    out = _launch("paged_attention_int8", q, k_pages, v_pages, page_table,
                  lengths, True)
    if out.shape[0]:
        _count(paged_attention_int8_cuda, "paged_attention_int8")
    return out


paged_attention_int8_cuda.launches = 0
_ENTRIES = {"paged_attention_float": paged_attention_float_cuda,
            "paged_attention_int8": paged_attention_int8_cuda}


@contextlib.contextmanager
def recording_launches():
    """Inside the block, kernel calls on a capturing stream are noted in
    the yielded dict ({entry point: calls}) instead of `launches`: a
    graph capture launches nothing. The graph's owner credits the dict
    at each replay. One capture at a time (captures are serialised)."""
    global _recording
    saved, _recording = _recording, {}
    try:
        yield _recording
    finally:
        _recording = saved


def credit_launches(record):
    """Count the kernel calls a replayed graph made (its capture's
    record)."""
    for name, n in record.items():
        _ENTRIES[name].launches += n


# ----------------------------------------------------------- entry points
def paged_attention(q, k_pages, v_pages, page_table, lengths, scale=None):
    """Single-query paged attention (module docstring): the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors."""
    k_pages = _quant.as_pool(k_pages)
    v_pages = _quant.as_pool(v_pages)
    _check_scale(scale, q.shape[-1])
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, page_table,
                                     lengths)
    if q.device.type != "cuda":
        raise MXNetError(f"paged attention has no kernel for {q.device}")
    if k_pages.scale is not None:
        return paged_attention_int8_cuda(q, k_pages, v_pages, page_table,
                                         lengths)
    return paged_attention_float_cuda(q, k_pages, v_pages, page_table,
                                      lengths)


def ragged_paged_attention(q, k_pages, v_pages, page_table, lengths,
                           scale=None):
    """Mixed decode + tail-prefill rows through the same paged kernel
    (module docstring): the per-row length is the only difference."""
    return paged_attention(q, k_pages, v_pages, page_table, lengths,
                           scale=scale)


def reset_launch_counts():
    paged_attention_float_cuda.launches = 0
    paged_attention_int8_cuda.launches = 0


def launch_counts():
    return {"paged_attention_float": paged_attention_float_cuda.launches,
            "paged_attention_int8": paged_attention_int8_cuda.launches}
