"""mxnet_tpu_torch paged attention and KV quantization against the JAX
package: the plain PyTorch version (what CPU tensors take) against
`paged_attention_lax` and `paged_attention_pallas` (Pallas body in
interpret mode on the CPU) over float32, bf16 and int8 pools, merged
ragged rows and a length-0 row; the kernel's split algorithm
(`paged_attention_chunked_plain`: fixed page chunks, skipped chunks,
ordered merge) against the same, and bit-identical across table widths
and batches; int8 quantization bit-exact; the CUDA entry points refusing
CPU tensors. The kernel itself is checked on the card by
tests/test_torch_decoding_cuda.py."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from mxnet_tpu.decoding import attention as jattn
from mxnet_tpu.decoding import quant as jquant
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.decoding import attention as tattn
from mxnet_tpu_torch.decoding import quant as tquant

# float32 / int8: both sides compute in float32 from identical stored
# values; only the summation order differs
ATOL = 1e-5


def _case(seed, b=5, h=2, d=8, p=4, bp=3, n=16):
    """Random q, pools and a table whose rows mix decode rows, the
    ragged tail rows of one sequence (consecutive lengths over one
    table, as the merged step packs them) and a length-0 row."""
    rs = np.random.RandomState(seed)
    q = rs.randn(b, h, d).astype(np.float32)
    k = rs.randn(n, p, h, d).astype(np.float32)
    v = rs.randn(n, p, h, d).astype(np.float32)
    table = np.stack([rs.choice(np.arange(1, n), size=bp, replace=False)
                      for _ in range(b)]).astype(np.int32)
    table[2] = table[1]            # rows 1..2: one sequence's tail rows
    table[3, 1:] = 0               # padded entries -> scratch page
    lengths = np.asarray([bp * p, 5, 6, 3, 0], np.int32)[:b]
    return q, k, v, table, lengths


def _jax_out(fn, q, kp, vp, table, lengths):
    return np.asarray(fn(jnp.asarray(q), kp, vp, jnp.asarray(table),
                         jnp.asarray(lengths)), np.float32)


def _torch_out(q, kp, vp, table, lengths):
    return tattn.paged_attention(
        torch.from_numpy(q), kp, vp, torch.from_numpy(table),
        torch.from_numpy(lengths)).numpy()


@pytest.mark.parametrize("jax_fn", ["lax", "pallas"])
def test_plain_float32_matches_jax(jax_fn):
    q, k, v, table, lengths = _case(0)
    fn = {"lax": jattn.paged_attention_lax,
          "pallas": jattn.paged_attention_pallas}[jax_fn]
    ref = _jax_out(fn, q, jnp.asarray(k), jnp.asarray(v), table, lengths)
    out = _torch_out(q, torch.from_numpy(k), torch.from_numpy(v), table,
                     lengths)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    # the length-0 row is uniform over all Bp*P positions of its table
    uniform = v[table[4]].reshape(-1, *v.shape[2:]).mean(axis=0)
    np.testing.assert_allclose(out[4], uniform, atol=ATOL, rtol=0)


@pytest.mark.parametrize("jax_fn", ["lax", "pallas"])
def test_plain_bf16_matches_jax(jax_fn):
    q, k, v, table, lengths = _case(1)
    fn = {"lax": jattn.paged_attention_lax,
          "pallas": jattn.paged_attention_pallas}[jax_fn]
    kb, vb = jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)
    ref = _jax_out(fn, q, kb, vb, table, lengths)
    kt = torch.from_numpy(k).to(torch.bfloat16)
    vt = torch.from_numpy(v).to(torch.bfloat16)
    # the same bf16 values on both sides, upcast to float32 in compute
    np.testing.assert_array_equal(
        kt.float().numpy(), np.asarray(kb, np.float32))
    out = _torch_out(q, kt, vt, table, lengths)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("jax_fn", ["lax", "pallas"])
def test_plain_int8_matches_jax(jax_fn):
    q, k, v, table, lengths = _case(2)
    fn = {"lax": jattn.paged_attention_lax,
          "pallas": jattn.paged_attention_pallas}[jax_fn]
    kq, ks, _ = jquant.quantize_values(jnp.asarray(k))
    vq, vs, _ = jquant.quantize_values(jnp.asarray(v))
    ref = _jax_out(fn, q, jquant.KVPool(kq, ks), jquant.KVPool(vq, vs),
                   table, lengths)
    kp = tquant.KVPool(torch.from_numpy(np.array(kq)),
                       torch.from_numpy(np.array(ks)))
    vp = tquant.KVPool(torch.from_numpy(np.array(vq)),
                       torch.from_numpy(np.array(vs)))
    out = _torch_out(q, kp, vp, table, lengths)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_ragged_entry_is_the_same_function():
    q, k, v, table, lengths = _case(3)
    args = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(table), torch.from_numpy(lengths))
    np.testing.assert_array_equal(tattn.ragged_paged_attention(*args),
                                  tattn.paged_attention(*args))
    with pytest.raises(ValueError):
        tattn.paged_attention(*args, scale=0.5)


def test_quantize_values_bit_exact():
    rs = np.random.RandomState(4)
    x = (rs.randn(3, 5, 2, 8) * rs.uniform(0.01, 10, (3, 5, 2, 1))
         ).astype(np.float32)
    x[0, 0, 0] = 0.0                      # all-zero row: scale floor
    x[1, 2, 1, 3] = np.inf                # nonfinite: clipped row
    jq, js, jc = jquant.quantize_values(jnp.asarray(x))
    tq, ts, tc = tquant.quantize_values(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert int(tc) == int(jc) > 0


@pytest.mark.parametrize("kv_dtype", ["float32", "bf16", "int8"])
def test_kv_scatter_bit_exact(kv_dtype):
    rs = np.random.RandomState(5)
    shape = (2, 6, 4, 2, 8)
    vals = rs.randn(5, 2, 8).astype(np.float32)
    pages = np.asarray([1, 3, 3, 5, 2], np.int32)
    slots = np.asarray([0, 1, 2, 3, 0], np.int32)
    jp = jquant.make_pool(shape, kv_dtype)
    jp, jc = jquant.kv_scatter(jp, 1, jnp.asarray(pages),
                               jnp.asarray(slots), jnp.asarray(vals))
    tp = tquant.make_pool(shape, kv_dtype)
    tc = tquant.kv_scatter(tp, 1, torch.from_numpy(pages).long(),
                           torch.from_numpy(slots).long(),
                           torch.from_numpy(vals))
    np.testing.assert_array_equal(tp.data.float().numpy(),
                                  np.asarray(jp.data, np.float32))
    if kv_dtype == "int8":
        np.testing.assert_array_equal(tp.scale.numpy(),
                                      np.asarray(jp.scale))
    else:
        assert tp.scale is None and jp.scale is None
    assert int(tc) == int(jc) == 0
    np.testing.assert_array_equal(
        tquant.dequant_page(tp, 1, 3).numpy(),
        np.asarray(jquant.dequant_page(jp, 1, 3)))
    assert tquant.kv_bytes_per_token(tp) == jquant.kv_bytes_per_token(jp)


def test_cuda_wrappers_refuse_cpu_tensors():
    """On a CPU tensor only the plain version runs; the CUDA entry
    points raise instead of falling back, and count no launch."""
    q, k, v, table, lengths = _case(6)
    args = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(table), torch.from_numpy(lengths))
    before = tattn.launch_counts()
    with pytest.raises(MXNetError):
        tattn.paged_attention_float_cuda(*args)
    kq, ks, _ = tquant.quantize_values(args[1])
    vq, vs, _ = tquant.quantize_values(args[2])
    with pytest.raises(MXNetError):
        tattn.paged_attention_int8_cuda(
            args[0], tquant.KVPool(kq, ks), tquant.KVPool(vq, vs),
            args[3], args[4])
    assert tattn.launch_counts() == before


# ------------------------------------------------- the kernel's split algorithm
def _chunk_case(seed, bp, chunk, b=8, h=2, d=8, p=4, n=48):
    """Rows for the split algorithm at table width bp and chunk size
    chunk (pages): a length-0 row, length 1, a length exactly on a chunk
    edge and one past it, a full table, two tail rows of one sequence
    (consecutive lengths over one table) and a short decode row. Entries
    past a row's pages point at the scratch page 0."""
    rs = np.random.RandomState(seed)
    q = rs.randn(b, h, d).astype(np.float32)
    k = rs.randn(n, p, h, d).astype(np.float32)
    v = rs.randn(n, p, h, d).astype(np.float32)
    full = bp * p
    edge = min(chunk * p, full)
    tail = min(edge + p + 1, full - 1) if full > 1 else 1
    lengths = np.asarray([0, 1, edge, min(edge + 1, full), full, tail,
                          tail + 1, max(1, full // 3)], np.int32)[:b]
    lengths = np.minimum(lengths, full)
    table = rs.randint(1, n, size=(b, bp)).astype(np.int32)
    table[6] = table[5]
    for row, length in enumerate(lengths):
        if length > 0:
            table[row, -(-length // p):] = 0
    return q, k, v, table, lengths


def _pools(kv, k, v):
    """(jax K, jax V, torch K, torch V) pools holding the same values."""
    if kv == "int8":
        kq, ks, _ = jquant.quantize_values(jnp.asarray(k))
        vq, vs, _ = jquant.quantize_values(jnp.asarray(v))
        return (jquant.KVPool(kq, ks), jquant.KVPool(vq, vs),
                tquant.KVPool(torch.from_numpy(np.array(kq)),
                              torch.from_numpy(np.array(ks))),
                tquant.KVPool(torch.from_numpy(np.array(vq)),
                              torch.from_numpy(np.array(vs))))
    if kv == "bf16":
        return (jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16),
                torch.from_numpy(k).to(torch.bfloat16),
                torch.from_numpy(v).to(torch.bfloat16))
    return (jnp.asarray(k), jnp.asarray(v), torch.from_numpy(k),
            torch.from_numpy(v))


def _chunked(q, kp, vp, table, lengths, chunk):
    return tattn.paged_attention_chunked_plain(
        torch.from_numpy(q), kp, vp, torch.from_numpy(table),
        torch.from_numpy(lengths), chunk_pages=chunk).numpy()


@pytest.mark.parametrize("chunk", [2, tattn.CHUNK_PAGES])
@pytest.mark.parametrize("bp", [3, 8, 20])
@pytest.mark.parametrize("kv", ["float32", "bf16", "int8"])
def test_chunked_plain_matches_jax(kv, bp, chunk):
    """Split-K over fixed page chunks, skipped chunks and the ordered
    merge give the JAX package's paged attention (lax and the Pallas
    body in interpret mode) with Bp below, at and above the chunk, at
    ATOL (the bf16 values are the same on both sides, computed in
    float32)."""
    q, k, v, table, lengths = _chunk_case(10 + bp, bp, chunk)
    jk, jv, tk, tv = _pools(kv, k, v)
    out = _chunked(q, tk, tv, table, lengths, chunk)
    for fn in (jattn.paged_attention_lax, jattn.paged_attention_pallas):
        ref = _jax_out(fn, q, jk, jv, table, lengths)
        np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    # the length-0 row: exactly uniform weights over all Bp*P positions
    vals = tquant.gather_ctx(tv, torch.from_numpy(table[:1]))
    uniform = vals.reshape(-1, *vals.shape[-2:]).mean(dim=0).numpy()
    np.testing.assert_allclose(out[0], uniform, atol=ATOL, rtol=0)


@pytest.mark.parametrize("chunk", [2, tattn.CHUNK_PAGES])
@pytest.mark.parametrize("kv", ["float32", "bf16", "int8"])
def test_chunked_plain_batch_invariant(kv, chunk):
    """A row's output is bit-identical whether its table is padded to
    Bp = 8 or 128 and whatever rows share the batch."""
    rs = np.random.RandomState(20)
    h, d, p, n = 2, 8, 4, 48
    q = rs.randn(6, h, d).astype(np.float32)
    k = rs.randn(n, p, h, d).astype(np.float32)
    v = rs.randn(n, p, h, d).astype(np.float32)
    _, _, tk, tv = _pools(kv, k, v)
    row_pages = rs.randint(1, n, size=8).astype(np.int32)
    others = rs.randint(1, n, size=(5, 128)).astype(np.int32)
    other_lengths = np.asarray([512, 3, 100, 257, 31], np.int32)
    for length in (1, 16, 29, 32):
        outs = []
        for bp, with_others in ((8, False), (8, True), (128, False),
                                (128, True)):
            table = np.zeros((1, bp), np.int32)
            table[0, :8] = row_pages
            lengths = np.asarray([length], np.int32)
            qq = q[:1]
            if with_others:
                table = np.concatenate([table, others[:, :bp]])
                lengths = np.concatenate(
                    [lengths, np.minimum(other_lengths, bp * p)])
                qq = q
            outs.append(_chunked(qq, tk, tv, table, lengths, chunk)[0])
        for o in outs[1:]:
            np.testing.assert_array_equal(o, outs[0])
