"""The port's long-context attention (mxnet_tpu_torch.parallel.attention)
against the JAX package's (mxnet_tpu.parallel.attention), on the CPU.

The same numpy inputs (seeded) go through both. The JAX flash path runs
its Pallas kernel in interpret mode, as tests/test_attention.py does; the
port's flash path on CPU tensors runs `flash_forward_plain`, the plain
version of the CUDA kernel. Tolerances:

- forward values rtol 2e-4 / atol 2e-5 in float32 (the JAX package's own
  flash-vs-reference tolerance);
- gradients rtol 1e-3 / atol 1e-4 (the JAX package's own);
- bf16: compared in float32, within one bf16 ulp of the output
  (rtol = atol = 2^-7): both round p to bf16 at the running max of each
  key block, but sum in other orders, so the final casts to bf16 may
  differ by one ulp.

The flash forward's causal mask is top-left and the reference's
bottom-right: with Tq != Tk they differ, in both packages, and the port
copies each.
"""
import importlib
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from mxnet_tpu_torch.base import MXNetError  # noqa: E402

# the modules (each package's `parallel.attention` name is the function)
jattn = importlib.import_module("mxnet_tpu.parallel.attention")
tattn = importlib.import_module("mxnet_tpu_torch.parallel.attention")

FWD_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-4)
BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -7)


def _qkv(b=2, tq=64, tk=None, h=4, d=16, seed=0):
    rs = np.random.RandomState(seed)
    tk = tq if tk is None else tk
    return (rs.standard_normal((b, tq, h, d)).astype(np.float32),
            rs.standard_normal((b, tk, h, d)).astype(np.float32),
            rs.standard_normal((b, tk, h, d)).astype(np.float32))


def _jax_flash(q, k, v, causal, block=16):
    return jattn.attention(q, k, v, causal=causal, impl="flash",
                           block_q=block, block_k=block, interpret=True)


def _t(arrays, dtype=torch.float32):
    return [torch.tensor(a).to(dtype) for a in arrays]


@pytest.mark.parametrize("causal", [False, True])
def test_forward_matches_jax(causal):
    qkv = _qkv()
    jq = [jnp.asarray(a) for a in qkv]
    j_ref = np.asarray(jattn.attention_reference(*jq, causal=causal))
    j_flash = np.asarray(_jax_flash(*jq, causal))
    tq = _t(qkv)
    np.testing.assert_allclose(
        tattn.attention_reference(*tq, causal=causal).numpy(), j_ref,
        **FWD_TOL)
    np.testing.assert_allclose(
        tattn.flash_forward_plain(*tq, causal=causal).numpy(), j_flash,
        **FWD_TOL)
    out = tattn.attention(*tq, causal=causal, impl="flash", block_q=16,
                          block_k=16)
    np.testing.assert_allclose(out.numpy(), j_flash, **FWD_TOL)
    np.testing.assert_allclose(out.numpy(), j_ref, **FWD_TOL)
    np.testing.assert_allclose(
        tattn.attention(*tq, causal=causal, impl="xla").numpy(), j_ref,
        **FWD_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_gradients_match_reference_and_jax(causal):
    qkv = _qkv(tq=32, seed=1)
    rs = np.random.RandomState(2)
    head = rs.standard_normal(qkv[0].shape).astype(np.float32)

    def jloss(fn):
        return lambda q, k, v: (fn(q, k, v) * head).sum()

    jq = [jnp.asarray(a) for a in qkv]
    j_flash = jax.grad(jloss(lambda q, k, v: _jax_flash(q, k, v, causal)),
                       argnums=(0, 1, 2))(*jq)

    def tgrads(impl):
        leaves = [t.requires_grad_(True) for t in _t(qkv)]
        out = tattn.attention(*leaves, causal=causal, impl=impl,
                              block_q=16, block_k=16)
        (out * torch.tensor(head)).sum().backward()
        return [t.grad.numpy() for t in leaves]

    flash, ref = tgrads("flash"), tgrads("xla")
    for name, a, b, j in zip("qkv", flash, ref, j_flash):
        np.testing.assert_allclose(a, b, err_msg=name, **GRAD_TOL)
        np.testing.assert_allclose(a, np.asarray(j), err_msg=name,
                                   **GRAD_TOL)


@pytest.mark.parametrize("tq,tk", [(32, 64), (64, 32)])
def test_unequal_lengths_causal_alignment(tq, tk):
    """The flash forward aligns the causal mask top-left, the reference
    bottom-right: each port function matches its JAX twin, and the two
    differ by O(1), as in the JAX package."""
    qkv = _qkv(b=1, tq=tq, tk=tk, h=2, d=16, seed=3)
    jq = [jnp.asarray(a) for a in qkv]
    j_flash = np.asarray(_jax_flash(*jq, True))
    j_ref = np.asarray(jattn.attention_reference(*jq, causal=True))
    tq_ = _t(qkv)
    t_flash = tattn.attention(*tq_, causal=True, impl="flash", block_q=16,
                              block_k=16).numpy()
    t_ref = tattn.attention_reference(*tq_, causal=True).numpy()
    np.testing.assert_allclose(t_flash, j_flash, **FWD_TOL)
    np.testing.assert_allclose(t_ref, j_ref, **FWD_TOL)
    assert np.abs(j_flash - j_ref).max() > 0.5
    assert np.abs(t_flash - t_ref).max() > 0.5
    # non-causal, the two agree whatever the lengths
    np.testing.assert_allclose(
        tattn.attention(*tq_, impl="flash", block_q=16,
                        block_k=16).numpy(),
        tattn.attention_reference(*tq_).numpy(), **FWD_TOL)


def test_unequal_lengths_gradients_follow_the_reference():
    """The flash backward differentiates the reference (bottom-right
    mask) even where the forward used the top-left one, in both
    packages."""
    qkv = _qkv(b=1, tq=32, tk=64, h=2, d=16, seed=4)
    jq = [jnp.asarray(a) for a in qkv]
    j = jax.grad(lambda q, k, v: _jax_flash(q, k, v, True).sum(),
                 argnums=(0, 1, 2))(*jq)
    leaves = [t.requires_grad_(True) for t in _t(qkv)]
    tattn.attention(*leaves, causal=True, impl="flash", block_q=16,
                    block_k=16).sum().backward()
    for t, a in zip(leaves, j):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(a),
                                   **GRAD_TOL)


@pytest.mark.parametrize("tq,tk,bq,bk", [(48, 64, 32, 16),
                                         (64, 40, 16, 16),
                                         (64, 64, 128, 128),
                                         (24, 24, 128, 16)])
def test_divisibility_assertion_matches(tq, tk, bq, bk):
    qkv = _qkv(b=1, tq=tq, tk=tk, h=1, d=8, seed=5)
    jq = [jnp.asarray(a) for a in qkv]
    try:
        jattn.attention(*jq, impl="flash", block_q=bq, block_k=bk,
                        interpret=True)
        j_err = None
    except AssertionError as e:
        j_err = str(e)
    try:
        tattn.attention(*_t(qkv), impl="flash", block_q=bq, block_k=bk)
        t_err = None
    except AssertionError as e:
        t_err = str(e)
    assert t_err == j_err
    if tk % min(bk, tk) or tq % min(bq, tq):
        assert t_err == ("flash attention: sequence lengths must divide "
                         "block sizes")


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_flash_matches_jax(causal):
    qkv = _qkv(seed=6)
    jq = [jnp.asarray(a, dtype=jnp.bfloat16) for a in qkv]
    j_out = np.asarray(_jax_flash(*jq, causal).astype(jnp.float32))
    out = tattn.attention(*_t(qkv, torch.bfloat16), causal=causal,
                          impl="flash", block_q=16, block_k=16)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), j_out, **BF16_TOL)


def test_kernel_block_k_follows_the_callers_block():
    """The CUDA kernel's key tile: block_k where it is 64 or 128, the
    tile that holds all of Tk where block_k does, else 64."""
    kb = tattn.kernel_block_k
    assert (kb(64, 4096), kb(128, 4096), kb(128, 128)) == (64, 128, 128)
    assert (kb(37, 37), kb(100, 100), kb(128, 100)) == (64, 128, 128)
    assert (kb(32, 256), kb(16, 64), kb(256, 2048), kb(200, 200)) == (
        64, 64, 64, 64)


def test_block_k_defaults_are_the_tpu_kernels():
    """Every flash entry point of the port defaults to the JAX package's
    key block, so a call without block_k rounds p over the same blocks
    on the CPU, on the card and in the JAX package."""
    import inspect

    def default(fn):
        return inspect.signature(fn).parameters["block_k"].default

    want = default(jattn.attention)
    assert want == 128
    assert [default(f) for f in (tattn.attention, tattn.flash_forward,
                                 tattn.flash_forward_plain)] == [want] * 3
    assert inspect.signature(tattn.kernel_instance).parameters[
        "tile_k"].default == tattn.kernel_block_k(want, 4096)


@pytest.mark.parametrize("block_k", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_bf16_block_k_matches_jax(block_k, causal):
    """bf16 p is rounded against the running max of each key block of
    block_k, in both packages: the port at the JAX package's block_k
    agrees within one ulp, and on more elements exactly than the port at
    the other block does."""
    qkv = _qkv(b=1, tq=256, h=2, d=16, seed=8)
    jq = [jnp.asarray(a, dtype=jnp.bfloat16) for a in qkv]
    j_out = np.asarray(jattn.attention(
        *jq, causal=causal, impl="flash", block_q=block_k,
        block_k=block_k, interpret=True).astype(jnp.float32))
    tq = _t(qkv, torch.bfloat16)
    outs = {bk: tattn.attention(*tq, causal=causal, impl="flash",
                                block_q=bk, block_k=bk).float().numpy()
            for bk in (64, 128)}
    np.testing.assert_allclose(outs[block_k], j_out, **BF16_TOL)
    other = 64 if block_k == 128 else 128
    assert ((outs[block_k] != j_out).sum()
            < (outs[other] != j_out).sum())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_l_sums_unrounded_p(dtype):
    """l adds the float32 p; only the PV product takes p rounded to v's
    dtype (the TPU kernel's p.astype(v.dtype)): on inputs where the two
    readings give different outputs, the plain version and the JAX
    package's kernel give the unrounded one."""
    from test_torch_attention_cuda import unrounded_p_case

    q, k, v, want, rounded_l = unrounded_p_case(dtype)
    assert want != rounded_l
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}[dtype]
    jq = [jnp.asarray(t.float().numpy(), dtype=jdt) for t in (q, k, v)]
    for block_k in (64, 128):
        out = tattn.flash_forward_plain(q, k, v, False, scale=1.0,
                                        block_k=block_k)
        assert (out[..., 0].float() == want).all(), block_k
        j_out = jattn.attention(*jq, scale=1.0, impl="flash", block_q=4,
                                block_k=block_k, interpret=True)
        np.testing.assert_array_equal(
            np.asarray(j_out.astype(jnp.float32)), out.float().numpy())


def test_fully_masked_rows_are_uniform():
    """Bottom-right alignment with Tq > Tk leaves the first rows without
    keys: -1e30 everywhere gives them uniform weights, in both."""
    qkv = _qkv(b=1, tq=32, tk=16, h=1, d=8, seed=7)
    j = np.asarray(jattn.attention_reference(
        *[jnp.asarray(a) for a in qkv], causal=True))
    t = tattn.attention_reference(*_t(qkv), causal=True).numpy()
    np.testing.assert_allclose(t, j, **FWD_TOL)
    np.testing.assert_allclose(t[0, 0], qkv[2][0].mean(axis=0), **FWD_TOL)


def test_cpu_takes_the_plain_version_and_the_kernel_takes_cuda_only():
    qkv = _t(_qkv(b=1, tq=16, h=1, d=8))
    before = tattn.flash_forward.launches
    tattn.attention(*qkv, causal=True, impl="flash")
    assert tattn.flash_forward.launches == before
    with pytest.raises(MXNetError, match="CUDA tensors"):
        tattn.flash_forward(*qkv)
    with pytest.raises(ValueError, match="unknown attention impl"):
        tattn.attention(*qkv, impl="ring")


def test_parallel_exports():
    import mxnet_tpu_torch.parallel as tpar

    assert tpar.attention is tattn.attention
    assert tpar.attention_reference is tattn.attention_reference
