"""The CUDA flash-attention forward of mxnet_tpu_torch against its plain
PyTorch version, on the card. Marked `cuda`: these skip where
torch.cuda.is_available() is false (the kernel has no CPU mode). This
file imports neither jax nor mxnet_tpu, so it runs on a machine with
only the port installed:

    python -m pytest tests/test_torch_attention_cuda.py -q

Tolerance: the plain version repeats the kernel's blockwise rounding of
p, over the same key blocks (`block_k`, each wrapper's default 128 unless
a test says otherwise).
The largest absolute difference beyond one ulp of the output's type at
the element's magnitude, as a share of the plain output's largest
magnitude, is at most 1e-4 in float32 and 2e-3 in bf16/f16: the kernel
sums in another order, and each version casts its float32 result to the
output type once, so where the two float32 values straddle a rounding
boundary the casts differ by one ulp. Two cases are held tighter, as
what they test is below that tolerance: the choice of key block, by how
many outputs differ from the plain version at that block and at the
other; and l summing the unrounded p, by exact outputs.
"""
import importlib
import math

import pytest
import torch

from mxnet_tpu_torch.base import MXNetError

# the module (the package's `parallel.attention` name is the function)
tattn = importlib.import_module("mxnet_tpu_torch.parallel.attention")

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-3, torch.float16: 2e-3}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _qkv(dev, b, tq, tk, h, d, dtype, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn(b, tq, h, d, generator=g)
    k = torch.randn(b, tk, h, d, generator=g)
    v = torch.randn(b, tk, h, d, generator=g)
    return [t.to(dev, dtype) for t in (q, k, v)]


def _rel_err(out, ref):
    """max(|out - ref| - ulp(ref), 0) / max|ref|, ulp in out's type."""
    eps = torch.finfo(out.dtype).eps
    ref = ref.float()
    mag = ref.abs().clamp_min(torch.finfo(torch.float32).tiny)
    ulp = eps * torch.exp2(torch.floor(torch.log2(mag)))
    excess = ((out.float() - ref).abs() - ulp).clamp_min(0)
    return (excess.max() / ref.abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("block_k", [64, 128])
def test_kernel_matches_plain(cuda_device, block_k, d, causal, dtype):
    q, k, v = _qkv(cuda_device, 2, 192, 192, 3, d, dtype)
    before = tattn.flash_forward.launches
    out = tattn.flash_forward(q, k, v, causal, block_k=block_k)
    torch.cuda.synchronize()
    assert tattn.flash_forward.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    ref = tattn.flash_forward_plain(q, k, v, causal, block_k=block_k)
    assert _rel_err(out, ref) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("tq,tk", [(64, 256), (256, 64), (100, 37),
                                   (1, 130)])
def test_kernel_unequal_lengths(cuda_device, tq, tk, dtype):
    """Tq != Tk (top-left causal alignment) and ragged tile edges; (1,
    130) with causal leaves the second key tile wholly masked for the
    one row."""
    q, k, v = _qkv(cuda_device, 1, tq, tk, 4, 64, dtype, seed=1)
    for causal in (False, True):
        for block_k in (64, 128):
            out = tattn.flash_forward(q, k, v, causal, block_k=block_k)
            ref = tattn.flash_forward_plain(q, k, v, causal,
                                            block_k=block_k)
            assert torch.isfinite(out.float()).all()
            assert _rel_err(out, ref) <= TOL[dtype], (causal, block_k)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d", [8, 33, 48, 80, 100, 256])
def test_kernel_other_head_dims(cuda_device, d, dtype):
    """A head_dim between the kernel's instances runs zero-padded; one
    whose rows are not a multiple of 16 bytes (33; 100 in bf16/f16)
    loads element by element."""
    q, k, v = _qkv(cuda_device, 1, 128, 128, 2, d, dtype, seed=2)
    for block_k in (64, 128):
        out = tattn.flash_forward(q, k, v, True, block_k=block_k)
        ref = tattn.flash_forward_plain(q, k, v, True, block_k=block_k)
        assert _rel_err(out, ref) <= TOL[dtype], block_k


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("block_k", [64, 128])
@pytest.mark.parametrize("d", [32, 64])
def test_kernel_reads_strided_views(cuda_device, d, block_k, dtype):
    """q, k, v as views of one fused (B, T, 3, H, D) projection: strides
    that are not packed but are multiples of 16 bytes, so the tiles
    stage by cp.async (and, in bf16/f16 at D = 64, feed wgmma)."""
    g = torch.Generator(device="cpu").manual_seed(3)
    qkv = torch.randn(2, 128, 3, 4, d, generator=g).to(cuda_device, dtype)
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    out = tattn.flash_forward(q, k, v, True, block_k=block_k)
    assert tattn.kernel_staging(q, k, v, out) == "cp.async"
    ref = tattn.flash_forward_plain(q.contiguous(), k.contiguous(),
                                    v.contiguous(), True, block_k=block_k)
    assert _rel_err(out, ref) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_reads_unaligned_rows(cuda_device, dtype):
    """Rows that start off a 16-byte boundary load element by element."""
    g = torch.Generator(device="cpu").manual_seed(5)
    big = torch.randn(3, 1, 160, 2, 65, generator=g).to(cuda_device, dtype)
    q, k, v = (t[..., 1:] for t in big.unbind(0))
    assert q.data_ptr() % 16 != 0
    for causal in (False, True):
        out = tattn.flash_forward(q, k, v, causal, block_k=128)
        assert tattn.kernel_staging(q, k, v, out) == "element"
        ref = tattn.flash_forward_plain(q, k, v, causal, block_k=128)
        assert _rel_err(out, ref) <= TOL[dtype], causal


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_kernel_follows_block_k(cuda_device, dtype):
    """In bf16/f16 the key block decides where p is rounded: the kernel
    at block_k 64 or 128 agrees with the plain version at that block on
    far more outputs than with the plain version at the other."""
    q, k, v = _qkv(cuda_device, 2, 512, 512, 4, 64, dtype, seed=6)
    plain = {bk: tattn.flash_forward_plain(q, k, v, False, block_k=bk)
             for bk in (64, 128)}
    assert (plain[64] != plain[128]).sum().item() > 100
    for bk, other in ((64, 128), (128, 64)):
        out = tattn.flash_forward(q, k, v, False, block_k=bk)
        assert _rel_err(out, plain[bk]) <= TOL[dtype]
        same = (out != plain[bk]).sum().item()
        assert same * 10 < (out != plain[other]).sum().item(), bk


def unrounded_p_case(dtype, device="cpu"):
    """Inputs on which "l sums the unrounded p" and "l sums p rounded to
    v's dtype" give different outputs in `dtype` (bf16 or f16): q
    (1, 4, 1, 64), k and v (1, 128, 1, 64), scale 1. Every score is 64
    (key 0) or 64 - x (keys 1..127), with x = 2^-(m+2) - 2^-(m+6) for m
    mantissa bits, so p = exp(-x) lies 2^-(m+6) above the midpoint between
    1 and the value of the type just below it, and rounds up to 1: a
    rounded l is 128, the unrounded one 128 - 127 x (about). v is
    1.9921875 and, on 36 keys, 2: a rounded l gives their mean,
    1.99438..., a quarter of an f16 ulp below a rounding boundary of the
    type (f16) or 1.7e-3 below one (bf16), and the unrounded l lifts it
    across. Returns (q, k, v, the output's column 0 in `dtype` as a
    float, what a rounded l gives)."""
    mant = {torch.bfloat16: 7, torch.float16: 10}[dtype]
    x = 2.0 ** -(mant + 2) - 2.0 ** -(mant + 6)
    tk, d = 128, 64
    q = torch.zeros(1, 4, 1, d, dtype=torch.float64)
    q[..., 0], q[..., 1] = 1.0, 64.0
    k = torch.zeros(1, tk, 1, d, dtype=torch.float64)
    k[..., 1] = 1.0
    k[:, 1:, :, 0] = -x
    v = torch.full((1, tk, 1, d), 1.9921875, dtype=torch.float64)
    v[:, :36] = 2.0
    l_true = 1 + (tk - 1) * math.exp(-x)
    true = v[0, :, 0, 0].sum() / l_true
    rounded_l = v[0, :, 0, 0].mean()
    q, k, v = (t.to(device, dtype) for t in (q, k, v))
    return (q, k, v, true.to(dtype).float().item(),
            rounded_l.to(dtype).float().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_kernel_sums_unrounded_p(cuda_device, dtype):
    """l sums the float32 p; only the PV product takes p rounded to v's
    dtype (`unrounded_p_case`)."""
    q, k, v, want, rounded_l = unrounded_p_case(dtype, cuda_device)
    assert want != rounded_l
    for block_k in (64, 128):
        out = tattn.flash_forward(q, k, v, False, scale=1.0,
                                  block_k=block_k)
        ref = tattn.flash_forward_plain(q, k, v, False, scale=1.0,
                                        block_k=block_k)
        assert torch.equal(out, ref), block_k
        assert (out[..., 0].float() == want).all(), block_k


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block_k", [32, 64, 128])
def test_attention_passes_block_k(cuda_device, block_k, dtype):
    """attention(impl="flash", block_k) runs the kernel at that key block
    (64 for any block_k but 64 and 128)."""
    q, k, v = _qkv(cuda_device, 1, 256, 256, 2, 64, dtype, seed=7)
    before = tattn.flash_forward.launches
    out = tattn.attention(q, k, v, causal=True, impl="flash",
                          block_q=block_k, block_k=block_k)
    assert tattn.flash_forward.launches == before + 1
    tile = tattn.kernel_block_k(block_k, 256)
    assert tile == (64 if block_k == 32 else block_k)
    ref = tattn.flash_forward_plain(q, k, v, True, block_k=tile)
    assert _rel_err(out, ref) <= TOL[dtype]


@pytest.mark.cuda
def test_attention_entry_point_and_gradients(cuda_device):
    q, k, v = _qkv(cuda_device, 2, 128, 128, 4, 64, torch.float32, seed=4)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = tattn.flash_forward.launches
    out = tattn.attention(*leaves, causal=True, impl="flash")
    out.square().sum().backward()
    assert tattn.flash_forward.launches == before + 1
    ref_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = tattn.attention_reference(*ref_leaves, causal=True)
    ref.square().sum().backward()
    assert _rel_err(out.detach(), ref.detach()) <= 1e-4
    for a, b in zip(leaves, ref_leaves):
        assert _rel_err(a.grad, b.grad) <= 1e-4


@pytest.mark.cuda
def test_kernel_refuses(cuda_device):
    q, k, v = _qkv(cuda_device, 1, 64, 64, 2, 320, torch.float32)
    with pytest.raises(MXNetError, match="head_dim <= 256"):
        tattn.flash_forward(q, k, v)
    q, k, v = _qkv(cuda_device, 1, 64, 64, 2, 64, torch.float64)
    with pytest.raises(MXNetError, match="float32, bfloat16 or float16"):
        tattn.flash_forward(q, k, v)
    q, k, v = _qkv(cuda_device, 1, 64, 64, 2, 64, torch.float32)
    with pytest.raises(MXNetError, match="is on"):
        tattn.flash_forward(q, k.cpu(), v)
    k_gapped = torch.randn(1, 64, 2, 128, device=cuda_device)[..., ::2]
    with pytest.raises(MXNetError, match="not contiguous"):
        tattn.flash_forward(q, k_gapped, v)
    with pytest.raises(MXNetError, match="CUDA tensors"):
        tattn.flash_forward(q.cpu(), k.cpu(), v.cpu())
