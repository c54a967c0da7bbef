"""The CUDA flash-attention forward of mxnet_tpu_torch against its plain
PyTorch version, on the card. Marked `cuda`: these skip where
torch.cuda.is_available() is false (the kernel has no CPU mode). This
file imports neither jax nor mxnet_tpu, so it runs on a machine with
only the port installed:

    python -m pytest tests/test_torch_attention_cuda.py -q

Tolerance: the plain version repeats the kernel's blockwise rounding of
p (64-key blocks). The largest absolute difference beyond one ulp of the
output's type at the element's magnitude, as a share of the plain
output's largest magnitude, is at most 1e-4 in float32 and 2e-3 in
bf16/f16: the kernel sums in another order, and each version casts its
float32 result to the output type once, so where the two float32 values
straddle a rounding boundary the casts differ by one ulp.
"""
import importlib

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
def test_kernel_matches_plain(cuda_device, d, causal, dtype):
    q, k, v = _qkv(cuda_device, 2, 192, 192, 3, d, dtype)
    before = tattn.flash_forward.launches
    out = tattn.flash_forward(q, k, v, causal)
    torch.cuda.synchronize()
    assert tattn.flash_forward.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    ref = tattn.flash_forward_plain(q, k, v, causal)
    assert _rel_err(out, ref) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tq,tk", [(64, 256), (256, 64), (100, 37),
                                   (1, 130)])
def test_kernel_unequal_lengths(cuda_device, tq, tk, dtype):
    """Tq != Tk (top-left causal alignment) and ragged tile edges."""
    q, k, v = _qkv(cuda_device, 1, tq, tk, 4, 64, dtype, seed=1)
    for causal in (False, True):
        out = tattn.flash_forward(q, k, v, causal)
        ref = tattn.flash_forward_plain(q, k, v, causal)
        assert _rel_err(out, ref) <= TOL[dtype], (causal, tq, tk)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 48, 80, 256])
def test_kernel_other_head_dims(cuda_device, d):
    """A head_dim between the kernel's instances runs zero-padded."""
    q, k, v = _qkv(cuda_device, 1, 128, 128, 2, d, torch.float32, seed=2)
    out = tattn.flash_forward(q, k, v, True)
    ref = tattn.flash_forward_plain(q, k, v, True)
    assert _rel_err(out, ref) <= TOL[torch.float32]


@pytest.mark.cuda
def test_kernel_reads_strided_views(cuda_device):
    """q, k, v as views of one fused (B, T, 3, H, D) projection."""
    g = torch.Generator(device="cpu").manual_seed(3)
    qkv = torch.randn(2, 128, 3, 4, 32, generator=g).to(cuda_device)
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    out = tattn.flash_forward(q, k, v, True)
    ref = tattn.flash_forward_plain(q.contiguous(), k.contiguous(),
                                    v.contiguous(), True)
    assert _rel_err(out, ref) <= TOL[torch.float32]


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
