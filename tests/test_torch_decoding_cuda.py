"""The CUDA paged-attention kernel of mxnet_tpu_torch against its plain
PyTorch version, on the card. Marked `cuda`: these skip where
torch.cuda.is_available() is false (the kernel has no CPU mode). This
file imports neither jax nor mxnet_tpu, so it runs on a machine with
only the port installed:

    python -m pytest tests/test_torch_decoding_cuda.py -q
"""
import pytest
import torch

from mxnet_tpu_torch.decoding import attention as tattn
from mxnet_tpu_torch.decoding import quant as tquant


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _pools(kv_dtype, k, v, device):
    if kv_dtype == "int8":
        kq, ks, _ = tquant.quantize_values(k)
        vq, vs, _ = tquant.quantize_values(v)
        kp, vp = tquant.KVPool(kq, ks), tquant.KVPool(vq, vs)
    else:
        dt = torch.bfloat16 if kv_dtype == "bf16" else torch.float32
        kp, vp = tquant.KVPool(k.to(dt)), tquant.KVPool(v.to(dt))

    def dev(pool):
        return tquant.KVPool(
            pool.data.to(device),
            None if pool.scale is None else pool.scale.to(device))

    return dev(kp), dev(vp)


def _case(device, kv_dtype, bp, b=24, h=16, d=64, p=16, n=256, seed=7):
    """Random rows over a random table (padding past each row's pages ->
    page 0), the last row of length 0, as CUDA tensors."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn(b, h, d, generator=g)
    k = torch.randn(n, p, h, d, generator=g)
    v = torch.randn(n, p, h, d, generator=g)
    table = torch.randint(1, n, (b, bp), generator=g, dtype=torch.int32)
    lengths = torch.randint(1, bp * p + 1, (b,), generator=g,
                            dtype=torch.int32)
    lengths[-1] = 0
    kp, vp = _pools(kv_dtype, k, v, device)
    return (q.to(device), kp, vp, table.to(device), lengths.to(device))


TOL = {"float32": 1e-4, "bf16": 2e-3, "int8": 1e-4}


@pytest.mark.cuda
@pytest.mark.parametrize("bp", [1, 8, 128])
@pytest.mark.parametrize("kv_dtype,atol", [("float32", 1e-4),
                                           ("bf16", 2e-3),
                                           ("int8", 1e-4)])
def test_cuda_kernel_matches_plain(cuda_device, kv_dtype, atol, bp):
    """The serving shape (R = 24, H = 16, D = 64, P = 16) at Bp = 1, 8
    (one chunk: the split kernel writes out) and 128 (16 chunks and the
    merge); each call adds exactly one to the launch counter."""
    args = _case(cuda_device, kv_dtype, bp)
    assert tattn.kernel_instance(args[1].data.dtype, 16, 64, 16)["serving"]
    before = sum(tattn.launch_counts().values())
    out = tattn.paged_attention(*args)
    torch.cuda.synchronize()
    assert sum(tattn.launch_counts().values()) == before + 1
    ref = tattn.paged_attention_plain(*args)
    assert (out - ref).abs().max().item() <= atol


@pytest.mark.cuda
@pytest.mark.parametrize("h,d,p", [(6, 32, 8), (2, 8, 4), (3, 128, 64),
                                   (5, 20, 16)])
@pytest.mark.parametrize("kv_dtype", ["float32", "bf16", "int8"])
def test_cuda_generic_instance_matches_plain(cuda_device, kv_dtype, h, d,
                                             p):
    """Shapes other than the serving one take the generic instance:
    heads that do not fill a head group, 16-, 8- and 4-byte copies, up
    to P = 64 and D = 128; Bp below and above the chunk."""
    for bp in (3, 21):
        args = _case(cuda_device, kv_dtype, bp, b=5, h=h, d=d, p=p, n=64,
                     seed=bp)
        inst = tattn.kernel_instance(args[1].data.dtype, h, d, p)
        assert not inst["serving"]
        before = sum(tattn.launch_counts().values())
        out = tattn.paged_attention(*args)
        torch.cuda.synchronize()
        assert sum(tattn.launch_counts().values()) == before + 1
        ref = tattn.paged_attention_plain(*args)
        assert (out - ref).abs().max().item() <= TOL[kv_dtype], (bp, inst)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 64, 16), (6, 32, 8)])
@pytest.mark.parametrize("kv_dtype", ["float32", "bf16", "int8"])
def test_cuda_batch_invariant(cuda_device, kv_dtype, shape):
    """A row alone, in a full batch, and with its table padded to Bp = 8
    or 128 gives bit-identical output on the card: the chunks are fixed
    and merged in order, whatever Bp and the other rows."""
    h, d, p = shape
    g = torch.Generator(device="cpu").manual_seed(3)
    n = 256
    q = torch.randn(24, h, d, generator=g)
    k = torch.randn(n, p, h, d, generator=g)
    v = torch.randn(n, p, h, d, generator=g)
    kp, vp = _pools(kv_dtype, k, v, cuda_device)
    row_pages = torch.randint(1, n, (8,), generator=g, dtype=torch.int32)
    others = torch.randint(1, n, (23, 128), generator=g, dtype=torch.int32)
    other_lengths = torch.randint(1, 128 * p + 1, (23,), generator=g,
                                  dtype=torch.int32)
    for length in (1, p, 5 * p + 3, 8 * p):
        outs = []
        for bp in (8, 128):
            table = torch.zeros((1, bp), dtype=torch.int32)
            table[0, :8] = row_pages
            for full in (False, True):
                tb, qq = table, q[:1]
                ln = torch.tensor([length], dtype=torch.int32)
                if full:
                    tb = torch.cat([table, others[:, :bp]])
                    ln = torch.cat([ln, other_lengths.clamp(max=bp * p)])
                    qq = q
                out = tattn.paged_attention(
                    qq.to(cuda_device), kp, vp, tb.to(cuda_device),
                    ln.to(cuda_device))
                outs.append(out[0].cpu())
        for o in outs[1:]:
            assert torch.equal(o, outs[0]), length


@pytest.mark.cuda
def test_cuda_refusals(cuda_device):
    """What the kernel does not take raises, and counts no launch: a
    table past MAX_TABLE_PAGES, an empty table, head_dim above 128, a
    page above 64 slots, a head_dim whose bytes are not a multiple of 4,
    a misaligned pool and CPU pages beside CUDA queries."""
    from mxnet_tpu_torch.base import MXNetError

    def call(bp=4, h=2, d=8, p=4, kv="float32", lengths=None, mutate=None):
        g = torch.Generator(device="cpu").manual_seed(0)
        q = torch.randn(1, h, d, generator=g)
        k = torch.randn(4, p, h, d, generator=g)
        kp, vp = _pools(kv, k, k.clone(), cuda_device)
        args = [q.to(cuda_device), kp, vp,
                torch.zeros((1, bp), dtype=torch.int32, device=cuda_device),
                torch.ones(1, dtype=torch.int32, device=cuda_device)]
        if mutate:
            mutate(args)
        return tattn.paged_attention(*args)

    before = tattn.launch_counts()
    with pytest.raises(MXNetError, match="tables of 1 to"):
        call(bp=tattn.MAX_TABLE_PAGES + 1)
    with pytest.raises(MXNetError, match="tables of 1 to"):
        call(bp=0)
    with pytest.raises(MXNetError, match="head_dim"):
        call(d=136)
    with pytest.raises(MXNetError, match="page_size"):
        call(p=65)
    with pytest.raises(MXNetError, match="multiple of 4"):
        call(d=6, kv="int8")

    def misalign(args):
        data = torch.zeros(args[1].data.numel() + 1, device=cuda_device)
        args[1] = tquant.KVPool(data[1:].view(args[1].data.shape))

    with pytest.raises(MXNetError, match="aligned"):
        call(d=16, mutate=misalign)

    def host_pages(args):
        args[2] = tquant.KVPool(args[2].data.cpu())

    with pytest.raises(MXNetError, match="is on"):
        call(mutate=host_pages)
    assert tattn.launch_counts() == before
    call(bp=tattn.MAX_TABLE_PAGES)       # the largest table is taken
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_decoded_model_on_card_matches_host(cuda_device):
    """A small DecodedModel on the card (merged step, prefix hits) gives
    the streams the host run gives, through the kernel."""
    from mxnet_tpu_torch import decoding as dec

    cfg = dec.DecoderConfig(vocab=32, d_model=16, n_layers=2, n_heads=2,
                            d_ff=32, max_len=64)
    params = dec.init_decoder_params(cfg, seed=0)
    prompts = [[5, 6, 7, 8, 9, 10, 11, 12, 3], [5, 6, 7, 8, 9, 10, 11, 12,
                                                4, 4], [9, 2]]
    outs = {}
    for device in ("cpu", cuda_device):
        m = dec.DecodedModel("lm", 1, params, cfg, max_batch=2,
                             page_size=4, num_pages=32,
                             page_buckets=(1, 2, 4), device=device)
        try:
            tattn.reset_launch_counts()
            outs[str(device)] = [m.generate(p, max_new_tokens=6,
                                            timeout=120) for p in prompts]
            snap = m.stats.snapshot()
            launched = tattn.launch_counts()["paged_attention_float"]
            assert launched == (cfg.n_layers * snap["steps"]
                                if device != "cpu" else 0)
            assert snap["traces_since_warmup"] == 0
        finally:
            m.close()
    assert outs["cpu"] == outs[str(cuda_device)]
