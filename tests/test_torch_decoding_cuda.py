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


# ------------------------------------------------------------ graphs
GRAPH_CFG = dict(vocab=512, d_model=64, n_layers=2, n_heads=4, d_ff=128,
                 max_len=256)


def _graph_engine(device, spec=False):
    """A small engine on the card, warmed (its graphs captured); with
    `spec` a self-draft at K = 3."""
    from mxnet_tpu_torch import decoding as dec

    cfg = dec.DecoderConfig(**GRAPH_CFG)
    params = dec.init_decoder_params(cfg, seed=0)
    kw = dict(draft_params=params, spec_k=3) if spec else {}
    return dec.DecodeEngine(params, cfg, max_batch=4, page_size=16,
                            num_pages=64, page_buckets=(1, 2, 4, 16),
                            prefix_cache=False, device=device,
                            **kw).warmup()


def _live_rows(eng, rows, prompt_len=20, pages=4):
    """`rows` sequences prefilled with prompts of prompt_len tokens; the
    step arrays of their next decode step over a 4-page table."""
    import numpy as np

    tables = [eng.allocator.alloc(pages) for _ in range(rows)]
    rs = np.random.RandomState(3)
    last = []
    for t in tables:
        prompt = rs.randint(2, eng.cfg.vocab, size=prompt_len).tolist()
        last.append(eng.prefill(prompt, t[:2]))
    table = np.asarray(tables, np.int32)
    lengths = np.full((rows,), prompt_len, np.int32)
    samp = (np.arange(rows, dtype=np.uint32) * 977,
            np.asarray([0.0, 0.8, 1.2, 0.5][:rows], np.float32),
            np.asarray([0, 40, 0, 5][:rows], np.int32),
            np.asarray([1.0, 0.95, 0.9, 1.0][:rows], np.float32))
    return (np.asarray(last, np.int32), table, lengths,
            np.ones((rows,), bool)), samp


@pytest.mark.cuda
@pytest.mark.parametrize("spec", [False, True])
@pytest.mark.parametrize("sampled", [False, True])
def test_graph_step_bit_identical_to_eager(cuda_device, spec, sampled):
    """One step of each family replayed from its CUDA graph against the
    same step run eagerly on the same pool state (a step's writes are
    idempotent on equal inputs): equal tokens, and equal pools."""
    import numpy as np

    eng = _graph_engine(cuda_device, spec)
    floor = eng.traces()
    rows, samp = _live_rows(eng, 4)
    if not sampled:
        samp = (samp[0], np.zeros(4, np.float32)) + samp[2:]

    def run():
        if spec:
            return eng.spec_step(*rows, np.ones(4, bool), *samp)
        return (eng.step(*rows, *samp),)

    with eng.eager():
        eager = run()
    pools = [t.clone() for t in (eng._k.data, eng._v.data)]
    graphed = run()
    for a, b in zip(eager, graphed):
        np.testing.assert_array_equal(a, b)
    assert torch.equal(pools[0], eng._k.data)
    assert torch.equal(pools[1], eng._v.data)
    assert eng.traces() == floor


@pytest.mark.cuda
def test_graphs_captured_at_warmup_only(cuda_device):
    """warmup() captures every cell's two graphs (greedy, sampling);
    serving greedy, sampled and speculative requests captures nothing
    more, and the kernel runs n_layers times a decode step."""
    from mxnet_tpu_torch import decoding as dec

    cfg = dec.DecoderConfig(**GRAPH_CFG)
    params = dec.init_decoder_params(cfg, seed=0)
    m = dec.DecodedModel("lm", 1, params, cfg, max_batch=4, page_size=16,
                         num_pages=64, page_buckets=(1, 2, 4, 16),
                         device=cuda_device)
    try:
        counts = m.engine.trace_counts()
        assert all(counts[f"decode@{b}"] == 2 for b in (1, 2, 4, 16))
        tattn.reset_launch_counts()
        outs = [m.generate([5, 6, 7] * k, max_new_tokens=8, timeout=120,
                           sampling=sp)
                for k, sp in ((1, None), (7, {"temperature": 0.8,
                                              "seed": 1}))]
        snap = m.stats.snapshot()
        assert snap["traces_since_warmup"] == 0 and all(outs)
        assert tattn.launch_counts()["paged_attention_float"] \
            == cfg.n_layers * snap["steps"]
    finally:
        m.close()
    s = dec.DecodedModel("lm", 2, params, cfg, max_batch=4, page_size=16,
                         num_pages=64, page_buckets=(1, 2, 4, 16),
                         draft="self", spec_k=3, prefix_cache=False,
                         device=cuda_device)
    try:
        assert s.engine.trace_counts()["verify@16"] == 2
        s.generate([5, 6, 7], max_new_tokens=8, timeout=120)
        assert s.stats.snapshot()["traces_since_warmup"] == 0
    finally:
        s.close()


@pytest.mark.cuda
def test_gumbel_on_card_bit_identical_to_cpu(cuda_device):
    import numpy as np

    from mxnet_tpu_torch.decoding import sampling as samp

    seeds = torch.tensor([0, 1, 7, 2 ** 31, 2 ** 32 - 1, 5, 6, 9])
    pos = torch.arange(8) * 251 + 3
    host = samp.gumbel(samp.stream_key(seeds, pos, samp.SALT_TOKEN), 32000)
    card = samp.gumbel(samp.stream_key(seeds.to(cuda_device),
                                       pos.to(cuda_device), samp.SALT_TOKEN),
                       32000)
    np.testing.assert_array_equal(host.numpy().view(np.int32),
                                  card.cpu().numpy().view(np.int32))
    u = samp.accept_uniform(seeds.to(cuda_device), pos.to(cuda_device))
    np.testing.assert_array_equal(
        samp.accept_uniform(seeds, pos).numpy().view(np.int32),
        u.cpu().numpy().view(np.int32))


@pytest.mark.cuda
def test_failed_capture_raises_naming_the_cell(cuda_device, monkeypatch):
    """A step body that syncs the host cannot be captured: the engine
    raises MXNetError naming the cell, and never steps eagerly."""
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.decoding import engine as eng_mod

    body = eng_mod.DecodeEngine._decode_body

    def syncing(self, buf, rows, bucket, sampled):
        out = body(self, buf, rows, bucket, sampled)
        out.sum().item()
        return out

    monkeypatch.setattr(eng_mod.DecodeEngine, "_decode_body", syncing)
    with pytest.raises(MXNetError, match=r"decode@16 cell"):
        _graph_engine(cuda_device)
