"""The mixture of experts and the pipeline on the card
(mxnet_tpu_torch/parallel/moe.py, parallel/pipeline.py). Marked `cuda`:
these skip where torch.cuda.is_available() is false. This file does not
import jax:

    python -m pytest tests/test_torch_pipeline_moe_cuda.py -q

- `moe_ffn` on cuda:0 against the host: the gating (the expert each
  token picks, its gate, its queue position, which tokens are dropped)
  bit for bit, since the softmax's exponential is XLA's host function
  computed elementwise in float64 on either device; the outputs within
  1e-5 of their largest magnitude (TF32 off: cuBLAS sums in its own
  order); the index route against the dense einsums on the card.
- `init_moe_params` with no device named puts its weights on the card.
- `pipeline_apply` over a 4-entry mesh of cuda:0 against the stages
  composed by hand microbatch by microbatch (bit for bit), with
  gradients.
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _inputs(t=4096, d=64, f=128, e=8, seed=0):
    from mxnet_tpu_torch.parallel import moe

    rs = np.random.RandomState(seed)
    x = torch.from_numpy(rs.standard_normal((t, d)).astype(np.float32))
    return x, moe.init_moe_params((0, seed), d, f, e, device="cpu")


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_gating_bit_for_bit_and_outputs_on_the_card(card, cf):
    from mxnet_tpu_torch.parallel import moe

    x, p = _inputs()
    logits = x @ p["router_w"]
    cap = moe._capacity(x.shape[0], 8, cf, None)
    got = moe._route(logits.cuda(), 8, cap)
    want = moe._route(logits, 8, cap)
    for g, w in zip(got[:4], want[:4]):
        assert torch.equal(g.cpu(), w), "gating differs"
    out, aux = moe.moe_ffn(x.cuda(), *(p[k].cuda() for k in
                                       ("router_w", "w1", "w2")),
                           capacity_factor=cf)
    ref, raux = moe.moe_ffn(x, p["router_w"], p["w1"], p["w2"],
                            capacity_factor=cf)
    scale = ref.abs().max().item()
    assert (out.cpu() - ref).abs().max().item() <= 1e-5 * scale
    assert abs(aux.item() - raux.item()) <= 1e-6
    plain, _ = moe.moe_ffn_plain(x[:512].cuda(), *(p[k].cuda() for k in (
        "router_w", "w1", "w2")), capacity_factor=cf)
    idx, _ = moe.moe_ffn(x[:512].cuda(), *(p[k].cuda() for k in (
        "router_w", "w1", "w2")), capacity_factor=cf)
    assert torch.equal(idx, plain)


def test_init_moe_params_lands_on_the_card(card):
    """With no device named, the weights go to the current context's
    device, the card; the values are the host draw's."""
    from mxnet_tpu_torch.parallel import moe

    got = moe.init_moe_params((0, 3), 8, 16, 4)
    want = moe.init_moe_params((0, 3), 8, 16, 4, device="cpu")
    for k, v in got.items():
        assert v.is_cuda, k
        assert torch.equal(v.cpu(), want[k]), k


def test_pipeline_apply_on_the_card(card):
    from mxnet_tpu_torch.context import Context
    from mxnet_tpu_torch.parallel import mesh as tmesh
    from mxnet_tpu_torch.parallel.pipeline import pipeline_apply

    rs = np.random.RandomState(1)
    w = torch.tensor(rs.standard_normal((4, 16, 16)).astype(np.float32)
                     * 0.3, device="cuda", requires_grad=True)
    mbs = torch.tensor(rs.standard_normal((6, 3, 16)).astype(np.float32),
                       device="cuda")
    mesh = tmesh.Mesh([Context("gpu", 0)] * 4, ("pipe",))
    out = pipeline_apply(lambda p, x, i: torch.tanh(x @ p), w, mbs, mesh)
    (g,) = torch.autograd.grad(out.square().sum(), w)
    # composed microbatch by microbatch, as the schedule runs them (a
    # matmul over all 6 at once rounds in cuBLAS's own order)
    refs = []
    for m in range(6):
        h = mbs[m]
        for s in range(4):
            h = torch.tanh(h @ w[s])
        refs.append(h)
    ref = torch.stack(refs)
    (rg,) = torch.autograd.grad(ref.square().sum(), w)
    assert torch.equal(out, ref) and torch.allclose(g, rg, rtol=1e-6,
                                                    atol=1e-7)
