"""Speculative decoding of mxnet_tpu_torch's decode tier against the JAX
package on the CPU: the draft proposer and the verifier on the same
pools, drafts and sampling rows (tokens and emit counts equal), then
tests/test_decode_prefix_spec.py's speculative tests replayed through
both packages' DecodedModel with the weights carried across by
params_from_jax — greedy self-draft and real-draft streams equal to
target-only greedy decoding and to the JAX package's, per-request
opt-out, the prefix cache with pool churn, and sampled speculation.
Every divergence between the packages must be a near tie, counted
(test_torch_decoding_sampling.near_tie)."""
import os
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu import decoding as jdec
from mxnet_tpu.decoding import attention as jattn
from mxnet_tpu.decoding import speculative as jspec
from mxnet_tpu_torch import decoding as tdec
from mxnet_tpu_torch.decoding import attention as tattn
from mxnet_tpu_torch.decoding import quant as tquant
from mxnet_tpu_torch.decoding import speculative as tspec
from mxnet_tpu_torch.serving import ServingError
from test_torch_decoding_sampling import explain


@pytest.fixture(autouse=True, scope="module")
def _own_jax_disk_root(tmp_path_factory):
    """The JAX references build under an empty exec-cache disk root of
    this module's own, with no bundle overlay mounted: a program another
    test left in the worker's shared root (tests/conftest.py) or in a
    bundle it mounted, built for another device layout, is never
    replayed here."""
    from mxnet_tpu import exec_cache_disk as jdisk

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MXNET_EXEC_CACHE_DIR",
                  str(tmp_path_factory.mktemp("jax_exec_cache")))
        mp.setattr(jdisk, "_overlays", [])
        yield


CFG_KW = dict(vocab=32, d_model=16, n_layers=2, n_heads=2, d_ff=32,
              max_len=64)
JCFG = jdec.DecoderConfig(**CFG_KW)
TCFG = tdec.DecoderConfig(**CFG_KW)
PARAMS = tdec.init_decoder_params(TCFG, seed=0)
DRAFT_PARAMS = tdec.init_decoder_params(TCFG, seed=1)   # a real draft
MODEL_KW = dict(max_batch=2, page_size=4, num_pages=32,
                page_buckets=(1, 2, 4), max_tokens=8)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for var in list(os.environ):
        if var.startswith("MXNET_DECODE_"):
            monkeypatch.delenv(var, raising=False)
    yield


def _dense_greedy(prompt, n):
    model = tdec.params_from_jax(PARAMS, TCFG, "cpu")
    toks, out = list(prompt), []
    for _ in range(n):
        nxt = int(tdec.reference_logits(model, [toks], TCFG)[0, -1].argmax())
        if nxt == TCFG.eos_id:
            break
        out.append(nxt)
        toks.append(nxt)
    return out


# ------------------------------------------------- the forward pair
def _filled_pools(seed=0, n=16, p=4):
    """Target-shaped pools with random K/V in every page, in both
    packages."""
    rs = np.random.RandomState(seed)
    shape = (TCFG.n_layers, n, p, TCFG.n_heads, TCFG.head_dim)
    k = rs.randn(*shape).astype(np.float32) * 0.5
    v = rs.randn(*shape).astype(np.float32) * 0.5
    jk, jv = jdec.quant.KVPool(jnp.asarray(k), None), \
        jdec.quant.KVPool(jnp.asarray(v), None)
    tk = tquant.KVPool(torch.from_numpy(k.copy()))
    tv = tquant.KVPool(torch.from_numpy(v.copy()))
    return (jk, jv), (tk, tv)


ROWS = dict(
    last=np.array([5, 9, 3, 7], np.int32),
    table=np.array([[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12],
                    [13, 14, 15, 0]], np.int32),
    lengths=np.array([3, 6, 9, 2], np.int32),
    active=np.array([True, True, True, False]),
    use_draft=np.array([True, False, True, True]),
    seeds=np.array([11, 12, 2 ** 32 - 1, 0], np.uint32),
    temps=np.array([0.0, 0.9, 1.3, 0.7], np.float32),
    top_ks=np.array([0, 8, 0, 3], np.int32),
    top_ps=np.array([1.0, 0.9, 0.95, 1.0], np.float32))


def _t(x, dtype=None):
    x = np.array(x)
    if x.dtype == np.uint32:
        x = x.astype(np.int64)
    return torch.as_tensor(x, dtype=dtype)


@pytest.mark.parametrize("sampled", [True, False])
def test_draft_and_verify_forward_equal_jax(sampled):
    """The draft's K proposals, then the verifier's (tokens_out,
    n_emit) on the same drafts and q distributions, in both packages:
    equal (greedy rows compare the argmax short-cut of a step with no
    sampling row against the JAX package's full rule)."""
    k = 3
    r = dict(ROWS)
    if not sampled:
        r["temps"] = np.zeros_like(r["temps"])
    jparams = {n: jnp.asarray(a) for n, a in PARAMS.items()}
    model = tdec.params_from_jax(PARAMS, TCFG)
    (jk, jv), (tk, tv) = _filled_pools()
    samp = (r["seeds"], r["temps"], r["top_ks"], r["top_ps"])
    tsamp = (_t(r["seeds"]), _t(r["temps"]), _t(r["top_ks"]),
             _t(r["top_ps"]))
    jd, jq, jdk, jdv = jspec.draft_propose_forward(
        jparams, r["last"], jk, jv, r["table"], r["lengths"], r["active"],
        *samp, cfg=JCFG, attn=jattn.paged_attention_lax, k=k)
    td, tq = tspec.draft_propose_forward(
        model, _t(r["last"]), tk, tv, _t(r["table"], torch.int32),
        _t(r["lengths"], torch.int32), _t(r["active"]), *tsamp, cfg=TCFG,
        attn=tattn.paged_attention, k=k, sampled=sampled)
    active = r["active"]
    np.testing.assert_array_equal(td.numpy()[active], np.asarray(jd)[active])
    np.testing.assert_allclose(tk.data.numpy(), np.asarray(jdk.data),
                               atol=1e-5, rtol=0)
    if sampled:
        np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-6,
                                   rtol=0)
    # verify from a fresh copy of the pools, on the JAX package's drafts
    (jk, jv), (tk, tv) = _filled_pools()
    jd = np.asarray(jd)
    jout, jn, jk2, _ = jspec.verify_forward(
        jparams, r["last"], jd, jq, jk, jv, r["table"], r["lengths"],
        r["active"], r["use_draft"], *samp, cfg=JCFG,
        attn_multi=jattn.paged_attention_lax_multi, k=k)
    tout, tn = tspec.verify_forward(
        model, _t(r["last"]), _t(jd).long(),
        torch.from_numpy(np.array(jq)) if sampled else None, tk, tv,
        _t(r["table"], torch.int32), _t(r["lengths"], torch.int32),
        _t(r["active"]), _t(r["use_draft"]), *tsamp, cfg=TCFG,
        attn_multi=tattn.paged_attention_multi, k=k, sampled=sampled)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    jout = np.asarray(jout)
    for row in np.flatnonzero(active):
        n = int(jn[row])
        np.testing.assert_array_equal(tout.numpy()[row, :n], jout[row, :n])
    np.testing.assert_allclose(tk.data.numpy(), np.asarray(jk2.data),
                               atol=1e-5, rtol=0)


# ------------------------------------------------------ DecodedModel
def _pair(**kw):
    merged = dict(MODEL_KW, **kw)
    return (jdec.DecodedModel("lm", 1, PARAMS, JCFG, **merged),
            tdec.DecodedModel("lm", 1, PARAMS, TCFG, device="cpu", **merged))


def _run_both(jobs, **kw):
    """The same request list through both packages, submitted before
    either loop starts; returns (jax outs, port outs, port snapshot,
    port engine)."""
    jm, tm = _pair(warmup=False, **kw)
    try:
        outs = []
        for m in (jm, tm):
            futs = [m.submit(p, max_new_tokens=n, sampling=sp, draft=d)
                    for p, n, sp, d in jobs]
            m.warmup()
            outs.append([f.result(240) for f in futs])
        floor = tm.stats.traces_at_warmup
        snap = tm.stats.snapshot()
        assert tm.engine.traces() == floor
        return outs[0], outs[1], snap, tm.engine
    finally:
        jm.close()
        tm.close()


def _jobs(prompts, n=8, sampling=None, draft=None):
    return [(p, n, sampling, draft) for p in prompts]


def test_self_draft_greedy_parity():
    """Self-draft at K=4: every stream exactly greedy, equal to the JAX
    package's, > 1.5 tokens per target step, zero steady-state
    traces."""
    jobs = _jobs(([5, 6, 7], [3], list(range(2, 11))))
    j_out, t_out, snap, eng = _run_both(jobs, draft="self", spec_k=4,
                                        prefix_cache=False)
    assert eng.spec_enabled and eng.draft_model is eng.model
    for (p, n, _, _), out in zip(jobs, t_out):
        assert out == _dense_greedy(p, n)
    assert t_out == j_out
    assert snap["tokens_per_target_step"] > 1.5
    assert snap["spec_acceptance_rate"] > 0.5
    assert snap["traces_since_warmup"] == 0
    assert {"draft@1", "verify@4", "draft_prefill@16"} <= set(
        eng.trace_counts())


def test_real_draft_greedy_parity():
    """A draft with different weights: acceptance drops, but every
    stream is still the target's greedy chain."""
    jm = jdec.DecodedModel("lm", 1, PARAMS, JCFG, draft=DRAFT_PARAMS,
                           draft_cfg=JCFG, spec_k=4, prefix_cache=False,
                           **MODEL_KW)
    tm = tdec.DecodedModel("lm", 1, PARAMS, TCFG, draft=DRAFT_PARAMS,
                           draft_cfg=TCFG, spec_k=4, prefix_cache=False,
                           device="cpu", **MODEL_KW)
    try:
        assert tm.engine.draft_model is not tm.engine.model
        for prompt in ([5, 6, 7], [4, 9], list(range(2, 11))):
            want = _dense_greedy(prompt, 8)
            assert tm.generate(prompt, max_new_tokens=8, timeout=120) == want
            assert jm.generate(prompt, max_new_tokens=8, timeout=120) == want
        snap = tm.stats.snapshot()
        assert snap["spec_proposed"] > 0
        assert snap["spec_accepted"] == jm.stats.snapshot()["spec_accepted"]
    finally:
        jm.close()
        tm.close()


def test_per_request_opt_out_and_checks():
    m = tdec.DecodedModel("lm", 1, PARAMS, TCFG, draft="self", spec_k=4,
                          prefix_cache=False, device="cpu", **MODEL_KW)
    try:
        ref = _dense_greedy([5, 6, 7], 6)
        assert m.generate([5, 6, 7], max_new_tokens=6, timeout=120,
                          draft=False) == ref
        assert m.stats.snapshot()["spec_proposed"] == 0
        assert m.generate([5, 6, 7], max_new_tokens=6, timeout=120,
                          draft=True) == ref
    finally:
        m.close()
    m2 = tdec.DecodedModel("lm", 1, PARAMS, TCFG, device="cpu", **MODEL_KW)
    try:
        with pytest.raises(ServingError):
            m2.submit([5, 6], draft=True)
    finally:
        m2.close()
    kw = dict(device="cpu", warmup=False, **MODEL_KW)
    with pytest.raises(ServingError, match="unknown draft"):
        tdec.DecodedModel("lm", 1, PARAMS, TCFG, draft="other", **kw)
    with pytest.raises(tdec.PageError, match="vocab"):
        tdec.DecodedModel("lm", 1, PARAMS, TCFG, draft=PARAMS,
                          draft_cfg=tdec.DecoderConfig(
                              **dict(CFG_KW, vocab=16)), **kw)
    with pytest.raises(tdec.PageError, match="max_len"):
        tdec.DecodedModel("lm", 1, PARAMS, TCFG, draft=PARAMS,
                          draft_cfg=tdec.DecoderConfig(
                              **dict(CFG_KW, max_len=32)), **kw)


def test_spec_draft_env_and_spec_k(monkeypatch):
    monkeypatch.setenv("MXNET_DECODE_SPEC_DRAFT", "self")
    monkeypatch.setenv("MXNET_DECODE_SPEC_K", "3")
    m = tdec.DecodedModel("lm", 1, PARAMS, TCFG, device="cpu", warmup=False,
                          **MODEL_KW)
    try:
        assert m.engine.spec_enabled and m.engine.spec_k == 3
    finally:
        m.close()
    monkeypatch.setenv("MXNET_DECODE_SPEC_K", "0")
    m = tdec.DecodedModel("lm", 1, PARAMS, TCFG, device="cpu", warmup=False,
                          **MODEL_KW)
    try:
        assert not m.engine.spec_enabled
    finally:
        m.close()


def test_speculative_with_cache_and_churn_parity():
    """Prefix cache on (so the split tail grid), self-draft at K=2, a
    pool small enough to force eviction/preemption, concurrent mixed
    requests: every output exactly greedy and equal to the JAX
    package's, the pool clean after a cache flush, zero traces."""
    rng = random.Random(0xD1CE)
    shared = [2, 3, 4, 5]
    jobs = []
    for i in range(10):
        p = (shared + [rng.randrange(2, 30)] if i % 2 else
             [rng.randrange(2, 30) for _ in range(rng.randint(1, 9))])
        jobs.append((p, rng.randint(1, 8), None, None))
    kw = dict(max_batch=4, num_pages=16, max_tokens=10, queue_cap=64,
              draft="self", spec_k=2)
    jm, tm = _pair(warmup=False, **kw)
    try:
        assert not tm.engine.merged_step_enabled
        outs = []
        for m in (jm, tm):
            futs = [m.submit(p, max_new_tokens=n) for p, n, _, _ in jobs]
            m.warmup()
            outs.append([f.result(240) for f in futs])
        for (p, n, _, _), out in zip(jobs, outs[1]):
            assert out == _dense_greedy(p, n)
        assert outs[1] == outs[0]
        snap = tm.stats.snapshot()
        assert snap["traces_since_warmup"] == 0
        assert snap["prefix_hits"] > 0
        tm.scheduler.cache.release_all()
        assert tm.engine.allocator.stats()["pages_in_use"] == 0
        tm.engine.allocator.check()
    finally:
        jm.close()
        tm.close()


def test_sampled_speculation_equal_jax():
    """Sampled self-draft and real-draft speculation: the streams finish,
    stay in the vocabulary and equal the JAX package's except at counted
    near ties."""
    sps = [tdec.SamplingParams(temperature=0.8, top_k=8, top_p=0.95,
                               seed=s) for s in range(4)]
    prompts = [[5, 6, 7], [3, 9], [2, 4, 6, 8, 10], [11]]
    jobs = [(p, 8, sp, None) for p, sp in zip(prompts, sps)]
    for draft in ("self", DRAFT_PARAMS):
        j_out, t_out, snap, _ = _run_both(jobs, draft=draft, spec_k=3,
                                          prefix_cache=False)
        assert all(0 < len(o) <= 8 for o in t_out)
        assert all(0 <= t < TCFG.vocab for o in t_out for t in o)
        assert snap["spec_proposed"] > 0
        explain(jobs, t_out, j_out)
