"""Sampled decoding, the split tail-prefill grid and drain/resume of
mxnet_tpu_torch's decode tier against the JAX package on the CPU.

The random streams are held bit for bit: keys (fold_in / stream_key),
the Gumbel noise and the accept uniforms are jax 0.9.0's own words.
Functions of logits are held on the same logits: filter_logits' masks
exactly, sampling_dist to 1e-6, sampled tokens equal except at a near
tie (NEAR_TIE_GAP, NEAR_TIE_MASS: sort, softmax and cumsum round
differently from XLA's, so only a top-2 gap of `filtered + g` or a
preceding mass within rounding of top_p can flip a draw). The
multi-query path and the tail prefill agree to 1e-5. Whole request
scripts then go through both packages' DecodedModel with the weights
carried across by params_from_jax (tests/test_decode_prefix_spec.py's
sampling tests replayed), and every stream divergence must be a
counted near tie."""
import os
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu import decoding as jdec
from mxnet_tpu.decoding import attention as jattn
from mxnet_tpu.decoding import model as jmodel
from mxnet_tpu.decoding import sampling as jsamp
from mxnet_tpu_torch import decoding as tdec
from mxnet_tpu_torch.decoding import attention as tattn
from mxnet_tpu_torch.decoding import model as tmodel
from mxnet_tpu_torch.decoding import quant as tquant
from mxnet_tpu_torch.decoding import sampling as tsamp
from mxnet_tpu_torch.serving import ServingError

NEAR_TIE_GAP = 1e-3     # top-2 gap of filtered + g (or of greedy logits)
NEAR_TIE_MASS = 1e-6    # a token's preceding mass within this of top_p

CFG_KW = dict(vocab=32, d_model=16, n_layers=2, n_heads=2, d_ff=32,
              max_len=64)
JCFG = jdec.DecoderConfig(**CFG_KW)
TCFG = tdec.DecoderConfig(**CFG_KW)
PARAMS = tdec.init_decoder_params(TCFG, seed=0)
SEEDS = [0, 1, 7, 12345, 2 ** 31, 2 ** 32 - 1]


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for var in list(os.environ):
        if var.startswith("MXNET_DECODE_"):
            monkeypatch.delenv(var, raising=False)
    yield


def _t(x, dtype=torch.int64):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _words(x):
    return np.asarray(x, np.float32).view(np.int32)


# ------------------------------------------------------------ streams
@pytest.mark.parametrize("seed", SEEDS)
def test_stream_key_words_exact(seed):
    positions = [0, 1, 63, 2047, 65535, 2 ** 31 - 1]
    got = tsamp.stream_key(_t([seed] * len(positions)), _t(positions),
                           _t([s % 4 for s in range(len(positions))]))
    for i, p in enumerate(positions):
        want = np.asarray(jsamp.stream_key(np.uint32(seed), p, i % 4))
        assert [int(got[0][i]), int(got[1][i])] == want.tolist()
    # fold_in alone, from a key that is not a seed key
    key = jax.random.PRNGKey(np.uint32(seed))
    want = np.asarray(jax.random.fold_in(key, 77))
    got = tdec.sampling._random.fold_in((0, seed), 77)
    assert [int(got[0]), int(got[1])] == want.tolist()


def test_gumbel_bit_exact_batched():
    """One vectorised pass over (rows, draws) keys gives each key's
    jax.random.gumbel(key, (V,)) word for word."""
    v = 257
    seeds = _t(SEEDS)[:, None]
    positions = _t([0, 5, 31, 2047, 9, 100])[:, None] + torch.arange(3)
    got = tsamp.gumbel(tsamp.stream_key(seeds, positions, tsamp.SALT_DRAFT),
                       v)
    assert got.shape == (len(SEEDS), 3, v) and got.dtype == torch.float32
    for i, seed in enumerate(SEEDS):
        for j in range(3):
            key = jsamp.stream_key(np.uint32(seed), int(positions[i, j]),
                                   jsamp.SALT_DRAFT)
            want = np.asarray(jax.random.gumbel(key, (v,)))
            np.testing.assert_array_equal(_words(got[i, j]), _words(want))


def test_accept_uniform_bit_exact():
    positions = [1, 2, 3, 500, 2047, 2 ** 20]
    got = tsamp.accept_uniform(_t(SEEDS), _t(positions))
    want = jax.vmap(jsamp.accept_uniform)(
        jnp.asarray(np.array(SEEDS, np.uint64).astype(np.uint32)),
        jnp.asarray(positions, jnp.int32))
    np.testing.assert_array_equal(_words(got), _words(want))


# ------------------------------------------------------------ filters
def _planted(rows=6, v=64, seed=3):
    """Logits with ties planted at each row's k-th value."""
    rs = np.random.RandomState(seed)
    lg = rs.randn(rows, v).astype(np.float32)
    ks = np.array([1, 3, 5, 8, 0, 64], np.int32)[:rows]
    for r, k in enumerate(ks):
        if 0 < k < v:
            order = np.argsort(-lg[r])
            lg[r, order[k:k + 3]] = lg[r, order[k - 1]]   # 3 more ties
    return lg, ks


def _mass_margin(scaled, top_p):
    """Distance of each row's preceding masses to top_p, in float64."""
    desc = -np.sort(-np.asarray(scaled, np.float64), axis=-1)
    e = np.exp(desc - desc[:, :1])
    probs = e / e.sum(axis=-1, keepdims=True)
    before = np.cumsum(probs, axis=-1) - probs
    return np.abs(before - np.asarray(top_p)[:, None]).min(axis=-1)


def test_filter_logits_masks_exact_with_planted_ties():
    lg, ks = _planted()
    ps = np.array([1.0, 0.9, 0.5, 1.0, 0.3, 0.95], np.float32)
    got = tsamp.filter_logits(_t(lg, torch.float32), _t(ks),
                              _t(ps, torch.float32)).numpy()
    want = np.asarray(jax.vmap(jsamp.filter_logits)(lg, ks, ps))
    np.testing.assert_array_equal(got == tsamp.NEG_INF,
                                  want == jsamp.NEG_INF)
    np.testing.assert_array_equal(got, want)
    # every tie at the k-th value survives top-k alone
    only_k = tsamp.filter_logits(_t(lg, torch.float32), _t(ks),
                                 torch.ones(len(ks))).numpy()
    for r, k in enumerate(ks):
        if k:
            kth = np.sort(lg[r])[::-1][k - 1]
            assert (only_k[r] > tsamp.NEG_INF).sum() == (lg[r] >= kth).sum()
    assert (_mass_margin(lg, ps) > NEAR_TIE_MASS).all()


def test_sampling_dist_matches():
    lg, ks = _planted()
    temps = np.array([0.0, 0.7, 1.0, 1.5, 0.0, 0.3], np.float32)
    ps = np.array([1.0, 0.9, 0.5, 1.0, 0.3, 0.95], np.float32)
    got = tsamp.sampling_dist(_t(lg, torch.float32), _t(temps, torch.float32),
                              _t(ks), _t(ps, torch.float32)).numpy()
    want = np.asarray(jax.vmap(jsamp.sampling_dist)(lg, temps, ks, ps))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    for r in np.flatnonzero(temps <= 0):       # greedy rows: exact one-hots
        np.testing.assert_array_equal(got[r], want[r])


def near_tie(logits, seed, position, temperature, top_k, top_p,
             salt=tsamp.SALT_TOKEN):
    """Whether a draw at these logits is within rounding of another
    outcome: the top-2 gap of filtered + g under NEAR_TIE_GAP, or a
    preceding mass within NEAR_TIE_MASS of top_p (greedy: the logits'
    top-2 gap)."""
    lg = torch.as_tensor(np.asarray(logits, np.float32))
    if temperature <= 0:
        top = np.sort(lg.numpy().astype(np.float64))[-2:]
        return top[1] - top[0] < NEAR_TIE_GAP
    scaled = lg / temperature
    filt = tsamp.filter_logits(scaled, top_k, top_p)
    g = tsamp.gumbel(tsamp.stream_key(seed, position, salt), lg.shape[-1])
    top = np.sort((filt + g).numpy().astype(np.float64))[-2:]
    margin = _mass_margin(scaled.numpy()[None], [top_p])[0]
    return top[1] - top[0] < NEAR_TIE_GAP or margin < NEAR_TIE_MASS


def test_sample_token_and_from_dist_match_except_near_ties():
    rs = np.random.RandomState(9)
    n, v = 64, 257
    lg = (rs.randn(n, v) * 2).astype(np.float32)
    seeds = rs.randint(0, 2 ** 32, size=n, dtype=np.uint64).astype(np.uint32)
    pos = rs.randint(0, 4096, size=n).astype(np.int32)
    temps = rs.choice([0.0, 0.5, 0.8, 1.0, 1.7], size=n).astype(np.float32)
    ks = rs.choice([0, 1, 5, 40, v], size=n).astype(np.int32)
    ps = rs.choice([1.0, 0.95, 0.6], size=n).astype(np.float32)
    got = tsamp.sample_token(
        _t(lg, torch.float32), _t(seeds.astype(np.int64)), _t(pos),
        _t(temps, torch.float32), _t(ks), _t(ps, torch.float32)).numpy()
    want = np.asarray(jax.jit(jax.vmap(jsamp.sample_token))(
        lg, seeds, pos, temps, ks, ps))
    ties = [i for i in np.flatnonzero(got != want)
            if near_tie(lg[i], int(seeds[i]), int(pos[i]), temps[i], ks[i],
                        ps[i])]
    assert list(np.flatnonzero(got != want)) == ties, (got, want)
    print(f"sample_token near-tie exceptions: {len(ties)} of {n}")
    # top_k = 1 is the argmax whatever the temperature
    one = tsamp.sample_token(_t(lg, torch.float32), _t(seeds.astype(np.int64)),
                             _t(pos), torch.full((n,), 1.3), torch.ones(n),
                             torch.ones(n))
    np.testing.assert_array_equal(one.numpy(), lg.argmax(-1))

    dist = np.asarray(jax.nn.softmax(lg / 0.9, axis=-1))
    got = tsamp.sample_from_dist(_t(dist, torch.float32),
                                 _t(seeds.astype(np.int64)), _t(pos),
                                 tsamp.SALT_RESAMPLE).numpy()
    want = np.asarray(jax.vmap(
        lambda d, s, p: jsamp.sample_from_dist(d, s, p, jsamp.SALT_RESAMPLE))(
            dist, seeds, pos))
    diff = np.flatnonzero(got != want)
    for i in diff:
        g = tsamp.gumbel(tsamp.stream_key(int(seeds[i]), int(pos[i]),
                                          tsamp.SALT_RESAMPLE), v)
        top = np.sort((np.log(np.maximum(dist[i], 1e-38)) + g.numpy())
                      .astype(np.float64))[-2:]
        assert top[1] - top[0] < NEAR_TIE_GAP, i
    print(f"sample_from_dist near-tie exceptions: {len(diff)} of {n}")


# ------------------------------------------------- multi-query + tail
def _pool_pair(kv, n=24, p=4, h=2, d=8, layers=2, seed=0):
    rs = np.random.RandomState(seed)
    k = rs.randn(layers, n, p, h, d).astype(np.float32)
    v = rs.randn(layers, n, p, h, d).astype(np.float32)
    jk, jv = jdec.quant.make_pool(k.shape, kv), jdec.quant.make_pool(
        v.shape, kv)
    tk = tquant.make_pool(k.shape, kv)
    tv = tquant.make_pool(v.shape, kv)
    pages = np.arange(n).repeat(p)
    slots = np.tile(np.arange(p), n)
    for i in range(layers):
        jk, _ = jdec.quant.kv_scatter(jk, i, pages, slots,
                                      k[i].reshape(n * p, h, d))
        jv, _ = jdec.quant.kv_scatter(jv, i, pages, slots,
                                      v[i].reshape(n * p, h, d))
        tquant.kv_scatter(tk, i, _t(pages), _t(slots),
                          torch.from_numpy(k[i].reshape(n * p, h, d)))
        tquant.kv_scatter(tv, i, _t(pages), _t(slots),
                          torch.from_numpy(v[i].reshape(n * p, h, d)))
    return (jk, jv), (tk, tv)


@pytest.mark.parametrize("kv", ["float32", "bf16", "int8"])
def test_multi_query_attention_matches(kv):
    (jk, jv), (tk, tv) = _pool_pair(kv)
    rs = np.random.RandomState(1)
    b, s, bp = 3, 5, 4
    q = rs.randn(b, s, 2, 8).astype(np.float32)
    table = rs.randint(1, 24, size=(b, bp)).astype(np.int32)
    qpos = np.stack([np.arange(s) + o for o in (0, 7, 11)]).astype(np.int32)
    want = np.asarray(jattn.paged_attention_lax_multi(
        q, jk.layer(1), jv.layer(1), table, qpos))
    got = tattn.paged_attention_multi(
        torch.from_numpy(q), tk.layer(1), tv.layer(1), _t(table, torch.int32),
        _t(qpos)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert tattn.get_multi_kernel("pallas") is tattn.paged_attention_multi


@pytest.mark.parametrize("sampled", [False, True])
def test_tail_prefill_matches(sampled):
    """A prompt prefilled whole, then its tail rerun from `start` over
    the first pass's pages: the port's K/V and first token against the
    JAX package's."""
    p, n_pages = 4, 32
    prompt = [5, 9, 11, 2, 30, 7, 3, 8, 4, 6, 12]
    start = 8
    shape = (TCFG.n_layers, n_pages, p, TCFG.n_heads, TCFG.head_dim)
    jk, jv = jdec.quant.make_pool(shape, "float32"), \
        jdec.quant.make_pool(shape, "float32")
    tk, tv = tquant.make_pool(shape, "float32"), \
        tquant.make_pool(shape, "float32")
    model = tdec.params_from_jax(PARAMS, TCFG)
    jparams = {k: jnp.asarray(v) for k, v in PARAMS.items()}
    ids = np.array([3, 9, 4, 0], np.int32)
    toks = np.zeros((1, 16), np.int32)
    toks[0, :len(prompt)] = prompt
    _, jk, jv = jmodel.prefill_forward(jparams, toks, len(prompt), jk, jv,
                                       ids, cfg=JCFG)
    tmodel.prefill_forward(model, _t(toks), len(prompt), tk, tv, _t(ids),
                           cfg=TCFG)
    samp = (np.uint32(99), np.float32(0.8), np.int32(5),
            np.float32(0.9)) if sampled else (None,) * 4
    tail = np.zeros((1, 4), np.int32)
    tail[0, :len(prompt) - start] = prompt[start:]
    full = np.zeros((16,), np.int32)
    full[:3] = ids[:3]
    jtok, jk2, jv2 = jmodel.tail_prefill_forward(
        jparams, tail, start, len(prompt), jk, jv, full, *samp, cfg=JCFG,
        attn_multi=jattn.paged_attention_lax_multi)
    ttok = tmodel.tail_prefill_forward(
        model, _t(tail), start, len(prompt), tk, tv, _t(full), *samp,
        cfg=TCFG, attn_multi=tattn.paged_attention_multi)
    np.testing.assert_allclose(tk.data.numpy(), np.asarray(jk2.data),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(tv.data.numpy(), np.asarray(jv2.data),
                               atol=1e-5, rtol=0)
    assert int(ttok) == int(jtok)


# ------------------------------------------------------ DecodedModel
MODEL_KW = dict(max_batch=4, page_size=4, num_pages=64,
                page_buckets=(1, 2, 4), max_tokens=12, queue_cap=64)


def _models(**kw):
    merged = dict(MODEL_KW, **kw)
    return (jdec.DecodedModel("lm", 1, PARAMS, JCFG, **merged),
            tdec.DecodedModel("lm", 1, PARAMS, TCFG, device="cpu", **merged))


def _serve(model, jobs):
    futs = [model.submit(p, max_new_tokens=n, sampling=sp, priority=pr)
            for p, n, sp, pr in jobs]
    return [f.result(240) for f in futs]


def explain(jobs, got, want):
    """The divergences of two stream lists, each checked to be a near tie
    of the port's dense logits at its position; returns their count."""
    model = tdec.params_from_jax(PARAMS, TCFG)
    count = 0
    for (prompt, _, sp, _), a, b in zip(jobs, got, want):
        j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            assert len(a) == len(b)
            continue
        ctx = list(prompt) + list(a[:j])
        lg = tdec.reference_logits(model, [ctx], TCFG)[0, -1]
        sp = tdec.SamplingParams.resolve(sp)
        assert near_tie(lg, sp.seed, len(ctx), sp.temperature, sp.top_k,
                        sp.top_p), (prompt, j, a, b)
        count += 1
    print(f"near-tie stream divergences: {count} of {len(jobs)}")
    return count


def _sampled_jobs(n=6, new=10):
    jobs = []
    for i in range(n):
        prompt = np.random.RandomState(i).randint(2, 32, size=6).tolist()
        sp = tdec.SamplingParams(temperature=0.8, top_k=0, top_p=0.9, seed=i)
        jobs.append((prompt, new, sp, i % 2))
    return jobs


def test_sampling_params_validation_and_top_k_one():
    with pytest.raises(ServingError):
        tdec.SamplingParams(top_p=0.0).validate(32)
    with pytest.raises(ServingError):
        tdec.SamplingParams(top_k=-1).validate(32)
    with pytest.raises(ServingError):
        tdec.SamplingParams(temperature=-1.0).validate(32)
    sp = tdec.SamplingParams.resolve(None, seed=7)
    assert sp.seed == 7 and sp.temperature == 0.0
    m = tdec.DecodedModel("lm", 1, PARAMS, TCFG, device="cpu", **MODEL_KW)
    try:
        greedy = m.generate([5, 6, 7], max_new_tokens=6, timeout=60)
        forced = m.generate([5, 6, 7], max_new_tokens=6, timeout=60,
                            sampling=tdec.SamplingParams(
                                temperature=1.0, top_k=1, seed=3))
        assert forced == greedy
        a, b = (m.generate([5, 6, 7], max_new_tokens=6, timeout=60,
                           sampling={"temperature": 0.9, "top_k": 8,
                                     "top_p": 0.95, "seed": 42})
                for _ in range(2))
        assert a == b and all(0 <= t < TCFG.vocab for t in a)
        assert m.stats.snapshot()["traces_since_warmup"] == 0
    finally:
        m.close()


@pytest.fixture(scope="module")
def sampled_runs():
    """The sampled script on a big pool in both packages, and on a pool
    small enough to force preemptions in the port."""
    jobs = _sampled_jobs()
    jm, tm = _models()
    try:
        j_big, t_big = _serve(jm, jobs), _serve(tm, jobs)
        t_snap = tm.stats.snapshot()
    finally:
        jm.close()
        tm.close()
    small = tdec.DecodedModel("lm", 2, PARAMS, TCFG, device="cpu",
                              **dict(MODEL_KW, num_pages=9))
    try:
        t_small = _serve(small, jobs)
        small_snap = small.stats.snapshot()
    finally:
        small.close()
    return jobs, j_big, t_big, t_snap, t_small, small_snap


def test_sampled_streams_equal_jax(sampled_runs):
    jobs, j_big, t_big, t_snap, _, _ = sampled_runs
    assert t_snap["traces_since_warmup"] == 0
    assert explain(jobs, t_big, j_big) == sum(a != b for a, b in
                                              zip(t_big, j_big))


def test_sampled_preempt_readmit_bit_identical(sampled_runs):
    jobs, _, t_big, _, t_small, small_snap = sampled_runs
    assert small_snap["preemptions"] > 0
    assert t_small == t_big
    assert small_snap["traces_since_warmup"] == 0


def _prefix_jobs():
    rs = np.random.RandomState(21)
    shared = rs.randint(2, 32, size=12).tolist()
    jobs = []
    for i in range(8):
        prompt = shared[:8 + 4 * (i % 2)] + rs.randint(
            2, 32, size=1 + i % 3).tolist()
        sp = (tdec.SamplingParams(temperature=0.7, top_k=10, seed=i)
              if i % 3 else None)
        jobs.append((prompt, 8, sp, 0))
    return jobs


def test_split_grid_streams_equal_jax():
    """prefix_cache=True, merged_step=False: hits prefill their tails
    through the tail shapes, in both packages, with equal streams."""
    jobs = _prefix_jobs()
    jm, tm = _models(prefix_cache=True, merged_step=False)
    try:
        assert not tm.engine.merged_step_enabled
        assert any(k.startswith("prefill_tail@")
                   for k in tm.engine.trace_counts())
        j_out, t_out = _serve(jm, jobs), _serve(tm, jobs)
        j_snap, t_snap = jm.stats.snapshot(), tm.stats.snapshot()
    finally:
        jm.close()
        tm.close()
    assert t_snap["prefix_hits"] > 0
    assert t_snap["traces_since_warmup"] == 0
    assert explain(jobs, t_out, j_out) == sum(a != b for a, b in
                                              zip(t_out, j_out))
    for key in ("prefix_hits", "prefix_misses", "prefix_pages_reused",
                "prefills", "prefill_tokens"):
        assert t_snap[key] == j_snap[key], key
    assert tm.engine.trace_counts() == jm.engine.trace_counts()


DRAIN_SAMP = {"temperature": 0.8, "seed": 7}


def test_drain_records_equal_jax():
    """Drained before its loop starts, every queued request hands off
    with the reference's record, key for key."""
    records = []
    for pkg, cfg in ((jdec, JCFG), (tdec, TCFG)):
        kw = dict(MODEL_KW, warmup=False)
        if pkg is tdec:
            kw["device"] = "cpu"
        m = pkg.DecodedModel("lm", 1, PARAMS, cfg, **kw)
        futs = [m.submit([3, 4, 5], max_new_tokens=6, sampling=DRAIN_SAMP,
                         priority=1),
                m.submit([6, 7], max_new_tokens=4, deadline_ms=60000)]
        records.append(m.drain(timeout=0))
        for f in futs:
            with pytest.raises(pkg.RequestHandedOff):
                f.result(10)
        with pytest.raises(pkg.scheduler.ServerClosedError):
            m.submit([3], max_new_tokens=2)
    (jrec, trec) = records
    assert len(trec) == len(jrec) == 2
    for a, b in zip(trec, jrec):
        assert sorted(a) == sorted(b)
        for key in a:
            if key == "deadline_ms":
                assert abs(a[key] - b[key]) < 5000
            else:
                assert a[key] == b[key], key


@pytest.mark.parametrize("sampling", [None, DRAIN_SAMP])
def test_drain_and_resume_lossless(sampling):
    """drain(timeout=0) mid-stream hands the request off; admit_resumed
    on a second model finishes it, its stream emitting only new tokens,
    and the delivered tokens plus the resumed tail are the uninterrupted
    run (bit-identical, sampled or greedy)."""
    kw = dict(MODEL_KW, page_buckets=(1, 2, 4, 8, 16), max_tokens=40)
    prompt = list(range(2, 11))
    ref_m = tdec.DecodedModel("ref", 1, PARAMS, TCFG, device="cpu", **kw)
    try:
        ref = ref_m.generate(prompt, max_new_tokens=30, sampling=sampling,
                             timeout=60)
    finally:
        ref_m.close()
    m1 = tdec.DecodedModel("a", 1, PARAMS, TCFG, device="cpu", **kw)
    m2 = tdec.DecodedModel("b", 1, PARAMS, TCFG, device="cpu", **kw)
    step = m1.engine.step

    def slow_step(*a, **k):     # keep the request in flight
        time.sleep(0.02)
        return step(*a, **k)

    m1.engine.step = slow_step
    try:
        st = m1.stream(prompt, max_new_tokens=30, sampling=sampling,
                       timeout=60)
        pre = [next(st) for _ in range(3)]
        (state,) = m1.drain(timeout=0)
        with pytest.raises(tdec.RequestHandedOff):
            list(st)
        assert state["generated"][:3] == pre
        assert state["position"] == len(state["generated"]) < 30
        fut = m2.admit_resumed(state)
        resumed = list(fut.stream(timeout=60))
        assert state["generated"] + resumed == ref
        assert fut.result(1) == ref
        assert m1.drain(timeout=0) == [state]
    finally:
        m1.close()
        m2.close()


def test_decoding_stats_snapshot_keys_equal_jax():
    """The decodingStats key set is the reference's published surface
    (tests/test_decoding.py::test_decoding_stats_view_shape_pinned)."""
    jm, tm = _models(draft="self", spec_k=2)
    try:
        jm.generate([5, 6, 7], max_new_tokens=3, timeout=60)
        tm.generate([5, 6, 7], max_new_tokens=3, timeout=60)
        jdec.stats._register(jm.key, jm.stats)
        jsnap = jdec.decoding_stats()[jm.key]
        tsnap = tdec.decoding_stats()[tm.key]
        assert sorted(tsnap) == sorted(jsnap)
        for key in ("decode_tokens", "prefills", "prefill_tokens",
                    "spec_proposed", "spec_accepted",
                    "spec_acceptance_rate", "tokens_per_target_step",
                    "traces_since_warmup"):
            assert tsnap[key] == jsnap[key], key
        tdec.reset_decoding_stats()
        assert tdec.decoding_stats()[tm.key]["decode_tokens"] == 0
    finally:
        jdec.stats._unregister(jm.key)
        jm.close()
        tm.close()


def test_decoding_exports_cover_jax_all():
    """Every name of the JAX package's decoding.__all__ is exported,
    but its kernel-selection entries (the port names its own kernel
    entry points: paged_attention, ragged_paged_attention)."""
    own = {"get_kernel", "paged_attention_lax", "paged_attention_pallas"}
    assert set(jdec.__all__) - own <= set(tdec.__all__)
    for name in tdec.__all__:
        assert hasattr(tdec, name), name
