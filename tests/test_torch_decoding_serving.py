"""The decode-serving slice of mxnet_tpu_torch end to end on the CPU:
the same request script through the JAX package's `DecodedModel` and
the port's gives token-for-token equal greedy streams (shared prompt
prefixes take the merged ragged tail rows; the pool is small enough to
force preemptions), equal to dense greedy decoding and with equal
page-level bookkeeping; plus the port's own serving contract — device
rule, import rule, stats keys, zero steady-state traces, the one option
still refused (ring-attention prefill), and pool-preserving probes."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mxnet_tpu import decoding as jdec
from mxnet_tpu_torch import decoding as tdec
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serving import ServingError
from mxnet_tpu_torch.telemetry import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CFG_KW = dict(vocab=32, d_model=16, n_layers=2, n_heads=2, d_ff=32,
              max_len=64)
JCFG = jdec.DecoderConfig(**CFG_KW)
TCFG = tdec.DecoderConfig(**CFG_KW)
PARAMS = tdec.init_decoder_params(TCFG, seed=0)
MODEL_KW = dict(max_batch=6, page_size=4, num_pages=32,
                page_buckets=(1, 2, 4, 8), max_tokens=12, queue_cap=64)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for var in list(os.environ):
        if var.startswith("MXNET_DECODE_"):
            monkeypatch.delenv(var, raising=False)
    yield


def _script():
    """Prompts sharing 8- and 12-token prefixes (prefix-cache hits with
    uncached tails) plus unrelated ones; more live tokens than the
    31-page pool holds, so sequences are preempted and readmitted."""
    rs = np.random.RandomState(12)
    shared = rs.randint(2, 32, size=12).tolist()
    jobs = []
    for i in range(9):
        if i % 3 == 2:
            prompt = rs.randint(2, 32, size=int(rs.randint(8, 16))).tolist()
        else:
            cut = 8 if i % 2 else 12
            tail = rs.randint(2, 32, size=int(rs.randint(1, 7))).tolist()
            prompt = shared[:cut] + tail
        jobs.append((prompt, int(rs.randint(12, 19)), i % 2))
    return jobs


def _serve(make):
    """Submit the whole script before the scheduler starts, so both
    packages admit in the same order, then serve it."""
    m = make(warmup=False)
    try:
        futs = [m.submit(p, max_new_tokens=n, priority=pr)
                for p, n, pr in _script()]
        m.warmup()
        outs = [f.result(240) for f in futs]
        snap = m.stats.snapshot()
        alloc = m.engine.allocator
        state = (alloc.stats(), list(alloc._free), list(alloc._refs),
                 m.scheduler.cache.cached_prefixes())
        return outs, snap, state
    finally:
        m.close()


@pytest.fixture(scope="module")
def served():
    jax_run = _serve(lambda **kw: jdec.DecodedModel(
        "lm", 1, PARAMS, JCFG, **MODEL_KW, **kw))
    torch_run = _serve(lambda **kw: tdec.DecodedModel(
        "lm", 1, PARAMS, TCFG, device="cpu", **MODEL_KW, **kw))
    return jax_run, torch_run


def _dense_greedy(prompt, n):
    model = tdec.params_from_jax(PARAMS, TCFG, "cpu")
    toks, out = list(prompt), []
    for _ in range(n):
        nxt = int(tdec.reference_logits(model, [toks], TCFG)[0, -1]
                  .argmax())
        if nxt == TCFG.eos_id:
            break
        out.append(nxt)
        toks.append(nxt)
    return out


def test_streams_equal_jax_decoded_model(served):
    (j_outs, j_snap, _), (t_outs, t_snap, _) = served
    assert t_outs == j_outs
    # the script exercises what it claims to
    assert t_snap["prefix_hits"] > 0 and t_snap["preemptions"] > 0
    assert t_snap["readmissions"] == t_snap["preemptions"]
    assert t_snap["traces_since_warmup"] == 0
    assert t_snap["completed"] == len(_script())


def test_streams_equal_dense_greedy(served):
    _, (t_outs, _, _) = served
    cap = MODEL_KW["page_buckets"][-1] * MODEL_KW["page_size"]
    for (prompt, n, _), out in zip(_script(), t_outs):
        # a sequence that fills its largest bucket stops ("length")
        assert out == _dense_greedy(prompt, min(n, cap + 1 - len(prompt)))


def test_page_bookkeeping_equal_jax(served):
    (_, j_snap, j_state), (_, t_snap, t_state) = served
    assert t_state == j_state
    for key in ("prefix_hits", "prefix_misses", "prefix_pages_reused",
                "prefix_evictions", "prefix_cached_pages", "preemptions",
                "readmissions", "prefills", "prefill_tokens",
                "decode_tokens", "steps", "pages_allocated",
                "free_low_watermark", "kv_bytes_per_token",
                "pool_capacity_tokens"):
        assert t_snap[key] == j_snap[key], key


def test_stats_keys_and_warmup_grid_equal_jax(served):
    (_, j_snap, _), (_, t_snap, _) = served
    assert sorted(t_snap) == sorted(j_snap)
    m = tdec.DecodedModel("lm", 2, PARAMS, TCFG, device="cpu",
                          **MODEL_KW)
    try:
        assert m.engine.trace_counts() == {
            "copy_page": 1, "prefill@4": 1, "prefill@8": 1,
            "prefill@16": 1, "prefill@32": 1, "decode@1": 1,
            "decode@2": 1, "decode@4": 1, "decode@8": 1}
        assert "lm:2" in tdec.decoding_stats()
    finally:
        m.close()
    assert "lm:2" not in tdec.decoding_stats()


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_quantized_pools_serve_and_probe(kv_dtype):
    prompt = [5, 9, 11, 2, 30, 7, 3]
    res = tdec.quant_parity_probe(
        PARAMS, TCFG, prompt, max_new=8, kv_dtype=kv_dtype, page_size=4,
        num_pages=16, page_buckets=(1, 2, 4), device="cpu")
    assert res["retraces"] == 0 and res["positions_compared"] == 8
    assert res["top1_agreement"] >= 0.75
    assert res["tokens"] == _dense_greedy(prompt, 8)[:len(res["tokens"])]
    jres = jdec.quant_parity_probe(
        PARAMS, JCFG, prompt, max_new=8, kv_dtype=kv_dtype, page_size=4,
        num_pages=16, page_buckets=(1, 2, 4))
    assert res["kv_pool_capacity_ratio"] == jres["kv_pool_capacity_ratio"]
    assert res["tokens"] == jres["tokens"]


def test_probe_logits_leaves_pools_untouched():
    eng = tdec.DecodeEngine(PARAMS, TCFG, max_batch=2, page_size=4,
                            num_pages=16, page_buckets=(1, 2),
                            prefix_cache=False, kv_dtype="int8",
                            device="cpu").warmup()
    table = eng.allocator.alloc(2)
    eng.prefill([5, 6, 7, 8, 9], table)
    before = [t.clone() for t in (eng._k.data, eng._k.scale, eng._v.data,
                                  eng._v.scale)]
    lg = eng.probe_logits(np.asarray([3, 0], np.int32),
                          np.asarray([table, [0, 0]], np.int32),
                          np.asarray([5, 0], np.int32),
                          np.asarray([True, False]))
    after = (eng._k.data, eng._k.scale, eng._v.data, eng._v.scale)
    for a, b in zip(before, after):
        assert torch.equal(a, b)
    assert lg.shape == (2, TCFG.vocab) and np.isfinite(lg).all()
    # the same step for real writes position 5 and gives the same argmax
    nxt = eng.step([3, 0], np.asarray([table, [0, 0]], np.int32), [5, 0],
                   [True, False])
    assert int(nxt[0]) == int(lg[0].argmax())
    assert not torch.equal(before[0], eng._k.data)


def test_copy_page_moves_data_and_scales():
    eng = tdec.DecodeEngine(PARAMS, TCFG, max_batch=1, page_size=4,
                            num_pages=8, page_buckets=(1, 2),
                            prefix_cache=False, kv_dtype="int8",
                            device="cpu")
    t = eng.allocator.alloc(1)
    eng.prefill([4, 5, 6], t)
    eng.copy_page(t[0], 5)
    for a, b in zip(eng.read_page_raw(1, t[0]), eng.read_page_raw(1, 5)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(eng.read_page(1, t[0]), eng.read_page(1, 5)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == np.float32 and np.abs(a).max() > 0
    assert eng.trace_counts() == {"prefill@4": 1, "copy_page": 1}


def test_device_rule():
    """No device argument means the CUDA device; without one it raises
    instead of running on the host."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(MXNetError, match="no CUDA device"):
        tdec.DecodedModel("lm", 1, PARAMS, TCFG, warmup=False)
    with pytest.raises(MXNetError, match="no CUDA device"):
        tdec.DecodeEngine(PARAMS, TCFG)


def test_import_rule():
    """The port imports neither jax nor mxnet_tpu."""
    code = (
        "import sys, mxnet_tpu_torch, mxnet_tpu_torch.kernels\n"
        "from mxnet_tpu_torch import decoding\n"
        "import mxnet_tpu_torch.symbol, mxnet_tpu_torch.executor\n"
        "import mxnet_tpu_torch.module, mxnet_tpu_torch.passes\n"
        "import mxnet_tpu_torch.models, mxnet_tpu_torch.parallel\n"
        "import mxnet_tpu_torch.models.transformer\n"
        "import mxnet_tpu_torch.ops.parallel_ops\n"
        "import mxnet_tpu_torch.ops.optimizer_ops\n"
        "import mxnet_tpu_torch.rtc, mxnet_tpu_torch.rtc_ops\n"
        "import mxnet_tpu_torch.operator, mxnet_tpu_torch.model\n"
        "import mxnet_tpu_torch.feed_forward\n"
        "import mxnet_tpu_torch.executor_manager\n"
        "bad = [m for m in sys.modules if m == 'jax' or m == 'mxnet_tpu'"
        " or m.startswith(('jax.', 'jaxlib', 'mxnet_tpu.'))]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_out_of_slice_options_raise():
    """Only ring-attention prefill is still refused (and an empty prompt
    is an error); a draft model, the split tail-prefill grid and sampled
    requests are accepted and decode."""
    kw = dict(device="cpu", warmup=False, page_size=4, num_pages=16,
              page_buckets=(1, 2))
    with pytest.raises(MXNetError, match="A.9"):
        tdec.DecodedModel("lm", 1, PARAMS, TCFG, ring_prefill=8, **kw)
    spec = tdec.DecodedModel("lm", 1, PARAMS, TCFG, draft="self",
                             spec_k=2, **kw)
    split = tdec.DecodedModel("lm", 2, PARAMS, TCFG, prefix_cache=True,
                              merged_step=False, **kw)
    try:
        assert spec.engine.spec_enabled
        assert not spec.engine.merged_step_enabled
        assert split.engine.prefix_cache_enabled
        assert not split.engine.merged_step_enabled
        spec.warmup()
        assert spec.generate([3, 4], max_new_tokens=3, timeout=60) \
            == _dense_greedy([3, 4], 3)
        split.warmup()
        sampled = split.generate([3, 4], max_new_tokens=3, timeout=60,
                                 sampling={"temperature": 0.7, "seed": 5})
        assert len(sampled) <= 3
        assert all(0 <= t < TCFG.vocab for t in sampled)
        with pytest.raises(ServingError):
            split.submit([])
    finally:
        spec.close()
        split.close()


def test_streaming_deadline_and_cancel():
    m = tdec.DecodedModel("lm", 1, PARAMS, TCFG, device="cpu", max_batch=2,
                          page_size=4, num_pages=16, page_buckets=(1, 2, 4),
                          max_tokens=8)
    try:
        fut = m.submit([3, 4], max_new_tokens=5)
        streamed = list(fut.stream(timeout=60))
        assert streamed == fut.result(1) == _dense_greedy([3, 4], 5)
        spans = trace.spans_for_trace(fut.trace_id)
        assert {"decoding.submit", "decoding.prefill", "decoding.step",
                "decoding.reply"} <= {s.name for s in spans}
        late = m.submit([3, 4, 5], max_new_tokens=8, deadline_ms=0.001)
        with pytest.raises(tdec.scheduler.DeadlineExceededError):
            late.result(60)
        gone = m.submit([6, 7], max_new_tokens=8)
        assert gone.cancel() in (True, False)
        gone.exception(60)
    finally:
        m.close()
    assert m.engine.allocator.stats()["pages_in_use"] == 0
    m.engine.allocator.check()


def test_numerics_guard_counts_nonfinite_rows(monkeypatch):
    """MXNET_NUMERICS_DECODE_GUARD: each step keeps a device count of
    active rows with non-finite logits (and int8 clips), drained in one
    fetch; healthy weights count nothing."""
    monkeypatch.setenv("MXNET_NUMERICS_DECODE_GUARD", "1")
    bad = dict(PARAMS)
    bad["l1.w2"] = np.full_like(PARAMS["l1.w2"], np.nan)
    for params, rows in ((PARAMS, 0), (bad, 2)):
        eng = tdec.DecodeEngine(params, TCFG, max_batch=2, page_size=4,
                                num_pages=16, page_buckets=(1, 2),
                                prefix_cache=False, kv_dtype="int8",
                                device="cpu").warmup()
        assert eng.drain_guard() == []
        t1, t2 = eng.allocator.alloc(1), eng.allocator.alloc(1)
        eng.step([3, 4], np.asarray([t1, t2], np.int32), [0, 0],
                 [True, True])
        assert eng.drain_guard() == [(rows, 0)]
