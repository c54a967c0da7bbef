"""The input pipeline and the compile tier's rest on the card. Marked
`cuda`: these skip where torch.cuda.is_available() is false. This file
does not import jax, so it runs on a machine with a card and no JAX:

    python -m pytest tests/test_torch_data_cuda.py -q

- DevicePrefetchIter under a busy consumer stream (a long kernel queued
  on it first) hands over 50 batches equal to the host's bit for bit,
  each read on the consumer stream the moment it is handed over.
- With the copy stream held back by a long kernel, the stager has to
  wait for free pinned slots, and no slot is refilled before the event
  of its previous copy has completed; the batches are still the
  host's, bit for bit.
- The bucketed optimizer update (MXNET_TPU_OPT_BUCKET=1) keeps every
  parameter a view into one flat buffer across captured replays (the
  same data_ptr), and trains as the per-parameter step does (1e-6 of
  each tensor's largest magnitude).
- Fused bucketing (MXNET_TPU_BUCKET_FUSED=1) over three buckets: one
  capture a bucket on the first pass and none on the second, one
  parameter and state storage for every bucket, and no parameter byte
  re-pointed or copied at a hand-over.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import data as mxdata
from mxnet_tpu_torch.data import device_prefetch


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return mx.gpu(0)


def _arrays(n=400, shape=(3, 64, 64)):
    rs = np.random.RandomState(0)
    x = rs.randint(0, 256, (n,) + shape).astype(np.float32)
    y = np.arange(n, dtype=np.float32)
    return x, y


def _host_batches(x, y, batch):
    with mx.cpu():
        it = mxdata.make_pipeline(x, batch, label=y, seed=1, prefetch=0,
                                  shard_id=0, num_shards=1)
        out = [(b.data[0].asnumpy().copy(), b.label[0].asnumpy().copy())
               for b in it]
        it.close()
    return out


@pytest.mark.cuda
def test_prefetch_under_a_busy_consumer_stream(card):
    x, y = _arrays()
    want = _host_batches(x, y, 8)
    got = []
    with card:
        it = mxdata.make_pipeline(x, 8, label=y, seed=1, prefetch=2,
                                  shard_id=0, num_shards=1)
        torch.cuda._sleep(200_000_000)     # the consumer stream is busy
        for b in it:
            # read on the consumer stream at once: a batch whose copy
            # had not landed would give other bytes
            got.append((b.data[0]._data.clone(), b.label[0]._data.clone()))
            if len(got) % 10 == 0:
                torch.cuda._sleep(20_000_000)
        it.close()
    torch.cuda.synchronize()
    assert len(got) == len(want) == 50
    for (gd, gl), (wd, wl) in zip(got, want):
        assert gd.device.type == "cuda"
        np.testing.assert_array_equal(gd.cpu().numpy(), wd)
        np.testing.assert_array_equal(gl.cpu().numpy(), wl)


@pytest.mark.cuda
def test_pinned_slot_refilled_only_after_its_copy(card, monkeypatch):
    x, y = _arrays()
    want = _host_batches(x, y, 8)
    refills = []
    orig_buffers = device_prefetch._PinnedRing.buffers

    def buffers(ring, i, tensors):
        # the slot is handed back for refilling: its last copy is done
        # (the consumer clears a slot's event only once it has completed)
        refills.append(ring.events[i] is None and i not in ring.free)
        return orig_buffers(ring, i, tensors)

    orig_issue = device_prefetch.DevicePrefetchIter._issue

    def slow_copies(self, item):
        if self._stream is not None:
            with torch.cuda.stream(self._stream):
                torch.cuda._sleep(20_000_000)   # the copy stream lags
        return orig_issue(self, item)

    monkeypatch.setattr(device_prefetch._PinnedRing, "buffers", buffers)
    monkeypatch.setattr(device_prefetch.DevicePrefetchIter, "_issue",
                        slow_copies)
    with card:
        it = mxdata.make_pipeline(x, 8, label=y, seed=1, prefetch=2,
                                  shard_id=0, num_shards=1)
        got = [(b.data[0]._data.clone(), b.label[0]._data.clone())
               for b in it]
        ring = it.ring_stats()
        it.close()
    torch.cuda.synchronize()
    assert refills and all(refills)
    assert ring["slots"] == 3 and ring["allocations"] == 3
    assert ring["reuse_waits"] > 0      # the wait path really ran
    for (gd, gl), (wd, wl) in zip(got, want):
        np.testing.assert_array_equal(gd.cpu().numpy(), wd)
        np.testing.assert_array_equal(gl.cpu().numpy(), wl)


def _mlp():
    d = mx.sym.Variable("data")
    h = mx.sym.FullyConnected(d, name="fc1", num_hidden=64)
    h = mx.sym.Activation(h, name="relu1", act_type="relu")
    h = mx.sym.FullyConnected(h, name="fc2", num_hidden=10)
    return mx.sym.SoftmaxOutput(h, name="softmax")


def _module(card, bucket, monkeypatch):
    monkeypatch.setenv("MXNET_TPU_OPT_BUCKET", "1" if bucket else "0")
    with card:
        mod = mx.mod.Module(_mlp(), context=card)
        mod.bind(data_shapes=[("data", (16, 32))],
                 label_shapes=[("softmax_label", (16,))])
        mx.random.seed(4)
        mod.init_params(mx.initializer.Uniform(0.2))
        mod.init_optimizer(optimizer="sgd", optimizer_params=(
            ("learning_rate", 0.1), ("momentum", 0.9), ("wd", 1e-3)))
    return mod


@pytest.mark.cuda
def test_bucketed_views_keep_their_storage(card, monkeypatch):
    rs = np.random.RandomState(2)
    batches = [mx.io.DataBatch(
        data=[mx.nd.array(rs.uniform(-1, 1, (16, 32)), ctx=mx.cpu())],
        label=[mx.nd.array(rs.randint(0, 10, 16), ctx=mx.cpu())])
        for _ in range(6)]
    per = _module(card, False, monkeypatch)
    mod = _module(card, True, monkeypatch)
    fs = mod._fused_step
    assert fs._bucket_active and fs.graphed
    ptrs = {n: v.data_ptr() for n, v in fs.params.items()}
    states = {n: s.data_ptr() for n, s in fs.states.items()}
    with card:
        for b in batches:
            for m in (per, mod):
                m.forward_backward(b)
                m.update()
    torch.cuda.synchronize()
    assert fs.captures == 1
    assert {n: v.data_ptr() for n, v in fs.params.items()} == ptrs
    assert {n: s.data_ptr() for n, s in fs.states.items()} == states
    flat = fs._bucket.weight
    lo = flat.data_ptr()
    hi = lo + flat.numel() * flat.element_size()
    assert all(lo <= p < hi for p in ptrs.values())
    a, _ = per.get_params()
    b, _ = mod.get_params()
    for n in a:
        x, y = a[n].asnumpy(), b[n].asnumpy()
        assert np.abs(x - y).max() <= 1e-6 * max(1.0, np.abs(x).max()), n


def _gen(key, vocab=17, d=8, classes=3):
    data = mx.sym.Variable("data")
    emb = mx.sym.Embedding(data, input_dim=vocab, output_dim=d, name="emb")
    pooled = mx.sym.mean(emb, axis=1)
    net = mx.sym.SoftmaxOutput(
        mx.sym.FullyConnected(pooled, num_hidden=classes, name="fc"),
        name="softmax")
    return net, ("data",), ("softmax_label",)


@pytest.mark.cuda
def test_fused_bucket_hand_over_copies_nothing(card, monkeypatch):
    monkeypatch.setenv("MXNET_TPU_BUCKET_FUSED", "1")
    rs = np.random.RandomState(0)
    with card:
        bm = mx.mod.BucketingModule(_gen, default_bucket_key=9,
                                    context=card)
        bm.bind(data_shapes=[("data", (8, 9))],
                label_shapes=[("softmax_label", (8,))])
        mx.random.seed(5)
        bm.init_params(mx.initializer.Xavier())
        bm.init_optimizer(optimizer="sgd", optimizer_params=(
            ("learning_rate", 0.2), ("momentum", 0.9)))

        def batch(t):
            return mx.io.DataBatch(
                data=[mx.nd.array(rs.randint(0, 17, (8, t)), ctx=mx.cpu())],
                label=[mx.nd.array(rs.randint(0, 3, 8), ctx=mx.cpu())],
                bucket_key=t, provide_data=[("data", (8, t))],
                provide_label=[("softmax_label", (8,))])

        def one_pass():
            for t in (4, 6, 9, 4, 6, 9):
                bm.forward(batch(t))
                bm.backward()
                bm.update()
            torch.cuda.synchronize()
            return {k: m._fused_step.captures
                    for k, m in bm._buckets.items()}

        first = one_pass()
        adopted = sum(m._fused_step.adopted_bytes
                      for m in bm._buckets.values())
        second = one_pass()
    assert first == {4: 1, 6: 1, 9: 1}
    assert second == first
    assert sum(m._fused_step.adopted_bytes
               for m in bm._buckets.values()) == adopted
    owner = bm._buckets[bm._state_owner]._fused_step
    assert owner._t == 12
    for m in bm._buckets.values():
        fs = m._fused_step
        for n, v in owner.params.items():
            assert fs.params[n].data_ptr() == v.data_ptr(), n
