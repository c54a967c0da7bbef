"""The port's input pipeline (mxnet_tpu_torch.recordio and .data) against
the JAX package's, on the CPU.

- tests/test_data_pipeline.py replayed on the port (the reference source
  with the module name `mxnet_tpu` read as `mxnet_tpu_torch`, under
  `with mx.cpu():`): the sampler, the loader's order, backpressure,
  shutdown and fast-fail, resume, RecordSource, DevicePrefetchIter's
  parity with its synchronous arm and its accounting, the profiler's
  `inputPipelineStats`, the seeded NDArrayIter and RecordIO's atomic
  index. tests/test_native_io.py's test_uint8_batches_train_fused runs
  the same way (uint8 raw-pixel batches into the fused step). Every
  case of tests/test_io.py is replayed in tests/test_torch_io.py
  already. NOT_REPLAYED names each case left out and the ROADMAP.md
  item that holds it.
- Across packages, bit for bit: epoch orders and shard splits (the
  default membership and a re-keyed one), the loader's batches for any
  worker count, `.rec`/`.idx` bytes (multi-part records with the magic
  in the payload, scalar and array labels, packed PNG and JPEG images),
  state files written by either package and loaded by the other, and
  DevicePrefetchIter's batches; the `inputPipelineStats` keys are
  equal.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import ast  # noqa: E402
import inspect  # noqa: E402
import pathlib  # noqa: E402
import re  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import mxnet_tpu as jmx  # noqa: E402
import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu import data as jdata  # noqa: E402
from mxnet_tpu import recordio as jrec  # noqa: E402
from mxnet_tpu_torch import data as tdata  # noqa: E402
from mxnet_tpu_torch import recordio as trec  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]

# reference test -> the ROADMAP.md item that holds it back (none now)
NOT_REPLAYED = {}
NATIVE_IO_CASES = ("test_uint8_batches_train_fused",)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one intra-op thread: the tensors here are small, and
    beside the suite's other workers more threads only contend (the
    examples' interpreters run the same way)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _replay(test_file, only=None):
    """The namespace of a reference test file run against the port; with
    `only`, just its imports and the named functions (the rest of
    test_native_io.py drives the JAX package's native module, A.11)."""
    path = ROOT / "tests" / test_file
    src = path.read_text()
    if only is not None:
        tree = ast.parse(src)
        keep = [n for n in tree.body
                if isinstance(n, (ast.Import, ast.ImportFrom))
                or (isinstance(n, ast.FunctionDef) and n.name in only)]
        src = "\n\n".join(ast.unparse(n) for n in keep)
    src = re.sub(r"\bmxnet_tpu\b(?!/)", "mxnet_tpu_torch", src)
    # native is A.11: test_native_io.py's cases that use it are not kept
    src = src.replace("from mxnet_tpu_torch import native, recordio",
                      "from mxnet_tpu_torch import recordio")
    ns = {"__name__": f"replay_{path.stem}", "__file__": str(path)}
    exec(compile(src, str(path), "exec"), ns)
    return ns


REPLAYED = {"test_data_pipeline.py": _replay("test_data_pipeline.py"),
            "test_native_io.py": _replay("test_native_io.py",
                                         only=NATIVE_IO_CASES)}


def _cases():
    out = []
    for f, ns in REPLAYED.items():
        for name, fn in ns.items():
            if not (name.startswith("test_") and callable(fn)):
                continue
            if f"{f}::{name}" in NOT_REPLAYED:
                continue
            marks = getattr(fn, "pytestmark", [])
            params = [m for m in marks if m.name == "parametrize"]
            values = params[0].args[1] if params else [None]
            for v in values:
                out.append((f, name, v, f"{f}::{name}"
                            + (f"[{v}]" if params else "")))
    return out


CASES = _cases()


@pytest.mark.parametrize("f,name,value,case", CASES,
                         ids=[c[3] for c in CASES])
def test_replayed(f, name, value, case, tmp_path, monkeypatch):
    fn = REPLAYED[f][name]
    params = inspect.signature(fn).parameters
    kwargs = {k: v for k, v in (("tmp_path", tmp_path),
                                ("monkeypatch", monkeypatch))
              if k in params}
    if value is not None:
        kwargs[next(p for p in params if p not in kwargs)] = value
    with tmx.cpu():
        fn(**kwargs)


def test_not_replayed_names_exist():
    src = (ROOT / "tests" / "test_data_pipeline.py").read_text()
    for key in NOT_REPLAYED:
        assert f"def {key.split('::')[1]}(" in src, key
    assert set(NATIVE_IO_CASES) <= set(REPLAYED["test_native_io.py"])


# ----------------------------------------------------- orders, shards
@pytest.mark.parametrize("seed,epoch,n", [(0, 0, 320), (7, 3, 100),
                                         (2**40 + 5, 11, 1000)])
def test_epoch_orders_and_shards_bit_exact(seed, epoch, n):
    np.testing.assert_array_equal(jdata.epoch_permutation(seed, epoch, n),
                                  tdata.epoch_permutation(seed, epoch, n))
    for shards in (1, 3, 4):
        for sid in range(shards):
            kw = dict(num_samples=n, batch_size=8, seed=seed,
                      shard_id=sid, num_shards=shards)
            js, ts = jdata.ShardedSampler(**kw), tdata.ShardedSampler(**kw)
            js.set_epoch(epoch)
            ts.set_epoch(epoch)
            assert len(js) == len(ts)
            np.testing.assert_array_equal(js.epoch_indices(),
                                          ts.epoch_indices())
            # a re-keyed membership: world 2, three steps consumed
            if shards > 2:
                js.set_membership(sid % 2, 2, consumed=3)
                ts.set_membership(sid % 2, 2, consumed=3)
                np.testing.assert_array_equal(js.epoch_indices(),
                                              ts.epoch_indices())
        np.testing.assert_array_equal(
            jdata.sampler.remainder_stream(seed, epoch, n, shards, 8, 2),
            tdata.sampler.remainder_stream(seed, epoch, n, shards, 8, 2))


def _arrays(n=60, feat=5):
    rs = np.random.RandomState(1)
    return (rs.standard_normal((n, feat)).astype(np.float32),
            rs.randint(0, 10, n).astype(np.float32))


@pytest.mark.parametrize("workers", [1, 3])
def test_loader_batches_bit_exact(workers):
    x, y = _arrays()
    out = []
    for data, mx in ((jdata, jmx), (tdata, tmx)):
        with mx.cpu():
            with data.DataLoader(x, 6, label=y, seed=9, num_workers=workers,
                                 shard_id=1, num_shards=2) as it:
                epochs = []
                for _ in range(2):
                    epochs.append([(b.data[0].asnumpy(),
                                    b.label[0].asnumpy()) for b in it])
                    it.reset()
                out.append(epochs)
    jb, tb = out
    assert len(jb[0]) == len(tb[0]) == 5
    for je, te in zip(jb, tb):
        for (jd, jl), (td, tl) in zip(je, te):
            np.testing.assert_array_equal(jd, td)
            np.testing.assert_array_equal(jl, tl)


def test_device_prefetch_batches_and_state_bit_exact():
    x, y = _arrays()
    out = []
    for data, mx in ((jdata, jmx), (tdata, tmx)):
        with mx.cpu():
            it = data.make_pipeline(x, 6, label=y, seed=4, prefetch=2,
                                    shard_id=0, num_shards=1)
            try:
                first = [it.next() for _ in range(3)]
                state = it.state_dict()
                rest = [b for b in it]
            finally:
                it.close()
        out.append(([b.data[0].asnumpy() for b in first + rest],
                    [b.label[0].asnumpy() for b in first + rest], state))
    (jd, jl, js), (td, tl, ts) = out
    assert js == ts and ts["position"] == 3
    assert len(td) == 10
    for a, b in zip(jd + jl, td + tl):
        np.testing.assert_array_equal(a, b)


# -------------------------------------------------------------- RecordIO
def _records():
    rs = np.random.RandomState(2)
    magic = np.uint32(0xCED7230A).tobytes()
    recs = [b"", b"abc", b"x" * 4, magic, b"pre" + magic + b"post",
            magic + b"mid" + magic + magic + b"end" + magic]
    recs += [rs.bytes(int(rs.randint(1, 300))) for _ in range(12)]
    return recs


@pytest.mark.parametrize("indexed", [False, True])
def test_recordio_files_byte_identical(tmp_path, indexed):
    recs = _records()
    files = {}
    for tag, rec in (("j", jrec), ("t", trec)):
        path = str(tmp_path / f"{tag}.rec")
        idx = str(tmp_path / f"{tag}.idx")
        if indexed:
            with rec.MXIndexedRecordIO(idx, path, "w") as w:
                for i, r in enumerate(recs):
                    w.write_idx(i * 3, r)
        else:
            with rec.MXRecordIO(path, "w") as w:
                for r in recs:
                    w.write(r)
        files[tag] = (path, idx)
    (jp, ji), (tp, ti) = files["j"], files["t"]
    assert open(jp, "rb").read() == open(tp, "rb").read()
    if indexed:
        assert open(ji).read() == open(ti).read()
    # each package reads the other's file
    for rec, (path, idx) in ((trec, files["j"]), (jrec, files["t"])):
        if indexed:
            r = rec.MXIndexedRecordIO(idx, path, "r")
            assert r.keys == [i * 3 for i in range(len(recs))]
            assert [r.read_idx(k) for k in reversed(r.keys)] == \
                recs[::-1]
        else:
            r = rec.MXRecordIO(path, "r")
            assert [r.read() for _ in recs] == recs
            assert r.read() is None
        r.close()


def test_pack_unpack_and_images_byte_identical():
    rs = np.random.RandomState(5)
    for header, payload in (
            (jrec.IRHeader(0, 3.0, 7, 0), b"payload"),
            (jrec.IRHeader(0, np.array([1.0, 0.25, 0.5, 0.75, 1.0],
                                       np.float32), 8, 2), b"\x00" * 9)):
        jp = jrec.pack(header, payload)
        tp = trec.pack(trec.IRHeader(*header), payload)
        assert jp == tp
        (jh, js), (th, ts) = jrec.unpack(tp), trec.unpack(jp)
        assert js == ts == payload
        np.testing.assert_array_equal(np.asarray(jh.label),
                                      np.asarray(th.label))
        assert (jh.flag, jh.id, jh.id2) == (th.flag, th.id, th.id2)
    img = rs.randint(0, 256, (24, 20, 3)).astype(np.uint8)
    for fmt, quality in ((".png", 3), (".jpg", 90)):
        h = jrec.IRHeader(0, 1.0, 3, 0)
        jp = jrec.pack_img(h, img, quality=quality, img_fmt=fmt)
        tp = trec.pack_img(trec.IRHeader(*h), img, quality=quality,
                           img_fmt=fmt)
        assert jp == tp
        _, jimg = jrec.unpack_img(tp)
        _, timg = trec.unpack_img(jp)
        np.testing.assert_array_equal(jimg, timg)
        if fmt == ".png":
            np.testing.assert_array_equal(timg, img)


def test_codec_missing_names_both_libraries(monkeypatch):
    import builtins

    real = builtins.__import__

    def no_codecs(name, *args, **kwargs):
        if name in ("cv2", "PIL") or name.startswith("PIL."):
            raise ImportError(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_codecs)
    with pytest.raises(tmx.MXNetError, match="cv2.*PIL"):
        trec._imdecode_np(b"\x89PNG")
    with pytest.raises(tmx.MXNetError, match="cv2.*PIL"):
        trec._imencode_np(np.zeros((2, 2, 3), np.uint8))


# ------------------------------------------------------------ state files
def _record_source(mod, data, tmp_path, tag):
    idx, rec = str(tmp_path / f"{tag}.idx"), str(tmp_path / f"{tag}.rec")
    with mod.MXIndexedRecordIO(idx, rec, "w") as w:
        for i in range(40):
            row = np.full(4, i, dtype=np.float32)
            w.write_idx(i, row.tobytes() + np.float32(i % 7).tobytes())

    def decode(payload):
        a = np.frombuffer(payload, dtype=np.float32)
        return a[:4], a[4:]

    return data.RecordSource(idx, rec, decode)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_state_files_load_across_packages(tmp_path, writer):
    """A loader's state file written after 3 batches by one package
    resumes the other's loader on exactly the remaining batches."""
    pk = {"jax": (jdata, jrec, jmx), "port": (tdata, trec, tmx)}
    w_data, w_rec, w_mx = pk[writer]
    r_data, r_rec, r_mx = pk["port" if writer == "jax" else "jax"]
    path = str(tmp_path / "state.json")
    with w_mx.cpu():
        src = _record_source(w_rec, w_data, tmp_path, "w")
        with w_data.make_pipeline(src, 4, seed=3, prefetch=2, shard_id=0,
                                  num_shards=1) as it:
            it.set_epoch(1)
            for _ in range(3):
                it.next()
            w_data.save_state(it, path)
            want = [b.data[0].asnumpy()[:, 0].copy() for b in it]
    with r_mx.cpu():
        src = _record_source(r_rec, r_data, tmp_path, "r")
        with r_data.make_pipeline(src, 4, seed=3, prefetch=2, shard_id=0,
                                  num_shards=1) as it:
            state = r_data.load_state(it, path)
            assert state["position"] == 3 and state["epoch"] == 1
            it.set_epoch(1)          # fit's top-of-epoch call: kept
            got = [b.data[0].asnumpy()[:, 0].copy() for b in it]
    assert len(got) == 7
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)


def test_input_pipeline_stats_keys_equal():
    x, y = _arrays()
    keys = []
    for data, mx in ((jdata, jmx), (tdata, tmx)):
        data.reset_input_pipeline_stats()
        with mx.cpu():
            it = data.make_pipeline(x, 6, label=y, seed=1, shard_id=0,
                                    num_shards=1)
            try:
                n = sum(1 for _ in it)
            finally:
                it.close()
        st = data.input_pipeline_stats()
        assert st["batches"] == n == 10
        keys.append(sorted(st))
        data.reset_input_pipeline_stats()
    assert keys[0] == keys[1]
    assert tmx.telemetry.has_view("inputPipelineStats")
    assert sorted(tmx.profiler.input_pipeline_stats()) == keys[1]
