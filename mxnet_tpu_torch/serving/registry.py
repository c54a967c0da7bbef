"""Multi-model registry: (name, version) -> Predictor-backed handle.

The counterpart of mxnet_tpu/serving/registry.py. One process serves
many models. Each `ServedModel` owns a grid of bucket-bound Predictors
that all read one loaded parameter set on the device
(`Predictor.reshaped` binds every cell to the base's arrays), and,
through the exec_cache, share bind plans with any other executor bound
to the same signature.

Warmup is the load-time contract: `ServedModel.warmup()` runs one
forward through every (batch, length) cell, so every cell's bind (its
plan, and its fusion kernels checked at that shape on the card) happens
before the model is marked ready. First requests then never pay a bind,
and steady-state serving builds no plan (stats.traces_since_warmup).

After each cell's warm forward, one more timed forward goes into the
profiling CalibrationStore (`forward[<batch>x<length>]`, and `forward`
for the largest cell) under the graph's canonical digest; a harvest
that fails is counted in `calibration_skipped` and warned about once.

`load_bundle` restores a serving bundle (serving/bundle.py): its binds
restore their plans from the bundle's records and load their kernel
libraries from its blobs, so a fresh process builds no plan and runs no
nvcc.
"""
from __future__ import annotations

import logging
import threading
import time

import numpy as np

from ..predictor import Predictor
from .batcher import BucketSpec, ServingError, default_batch_buckets
from .stats import ServingStats, _register, _unregister

log = logging.getLogger(__name__)
# warn once about a failed calibration harvest; later failures are only
# counted (stats.calibration_skipped)
_calibration_warned = False


class ServedModel:
    """One loaded model version: bucket grid + predictors + stats."""

    def __init__(self, name, version, predictor, spec):
        self.name = name
        self.version = int(version)
        self.spec = spec
        self.stats = ServingStats()
        self._base = predictor
        self._by_bucket = {}
        self._lock = threading.Lock()
        self._warm = False

    @property
    def key(self):
        return f"{self.name}:{self.version}"

    def predictor_for(self, batch, length):
        """The bucket's bound Predictor (bind-on-first-touch; warmup
        touches every cell so serving never binds on the hot path)."""
        cell = (batch, length)
        with self._lock:
            pred = self._by_bucket.get(cell)
            if pred is None:
                shapes = self.spec.input_shapes(batch, length)
                pred = self._base.reshaped(shapes)
                self._by_bucket[cell] = pred
        return pred

    def warmup(self):
        """Bind and run every cell once: one zero-batch forward per grid
        cell, its outputs read back, so every bind (and every fusion
        kernel's check at that cell's shape) happens before the model is
        ready. Idempotent."""
        if self._warm:
            return self
        for batch, length in self.spec.all_buckets():
            pred = self.predictor_for(batch, length)
            for name, shape in self.spec.input_shapes(
                    batch, length).items():
                dtype = pred._input_dtypes.get(name, np.float32)
                pred.set_input(name, np.zeros(shape, dtype=dtype))
            pred.forward()
            for i in range(pred.num_outputs):
                pred.get_output(i)
            self._harvest_calibration(pred, batch, length)
        self._warm = True
        self.stats.mark_warmup_done()
        return self

    def _harvest_calibration(self, pred, batch, length):
        """One timed warm forward of this cell into the CalibrationStore
        under the graph's canonical digest (module docstring)."""
        try:
            from .. import profiling as _profiling

            if not _profiling.profiling_enabled():
                return
            canonical = getattr(pred._exec._compiled, "canonical", None)
            if not canonical:
                return
            t0 = time.perf_counter()
            pred.forward()
            for i in range(pred.num_outputs):
                pred.get_output(i)   # the time includes the compute
            seconds = time.perf_counter() - t0
            store = _profiling.calibration_store()
            dev = pred._ctx.torch_device().type
            platform = "gpu" if dev == "cuda" else dev
            store.record(canonical, platform,
                         f"forward[{batch}x{length}]", seconds)
            if (batch, length) == tuple(self.spec.all_buckets()[-1]):
                store.record(canonical, platform, "forward", seconds)
        except Exception as e:
            self.stats.note_calibration_skipped()
            global _calibration_warned
            if not _calibration_warned:
                _calibration_warned = True
                log.warning(
                    "calibration harvest failed for %s bucket (%d, %d): "
                    "%s — continuing without measured-cost records "
                    "(counted as stats.calibration_skipped; further "
                    "failures are silent)", self.key, batch, length, e)

    def bind_thread(self):
        """Make the model's card the current device of the calling
        thread (the lane's worker runs every forward of the model)."""
        dev = self._base._ctx.torch_device()
        if dev.type == "cuda":
            import torch

            torch.cuda.set_device(dev)

    def infer(self, feed, batch, length):
        """Run one assembled batch; returns the raw padded outputs."""
        pred = self.predictor_for(batch, length)
        for name, arr in feed.items():
            pred.set_input(name, arr)
        pred.forward()
        return [pred.get_output(i) for i in range(pred.num_outputs)]


class ModelRegistry:
    """name -> {version -> ServedModel}; lookups default to the latest
    version (the classic serving-registry convention)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._models: "dict[str, dict[int, ServedModel]]" = {}

    def load(self, name, symbol_json, param_data, input_specs,
             version=1, ctx=None, input_dtypes=None, output_names=None,
             batch_buckets=None, length_buckets=None, max_batch=None,
             pad_value=0.0, warmup=True):
        """Load + (by default) warm one model version.

        input_specs: per-request shapes with the ragged axis as "L"
        (batcher.BucketSpec). The largest (batch, length) cell binds
        the base Predictor; every other cell is a `reshaped` view
        sharing its parameters."""
        from . import config as _cfg

        if max_batch is None:
            max_batch = _cfg.max_batch()
        if batch_buckets is None:
            batch_buckets = _cfg.batch_buckets() or \
                default_batch_buckets(max_batch)
        if length_buckets is None:
            length_buckets = _cfg.length_buckets()
        spec = BucketSpec(input_specs, batch_buckets,
                          length_buckets=length_buckets,
                          pad_value=pad_value)
        base_shapes = spec.input_shapes(spec.batch_buckets[-1],
                                        spec.length_buckets[-1])
        predictor = Predictor(
            symbol_json, param_data, base_shapes, ctx=ctx,
            output_names=output_names, input_dtypes=input_dtypes)
        model = ServedModel(name, version, predictor, spec)
        with self._lock:
            versions = self._models.setdefault(name, {})
            if version in versions:
                raise ServingError(
                    f"model {name!r} version {version} already loaded")
            versions[version] = model
        if warmup:
            model.warmup()
        _register(model.key, model.stats)
        return model

    def load_checkpoint(self, name, prefix, epoch, input_specs,
                        **kwargs):
        """Serve a `save_checkpoint` artifact: `prefix-symbol.json` +
        `prefix-%04d.params` (model.load_checkpoint layout)."""
        from .. import ndarray as nd

        with open(f"{prefix}-symbol.json") as f:
            symbol_json = f.read()
        params = nd.load(f"{prefix}-{epoch:04d}.params")
        return self.load(name, symbol_json, params, input_specs,
                         **kwargs)

    def load_decoder(self, name, params, decoder_cfg, version=1,
                     warmup=True, **kwargs):
        """Load + (by default) warm a continuous-batching decoder
        (decoding.DecodedModel) into the same name/version namespace as
        one-shot models. `params` is a decoder module (its weights are
        used where they are, not copied) or a parameter dict. Warmup
        visits the decoder's whole prefill + decode grid (capturing its
        CUDA graphs on the card), the same readiness contract as
        ServedModel.warmup, and starts its scheduler thread. kwargs:
        DecodedModel knobs (max_batch, page_size, num_pages,
        page_buckets, ring_prefill, queue_cap, max_tokens, draft,
        draft_cfg, spec_k, prefix_cache, merged_step, kv_dtype,
        device)."""
        from ..decoding.scheduler import DecodedModel
        from ..decoding import stats as _dec_stats

        model = DecodedModel(name, version, params, decoder_cfg,
                             warmup=False, **kwargs)
        with self._lock:
            versions = self._models.setdefault(name, {})
            if version in versions:
                raise ServingError(
                    f"model {name!r} version {version} already loaded")
            versions[version] = model
        if warmup:
            model.warmup()
        _dec_stats._register(model.key, model.stats)
        return model

    def load_bundle(self, path, name=None, version=None, warmup=True):
        """Restore a serving bundle (serving.save_bundle) into this
        registry on the current context: a ServedModel or a
        DecodedModel, warm by default, built from the bundle's records
        and kernel libraries (serving/bundle.py)."""
        from .bundle import load_bundle

        return load_bundle(path, self, name=name, version=version,
                           warmup=warmup)

    def get(self, name, version=None):
        with self._lock:
            versions = self._models.get(name)
            if not versions:
                raise ServingError(f"model {name!r} is not loaded")
            if version is None:
                version = max(versions)
            model = versions.get(int(version))
            if model is None:
                raise ServingError(
                    f"model {name!r} has no version {version} "
                    f"(loaded: {sorted(versions)})")
            return model

    def unload(self, name, version=None):
        with self._lock:
            versions = self._models.get(name)
            if not versions:
                raise ServingError(f"model {name!r} is not loaded")
            if version is None:
                removed, self._models[name] = dict(versions), {}
            else:
                if int(version) not in versions:
                    raise ServingError(
                        f"model {name!r} has no version {version}")
                removed = {int(version): versions.pop(int(version))}
            if not self._models[name]:
                del self._models[name]
        for model in removed.values():
            if isinstance(model, ServedModel):
                _unregister(model.key)
            else:  # DecodedModel: stop its scheduler, drop its stats
                from ..decoding import stats as _dec_stats

                _dec_stats._unregister(model.key)
                model.close(drain=False)
        return list(removed.values())

    def models(self):
        """[(name, version), ...] of every loaded model."""
        with self._lock:
            return sorted(
                (name, v)
                for name, versions in self._models.items()
                for v in versions)
