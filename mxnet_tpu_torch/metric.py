"""Evaluation metrics (mxnet_tpu/metric.py): Accuracy, CrossEntropy, the
regression metrics MAE, MSE and RMSE, CompositeEvalMetric, CustomMetric
and `create`.

Every built-in metric is one vectorized statistic over a whole batch.
The training loop's entry point `update_auto` accumulates it on the
device: each batch appends its sum as a device scalar to a pending list
(the instance count is shape arithmetic and lands at once), and `get()`
fetches the pending sums in one transfer and folds them into
`sum_metric` in order, as the JAX package's device metrics do. So the
loop never waits on the card for a metric. `update()` is the host path
(one fetch per batch); both give the same values.
"""
from __future__ import annotations

import numpy as _np
import torch

from .ndarray import NDArray


def update_auto(metric, labels, preds):
    """The training/eval loop's metric entry point (device-resident
    accumulation)."""
    metric.update_device(labels, preds)


def check_label_shapes(labels, preds, shape=0):
    a = len(labels) if shape == 0 else labels.shape
    b = len(preds) if shape == 0 else preds.shape
    if a != b:
        raise ValueError(
            f"Shape of labels {a} does not match shape of predictions {b}")


def _tensor(x, device=None):
    t = x._data if isinstance(x, NDArray) else torch.as_tensor(
        _np.asarray(x))
    return t if device is None else t.to(device, non_blocking=True)


def _host(x):
    return x.asnumpy() if isinstance(x, NDArray) else _np.asarray(x)


class EvalMetric:
    """Accumulator: running (sum_metric, num_inst)."""

    def __init__(self, name, num=None):
        self.name = name
        self.num = num
        self.reset()

    # device statistic: tensor ops returning the batch SUM as a device
    # scalar; None = host update() only
    _stat_device = None

    def _stat(self, label, pred):
        raise NotImplementedError

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            s, n = self._stat(_host(label), _host(pred))
            self.sum_metric += float(s)
            self.num_inst += int(n)

    def supports_device(self):
        cls = type(self)
        return (self.num is None and cls._stat_device is not None
                and cls.update is EvalMetric.update)

    def update_device(self, labels, preds):
        """Append this batch's device-scalar sum; fetched at get()."""
        if not self.supports_device():
            return self.update(labels, preds)
        check_label_shapes(labels, preds)
        with torch.no_grad():
            for label, pred in zip(labels, preds):
                p = _tensor(pred)
                self._pending.append(
                    self._stat_device(_tensor(label, p.device), p))
                self.num_inst += self._count_device(label, pred)

    def _count_device(self, label, pred):
        """This batch's instance count, from shapes alone: one instance
        per label element."""
        return int(_np.prod(label.shape)) if label.shape else 1

    def _drain_pending(self):
        if not self._pending:
            return
        host = torch.stack([p.to(torch.float64)
                            for p in self._pending]).cpu().tolist()
        self._pending = []
        for s in host:
            self.sum_metric += float(s)

    def reset(self):
        self._pending = []
        if self.num is None:
            self.num_inst, self.sum_metric = 0, 0.0
        else:
            self.num_inst = [0] * self.num
            self.sum_metric = [0.0] * self.num

    def get(self):
        self._drain_pending()
        if self.num is None:
            val = (self.sum_metric / self.num_inst if self.num_inst
                   else float("nan"))
            return (self.name, val)
        return ([f"{self.name}_{i}" for i in range(self.num)],
                [s / n if n else float("nan")
                 for s, n in zip(self.sum_metric, self.num_inst)])

    def get_name_value(self):
        names, vals = self.get()
        if not isinstance(names, list):
            names, vals = [names], [vals]
        return list(zip(names, vals))

    def __str__(self):
        return f"EvalMetric: {dict(self.get_name_value())}"


class Accuracy(EvalMetric):
    """Fraction of argmax(pred) == label."""

    def __init__(self):
        super().__init__("accuracy")

    def _stat(self, label, pred):
        if pred.shape != label.shape:
            pred = pred.argmax(axis=1)
        y, yhat = label.astype("int64").ravel(), pred.astype("int64").ravel()
        check_label_shapes(y, yhat, shape=1)
        return (y == yhat).sum(), y.size

    def _stat_device(self, label, pred):
        if pred.shape != label.shape:
            pred = torch.argmax(pred, dim=1)
        y = label.to(torch.int64).reshape(-1)
        yhat = pred.to(torch.int64).reshape(-1)
        check_label_shapes(y, yhat, shape=1)
        return (y == yhat).sum()


class CrossEntropy(EvalMetric):
    """Mean negative log-likelihood of the label row."""

    def __init__(self, eps=1e-8):
        super().__init__("cross-entropy")
        self.eps = eps

    def _stat(self, label, pred):
        y = label.ravel().astype("int64")
        assert y.shape[0] == pred.shape[0]
        picked = pred[_np.arange(y.size), y]
        return -_np.log(picked + self.eps).sum(), y.size

    def _stat_device(self, label, pred):
        y = label.reshape(-1).to(torch.int64)
        assert y.shape[0] == pred.shape[0]
        picked = pred[torch.arange(y.shape[0], device=pred.device), y]
        return -torch.log(picked + self.eps).sum()


class _Regression(EvalMetric):
    """Elementwise-error metrics: one value accumulated per batch."""

    def _error(self, diff):
        raise NotImplementedError

    def _error_device(self, diff):
        raise NotImplementedError

    @staticmethod
    def _align(label, pred):
        """Same-size arrays compare elementwise ((N,) against (N, 1) never
        broadcasts to (N, N)); a per-sample (N,) label against (N, M)
        predictions broadcasts across the columns."""
        if label.shape != pred.shape:
            squeezed = tuple(s for s in label.shape if s != 1)
            p_squeezed = tuple(s for s in pred.shape if s != 1)
            if squeezed == p_squeezed:
                label = label.reshape(pred.shape)
            elif (label.ndim == 1 and pred.ndim > 1
                  and label.shape[0] == pred.shape[0]):
                label = label.reshape(-1, *([1] * (pred.ndim - 1)))
            else:
                raise ValueError(
                    f"regression metric: label shape {tuple(label.shape)} "
                    f"incompatible with pred shape {tuple(pred.shape)}")
        return label

    def _stat(self, label, pred):
        label = self._align(label, pred)
        return self._error(label - pred), 1

    def _stat_device(self, label, pred):
        label = self._align(label, pred)
        return self._error_device(label - pred)

    def _count_device(self, label, pred):
        return 1


class MAE(_Regression):
    def __init__(self):
        super().__init__("mae")

    def _error(self, diff):
        return _np.abs(diff).mean()

    def _error_device(self, diff):
        return diff.abs().mean()


class MSE(_Regression):
    def __init__(self):
        super().__init__("mse")

    def _error(self, diff):
        return _np.square(diff).mean()

    def _error_device(self, diff):
        return diff.square().mean()


class RMSE(_Regression):
    def __init__(self):
        super().__init__("rmse")

    def _error(self, diff):
        return _np.sqrt(_np.square(diff).mean())

    def _error_device(self, diff):
        return diff.square().mean().sqrt()


class CompositeEvalMetric(EvalMetric):
    """Fan updates out to child metrics; reports them all."""

    def __init__(self, **kwargs):
        super().__init__("composite")
        self.metrics = list(kwargs.get("metrics", []))

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        try:
            return self.metrics[index]
        except IndexError:
            raise ValueError(f"Metric index {index} is out of range 0 and "
                             f"{len(self.metrics)}") from None

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def update_device(self, labels, preds):
        for m in self.metrics:
            m.update_device(labels, preds)

    def reset(self):
        self._pending = []
        for m in getattr(self, "metrics", []):
            m.reset()

    def get(self):
        pairs = [m.get() for m in self.metrics]
        return ([n for n, _ in pairs], [v for _, v in pairs])


class CustomMetric(EvalMetric):
    """Wrap feval(label, pred) -> value or (sum, count), on numpy."""

    def __init__(self, feval, name=None, allow_extra_outputs=False):
        if name is None:
            name = feval.__name__
            if "<" in name:
                name = f"custom({name})"
        super().__init__(name)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            check_label_shapes(labels, preds)
        for pred, label in zip(preds, labels):
            out = self._feval(_host(label), _host(pred))
            s, n = out if isinstance(out, tuple) else (out, 1)
            self.sum_metric += s
            self.num_inst += n


_REGISTRY = {
    "acc": Accuracy,
    "accuracy": Accuracy,
    "ce": CrossEntropy,
    "mae": MAE,
    "mse": MSE,
    "rmse": RMSE,
}


def create(metric, **kwargs):
    """Resolve a metric from a name, callable, instance, or list."""
    if callable(metric):
        return CustomMetric(metric)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        out = CompositeEvalMetric()
        for child in metric:
            out.add(create(child, **kwargs))
        return out
    try:
        return _REGISTRY[metric.lower()](**kwargs)
    except Exception:
        raise ValueError(
            f"Metric must be either callable or in {sorted(_REGISTRY)}"
        ) from None
