"""Training callbacks (mxnet_tpu/callback.py): the BatchEndParam
convention and Speedometer. log_train_metric, the checkpoint callbacks
and ProgressBar wait for a later slice.

Speedometer touches the metric only when a log interval fires, never
per batch, so the device-resident metrics are fetched only then.
"""
from __future__ import annotations

import logging
import time
from collections import namedtuple

BatchEndParam = namedtuple(
    "BatchEndParams", ["epoch", "nbatch", "eval_metric", "locals"]
)


class Speedometer:
    """Batch-end callback reporting throughput (samples/sec) every
    `frequent` batches, interleaved with the current training metric.

    Implemented as a rate meter: a monotonic-clock mark is taken at the
    start of each reporting window; the next report divides the window's
    sample count by the elapsed time. An epoch restart (batch counter
    going backwards) re-arms the meter.

    Sync discipline: the metric is only touched (get_name_value) when a
    log interval actually fires, never per batch — with device-resident
    metrics that's the ONLY point the pending device stats are fetched,
    so the steady-state loop stays sync-free.
    auto_reset=False reports the running epoch average instead of the
    per-window value (and leaves resetting to fit's epoch boundary).
    """

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.auto_reset = auto_reset
        self._mark = None      # perf_counter at window start
        self._prev_batch = -1

    def __call__(self, param):
        if param.nbatch < self._prev_batch:
            self._mark = None  # new epoch
        self._prev_batch = param.nbatch

        if self._mark is None:
            self._mark = time.perf_counter()
            return
        if param.nbatch % self.frequent:
            return

        elapsed = time.perf_counter() - self._mark
        rate = self.frequent * self.batch_size / max(elapsed, 1e-12)
        if param.eval_metric is not None:
            pairs = param.eval_metric.get_name_value()
            if self.auto_reset:
                param.eval_metric.reset()
            for name, value in pairs:
                logging.info(
                    "Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec"
                    "\tTrain-%s=%f",
                    param.epoch, param.nbatch, rate, name, value)
        else:
            logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                         param.epoch, param.nbatch, rate)
        self._mark = time.perf_counter()
