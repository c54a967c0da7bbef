"""Fault tolerance: checkpoint auto-resume and fault injection
(mxnet_tpu/fault.py).

- `latest_checkpoint(prefix)` finds the newest saved epoch.
- `fit_auto_resume(...)` wraps Module.fit: it resumes parameters and
  epoch from the newest checkpoint and saves every epoch, so a crashed
  or preempted run restarted with the same command continues where it
  left off.
- When `train_data` speaks the resume protocol (mxnet_tpu_torch.data),
  the stream's position is durable too: `<prefix>-data-state.json` is
  rewritten atomically every batch, so a run killed mid-epoch resumes at
  the batch it died on and replays the remaining sequence bit for bit
  (parameters restart from the last epoch boundary). The checkpoint and
  data-state files are the JAX package's formats: a run of either
  package that is killed mid-epoch resumes in the other.
- `FaultInjector` (MXNET_TPU_FAULT_INJECT="epoch:N" or "step:N") raises
  at epoch N / global step N, after the flight recorder's dump.
- "kill:step:N" is the hard form: SIGKILL to the process itself at step
  N, so no `finally`, buffer flush or atexit hook runs, as on a
  preempted host. Surviving it shows that durability came from state
  persisted before the step.
- "nan:step:N[:param]" is the numerics fault (`parse_nan_inject`, read
  by the fused train step when it is built): one gradient is poisoned
  with NaN on the card at step N and the run goes on, for the numerics
  tier's detection and first-bad-op attribution.
"""
from __future__ import annotations

import glob
import os
import re

from . import model as _model
from .base import MXNetError
from .telemetry import flight as _flight


def latest_checkpoint(prefix):
    """Newest saved epoch for `prefix`, or None."""
    pat = re.compile(
        re.escape(os.path.basename(prefix)) + r"-(\d{4})\.params$"
    )
    best = None
    for path in glob.glob(prefix + "-*.params"):
        m = pat.search(os.path.basename(path))
        if m:
            ep = int(m.group(1))
            best = ep if best is None else max(best, ep)
    return best


def data_state_path(prefix):
    """Where fit_auto_resume persists the input-stream position."""
    return prefix + "-data-state.json"


def parse_nan_inject(spec=None):
    """Parse the numerics fault spec 'nan:step:N[:param]' from `spec`
    or MXNET_TPU_FAULT_INJECT. Returns (step, param_or_None), or None
    when the spec is absent or not a nan fault. The 'epoch:N' / 'step:N'
    / 'kill:step:N' specs return None here, and 'nan:...' matches
    neither branch of FaultInjector: the two consumers are disjoint."""
    if spec is None:
        spec = os.environ.get("MXNET_TPU_FAULT_INJECT", "")
    parts = spec.split(":")
    if len(parts) < 3 or parts[0] != "nan" or parts[1] != "step":
        return None
    try:
        step = int(parts[2])
    except ValueError:
        raise MXNetError(f"bad nan fault spec {spec!r}: step must be "
                         "an integer ('nan:step:N[:param]')")
    param = parts[3] if len(parts) > 3 and parts[3] else None
    return (step, param)


class FaultInjector(object):
    """Deterministic crash injection for resilience tests. The spec
    comes from MXNET_TPU_FAULT_INJECT: 'epoch:N' fires after the
    checkpoint of epoch N is durable; 'step:N' fires when the global
    batch counter reaches N (mid-epoch, the hard resume case);
    'kill:step:N' is the no-teardown form, SIGKILL to the process's own
    pid instead of a Python exception. Fires once."""

    def __init__(self, spec=None):
        self.spec = spec if spec is not None else os.environ.get(
            "MXNET_TPU_FAULT_INJECT", ""
        )
        self._steps = 0

    def _parse(self):
        kind, _, val = self.spec.partition(":")
        if kind == "kill":
            # "kill:step:N": the mode is the second field, SIGKILL the
            # delivery. Only step-keyed kills exist: epoch boundaries
            # are durable already, so a kill there tests nothing.
            sub, _, n = val.partition(":")
            if sub != "step":
                raise MXNetError(
                    f"bad kill fault spec {self.spec!r}: expected "
                    "'kill:step:N'")
            return "kill", n
        return kind, val

    def maybe_fail(self, epoch):
        if not self.spec:
            return
        kind, val = self._parse()
        if kind == "epoch" and epoch == int(val):
            # the last spans and a stats snapshot on disk before the
            # crash propagates (MXNET_TELEMETRY_FLIGHT_DIR; no-op off)
            _flight.maybe_dump(f"fault_injector:{self.spec}")
            raise RuntimeError(
                f"[fault-injection] simulated failure at epoch {epoch}"
            )

    def note_step(self):
        """One training batch completed; fires the 'step:N' spec when
        the global counter reaches N. Call AFTER the batch's state is
        durable: the resumed run must not see again the batch that was
        live when the fault hit."""
        self._steps += 1
        if not self.spec:
            return
        kind, val = self._parse()
        if kind == "step" and self._steps == int(val):
            _flight.maybe_dump(f"fault_injector:{self.spec}")
            raise RuntimeError(
                f"[fault-injection] simulated failure at step "
                f"{self._steps}"
            )
        if kind == "kill" and self._steps == int(val):
            # the flight record first: the only artifact a SIGKILLed
            # process leaves behind by choice
            _flight.maybe_dump(f"fault_injector:{self.spec}")
            import signal

            os.kill(os.getpid(), signal.SIGKILL)


def fit_auto_resume(module, train_data, prefix, num_epoch,
                    eval_data=None, fault_injector=None,
                    data_state=True, **fit_kwargs):
    """Module.fit with per-epoch durable checkpoints and automatic
    resume from the newest one. Returns the epoch training ended at.

    `data_state=True` (default) additionally checkpoints the input
    stream every batch when `train_data` has state_dict/load_state_dict
    (mxnet_tpu_torch.data loaders): on restart the loader is wound to
    the exact (epoch, position) it died at before fit begins, so the
    killed epoch's remaining batches replay bit for bit."""
    if fault_injector is None:
        fault_injector = FaultInjector()
    begin_epoch = 0
    arg_params = aux_params = None
    resumed = latest_checkpoint(prefix)
    if resumed is not None:
        _, arg_params, aux_params = _model.load_checkpoint(
            prefix, resumed
        )
        begin_epoch = resumed
    if begin_epoch >= num_epoch:
        return begin_epoch

    injected = fault_injector
    track_data = data_state and hasattr(train_data, "state_dict") \
        and hasattr(train_data, "load_state_dict")
    state_path = data_state_path(prefix)

    if track_data:
        from .data.state import read_state

        st = read_state(state_path)
        # only rewind to saved data state at or ahead of the checkpoint
        # resumed from: state of an older run (a lower epoch) must not
        # drag the stream backwards
        if st is not None and int(st["epoch"]) >= begin_epoch:
            train_data.load_state_dict(st)

    batch_cbs = []
    user_batch_cb = fit_kwargs.pop("batch_end_callback", None)
    if user_batch_cb is not None:
        batch_cbs.extend(user_batch_cb if isinstance(user_batch_cb, list)
                         else [user_batch_cb])

    if track_data:
        from .data.state import save_state

        def data_state_cb(param):
            # durable before note_step can fire: a kill at step N
            # leaves position N on disk, so the resume starts at batch
            # N, consuming none twice and skipping none
            save_state(train_data, state_path)
            injected.note_step()

        batch_cbs.append(data_state_cb)
    elif injected.spec.startswith("step"):
        def step_cb(param):
            injected.note_step()

        batch_cbs.append(step_cb)

    if "numerics" not in fit_kwargs:
        from . import numerics as _numerics
        from . import utils as _utils

        if _utils.getenv("MXNET_NUMERICS"):
            # auto-resumed runs get a run log next to the checkpoints
            # by default: the log's open() writes a resume marker, so
            # one JSONL file tells the whole kill and restart story
            fit_kwargs["numerics"] = _numerics.NumericsMonitor(
                run_log=_utils.getenv("MXNET_NUMERICS_RUNLOG")
                or (prefix + "-runlog.jsonl"))

    def epoch_cb(epoch, symbol, arg, aux):
        _model.save_checkpoint(
            prefix, epoch + 1, symbol, arg or {}, aux or {}
        )
        injected.maybe_fail(epoch + 1)

    module.fit(
        train_data, eval_data=eval_data,
        begin_epoch=begin_epoch, num_epoch=num_epoch,
        arg_params=arg_params, aux_params=aux_params,
        allow_missing=False,
        epoch_end_callback=[epoch_cb],
        batch_end_callback=batch_cbs or None,
        **fit_kwargs,
    )
    return num_epoch
