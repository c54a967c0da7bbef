"""Checkpointable iterator state — the mid-epoch resume contract.

A pipeline iterator's stream is a pure function of
`(seed, epoch, position)` on a fixed `(shard_id, num_shards)`:
the sampler derives the epoch permutation from `(seed, epoch)` with a
counter-based RNG (sampler.py), and `position` says how many batches
were already consumed. So resume is replay: restore those three numbers
and the iterator yields the EXACT remaining batch sequence,
bit-for-bit. No RNG state blobs, no data re-read, no coordination.

This module is the serialization of that triple: JSON on disk, written
atomically (tmp + os.replace) so a kill mid-write leaves the previous
consistent state, never a torn file — the same crash-safety discipline
as recordio's index flush. The file format is the JAX package's
(mxnet_tpu/data/state.py): a state file written by either package loads
in the other. `checkpoint_sharded` writes them beside a sharded
checkpoint, and `fault.fit_auto_resume` rewrites `<prefix>-data-state.json`
after every batch.

Limitations worth knowing (docs/data.md): parameter checkpoints are
per-epoch while data state is per-step, so an auto-resumed run replays
the current epoch's remaining BATCHES identically but restarts params
from the last epoch boundary; bit-identical end-to-end training
additionally needs step-granular param checkpoints.
"""
from __future__ import annotations

import json
import os

from ..utils.persist import atomic_write_json
from .loader import STATE_FORMAT, DataPipelineError


def is_resumable(data_iter):
    """True when `data_iter` speaks the resume protocol
    (state_dict / load_state_dict / set_epoch)."""
    return (hasattr(data_iter, "state_dict")
            and hasattr(data_iter, "load_state_dict"))


def save_state(data_iter, path):
    """Atomically write `data_iter.state_dict()` as JSON to `path`.

    tmp + fsync + os.replace (utils.persist.atomic_write_json): a
    crash at any instant leaves either the previous state file or the
    new one, never a torn write."""
    state = data_iter.state_dict()
    atomic_write_json(path, state, indent=0)
    return state


def read_state(path):
    """Load + validate a state file; None when absent (fresh run)."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        state = json.load(f)
    if state.get("format") != STATE_FORMAT:
        raise DataPipelineError(
            f"{path}: unrecognized data state format "
            f"{state.get('format')!r}")
    return state


def load_state(data_iter, path):
    """Restore `data_iter` from `path`; returns the state dict, or
    None when no state file exists (iterator left untouched)."""
    state = read_state(path)
    if state is None:
        return None
    data_iter.load_state_dict(state)
    return state
