"""Global random state.

Two halves, both under `seed()`:

  host     `np_rng()` is numpy's global RandomState. Initializers and
           iterators draw through it, so under the same `mx.random.seed`
           the port's initial weights are bit-identical to the JAX
           package's.
  device   one `torch.Generator` per device (`generator(device)`), for
           ops that need random bits (Dropout). The JAX package's PRNG
           key chain has no counterpart: its bits cannot be reproduced,
           so random ops are compared by their statistics.
"""
from __future__ import annotations

import threading

import numpy as _np
import torch

_DEFAULT_SEED = 0
_lock = threading.Lock()
_seed = _DEFAULT_SEED
_generators: dict = {}

def np_rng():
    """numpy's global RandomState (steered by `seed()` and by plain
    `np.random.seed`)."""
    return _np.random.mtrand._rand


def seed(seed_state: int):
    """Seed numpy's global generator and every device generator."""
    global _seed
    with _lock:
        _seed = int(seed_state)
        _generators.clear()
    _np.random.seed(int(seed_state) & 0xFFFFFFFF)


def generator(device):
    """The torch.Generator of `device`, created from the current seed
    at first use."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = str(dev)
    with _lock:
        gen = _generators.get(key)
        if gen is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(_seed)
            _generators[key] = gen
    return gen
