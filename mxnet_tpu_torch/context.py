"""Device contexts.

A `Context` names a device (`cpu(0)`, `gpu(i)`) and maps to a
`torch.device`. `resolve_device(None)` is the card: the package's entry
points run on CUDA unless the caller names another device, and they
refuse to start when no CUDA device is present rather than carrying on
on the CPU. `current_context()` is the innermost `with ctx:` scope, else
`default_context()`, which is `gpu(0)`.

`cpu_pinned()` names the host, as in the JAX package (torch pins the
buffers that need it itself). `num_devices`, `memory_stats` and
`set_memory_fraction` answer for and size the card's caching allocator;
MXNET_TPU_MEM_FRACTION, read at import, is `set_memory_fraction`'s
declarative form.
"""
from __future__ import annotations

import os
import threading

import torch

from .base import MXNetError


class Context:
    """Device handle: device type ('cpu' or 'gpu') and id."""

    devtype2str = {1: "cpu", 2: "gpu", 3: "cpu_pinned"}
    devstr2type = {"cpu": 1, "gpu": 2, "cpu_pinned": 3}

    _default_ctx = threading.local()

    def __init__(self, device_type, device_id: int = 0):
        if isinstance(device_type, Context):
            self.device_typeid = device_type.device_typeid
            self.device_id = device_type.device_id
            return
        if device_type not in Context.devstr2type:
            raise MXNetError(f"unknown device type {device_type!r}")
        self.device_typeid = Context.devstr2type[device_type]
        self.device_id = int(device_id)

    @property
    def device_type(self) -> str:
        return Context.devtype2str[self.device_typeid]

    def torch_device(self):
        """The torch.device; raises for gpu when CUDA is unavailable."""
        if self.device_type in ("cpu", "cpu_pinned"):
            return torch.device("cpu")
        return resolve_device(torch.device("cuda", self.device_id))

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_typeid == other.device_typeid
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_typeid, self.device_id))

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"

    def __enter__(self):
        if not hasattr(Context._default_ctx, "stack"):
            Context._default_ctx.stack = []
        Context._default_ctx.stack.append(self)
        return self

    def __exit__(self, *_):
        Context._default_ctx.stack.pop()


def cpu(device_id=0):
    del device_id  # one host device
    return Context("cpu", 0)


def gpu(device_id=0):
    return Context("gpu", device_id)


def cpu_pinned(device_id=0):
    """Pinned-host context: the host's device, as `cpu()`."""
    del device_id  # one host device
    return Context("cpu_pinned", 0)


def default_context():
    """The card, gpu(0): the port's entry points run there unless the
    caller names another context (the JAX package's default is its
    accelerator, else the host)."""
    return gpu(0)


def current_context():
    """Innermost `with Context(...)` scope, else default_context()."""
    stack = getattr(Context._default_ctx, "stack", None)
    if stack:
        return stack[-1]
    return default_context()


def as_context(device):
    """A Context for a Context, torch.device or device string."""
    if isinstance(device, Context):
        return device
    dev = torch.device(device)
    if dev.type == "cpu":
        return cpu()
    if dev.type == "cuda":
        return gpu(dev.index or 0)
    raise MXNetError(f"no context for device {dev}")


def resolve_device(device=None):
    """The device an entry point runs on: `device` as given (a Context,
    a torch.device or anything torch.device accepts), or the current
    CUDA device when None. Raises MXNetError when CUDA is asked for
    (explicitly or by default) and none is available, or for a card
    index beyond those this process sees."""
    if isinstance(device, Context):
        device = ("cpu" if device.device_type in ("cpu", "cpu_pinned")
                  else torch.device("cuda", device.device_id))
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise MXNetError(
                "no CUDA device is available; pass device='cpu' (or "
                "mx.cpu()) to run on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev.index >= torch.cuda.device_count():
            raise MXNetError(
                f"{dev} is not reachable: this process sees "
                f"{torch.cuda.device_count()} CUDA device(s)")
    return dev


def num_devices(device_type="gpu"):
    """Process-local device count for a device type: the CUDA cards this
    process sees for "gpu", 1 for the host, 0 for "tpu"."""
    if device_type == "gpu":
        return torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
    if device_type in ("cpu", "cpu_pinned"):
        return 1
    if device_type == "tpu":
        return 0
    raise MXNetError(f"unknown device type {device_type!r}")


_MEM_FRACTION = {}


def set_memory_fraction(fraction, preallocate=None):
    """Cap the share of each card's memory this process's caching
    allocator may take (the JAX package's HBM pool knob, the reference's
    MXNET_GPU_MEM_POOL_RESERVE), through
    torch.cuda.set_per_process_memory_fraction. Must run BEFORE the
    first device use in the process; afterwards it raises. The cap is
    applied when CUDA initializes; `preallocate=True` then also reserves
    the capped share in the allocator's cache at once.

    Also reachable via env: MXNET_TPU_MEM_FRACTION (read at import).
    """
    if torch.cuda.is_initialized():
        raise MXNetError(
            "set_memory_fraction must be called before the first "
            "device use (the caching allocator is sized when CUDA "
            "initializes)")
    fraction = float(fraction)
    if not 0.0 < fraction <= 1.0:
        raise MXNetError(f"memory fraction {fraction} is not in (0, 1]")
    first = not _MEM_FRACTION
    _MEM_FRACTION.update(fraction=fraction, preallocate=bool(preallocate))
    if first:
        # at CUDA's lazy initialization, with the latest values
        torch.cuda._lazy_call(_apply_mem_fraction)


def _apply_mem_fraction():
    frac = _MEM_FRACTION["fraction"]
    for i in range(torch.cuda.device_count()):
        torch.cuda.set_per_process_memory_fraction(frac, i)
        if _MEM_FRACTION["preallocate"]:
            total = torch.cuda.get_device_properties(i).total_memory
            block = torch.empty(int(total * frac * 0.98), dtype=torch.uint8,
                                device=torch.device("cuda", i))
            del block   # the block stays in the allocator's cache


def memory_stats(ctx=None):
    """The card's allocator counters under the JAX package's keys:
    `bytes_in_use` (allocated now), `peak_bytes_in_use` (allocated at
    most since the process started or the peak was reset) and
    `bytes_limit` (what the allocator may take: the card's memory times
    the set fraction). {} for a host context, or a card this process
    cannot reach."""
    c = ctx if ctx is not None else current_context()
    c = as_context(c) if not isinstance(c, Context) else c
    if c.device_type != "gpu":
        return {}
    try:
        dev = c.torch_device()
    except MXNetError:
        return {}
    total = torch.cuda.get_device_properties(dev).total_memory
    frac = _MEM_FRACTION.get("fraction", 1.0)
    return {"bytes_in_use": int(torch.cuda.memory_allocated(dev)),
            "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(dev)),
            "bytes_limit": int(total * frac)}


if os.environ.get("MXNET_TPU_MEM_FRACTION") \
        and not torch.cuda.is_initialized():
    set_memory_fraction(float(os.environ["MXNET_TPU_MEM_FRACTION"]))
