"""Device contexts.

A `Context` names a device (`cpu(0)`, `gpu(i)`) and maps to a
`torch.device`. `resolve_device(None)` is the card: the package's entry
points run on CUDA unless the caller names another device, and they
refuse to start when no CUDA device is present rather than carrying on
on the CPU. `current_context()` is the innermost `with ctx:` scope, else
`default_context()`, which is `gpu(0)`.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError


class Context:
    """Device handle: device type ('cpu' or 'gpu') and id."""

    devtype2str = {1: "cpu", 2: "gpu"}
    devstr2type = {"cpu": 1, "gpu": 2}

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
        if self.device_type == "cpu":
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
    (explicitly or by default) and none is available."""
    if isinstance(device, Context):
        device = ("cpu" if device.device_type == "cpu"
                  else torch.device("cuda", device.device_id))
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise MXNetError(
                "no CUDA device is available; pass device='cpu' (or "
                "mx.cpu()) to run on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
