"""Single operator registry: an op is a plain function on torch tensors
plus metadata.

Shape and dtype inference need no per-op rules beyond the ops that
create parameter shapes (`shape_infer.py`): the op's own function runs
on "meta" tensors. Gradients come from autograd; ops whose MXNet
gradient differs from the mathematical one (SoftmaxOutput, MakeLoss)
are `torch.autograd.Function`s.

Conventions for the registered fn:
  fn(*inputs, **params) -> Tensor | tuple[Tensor, ...]
  - `params` are already-coerced Python values (see `coerce`).
  - ops with `needs_rng` receive a `rng` kwarg: a torch.Generator on
    the inputs' device, or with needs_rng="key" (the samplers) a key of
    the port's rebuilt JAX key chain (`random.next_key`). Every
    imperative call of such an op advances the chain, as the JAX
    package's `invoke` does.
  - ops with `needs_mode` receive an `is_train` kwarg (Python bool).
  - `capturable=False` marks an op that must synchronise with the host
    (a data-dependent shape, a read of a device value, user Python
    code): a fused train step whose graph holds one runs uncaptured on
    the card and says so by the op's name (parallel/dp_step.py).
  - ops with `aux_names` take the aux tensors as trailing inputs and,
    when `is_train=True`, return extra trailing outputs: the updated
    aux values (BatchNorm's moving mean/var), which the executor writes
    back outside the autograd graph.

This module holds the counterpart of mxnet_tpu/ops/registry.py with the
same names, aliases, coercers and defaults for the ops it registers.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

from ..base import MXNetError


@dataclass
class OpDef:
    name: str
    fn: Callable
    num_outputs: int = 1
    # named inputs for Symbol composition; None => variadic (Concat)
    arg_names: Optional[Sequence[str]] = None
    aux_names: Sequence[str] = ()
    coerce: dict = field(default_factory=dict)
    defaults: dict = field(default_factory=dict)
    needs_rng: bool = False
    needs_mode: bool = False
    aliases: Sequence[str] = ()
    num_outputs_fn: Optional[Callable] = None
    arg_names_fn: Optional[Callable] = None
    no_grad_inputs: Sequence[str] = ()
    capturable: bool = True

    def resolved_num_outputs(self, params) -> int:
        if self.num_outputs_fn is not None:
            return self.num_outputs_fn(params)
        return self.num_outputs

    def normalize_params(self, kwargs: dict) -> dict:
        out = dict(self.defaults)
        for k, v in kwargs.items():
            if v is None:
                continue
            fn = self.coerce.get(k)
            out[k] = fn(v) if fn is not None else v
        return out


_REGISTRY: dict[str, OpDef] = {}

# the JAX package's op names the port does not register yet, each refused
# with the ROADMAP.md item that queues it (tests/test_torch_ndarray.py
# holds the port's names and these to the JAX package's registry); none
# is left
NOT_PORTED = {}


class NotPortedError(MXNetError, AttributeError):
    """A name of the JAX package the port does not have yet. An
    AttributeError too, so `hasattr` and `getattr(..., default)` see
    the name as absent."""


def not_ported_message(name):
    """The refusal for an op name the JAX package registers and the
    port does not (the mixture of experts), or None."""
    return NOT_PORTED.get(name)


def register(name, num_outputs=1, arg_names=None, aux_names=(), coerce=None,
             defaults=None, needs_rng=False, needs_mode=False, aliases=(),
             num_outputs_fn=None, no_grad_inputs=(), arg_names_fn=None,
             capturable=True):
    """Decorator registering a torch function as a framework op."""

    def deco(fn):
        op = OpDef(name=name, fn=fn, num_outputs=num_outputs,
                   arg_names=arg_names, aux_names=tuple(aux_names),
                   coerce=coerce or {}, defaults=defaults or {},
                   needs_rng=needs_rng, needs_mode=needs_mode,
                   aliases=tuple(aliases), num_outputs_fn=num_outputs_fn,
                   no_grad_inputs=tuple(no_grad_inputs),
                   arg_names_fn=arg_names_fn, capturable=capturable)
        if name in _REGISTRY:
            raise MXNetError(f"op {name!r} registered twice")
        _REGISTRY[name] = op
        for alias in op.aliases:
            if alias in _REGISTRY:
                raise MXNetError(f"op alias {alias!r} registered twice")
            _REGISTRY[alias] = op
        return fn

    return deco


def get(name: str) -> OpDef:
    try:
        return _REGISTRY[name]
    except KeyError:
        msg = not_ported_message(name)
        if msg is not None:
            raise NotPortedError(msg) from None
        raise MXNetError(f"unknown op {name!r}") from None


def list_ops() -> list[str]:
    return sorted(_REGISTRY)
