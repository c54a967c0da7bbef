"""Parallelism-aware ops (mxnet_tpu/ops/parallel_ops.py), on one device.

`RingAttention` keeps the JAX package's name, inputs, defaults and
coercions. The JAX op reads the ambient device mesh: with a mesh axis of
size > 1 it runs ring or Ulysses attention across chips, and otherwise
it computes `_plain_attention`. The port has no mesh yet, so it always
computes `_plain_attention`: einsum, the top-left causal `tril` mask with
-inf, softmax and einsum in stock torch. It does not go through the flash
kernel, and neither does the JAX op.

`MoEFFN` (expert-parallel mixture of experts) is not ported: a graph
that names it raises MXNetError (`registry.NOT_PORTED`).
"""
from __future__ import annotations

import math

import torch

from ..base import coerce_bool, coerce_float
from .registry import register


def _plain_attention(q, k, v, causal, scale):
    """(B, T, H, D) attention; the top-left causal mask with -inf."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        t_q, t_k = q.shape[1], k.shape[1]
        mask = torch.ones((t_q, t_k), dtype=torch.bool,
                          device=q.device).tril()
        logits = logits.masked_fill(~mask, -math.inf)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


@register("RingAttention", arg_names=["query", "key", "value"],
          coerce={"causal": coerce_bool, "scale": coerce_float},
          defaults={"causal": False, "impl": "ring", "axis_name": "seq"},
          aliases=("ring_attention",))
def ring_attention_op(query, key, value, causal=False, impl="ring",
                      axis_name="seq", scale=None):
    """Sequence-parallel attention over (B, T, H, D) inputs; on one
    device (the only case the port has) plain attention."""
    if scale is None:
        scale = 1.0 / math.sqrt(query.shape[-1])
    return _plain_attention(query, key, value, causal, scale)
