"""Parallelism-aware ops (mxnet_tpu/ops/parallel_ops.py).

`RingAttention` keeps the JAX package's name, inputs, defaults and
coercions, and reads the ambient mesh (`parallel.mesh.use_mesh`, which
the fused step installs) as the JAX op does: with the op's axis in the
mesh at a size > 1 it runs ring or Ulysses attention
(parallel/ring_attention.py: the shards' ring steps on one device in one
process, the ring across processes under tools/launch.py), and otherwise
it computes `_plain_attention`: einsum, the top-left causal `tril` mask
with -inf, softmax and einsum in stock torch. It does not go through the
flash kernel, and neither does the JAX op.

`MoEFFN` (alias `moe_ffn`) keeps the JAX op's inputs, defaults,
coercions and two outputs (the tokens, the aux loss) and reads the
ambient mesh: its `axis_name` axis splits the experts and a `data` axis
across processes keeps the gating global (parallel/moe.py). On meta
tensors (shape inference) it runs no collective. It is registered
`capturable=False`: the index route reads the number of kept tokens on
the host (`nonzero`), so a fused step whose graph holds it runs
uncaptured and says so.
"""
from __future__ import annotations

import math

import torch

from ..base import coerce_bool, coerce_float, coerce_int
from .registry import register


def _ambient_mesh(axis_name):
    from ..parallel import mesh as mesh_mod

    m = mesh_mod.current_mesh()
    if m is not None and axis_name in m.axis_names \
            and m.shape[axis_name] > 1:
        return m
    return None


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
    """Sequence-parallel attention over (B, T, H, D) inputs.

    impl='ring': ring attention over the ambient mesh's `axis_name`;
    impl='ulysses': the head-scatter/seq-gather relayout. Without a
    mesh (or axis size 1) both reduce to plain attention."""
    if scale is None:
        scale = 1.0 / math.sqrt(query.shape[-1])
    m = _ambient_mesh(axis_name)
    if m is None:
        return _plain_attention(query, key, value, causal, scale)
    from ..parallel.ring_attention import ring_attention, ulysses_attention

    fn = ulysses_attention if impl == "ulysses" else ring_attention
    return fn(query, key, value, mesh=m, axis_name=axis_name,
              causal=causal, scale=scale)


@register("MoEFFN", arg_names=["data", "gate_weight", "w1_weight",
                               "w2_weight"],
          coerce={"num_experts": coerce_int, "hidden_size": coerce_int,
                  "capacity_factor": coerce_float},
          defaults={"capacity_factor": 1.25, "axis_name": "expert"},
          num_outputs=2, aliases=("moe_ffn",), capturable=False)
def moe_ffn_op(data, gate_weight, w1_weight, w2_weight, num_experts=0,
               hidden_size=0, capacity_factor=1.25, axis_name="expert"):
    """Top-1-routed mixture-of-experts FFN over (..., D) tokens.

    Outputs: (transformed tokens, load-balancing aux loss). The ambient
    mesh's `axis_name` axis splits the experts across processes, and its
    `data` axis keeps the gating global (parallel/moe.py)."""
    from ..parallel import mesh as mesh_mod
    from ..parallel.moe import moe_ffn

    lead = tuple(data.shape[:-1])
    x = data.reshape((-1, data.shape[-1]))
    out, aux = moe_ffn(
        x, gate_weight, w1_weight, w2_weight,
        capacity_factor=capacity_factor,
        mesh=mesh_mod.current_mesh(), axis_name=axis_name)
    return out.reshape(lead + (data.shape[-1],)), aux
