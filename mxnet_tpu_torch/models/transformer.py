"""Transformer regression tower, as mxnet_tpu/models/transformer.py: the
same signature, node names and JSON.

Each layer is self-attention through the RingAttention op (ring or
Ulysses attention under a mesh with a 'seq' axis, plain attention
otherwise: einsum and softmax, not the flash kernel) and a position-wise
FFN, each added back to its input; the head is a LinearRegressionOutput
against a (B, T, d_model) label. `tp_axis` sets the `sharding` attribute
of the FFN weights (w1 over it on dim 0, w2 on dim 1), which Module reads
under a mesh. `moe_every=k` makes every k-th layer's FFN a MoEFFN of
`num_experts` experts (parallel/moe.py), and the graph's second head is
MakeLoss(sum of the layers' aux losses * moe_aux_weight), as in the JAX
package.

    net = get_transformer(d_model=512, num_heads=8, d_ff=1024,
                          num_layers=4)
    mod = mx.mod.Module(net, label_names=("label",))
"""
from .. import symbol as sym


def _attention(x, d_model, num_heads, name, impl, causal):
    """Multi-head self-attention through the RingAttention op."""
    qkv = sym.FullyConnected(
        x, num_hidden=3 * d_model, flatten=False, no_bias=True,
        name=name + "_qkv")
    q, k, v = sym.SliceChannel(qkv, num_outputs=3, axis=-1,
                               name=name + "_split")
    dh = d_model // num_heads
    to_heads = lambda z, nm: sym.Reshape(  # noqa: E731
        z, shape=(0, 0, num_heads, dh), name=nm)
    attn = sym.RingAttention(
        to_heads(q, name + "_qh"), to_heads(k, name + "_kh"),
        to_heads(v, name + "_vh"), causal=causal, impl=impl,
        name=name + "_attn")
    merged = sym.Reshape(attn, shape=(0, 0, d_model),
                         name=name + "_merge")
    return sym.FullyConnected(
        merged, num_hidden=d_model, flatten=False, no_bias=True,
        name=name + "_out")


def _ffn(x, d_model, d_ff, name, tp_axis):
    """Position-wise FFN; `tp_axis` annotates the weights for
    column/row tensor parallelism."""
    w1 = sym.Variable(
        name + "_w1_weight",
        **({"sharding": f"{tp_axis},None"} if tp_axis else {}))
    w2 = sym.Variable(
        name + "_w2_weight",
        **({"sharding": f"None,{tp_axis}"} if tp_axis else {}))
    h = sym.FullyConnected(x, weight=w1, num_hidden=d_ff, flatten=False,
                           no_bias=True, name=name + "_w1")
    h = sym.Activation(h, act_type="relu", name=name + "_relu")
    return sym.FullyConnected(h, weight=w2, num_hidden=d_model,
                              flatten=False, no_bias=True,
                              name=name + "_w2")


def _moe(x, d_model, d_ff, num_experts, name, capacity_factor):
    out = sym.MoEFFN(
        x, num_experts=num_experts, hidden_size=d_ff,
        capacity_factor=capacity_factor, name=name)
    return out[0], out[1]


def get_transformer(d_model=64, num_heads=4, d_ff=256, num_layers=2,
                    causal=True, impl="ring", tp_axis=None,
                    moe_every=0, num_experts=0, moe_aux_weight=0.01,
                    capacity_factor=1.25):
    """Transformer regression tower over (B, T, d_model) inputs."""
    x = sym.Variable("data")
    aux_losses = []
    for i in range(num_layers):
        name = f"layer{i}"
        x = x + _attention(x, d_model, num_heads, name + "_attn",
                           impl, causal)
        use_moe = moe_every and (i + 1) % moe_every == 0 and num_experts
        if use_moe:
            out, aux = _moe(x, d_model, d_ff, num_experts,
                            name + "_moe", capacity_factor)
            x = x + out
            aux_losses.append(aux)
        else:
            x = x + _ffn(x, d_model, d_ff, name + "_ffn", tp_axis)
    label = sym.Variable("label")
    head = sym.LinearRegressionOutput(x, label, name="regress")
    if aux_losses:
        total_aux = aux_losses[0]
        for a in aux_losses[1:]:
            total_aux = total_aux + a
        aux_head = sym.MakeLoss(total_aux * moe_aux_weight,
                                name="moe_aux")
        return sym.Group([head, aux_head])
    return head
