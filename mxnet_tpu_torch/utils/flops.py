"""Analytic model-FLOP counting over a Symbol graph
(mxnet_tpu/utils/flops.py: the same convention and counts).

The reference reports headline throughput in img/s and leaves FLOP math
to the reader; for MFU we need the *analytic* convention used by the
scaling literature: count 2 FLOPs per MAC in the matmul-class ops
(Convolution, FullyConnected, Deconvolution, dot), forward only, and
take a training step as 3x forward (backward = grad-wrt-input +
grad-wrt-weight, each the same MAC count as forward). Executed work
(zero-multiplies in dilated gradient convolutions, recomputation) is
not counted.
"""
from __future__ import annotations


def _prod(t):
    out = 1
    for v in t:
        out *= int(v)
    return out


def count_flops(symbol, **input_shapes):
    """Analytic forward FLOPs of `symbol` at the given input shapes.

    Returns {"forward": F, "train_step": 3*F, "by_op": {op_name: F}}.
    Only matmul-class ops are counted (elementwise/norm traffic is
    bandwidth, not tensor-core work, and is <2% of FLOPs for conv
    nets).
    """
    from ..symbol import _graph_infer, _topo

    known = {k: tuple(v) for k, v in input_shapes.items()}
    shapes, _ = _graph_infer(symbol._outputs, known, {}, partial=True)
    if shapes is None:
        raise ValueError("count_flops: shape inference failed")

    total = 0.0
    by_op = {}

    def shape_of(node, idx=0):
        return shapes.get((node, idx))

    for n in _topo(symbol._outputs):
        if n.is_variable:
            continue
        opname = n.op.name
        params = n.op.normalize_params(n.attrs)
        out = shape_of(n)
        f = 0.0
        if opname == "Convolution" and out is not None:
            kernel = tuple(params["kernel"])
            ng = int(params.get("num_group", 1))
            data_sh = shape_of(*n.inputs[0])
            w_sh = shape_of(*n.inputs[1])
            if data_sh is None or w_sh is None:
                continue
            layout = str(params.get("layout") or "")
            c_in = (data_sh[-1] if layout.upper().endswith("C")
                    else data_sh[1])
            # out spatial x filters x per-output-dot-product, x2 for MAC
            f = 2.0 * _prod(out) * (c_in // ng) * _prod(kernel)
        elif opname == "Deconvolution":
            kernel = tuple(params["kernel"])
            ng = int(params.get("num_group", 1))
            nf = int(params["num_filter"])
            data_sh = shape_of(*n.inputs[0])
            if data_sh is None:
                continue
            f = 2.0 * _prod(data_sh) * (nf // ng) * _prod(kernel)
        elif opname == "FullyConnected" and out is not None:
            data_sh = shape_of(*n.inputs[0])
            if data_sh is None:
                continue
            k = (_prod(data_sh[1:]) if params.get("flatten", True)
                 else data_sh[-1])
            f = 2.0 * _prod(out[:-1]) * out[-1] * k
        elif opname in ("dot", "batch_dot", "linalg_gemm2") and \
                out is not None:
            a_sh = shape_of(*n.inputs[0])
            if a_sh is None:
                continue
            # contraction length = prod(a) * prod(out) / prod(a batch+M)
            # for plain dot with default axes: K is a's last dim
            f = 2.0 * _prod(out) * a_sh[-1]
        if f:
            total += f
            by_op[n.name] = f

    return {"forward": total, "train_step": 3.0 * total, "by_op": by_op}
