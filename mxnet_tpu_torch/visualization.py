"""Network visualization (mxnet_tpu/visualization.py, the reference
python/mxnet/visualization.py): print_summary (text table of layers,
output shapes, param counts) and plot_network (graphviz digraph, gated
on graphviz availability)."""
from __future__ import annotations

from .base import MXNetError
from .symbol import Symbol, _topo


def _node_params(node):
    return {k: str(v) for k, v in (node.attrs or {}).items()}


def print_summary(symbol, shape=None, line_length=120, positions=None):
    """Print a layer-by-layer summary (reference
    visualization.py print_summary)."""
    if not isinstance(symbol, Symbol):
        raise MXNetError("symbol must be a Symbol")
    if positions is None:
        positions = [0.44, 0.64, 0.74, 1.0]
    show_shape = False
    shape_dict = {}
    if shape is not None:
        show_shape = True
        interals = symbol.get_internals()
        _, out_shapes, _ = interals.infer_shape(**shape)
        if out_shapes is None:
            raise MXNetError("Input shape is incomplete")
        shape_dict = dict(zip(interals.list_outputs(), out_shapes))

    positions = [int(line_length * p) for p in positions]
    to_display = ["Layer (type)", "Output Shape", "Param #",
                  "Previous Layer"]

    def print_row(fields, pos):
        line = ""
        for field, p in zip(fields, pos):
            line += str(field)
            line = line[: p - 1]
            line += " " * (p - len(line))
        print(line)

    print("_" * line_length)
    print_row(to_display, positions)
    print("=" * line_length)

    nodes = _topo(symbol._outputs)
    arg_shape_dict = {}
    if show_shape:
        arg_shapes, _, _ = symbol.infer_shape(**shape)
        if arg_shapes is not None:
            arg_shape_dict = dict(
                zip(symbol.list_arguments(), arg_shapes)
            )
    total_params = 0
    for node in nodes:
        if node.is_variable:
            continue
        op = node.op.name
        name = node.name
        pre_nodes = [src.name for src, _ in node.inputs
                     if not src.is_variable]
        # param count: product of shapes of this node's own variables
        cur_param = 0
        if show_shape:
            for src, _ in node.inputs:
                if src.is_variable and src.name.startswith(name) \
                        and not src.name.endswith("label"):
                    s = arg_shape_dict.get(src.name)
                    if s:
                        p = 1
                        for d in s:
                            p *= d
                        cur_param += p
        out_shape = "?"
        if show_shape:
            key = name + "_output"
            if key in shape_dict:
                out_shape = str(shape_dict[key])
        fields = [
            f"{name}({op})",
            out_shape,
            cur_param,
            ",".join(pre_nodes),
        ]
        print_row(fields, positions)
        total_params += cur_param
    print("=" * line_length)
    print(f"Total params: {total_params}")
    print("_" * line_length)
    return total_params


def plot_network(symbol, title="plot", save_format="pdf", shape=None,
                 node_attrs=None, hide_weights=True):
    """Graphviz digraph of the network (reference
    visualization.py plot_network). Requires the `graphviz` package;
    raises a clear error when unavailable."""
    try:
        from graphviz import Digraph
    except ImportError as e:
        raise MXNetError(
            "plot_network requires the graphviz python package"
        ) from e
    if not isinstance(symbol, Symbol):
        raise MXNetError("symbol must be a Symbol")

    node_attrs = node_attrs or {}
    node_attr = {
        "shape": "box", "fixedsize": "true", "width": "1.3",
        "height": "0.8034", "style": "filled",
    }
    node_attr.update(node_attrs)
    dot = Digraph(name=title, format=save_format)

    fill_colors = {
        "variable": "#8dd3c7",
        "fc": "#fb8072",
        "conv": "#fb8072",
        "act": "#ffffb3",
        "bn": "#bebada",
        "pool": "#80b1d3",
        "other": "#fccde5",
    }

    nodes = _topo(symbol._outputs)
    for node in nodes:
        name = node.name
        if node.is_variable:
            if hide_weights and not node.name.endswith("data") \
                    and not node.name.endswith("label"):
                continue
            dot.node(
                name=name, label=name,
                fillcolor=fill_colors["variable"], **node_attr
            )
            continue
        op = node.op.name
        key = "other"
        label = f"{op}\n{name}"
        low = op.lower()
        if "fullyconnected" in low:
            key = "fc"
        elif "convolution" in low or "deconvolution" in low:
            key = "conv"
        elif "activation" in low or "relu" in low:
            key = "act"
        elif "batchnorm" in low:
            key = "bn"
        elif "pooling" in low:
            key = "pool"
        dot.node(
            name=name, label=label, fillcolor=fill_colors[key],
            **node_attr
        )
        for src, _ in node.inputs:
            if src.is_variable and hide_weights \
                    and not src.name.endswith("data") \
                    and not src.name.endswith("label"):
                continue
            dot.edge(tail_name=src.name, head_name=name)
    return dot
