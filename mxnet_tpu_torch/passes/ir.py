"""Graph IR for the pass pipeline: the Symbol JSON node-list form.

A `Graph` is the mutable, index-based twin of `Symbol.tojson()`: a flat
node list (op name or None for variables, node name, Python-valued
params, input wiring as ``(node_index, output_index)`` pairs) plus the
head list. Passes need it for two things the live `Symbol` cannot give
them: dead nodes stay addressable until `compact()` sweeps them, and
rewiring is an index update. The counterpart of mxnet_tpu/passes/ir.py,
with the structural verifier (dead nodes, duplicate names, input
ranges) the pass manager runs after every pass.
"""
from __future__ import annotations

from ..base import MXNetError


class GraphNode:
    """One node record: `op` is the registry op NAME (string), or None
    for a variable."""

    __slots__ = ("op", "name", "attrs", "inputs", "is_aux", "extra")

    def __init__(self, op, name, attrs=None, inputs=None, is_aux=False,
                 extra=None):
        self.op = op
        self.name = name
        self.attrs = dict(attrs or {})
        self.inputs = [tuple(i) for i in (inputs or [])]
        self.is_aux = bool(is_aux)
        self.extra = dict(extra or {})

    @property
    def is_variable(self):
        return self.op is None

    def opdef(self):
        from ..ops import registry as _registry

        if self.op is None:
            return None
        return _registry.get(self.op)

    def params(self):
        """Normalized (default-filled, coerced) op params."""
        od = self.opdef()
        return od.normalize_params(self.attrs) if od else {}

    def copy(self):
        return GraphNode(self.op, self.name, dict(self.attrs),
                         list(self.inputs), self.is_aux, dict(self.extra))

    def __repr__(self):
        return (f"<GraphNode {self.op or 'null'} {self.name!r} "
                f"inputs={self.inputs}>")


def dead_node_indices(node_inputs, head_indices):
    """Indices of nodes unreachable from any head (`node_inputs`: one
    list of input node indices per node)."""
    n = len(node_inputs)
    reachable = set()
    stack = [h for h in head_indices if 0 <= h < n]
    while stack:
        i = stack.pop()
        if i in reachable:
            continue
        reachable.add(i)
        stack.extend(src for src in node_inputs[i] if 0 <= src < n)
    return {i for i in range(n) if i not in reachable}


class Graph:
    """Flat node-list graph: `nodes` (GraphNode records, inputs refer to
    list indices) + `heads` ([(node_index, output_index)])."""

    def __init__(self, nodes=None, heads=None):
        self.nodes = list(nodes or [])
        self.heads = [tuple(h) for h in (heads or [])]

    @classmethod
    def from_symbol(cls, symbol):
        from ..symbol import _topo

        order = _topo(symbol._outputs)
        index = {id(n): i for i, n in enumerate(order)}
        nodes = [GraphNode(None if n.is_variable else n.op.name, n.name,
                           attrs=n.attrs,
                           inputs=[(index[id(src)], i)
                                   for src, i in n.inputs],
                           is_aux=n.is_aux, extra=n._extra_attrs)
                 for n in order]
        heads = [(index[id(n)], i) for n, i in symbol._outputs]
        return cls(nodes, heads)

    def to_symbol(self):
        from ..symbol import Node, Symbol

        built = []
        for gn in self.nodes:
            node = Node(gn.opdef(), gn.name, attrs=dict(gn.attrs),
                        is_aux=gn.is_aux)
            node._extra_attrs = dict(gn.extra)
            node.inputs = [(built[i], j) for i, j in gn.inputs]
            built.append(node)
        return Symbol([(built[i], j) for i, j in self.heads])

    # --------------------------------------------------------- structure
    def consumers(self):
        """node index -> list of (consumer_index, input_position)."""
        out = {i: [] for i in range(len(self.nodes))}
        for ci, gn in enumerate(self.nodes):
            for pos, (src, _) in enumerate(gn.inputs):
                out[src].append((ci, pos))
        return out

    def validate(self):
        n = len(self.nodes)
        for i, gn in enumerate(self.nodes):
            for src, _ in gn.inputs:
                if not 0 <= src < n:
                    raise MXNetError(
                        f"graph node #{i} ({gn.name!r}) references "
                        f"nonexistent input #{src}")
                if src >= i:
                    raise MXNetError(
                        f"graph node #{i} ({gn.name!r}) references "
                        f"non-topological input #{src}")
        for src, _ in self.heads:
            if not 0 <= src < n:
                raise MXNetError(
                    f"graph head references nonexistent node #{src}")

    def verify(self):
        """Structural findings as strings: dead nodes and duplicate
        names (empty = clean)."""
        issues = []
        dead = dead_node_indices(
            [[src for src, _ in gn.inputs] for gn in self.nodes],
            [src for src, _ in self.heads])
        for i in sorted(dead):
            issues.append(f"[dead_node] node #{i} "
                          f"({self.nodes[i].name!r}) is unreachable")
        seen = {}
        for i, gn in enumerate(self.nodes):
            if gn.name in seen:
                issues.append(f"[duplicate_arg] nodes #{seen[gn.name]} "
                              f"and #{i} share the name {gn.name!r}")
            else:
                seen[gn.name] = i
        return issues

    def compact(self):
        """Remove nodes unreachable from the heads; returns how many."""
        dead = dead_node_indices(
            [[src for src, _ in gn.inputs] for gn in self.nodes],
            [src for src, _ in self.heads])
        if not dead:
            return 0
        remap, kept = {}, []
        for i, gn in enumerate(self.nodes):
            if i in dead:
                continue
            remap[i] = len(kept)
            kept.append(gn)
        for gn in kept:
            gn.inputs = [(remap[src], j) for src, j in gn.inputs]
        self.heads = [(remap[src], j) for src, j in self.heads]
        removed = len(self.nodes) - len(kept)
        self.nodes = kept
        return removed

    def toposort(self):
        """Reorder into DFS post-order from the heads (dead nodes keep
        their relative order at the tail): a pure function of the
        wiring, matching symbol._topo's visit order."""
        n = len(self.nodes)
        order = []
        seen = [False] * n
        for h, _ in self.heads:
            stack = [(h, False)]
            while stack:
                i, expanded = stack.pop()
                if expanded:
                    order.append(i)
                    continue
                if seen[i]:
                    continue
                seen[i] = True
                stack.append((i, True))
                for src, _ in reversed(self.nodes[i].inputs):
                    if not seen[src]:
                        stack.append((src, False))
        order.extend(i for i in range(n) if not seen[i])
        remap = {old: new for new, old in enumerate(order)}
        self.nodes = [self.nodes[i] for i in order]
        for gn in self.nodes:
            gn.inputs = [(remap[src], j) for src, j in gn.inputs]
        self.heads = [(remap[src], j) for src, j in self.heads]
        return self

    def copy(self):
        return Graph([gn.copy() for gn in self.nodes], list(self.heads))

    def __len__(self):
        return len(self.nodes)

    def __repr__(self):
        n_ops = sum(1 for gn in self.nodes if not gn.is_variable)
        return (f"<Graph {len(self.nodes)} nodes ({n_ops} ops), "
                f"{len(self.heads)} heads>")
