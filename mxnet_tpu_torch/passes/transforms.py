"""The built-in graph-to-graph transforms (mxnet_tpu/passes/transforms.py).

Each pass is `pass_fn(graph) -> int`, mutating a `passes.ir.Graph` in
place and returning how many rewrites it applied (0 = fixpoint). The
manager compacts and re-verifies after every pass. Pipeline order:

  dce          delete head-unreachable nodes
  fold         evaluate constant-rooted subgraphs into `_graph_constant`
               leaves + algebraic identities (x*1, x/1, x+0, x-0)
  cse          merge structurally identical subexpressions
  canonicalize stable topo order, canonical op names, normalized
               params, dense renaming of auto-named nodes
  fusion_hints annotate single-consumer elementwise chains with
               `__fusion_group__`
  codegen      (codegen.py) absorb trailing full reductions and stamp
               each group `candidate:<digest>` or `fallback:<reason>`

The opt-in NCHW -> NHWC layout rewrite is not ported.

Invariants: variables are never renamed, created or merged away (binding
is by name); head count and order never change; head values are
unchanged.
"""
from __future__ import annotations

import re

import numpy as np

from ..base import MXNetError

# Elementwise (shape-preserving, pointwise) ops for fusion grouping:
# canonical registry names, the same set as the JAX package's.
ELEMWISE_OPS = frozenset({
    "relu", "sigmoid", "tanh", "exp", "log", "log1p", "expm1", "sqrt",
    "rsqrt", "square", "abs", "sign", "negative", "reciprocal",
    "softsign", "erf", "identity", "_copy", "cast", "clip",
    "Activation", "LeakyReLU", "smooth_l1",
    "elemwise_add", "elemwise_sub", "elemwise_mul", "elemwise_div",
    "_power", "_maximum", "_minimum", "_mod",
    "broadcast_add", "broadcast_sub", "broadcast_mul", "broadcast_div",
    "broadcast_power", "broadcast_maximum", "broadcast_minimum",
    "_plus_scalar", "_minus_scalar", "_rminus_scalar", "_mul_scalar",
    "_div_scalar", "_rdiv_scalar", "_power_scalar", "_rpower_scalar",
    "_maximum_scalar", "_minimum_scalar",
})

# ops that materialize a deterministic value from params alone
CONST_SOURCE_OPS = frozenset({"_zeros", "_ones", "_graph_constant"})


def _fold_cap():
    from ..utils import getenv

    return int(getenv("MXNET_PASS_FOLD_MAX"))


# ------------------------------------------------------------------ dce
def dce(graph):
    """Dead-node elimination."""
    return graph.compact()


# ----------------------------------------------------------------- fold
def _is_foldable_op(gn):
    if gn.is_variable:
        return False
    try:
        od = gn.opdef()
    except MXNetError:
        return False
    return (not od.needs_rng and not od.needs_mode and not od.aux_names
            and od.resolved_num_outputs(od.normalize_params(gn.attrs))
            == 1)


def _shape_guard(gn, cap):
    shape = gn.params().get("shape")
    if not shape:
        return True
    n = 1
    for d in shape:
        n *= int(d)
    return n <= cap


def fold(graph):
    """Constant folding: every op whose inputs are all constant-valued
    collapses into a `_graph_constant` leaf holding the evaluated value
    (nested lists), plus the identities x*1, x/1, x+0, x-0 except at
    graph heads."""
    cap = _fold_cap()
    n = len(graph.nodes)
    is_const = [False] * n
    for i, gn in enumerate(graph.nodes):
        if not _is_foldable_op(gn):
            continue
        if gn.inputs:
            is_const[i] = all(is_const[s] for s, _ in gn.inputs)
        else:
            is_const[i] = (gn.op in CONST_SOURCE_OPS
                           and _shape_guard(gn, cap))
    targets = [i for i in range(n) if is_const[i] and graph.nodes[i].inputs]
    memo = {}

    def _eval(i):
        if i not in memo:
            gn = graph.nodes[i]
            vals = [_eval(s) for s, _ in gn.inputs]
            memo[i] = gn.opdef().fn(*vals, **gn.params())
        return memo[i]

    folds = 0
    taken = {gn.name for gn in graph.nodes}
    for i in targets:
        try:
            val = np.asarray(_eval(i).detach().cpu().numpy())
        except Exception:
            continue  # op rejected the const inputs: leave it in place
        if val.size > cap:
            continue
        gn = graph.nodes[i]
        gn.op = "_graph_constant"
        gn.attrs = {"value": val.tolist(), "dtype": val.dtype.name}
        gn.inputs = []
        name, k = f"graph_constant{i}", i
        while name in taken:
            k += len(graph.nodes)
            name = f"graph_constant{k}"
        taken.discard(gn.name)
        taken.add(name)
        gn.name = name
        folds += 1
    return folds + _fold_identities(graph)


_IDENTITY_OPS = {
    "_mul_scalar": 1.0, "_div_scalar": 1.0,
    "_plus_scalar": 0.0, "_minus_scalar": 0.0,
}


def _fold_identities(graph):
    head_nodes = {s for s, _ in graph.heads}
    redirect = {}
    for i, gn in enumerate(graph.nodes):
        neutral = _IDENTITY_OPS.get(gn.op)
        if neutral is None or i in head_nodes:
            continue
        if float(gn.params().get("scalar", neutral)) != neutral:
            continue
        src = gn.inputs[0]
        while src[0] in redirect:
            src = redirect[src[0]]
        redirect[i] = src
    if not redirect:
        return 0
    for gn in graph.nodes:
        gn.inputs = [redirect.get(s, (s, j)) for s, j in gn.inputs]
    graph.heads = [redirect.get(s, (s, j)) for s, j in graph.heads]
    return len(redirect)


# ------------------------------------------------------------------ cse
def cse(graph):
    """Common-subexpression elimination: same op, normalized params,
    ctx-group and deduplicated inputs compute the same value. Variables
    merge by name; random and aux-carrying ops never merge."""
    from ..symbol import _canon

    canonical, replace = {}, {}
    for i, gn in enumerate(graph.nodes):
        if gn.is_variable:
            key = ("var", gn.name, gn.is_aux)
        else:
            try:
                od = gn.opdef()
            except MXNetError:
                continue
            if od.needs_rng or od.aux_names:
                continue
            key = ("op", od.name, _canon(od.normalize_params(gn.attrs)),
                   gn.extra.get("__ctx_group__"),
                   tuple((replace.get(s, s), j) for s, j in gn.inputs))
        if key in canonical:
            replace[i] = canonical[key]
        else:
            canonical[key] = i
    if not replace:
        return 0
    for gn in graph.nodes:
        gn.inputs = [(replace.get(s, s), j) for s, j in gn.inputs]
    graph.heads = [(replace.get(s, s), j) for s, j in graph.heads]
    return len(replace)


# --------------------------------------------------------- canonicalize
def canonicalize(graph):
    """Canonical form: DFS-post-order node list, canonical op names,
    normalized params, auto-named op nodes renamed to dense per-op
    counters in topo order (user-named nodes and variables keep their
    names)."""
    from ..symbol import _canon

    graph.toposort()
    changed = 0
    for gn in graph.nodes:
        if gn.is_variable:
            continue
        try:
            od = gn.opdef()
        except MXNetError:
            continue
        if gn.op != od.name:
            gn.op = od.name
            changed += 1
        norm = od.normalize_params(gn.attrs)
        if _canon(norm) != _canon(gn.attrs):
            changed += 1
        gn.attrs = norm

    auto, taken = [], set()
    for gn in graph.nodes:
        base = None if gn.is_variable else gn.op.lower().lstrip("_")
        if base is not None and re.fullmatch(re.escape(base) + r"\d+",
                                             gn.name):
            auto.append((gn, base))
        else:
            taken.add(gn.name)
    counters, assigned = {}, set()
    for gn, base in auto:
        k = counters.get(base, 0)
        while f"{base}{k}" in taken or f"{base}{k}" in assigned:
            k += 1
        counters[base] = k + 1
        new = f"{base}{k}"
        assigned.add(new)
        if new != gn.name:
            gn.name = new
            changed += 1
    return changed


# -------------------------------------------------------- fusion hints
def fusion_hints(graph):
    """Tag producer-consumer elementwise chains with `__fusion_group__`
    (fg0, fg1, ... in topo order). A node joins its producer's group
    only when it is that producer's sole consumer and the producer is
    not a head."""
    consumers = graph.consumers()
    head_nodes = {s for s, _ in graph.heads}

    def _elementwise(gn):
        if gn.is_variable:
            return False
        try:
            return gn.opdef().name in ELEMWISE_OPS
        except MXNetError:
            return False

    group, members = {}, []
    for i, gn in enumerate(graph.nodes):
        if not _elementwise(gn):
            continue
        g = None
        for s, _ in gn.inputs:
            if (s in group and len(consumers[s]) == 1
                    and s not in head_nodes):
                g = group[s]
                break
        if g is None:
            g = len(members)
            members.append([])
        group[i] = g
        members[g].append(i)

    changed = 0
    real = [m for m in members if len(m) >= 2]
    tags = {i: f"fg{gid}" for gid, m in enumerate(real) for i in m}
    for i, gn in enumerate(graph.nodes):
        want = tags.get(i)
        if want != gn.extra.get("__fusion_group__"):
            changed += 1
            if want is None:
                del gn.extra["__fusion_group__"]
            else:
                gn.extra["__fusion_group__"] = want
    return changed and len(real)
