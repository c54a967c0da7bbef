"""Symbolic graph API: the counterpart of mxnet_tpu/symbol.py.

Composition with auto-created weight and aux variables, attribute
scopes, the node-list JSON form (`tojson` gives the same bytes as the
JAX package for the same graph), shape and type inference, the
structural key the pass memo and the fusion digests hash, and
`bind`/`simple_bind` producing an Executor (executor.py) that runs the
optimized graph eagerly on torch tensors; `save`/`load` keep the JSON in
a file (a checkpoint's -symbol.json). Every registered op has its
constructor here, `Custom(..., op_type=...)` included.

Not ported: `Symbol.__call__` composition is refused as in the JAX
package; `canonical_signature` and the tuner it keys wait.
"""
from __future__ import annotations

import json
import sys as _sys
import threading

import numpy as np

from . import ops as _ops  # noqa: F401  (registers every op)
from .base import MXNetError, _auto_name, coerce_tuple
from .context import current_context
from .ops import registry as _registry
from .ops import shape_infer as _shape_infer


class AttrScope:
    """with mx.AttrScope(ctx_group='dev1'): ..."""

    _current = threading.local()

    def __init__(self, **kwargs):
        self._attr = {f"__{k}__" if not k.startswith("__") else k: str(v)
                      for k, v in kwargs.items()}

    @classmethod
    def current_attrs(cls):
        out = {}
        for scope in getattr(cls._current, "stack", None) or ():
            out.update(scope._attr)
        return out

    def __enter__(self):
        if not hasattr(AttrScope._current, "stack"):
            AttrScope._current.stack = []
        AttrScope._current.stack.append(self)
        return self

    def __exit__(self, *_):
        AttrScope._current.stack.pop()


class Prefix:
    """with mx.name.Prefix('stage1_'): ..."""

    _current = threading.local()

    def __init__(self, prefix):
        self._prefix = prefix

    @classmethod
    def current_prefix(cls):
        return "".join(p._prefix
                       for p in getattr(cls._current, "stack", None) or ())

    def __enter__(self):
        if not hasattr(Prefix._current, "stack"):
            Prefix._current.stack = []
        Prefix._current.stack.append(self)
        return self

    def __exit__(self, *_):
        Prefix._current.stack.pop()


class Node:
    __slots__ = ("op", "name", "attrs", "inputs", "is_aux", "_extra_attrs")

    def __init__(self, op, name, attrs=None, inputs=None, is_aux=False):
        self.op = op  # OpDef or None for variables
        self.name = name
        self.attrs = dict(attrs or {})  # op params (python values)
        self.inputs = list(inputs or [])  # [(Node, out_index)]
        self.is_aux = is_aux
        self._extra_attrs = {}  # user attrs (__ctx_group__, lr_mult, ...)

    @property
    def is_variable(self):
        return self.op is None


def _topo(heads):
    """Post-order DFS over nodes reachable from head (node, idx) pairs."""
    seen = set()
    order = []

    def visit(node):
        if id(node) in seen:
            return
        seen.add(id(node))
        for inp, _ in node.inputs:
            visit(inp)
        order.append(node)

    for node, _ in heads:
        visit(node)
    return order


class Symbol:
    """Symbolic graph handle: a list of (Node, output-index) heads."""

    def __init__(self, outputs):
        self._outputs = list(outputs)  # [(Node, int)]

    # ------------------------------------------------------- structure
    @property
    def name(self):
        if len(self._outputs) == 1:
            return self._outputs[0][0].name
        return None

    def list_outputs(self):
        out = []
        for node, idx in self._outputs:
            if node.is_variable:
                out.append(node.name)
                continue
            n_out = node.op.resolved_num_outputs(
                node.op.normalize_params(node.attrs))
            out.append(f"{node.name}_output" if n_out == 1
                       else f"{node.name}_output{idx}")
        return out

    def list_arguments(self):
        return [n.name for n in _topo(self._outputs)
                if n.is_variable and not n.is_aux]

    def list_auxiliary_states(self):
        return [n.name for n in _topo(self._outputs)
                if n.is_variable and n.is_aux]

    def get_internals(self):
        heads = []
        for node in _topo(self._outputs):
            if node.is_variable:
                heads.append((node, 0))
                continue
            params = node.op.normalize_params(node.attrs)
            for i in range(node.op.resolved_num_outputs(params)):
                heads.append((node, i))
        return Symbol(heads)

    def __getitem__(self, index):
        if isinstance(index, str):
            names = self.list_outputs()
            if index not in names:
                raise MXNetError(f"cannot find output {index!r} in {names}")
            index = names.index(index)
        return Symbol([self._outputs[index]])

    def __len__(self):
        return len(self._outputs)

    def __iter__(self):
        return (self[i] for i in range(len(self._outputs)))

    # ------------------------------------------------------ attributes
    def attr(self, key):
        return self._outputs[0][0]._extra_attrs.get(key)

    def _set_attr(self, **kwargs):
        self._outputs[0][0]._extra_attrs.update(
            {k: str(v) for k, v in kwargs.items()})

    def attr_dict(self):
        out = {}
        for node in _topo(self._outputs):
            d = {k: str(v) for k, v in node.attrs.items()}
            d.update(node._extra_attrs)
            if d:
                out[node.name] = d
        return out

    # ------------------------------------------------------ composition
    def __call__(self, *args, **kwargs):
        raise MXNetError("Symbol.__call__ composition not supported; "
                         "pass inputs at creation time")

    def __add__(self, other):
        return _sym_binary(self, other, "elemwise_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, other):
        return _sym_binary(self, other, "elemwise_sub", "_minus_scalar")

    def __rsub__(self, other):
        return _sym_scalar(self, other, "_rminus_scalar")

    def __mul__(self, other):
        return _sym_binary(self, other, "elemwise_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return _sym_binary(self, other, "elemwise_div", "_div_scalar")

    def __rtruediv__(self, other):
        return _sym_scalar(self, other, "_rdiv_scalar")

    def __pow__(self, other):
        return _sym_binary(self, other, "_power", "_power_scalar")

    def __rpow__(self, other):
        return _sym_scalar(self, other, "_rpower_scalar")

    def __neg__(self):
        return _sym_scalar(self, -1.0, "_mul_scalar")

    def __repr__(self):
        return f"<Symbol {self.name or 'grouped'}>"

    # -------------------------------------------------------- inference
    def infer_shape(self, *args, **kwargs):
        return self._infer_shape_impl(False, *args, **kwargs)

    def infer_shape_partial(self, *args, **kwargs):
        return self._infer_shape_impl(True, *args, **kwargs)

    def _infer_shape_impl(self, partial, *args, **kwargs):
        known = {}
        for name, shape in zip(self.list_arguments(), args):
            if shape is not None:
                known[name] = tuple(shape)
        known.update({k: tuple(v) for k, v in kwargs.items()
                      if v is not None})
        shapes, _ = _graph_infer(self._outputs, known, {}, partial=partial)
        if shapes is None:
            return None, None, None
        var_nodes = _var_nodes(self._outputs)
        arg_shapes = [shapes.get((n, 0)) for n in var_nodes if not n.is_aux]
        aux_shapes = [shapes.get((n, 0)) for n in var_nodes if n.is_aux]
        out_shapes = [shapes.get(_key(h)) for h in self._outputs]
        return arg_shapes, out_shapes, aux_shapes

    def infer_type(self, *args, **kwargs):
        """Dtype propagation: variables default to float32 (or their
        __dtype__ attr / explicit kwargs); op outputs take the op's
        `dtype` param when present, else the first input's dtype."""
        known = {}
        for name, t in zip(self.list_arguments(), args):
            if t is not None:
                known[name] = np.dtype(t)
        known.update({k: np.dtype(v) for k, v in kwargs.items()
                      if v is not None})
        dtypes = {}
        for n in _topo(self._outputs):
            if n.is_variable:
                if n.name in known:
                    dt = known[n.name]
                elif "__dtype__" in n._extra_attrs:
                    dt = np.dtype(n._extra_attrs["__dtype__"])
                else:
                    dt = np.dtype(np.float32)
                dtypes[(n, 0)] = dt
                continue
            params = n.op.normalize_params(n.attrs)
            if "dtype" in params:
                dt = np.dtype(params["dtype"])
            elif n.inputs:
                dt = dtypes[(n.inputs[0][0], n.inputs[0][1])]
            else:
                dt = np.dtype(np.float32)
            for i in range(n.op.resolved_num_outputs(params)):
                dtypes[(n, i)] = dt
        f32 = np.dtype(np.float32)
        var_nodes = _var_nodes(self._outputs)
        return ([dtypes.get((n, 0), f32) for n in var_nodes
                 if not n.is_aux],
                [dtypes.get(_key(h), f32) for h in self._outputs],
                [dtypes.get((n, 0), f32) for n in var_nodes if n.is_aux])

    # ------------------------------------------------------ canonical form
    def structure_key(self):
        """Canonical, hashable signature of the graph structure: the
        topo-sorted node list (op name, node name, normalized params,
        ctx-group tag, input wiring as topo indices) plus the head
        wiring. It keys the pass pipeline's memo."""
        nodes = _topo(self._outputs)
        idx = {id(n): i for i, n in enumerate(nodes)}
        entries = []
        for n in nodes:
            if n.is_variable:
                entries.append(("null", n.name, bool(n.is_aux),
                                n._extra_attrs.get("__ctx_group__")))
            else:
                entries.append((
                    n.op.name, n.name,
                    _canon(n.op.normalize_params(n.attrs)),
                    n._extra_attrs.get("__ctx_group__"),
                    tuple((idx[id(src)], i) for src, i in n.inputs)))
        heads = tuple((idx[id(n)], i) for n, i in self._outputs)
        return (tuple(entries), heads)

    # ------------------------------------------------------- serialization
    def tojson(self, canonical=False):
        """Serialize to the node-list JSON graph; `canonical=True` runs
        the default pass pipeline first."""
        if canonical:
            from . import passes as _passes

            return _passes.optimize(self).tojson()
        nodes = _topo(self._outputs)
        node_index = {id(n): i for i, n in enumerate(nodes)}
        jnodes = []
        for n in nodes:
            attrs = {k: _attr_str(v) for k, v in n.attrs.items()}
            attrs.update(n._extra_attrs)
            jn = {
                "op": "null" if n.is_variable else n.op.name,
                "name": n.name,
                "inputs": [[node_index[id(src)], idx, 0]
                           for src, idx in n.inputs],
            }
            if attrs:
                jn["attrs"] = attrs
            if n.is_aux:
                jn.setdefault("attrs", {})["__is_aux__"] = "True"
            jnodes.append(jn)
        return json.dumps(
            {
                "nodes": jnodes,
                "arg_nodes": [i for i, n in enumerate(nodes)
                              if n.is_variable],
                "heads": [[node_index[id(n)], idx, 0]
                          for n, idx in self._outputs],
                "attrs": {"mxnet_version": ["str", "0.9.5-tpu"]},
            },
            indent=2,
        )

    def save(self, fname):
        """Write `tojson()` to `fname` (a checkpoint's -symbol.json)."""
        with open(fname, "w") as f:
            f.write(self.tojson())

    # ------------------------------------------------------------- binding
    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    **kwargs):
        """Allocate zeroed argument, gradient and aux arrays of the
        inferred shapes on `ctx` (the card when None) and bind them."""
        from . import ndarray as nd
        from .executor import Executor

        ctx = ctx or current_context()
        arg_shapes, _, aux_shapes = self.infer_shape(**kwargs)
        if arg_shapes is None or any(s is None for s in arg_shapes):
            raise MXNetError(
                f"simple_bind: could not infer all argument shapes from "
                f"{kwargs}")
        arg_types, _, aux_types = self.infer_type(**(type_dict or {}))
        arg_names = self.list_arguments()
        args = {n: nd.zeros(s, ctx=ctx, dtype=t)
                for n, s, t in zip(arg_names, arg_shapes, arg_types)}
        aux = {n: nd.zeros(s, ctx=ctx, dtype=t)
               for n, s, t in zip(self.list_auxiliary_states(), aux_shapes,
                                  aux_types)}
        req = _grad_req_dict(grad_req, arg_names)
        grads = {n: nd.zeros(s, ctx=ctx, dtype=t)
                 for n, s, t in zip(arg_names, arg_shapes, arg_types)
                 if req.get(n, "null") != "null"}
        return Executor(self, ctx, args, grads, req, aux)

    def bind(self, ctx=None, args=None, args_grad=None, grad_req="write",
             aux_states=None):
        from . import ndarray as nd
        from .executor import Executor

        ctx = ctx or current_context()
        arg_names = self.list_arguments()
        aux_names = self.list_auxiliary_states()
        if isinstance(args, (list, tuple)):
            args = dict(zip(arg_names, args))
        if isinstance(args_grad, (list, tuple)):
            args_grad = dict(zip(arg_names, args_grad))
        args_grad = args_grad or {}
        if isinstance(aux_states, (list, tuple)):
            aux_states = dict(zip(aux_names, aux_states))
        aux_states = aux_states or {}
        req = _grad_req_dict(grad_req, arg_names)
        if aux_names and len(aux_states) < len(aux_names):
            shapes = {n: tuple(a.shape) for n, a in args.items()}
            _, _, aux_shapes = self.infer_shape(**shapes)
            for n, s in zip(aux_names, aux_shapes):
                if n not in aux_states:
                    aux_states[n] = nd.zeros(s, ctx=ctx)
        return Executor(self, ctx, args, args_grad, req, aux_states)


def _grad_req_dict(grad_req, arg_names):
    if isinstance(grad_req, str):
        return {n: grad_req for n in arg_names}
    if isinstance(grad_req, (list, tuple)):
        return dict(zip(arg_names, grad_req))
    return dict(grad_req)


def _canon(value):
    """Hashable canonical form of an op-param value (the same form the
    JAX package hashes, so fusion-group digests agree)."""
    if isinstance(value, dict):
        return tuple(sorted((str(k), _canon(v)) for k, v in value.items()))
    if isinstance(value, (list, tuple)):
        return tuple(_canon(v) for v in value)
    if isinstance(value, (set, frozenset)):
        return tuple(sorted(repr(_canon(v)) for v in value))
    if isinstance(value, np.dtype):
        return value.name
    if isinstance(value, np.ndarray):
        return (value.dtype.name, value.shape, value.tobytes())
    try:
        hash(value)
        return value
    except TypeError:
        return repr(value)


def _key(head):
    return (head[0], head[1])


def _var_nodes(outputs):
    return [n for n in _topo(outputs) if n.is_variable]


def _attr_str(v):
    if isinstance(v, (tuple, list)):
        return "(" + ", ".join(str(x) for x in v) + ")"
    return str(v)


def _graph_infer(heads, known_shapes, known_dtypes, partial=False):
    """Iterative forward inference to fixpoint over the graph."""
    nodes = _topo(heads)
    shapes = {}  # (node, idx) -> tuple
    dtypes = {}
    for n in nodes:
        if not n.is_variable:
            continue
        if n.name in known_shapes:
            shapes[(n, 0)] = tuple(known_shapes[n.name])
        elif "__shape__" in n._extra_attrs:
            shapes[(n, 0)] = coerce_tuple(n._extra_attrs["__shape__"])
        if n.name in known_dtypes:
            dtypes[(n, 0)] = np.dtype(known_dtypes[n.name])
    progress = True
    failures = {}
    while progress:
        progress = False
        failures = {}
        for n in nodes:
            if n.is_variable:
                continue
            params = n.op.normalize_params(n.attrs)
            outkeys = [(n, i)
                       for i in range(n.op.resolved_num_outputs(params))]
            if all(k in shapes for k in outkeys) and all(
                    (src, i) in shapes for src, i in n.inputs):
                continue
            in_shapes = [shapes.get((src, i)) for src, i in n.inputs]
            in_dtypes = [dtypes.get((src, i), np.dtype(np.float32))
                         for src, i in n.inputs]
            try:
                new_in, out_shapes, out_dtypes = _shape_infer.infer_node(
                    n.op, params, in_shapes, in_dtypes)
            except MXNetError as e:
                failures[n.name] = str(e)
                continue
            except Exception as e:  # the op refused the meta inputs
                failures[n.name] = f"{type(e).__name__}: {e}"
                continue
            for (src, i), s in zip(n.inputs, new_in):
                if (src, i) not in shapes and s is not None:
                    shapes[(src, i)] = tuple(s)
                    progress = True
            for k, s, d in zip(outkeys, out_shapes, out_dtypes):
                if k not in shapes:
                    shapes[k] = tuple(s)
                    progress = True
                dtypes[k] = d
    if failures and not partial:
        detail = "; ".join(f"{k}: {v}" for k, v in failures.items())
        raise MXNetError(f"infer_shape failed: {detail}")
    return shapes, dtypes


# ------------------------------------------------------------ constructors
def Variable(name, attr=None, shape=None, lr_mult=None, wd_mult=None,
             dtype=None, init=None, **kwargs):
    """A named graph input/parameter Symbol; extra kwargs become
    __attr__ annotations."""
    node = Node(None, name)
    if attr:
        node._extra_attrs.update({k: str(v) for k, v in attr.items()})
    node._extra_attrs.update(AttrScope.current_attrs())
    if shape is not None:
        node._extra_attrs["__shape__"] = str(tuple(shape))
    if lr_mult is not None:
        node._extra_attrs["__lr_mult__"] = str(lr_mult)
    if wd_mult is not None:
        node._extra_attrs["__wd_mult__"] = str(wd_mult)
    if dtype is not None:
        node._extra_attrs["__dtype__"] = str(np.dtype(dtype))
    if init is not None:
        node._extra_attrs["__init__"] = (
            init if isinstance(init, str) else init.dumps())
    for k, v in kwargs.items():
        node._extra_attrs[f"__{k}__"] = str(v)
    return Symbol([(node, 0)])


var = Variable


def Group(symbols):
    """One multi-output Symbol from many."""
    outputs = []
    for s in symbols:
        outputs.extend(s._outputs)
    return Symbol(outputs)


def load(fname):
    """The Symbol saved in `fname` by `Symbol.save`."""
    with open(fname) as f:
        return loads(f.read())


def loads(json_str):
    data = json.loads(json_str)
    nodes = []
    for jn in data["nodes"]:
        attrs = dict(jn.get("attrs", jn.get("attr", {}) or {}))
        is_aux = attrs.pop("__is_aux__", "False") in ("True", "1", "true")
        extra = {k: v for k, v in attrs.items() if k.startswith("__")}
        params = {k: v for k, v in attrs.items() if not k.startswith("__")}
        if jn["op"] == "null":
            node = Node(None, jn["name"], is_aux=is_aux)
        else:
            node = Node(_registry.get(jn["op"]), jn["name"], attrs=params)
        node._extra_attrs = extra
        node.inputs = [(nodes[i], idx) for i, idx, *_ in jn["inputs"]]
        nodes.append(node)
    return Symbol([(nodes[i], idx) for i, idx, *_ in data["heads"]])


def _sym_binary(lhs, rhs, elem_op, scalar_op):
    if isinstance(rhs, Symbol):
        return _create(_registry.get(elem_op), [lhs, rhs], {})
    return _create(_registry.get(scalar_op), [lhs], {"scalar": float(rhs)})


def _sym_scalar(sym, scalar, op):
    return _create(_registry.get(op), [sym], {"scalar": float(scalar)})


def _create(opdef, input_syms, params, name=None):
    """Create an op node: auto-name, auto-create missing weight/aux
    variables."""
    prefix = Prefix.current_prefix()
    if name is None:
        name = prefix + _auto_name(opdef.name.lower().lstrip("_"))
    else:
        name = prefix + name
    inputs = []
    params = opdef.normalize_params(params)
    if opdef.arg_names is not None or opdef.arg_names_fn is not None:
        given = list(input_syms)
        needed = _required_inputs(opdef, params)
        gi = iter(given)
        for an in needed:
            s = next(gi, None)
            if s is None:
                inputs.append(Variable(f"{name}_{an}")._outputs[0])
                continue
            if len(s._outputs) != 1:
                raise MXNetError(
                    f"{opdef.name}: grouped symbol cannot be an input")
            inputs.append(s._outputs[0])
        if list(gi):
            raise MXNetError(
                f"{opdef.name}: too many inputs ({len(given)} given, "
                f"{len(needed)} expected)")
    else:
        for s in input_syms:
            inputs.extend(s._outputs)
        if "num_args" in (opdef.coerce or {}):
            params.setdefault("num_args", len(inputs))
    for aux in opdef.aux_names:
        v = Variable(f"{name}_{aux}")
        v._outputs[0][0].is_aux = True
        inputs.append(v._outputs[0])
    node = Node(opdef, name, attrs=params, inputs=inputs)
    node._extra_attrs.update(AttrScope.current_attrs())
    n_out = opdef.resolved_num_outputs(params)
    return Symbol([(node, i) for i in range(n_out)])


def _required_inputs(opdef, params):
    """Declared inputs actually used given params (no bias when
    no_bias=True)."""
    if opdef.arg_names_fn is not None:
        return list(opdef.arg_names_fn(params))
    names = list(opdef.arg_names)
    if params.get("no_bias") and "bias" in names:
        names.remove("bias")
    return names


def _make_symbol_function(opdef, func_name):
    def creator(*args, **kwargs):
        name = kwargs.pop("name", None)
        kwargs.pop("attr", None)
        input_syms = [a for a in args if isinstance(a, Symbol)]
        sym_kwargs, params = {}, {}
        for k, v in kwargs.items():
            if isinstance(v, Symbol):
                if opdef.arg_names is None and opdef.arg_names_fn is None:
                    raise MXNetError(f"{func_name}: variadic op takes "
                                     f"positional symbol inputs only")
                sym_kwargs[k] = v
            else:
                params[k] = v
        norm = opdef.normalize_params(params)
        valid_names = set(_required_inputs(opdef, norm)) \
            if opdef.arg_names is not None or opdef.arg_names_fn \
            is not None else set()
        for k in sym_kwargs:
            if k not in valid_names:
                raise MXNetError(f"{func_name}: unknown input {k!r} "
                                 f"(expected one of {sorted(valid_names)})")
        if sym_kwargs:
            # kwargs pin their named slot; positional args fill the rest
            merged = []
            pos = iter(input_syms)
            for an in _required_inputs(opdef, norm):
                merged.append(sym_kwargs[an] if an in sym_kwargs
                              else next(pos, None))
            if list(pos):
                raise MXNetError(f"{func_name}: too many symbol inputs")
            input_syms = merged
        return _create(opdef, input_syms, params, name=name)

    creator.__name__ = func_name
    creator.__doc__ = f"Symbolic {opdef.name} (registered op {func_name!r})."
    return creator


_this = _sys.modules[__name__]
for _name in _registry.list_ops():
    if not hasattr(_this, _name):
        setattr(_this, _name, _make_symbol_function(_registry.get(_name),
                                                    _name))
