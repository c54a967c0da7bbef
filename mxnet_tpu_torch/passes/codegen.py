"""Fusion codegen: lower `__fusion_group__` chains to generated CUDA
kernels. The counterpart of mxnet_tpu/passes/pallas_codegen.py.

Two halves, two call sites, as in the JAX package:

  codegen(graph)      the registered pass. Absorbs an eligible trailing
                      full reduction into its producer chain, then
                      stamps every group's output node with
                      `__fusion_codegen__`:
                        candidate:<digest>   structurally lowerable
                        fallback:<reason>    counted static reject
                                             (disabled / too_small /
                                             unsupported_op:<name>)
  plan_for(symbol, input_shapes, device)
                      executor-side lowering of an optimized symbol:
                      each candidate becomes a fused callable or a
                      counted fallback reason (irregular_shapes /
                      unsupported_dtype), and the executor gets the
                      node-index routing.

Templates, one CUDA C++ source emitted per (group digest, dtypes) over
csrc/fusion_codegen.cuh and compiled with nvcc for sm_90a:

  elementwise     (B1, replaces pallas_codegen.py:408) same-shape chain:
                  a grid-stride loop, 16-byte vector loads and stores
                  when every pointer is aligned
  scale_bias_act  (B2, :444) the mul -> add -> activation case; it
                  shares the elementwise emitter, and is classified
                  apart in the stats and the launch counts
  reduction       (B3, :455) chain + absorbed axis=None sum/mean/max/
                  min: per-block partials, then one block, in float32

Every op of the chain is one float32 device expression with its scalar
parameters as literals; the result is stored in the output dtype. The
TPU tiling rule ((8, 128) tiles) does not apply: any same-shape group
lowers, as it does in the JAX package's interpret mode.

The device decides the path. A group's fused callable is a
torch.autograd.Function: forward runs the generated kernel on CUDA
tensors and the plain version (`group_lax_fn`, the group's ops composed
on tensors) on CPU tensors; backward recomputes the plain chain on the
saved inputs under autograd (the JAX package's lax-twin vjp). On the
card the kernels of a bind are compiled together, each is checked
against the plain chain on inputs seeded from its digest, and an nvcc,
launch or parity failure raises MXNetError: a group never gives way to
the plain version on a CUDA tensor.

The decisions and `fusion_stats()` on the CPU equal the JAX package's
under MXNET_FUSION_INTERPRET=1 (there the "kernel" is the plain version
and its parity check is trivial). MXNET_FUSION_INTERPRET, the
`platform` reason and `calibrated_slower` have no counterpart.
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import threading
from dataclasses import dataclass

import numpy as np
import torch

from ..base import MXNetError
from ..ops.shape_infer import torch_dtype
from .transforms import ELEMWISE_OPS

# trailing reductions absorbable into a chain: axis=None (full) only
REDUCE_OPS = frozenset({"sum", "mean", "max", "min"})

# the scale_bias_act classifier's per-position op sets
_MUL_OPS = frozenset({"broadcast_mul", "elemwise_mul", "_mul_scalar"})
_ADD_OPS = frozenset({"broadcast_add", "elemwise_add", "_plus_scalar"})
_ACT_OPS = frozenset({"relu", "sigmoid", "tanh", "Activation"})

TEMPLATES = ("elementwise", "scale_bias_act", "reduction")

PARITY_RTOL = 1e-6
PARITY_ATOL = 1e-6
# a float32 reduction's error, as a share of the sum of its terms'
# magnitudes: per-thread partial sums of a few dozen terms, then two
# block trees, against a float64 reference
REDUCE_RTOL = 1e-5
# a low-precision output is rounded once from the float32 chain, so it
# agrees with the float32 reference to about one unit in its last place
_LOWP_RTOL = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}

_THREADS = 256
_REDUCE_MAX_BLOCKS = 1024


class _Unsupported(Exception):
    """Raised by an emitter when a group cannot take its template; the
    message is the counted fallback reason."""


# ---------------------------------------------------------------- config
@dataclass(frozen=True)
class CodegenConfig:
    enabled: bool       # MXNET_FUSION_CODEGEN
    min_group: int      # MXNET_FUSION_MIN_GROUP


def codegen_config():
    """Read the codegen knobs (fresh each call: they are env vars)."""
    from ..utils import getenv

    return CodegenConfig(enabled=bool(getenv("MXNET_FUSION_CODEGEN")),
                         min_group=int(getenv("MXNET_FUSION_MIN_GROUP")))


# ----------------------------------------------------------------- state
_LOCK = threading.RLock()
# digest -> {"tag", "ops", "template", "decision", "reason"}: the latest
# decision per group
_GROUPS = {}
_COUNTS = {"kernels_built": 0, "parity_checks": 0, "parity_failures": 0}
# (digest, ext signature, device type) -> ("ok", FusedGroup) |
# ("demoted", reason)
_KERNELS = {}
# kernel launches per template (B1-B3), counted where a kernel launches
_LAUNCHES = {t: 0 for t in TEMPLATES}


def fusion_stats():
    """Aggregate codegen counters: groups seen/lowered/fallback,
    per-reason fallback counts, per-template kernel counts, parity
    totals (the same keys as the JAX package's)."""
    with _LOCK:
        groups = [dict(v) for v in _GROUPS.values()]
        counts = dict(_COUNTS)
    reasons, templates, lowered = {}, {}, 0
    for g in groups:
        if g["decision"] == "kernel":
            lowered += 1
            templates[g["template"]] = templates.get(g["template"], 0) + 1
        else:
            reasons[g["reason"]] = reasons.get(g["reason"], 0) + 1
    out = {"groups_seen": len(groups), "groups_lowered": lowered,
           "groups_fallback": len(groups) - lowered,
           "fallback_reasons": reasons, "templates": templates}
    out.update(counts)
    return out


def fusion_group_records():
    """Per-group drill-down: {digest: {tag, ops, template, decision,
    reason}}."""
    with _LOCK:
        return {d: dict(v) for d, v in _GROUPS.items()}


def reset_fusion_stats():
    """Forget decisions, built callables and counters."""
    with _LOCK:
        _GROUPS.clear()
        _KERNELS.clear()
        for k in _COUNTS:
            _COUNTS[k] = 0


def launch_counts():
    """Generated-kernel launches per template since the last reset."""
    with _LOCK:
        return dict(_LAUNCHES)


def reset_launch_counts():
    with _LOCK:
        for k in _LAUNCHES:
            _LAUNCHES[k] = 0


def _note_group(digest, tag, ops, template, decision, reason=None):
    with _LOCK:
        _GROUPS[digest] = {"tag": tag, "ops": tuple(ops),
                           "template": template, "decision": decision,
                           "reason": reason}


# ------------------------------------------------------- group structure
def _groups_in(nodes):
    """{tag: [member indices, topo order]} over GraphNode records."""
    groups = {}
    for i, gn in enumerate(nodes):
        tag = gn.extra.get("__fusion_group__")
        if tag is not None:
            groups.setdefault(tag, []).append(i)
    return groups


def _absorb_reductions(graph, groups):
    """Extend each chain by its sole-consumer trailing FULL reduction
    (axis=None, exclude off), so the reduction template computes the
    chain and its scalar in one kernel."""
    consumers = graph.consumers()
    heads = {s for s, _ in graph.heads}
    changed = 0
    for tag, members in groups.items():
        out = members[-1]
        if out in heads or len(consumers[out]) != 1:
            continue
        ci, _ = consumers[out][0]
        gn = graph.nodes[ci]
        if gn.is_variable or gn.extra.get("__fusion_group__"):
            continue
        try:
            od = gn.opdef()
        except MXNetError:
            continue
        if od.name not in REDUCE_OPS:
            continue
        params = gn.params()
        if params.get("axis") is not None or params.get("exclude"):
            continue
        if any(s != out for s, _ in gn.inputs):
            continue
        gn.extra["__fusion_group__"] = tag
        members.append(ci)
        changed += 1
    return changed


def _group_spec(nodes, members):
    """(spec, ext): one (op_name, params, wired_inputs) per member, wired
    entries ("m", member_pos) or ("x", ext_pos); ext lists the external
    (node_index, out_index) keys in first-use order."""
    pos = {m: j for j, m in enumerate(members)}
    ext, ext_index, spec = [], {}, []
    for m in members:
        gn = nodes[m]
        wired = []
        for src, oi in gn.inputs:
            if src in pos:
                wired.append(("m", pos[src]))
                continue
            key = (src, oi)
            if key not in ext_index:
                ext_index[key] = len(ext)
                ext.append(key)
            wired.append(("x", ext_index[key]))
        spec.append((gn.opdef().name, gn.params(), tuple(wired)))
    return spec, ext


def group_digest(spec, n_ext):
    """Structural digest of one group (ops, canonical params, internal
    wiring, external arity), equal to the JAX package's."""
    from ..symbol import _canon

    payload = tuple((op, _canon(params), wired)
                    for op, params, wired in spec)
    return hashlib.sha256(repr((payload, n_ext)).encode()).hexdigest()[:16]


def _template_of(spec):
    ops = [s[0] for s in spec]
    if ops[-1] in REDUCE_OPS:
        return "reduction"
    if (len(ops) == 3 and ops[0] in _MUL_OPS and ops[1] in _ADD_OPS
            and ops[2] in _ACT_OPS):
        return "scale_bias_act"
    return "elementwise"


def _static_reason(nodes, members, cfg):
    """Device-independent eligibility; None = candidate."""
    if not cfg.enabled:
        return "disabled"
    n_elem = 0
    for m in members:
        gn = nodes[m]
        try:
            od = gn.opdef()
        except MXNetError:
            return "unsupported_op:unknown"
        if od is None:
            return "unsupported_op:variable"
        name = od.name
        if name in ELEMWISE_OPS:
            n_elem += 1
        elif name in REDUCE_OPS:
            if m != members[-1]:
                return f"unsupported_op:{name}"
        else:
            return f"unsupported_op:{name}"
        if od.needs_rng or od.needs_mode or od.aux_names:
            return f"unsupported_op:{name}"
        if od.resolved_num_outputs(gn.params()) != 1:
            return f"unsupported_op:{name}"
    if n_elem < cfg.min_group:
        return "too_small"
    return None


# ------------------------------------------------------------- the pass
def codegen(graph):
    """The pipeline stage after fusion_hints: absorb trailing
    reductions, then stamp every group's output node with its verdict.
    Returns the candidate count (0 at fixpoint)."""
    cfg = codegen_config()
    groups = _groups_in(graph.nodes)
    changed = _absorb_reductions(graph, groups)
    stamps = {}
    n_candidates = 0
    for tag in sorted(groups):
        members = sorted(groups[tag])
        out = members[-1]
        reason = _static_reason(graph.nodes, members, cfg)
        if reason is None:
            spec, ext = _group_spec(graph.nodes, members)
            stamps[out] = f"candidate:{group_digest(spec, len(ext))}"
            n_candidates += 1
        else:
            stamps[out] = f"fallback:{reason}"
    for i, gn in enumerate(graph.nodes):
        want = stamps.get(i)
        if want != gn.extra.get("__fusion_codegen__"):
            changed += 1
            if want is None:
                del gn.extra["__fusion_codegen__"]
            else:
                gn.extra["__fusion_codegen__"] = want
    return changed and n_candidates


# ------------------------------------------------------- the plain chain
def group_lax_fn(spec):
    """The group's registry ops composed into one callable over the
    external inputs: the plain version of its kernel, and what its
    backward differentiates."""
    from ..ops import registry as _registry

    steps = [(_registry.get(op).fn, dict(params), wired)
             for op, params, wired in spec]

    def plain_fn(*ext_vals):
        vals = []
        for fn, params, wired in steps:
            ins = [ext_vals[w[1]] if w[0] == "x" else vals[w[1]]
                   for w in wired]
            vals.append(fn(*ins, **params))
        return vals[-1]

    return plain_fn


# ------------------------------------------------------ source emitters
_CTYPE = {torch.float32: "float", torch.bfloat16: "__nv_bfloat16",
          torch.float16: "__half"}


def _lit(v):
    """A float32 C literal of the parameter value, as the JAX package
    bakes the Python scalar into a float32 computation."""
    f = float(np.float32(v))
    if math.isnan(f):
        return "NAN"
    if math.isinf(f):
        return "INFINITY" if f > 0 else "(-INFINITY)"
    return repr(f) + "f"


def _fmt(template):
    return lambda p, a: template.format(*a)


def _scalar(template):
    return lambda p, a: template.format(a[0], _lit(p.get("scalar", 0.0)))


def _cast(p, a):
    dt = torch_dtype(p.get("dtype", "float32"))
    if dt in (torch.float32, torch.float64):
        return a[0]
    if dt == torch.bfloat16:
        return f"mxf::round_bf16({a[0]})"
    if dt == torch.float16:
        return f"mxf::round_f16({a[0]})"
    raise _Unsupported("unsupported_dtype")


def _activation(p, a):
    act = p.get("act_type", "relu")
    fn = {"relu": "mxf::relu", "sigmoid": "mxf::sigmoid", "tanh": "tanhf",
          "softrelu": "mxf::softplus"}.get(act)
    if fn is None:
        raise _Unsupported(f"unsupported_op:Activation:{act}")
    return f"{fn}({a[0]})"


def _smooth_l1(p, a):
    s2 = float(p.get("scalar", 1.0)) ** 2
    x = a[0]
    return (f"(fabsf({x}) < {_lit(1.0 / s2)} ? {_lit(0.5 * s2)} * ({x} * "
            f"{x}) : fabsf({x}) - {_lit(0.5 / s2)})")


# op name -> (params, argument expressions) -> float32 C expression
_EXPR = {
    "relu": _fmt("mxf::relu({0})"),
    "sigmoid": _fmt("mxf::sigmoid({0})"),
    "tanh": _fmt("tanhf({0})"),
    "exp": _fmt("expf({0})"),
    "log": _fmt("logf({0})"),
    "log1p": _fmt("log1pf({0})"),
    "expm1": _fmt("expm1f({0})"),
    "sqrt": _fmt("sqrtf({0})"),
    "rsqrt": _fmt("(1.f / sqrtf({0}))"),
    "square": _fmt("({0} * {0})"),
    "abs": _fmt("fabsf({0})"),
    "sign": _fmt("mxf::sign({0})"),
    "negative": _fmt("(-{0})"),
    "reciprocal": _fmt("(1.f / {0})"),
    "softsign": _fmt("({0} / (1.f + fabsf({0})))"),
    "erf": _fmt("erff({0})"),
    "identity": _fmt("{0}"),
    "_copy": _fmt("{0}"),
    "cast": _cast,
    "clip": lambda p, a: (f"mxf::clip({a[0]}, {_lit(p['a_min'])}, "
                          f"{_lit(p['a_max'])})"),
    "Activation": _activation,
    "smooth_l1": _smooth_l1,
    "elemwise_add": _fmt("({0} + {1})"),
    "elemwise_sub": _fmt("({0} - {1})"),
    "elemwise_mul": _fmt("({0} * {1})"),
    "elemwise_div": _fmt("({0} / {1})"),
    "_power": _fmt("powf({0}, {1})"),
    "_maximum": _fmt("mxf::maxf({0}, {1})"),
    "_minimum": _fmt("mxf::minf({0}, {1})"),
    "_mod": _fmt("mxf::pymod({0}, {1})"),
    "broadcast_add": _fmt("({0} + {1})"),
    "broadcast_sub": _fmt("({0} - {1})"),
    "broadcast_mul": _fmt("({0} * {1})"),
    "broadcast_div": _fmt("({0} / {1})"),
    "broadcast_power": _fmt("powf({0}, {1})"),
    "broadcast_maximum": _fmt("mxf::maxf({0}, {1})"),
    "broadcast_minimum": _fmt("mxf::minf({0}, {1})"),
    "_plus_scalar": _scalar("({0} + {1})"),
    "_minus_scalar": _scalar("({0} - {1})"),
    "_rminus_scalar": _scalar("({1} - {0})"),
    "_mul_scalar": _scalar("({0} * {1})"),
    "_div_scalar": _scalar("({0} / {1})"),
    "_rdiv_scalar": _scalar("({1} / {0})"),
    "_power_scalar": _scalar("powf({0}, {1})"),
    "_rpower_scalar": _scalar("powf({1}, {0})"),
    "_maximum_scalar": _scalar("mxf::maxf({0}, {1})"),
    "_minimum_scalar": _scalar("mxf::minf({0}, {1})"),
}

_REDUCE_FINAL = {"sum": ("mxf::SumOp", "acc"),
                 "mean": ("mxf::SumOp", "acc / (float)n"),
                 "max": ("mxf::MaxOp", "acc"),
                 "min": ("mxf::MinOp", "acc")}


def _chain_source(chain, n_ext):
    lines = []
    for j, (op, params, wired) in enumerate(chain):
        emit = _EXPR.get(op)
        if emit is None:
            raise _Unsupported(f"unsupported_op:{op}")
        args = [f"x{w[1]}" if w[0] == "x" else f"v{w[1]}" for w in wired]
        lines.append(f"  const float v{j} = {emit(params, args)};")
    sig = ", ".join(f"float x{i}" for i in range(n_ext))
    body = "\n".join(lines)
    return (f"__device__ __forceinline__ float chain({sig}) {{\n{body}\n"
            f"  return v{len(chain) - 1};\n}}\n")


def _vec_width(in_dtypes, out_dtype):
    """Elements per 16-byte access of the widest type in the kernel."""
    widest = max(torch.empty((), dtype=d).element_size()
                 for d in (*in_dtypes, out_dtype))
    return 16 // widest


def group_source(spec, template, in_dtypes, out_dtype, digest="group"):
    """The CUDA C++ source of one group for the given external input
    dtypes and output dtype (torch dtypes). Raises _Unsupported with the
    fallback reason when a dtype or op has no device form."""
    for d in (*in_dtypes, out_dtype):
        if d not in _CTYPE:
            raise _Unsupported("unsupported_dtype")
    n_ext = len(in_dtypes)
    in_t = [_CTYPE[d] for d in in_dtypes]
    out_t = _CTYPE[out_dtype]
    params = ", ".join(f"const {t}* __restrict__ in{i}"
                       for i, t in enumerate(in_t))
    casts = ", ".join(f"(const {t}*)ins[{i}]" for i, t in enumerate(in_t))
    scalar_args = ", ".join(f"mxf::to_f(in{i}[i])" for i in range(n_ext))
    head = (f"// generated by mxnet_tpu_torch/passes/codegen.py: fusion "
            f"group {digest}, template {template}\n"
            f"// ops: {', '.join(op for op, _, _ in spec)}\n"
            f"#include \"fusion_codegen.cuh\"\n\n")
    if template == "reduction":
        op_struct, final = _REDUCE_FINAL[spec[-1][0]]
        return head + _chain_source(spec[:-1], n_ext) + f"""
__global__ void __launch_bounds__({_THREADS}) fused_partials(
    {params}, float* __restrict__ partials, long long n) {{
  float acc = {op_struct}::init();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride)
    acc = {op_struct}::apply(acc, chain({scalar_args}));
  acc = mxf::block_reduce<{op_struct}>(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}}

__global__ void __launch_bounds__(1024) fused_final(
    const float* __restrict__ partials, int n_parts,
    {out_t}* __restrict__ out, long long n) {{
  float acc = {op_struct}::init();
  for (int i = threadIdx.x; i < n_parts; i += blockDim.x)
    acc = {op_struct}::apply(acc, partials[i]);
  acc = mxf::block_reduce<{op_struct}>(acc);
  if (threadIdx.x == 0) out[0] = mxf::from_f<{out_t}>({final});
}}

extern "C" int mxf_launch_reduce(const void* const* ins, void* out,
                                 void* partials, long long n, int blocks,
                                 void* stream) {{
  cudaStream_t s = (cudaStream_t)stream;
  fused_partials<<<blocks, {_THREADS}, 0, s>>>({casts}, (float*)partials,
                                               n);
  fused_final<<<1, 1024, 0, s>>>((const float*)partials, blocks,
                                 ({out_t}*)out, n);
  return (int)cudaGetLastError();
}}
"""
    vec = _vec_width(in_dtypes, out_dtype)
    loads = "\n".join(
        f"    float a{i}[{vec}];\n"
        f"    mxf::load<{vec}>(in{i} + base, a{i});" for i in range(n_ext))
    vec_args = ", ".join(f"a{i}[k]" for i in range(n_ext))
    return head + _chain_source(spec, n_ext) + f"""
__global__ void __launch_bounds__({_THREADS}) fused_kernel(
    {params}, {out_t}* __restrict__ out, long long n, long long nvec) {{
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long v = tid; v < nvec; v += stride) {{
    const long long base = v * {vec};
{loads}
    float r[{vec}];
#pragma unroll
    for (int k = 0; k < {vec}; ++k) r[k] = chain({vec_args});
    mxf::store<{vec}>(out + base, r);
  }}
  for (long long i = nvec * {vec} + tid; i < n; i += stride)
    out[i] = mxf::from_f<{out_t}>(chain({scalar_args}));
}}

extern "C" int mxf_launch(const void* const* ins, void* out, long long n,
                          int vec_ok, int blocks, void* stream) {{
  const long long nvec = vec_ok ? n / {vec} : 0;
  fused_kernel<<<blocks, {_THREADS}, 0, (cudaStream_t)stream>>>(
      {casts}, ({out_t}*)out, n, nvec);
  return (int)cudaGetLastError();
}}
"""


# ------------------------------------------------------ kernel wrappers
_SMS = {}


def _sm_count(dev):
    n = _SMS.get(dev.index)
    if n is None:
        n = _SMS[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return n


class GeneratedKernel:
    """One compiled group kernel: the ctypes entry of its generated
    library, with the checks and the launch count of a wrapper."""

    def __init__(self, template, tag, source, in_dtypes, out_dtype):
        self.template = template
        self.tag = tag
        self.source = source
        self.in_dtypes = tuple(in_dtypes)
        self.out_dtype = out_dtype
        self.vec = _vec_width(in_dtypes, out_dtype)
        self.launches = 0
        self._entry = None

    def _fn(self):
        if self._entry is None:
            from .. import kernels

            lib = kernels.load_generated(self.tag, self.source)
            ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            if self.template == "reduction":
                fn = lib.mxf_launch_reduce
                fn.argtypes = [ptr, ptr, ptr, i64, i32, ptr]
            else:
                fn = lib.mxf_launch
                fn.argtypes = [ptr, ptr, i64, i32, i32, ptr]
            fn.restype = i32
            self._entry = fn
        return self._entry

    def _check(self, xs):
        dev = xs[0].device
        if dev.type != "cuda":
            raise MXNetError(
                f"generated fusion kernel {self.tag} takes CUDA tensors, "
                f"got {dev}")
        shape = tuple(xs[0].shape)
        for i, (x, want) in enumerate(zip(xs, self.in_dtypes)):
            if x.device != dev:
                raise MXNetError(f"{self.tag}: input {i} is on {x.device}, "
                                 f"input 0 on {dev}")
            if x.dtype != want:
                raise MXNetError(f"{self.tag}: input {i} is {x.dtype}, the "
                                 f"kernel was built for {want}")
            if tuple(x.shape) != shape:
                raise MXNetError(f"{self.tag}: input shapes differ "
                                 f"({tuple(x.shape)} vs {shape})")
            if not x.is_contiguous():
                raise MXNetError(f"{self.tag}: input {i} is not "
                                 f"contiguous")
        if len(xs) != len(self.in_dtypes):
            raise MXNetError(f"{self.tag}: {len(xs)} inputs, the kernel "
                             f"takes {len(self.in_dtypes)}")
        return dev

    def __call__(self, *xs, out_shape, count=True):
        """Launch on CUDA tensors; returns a new output tensor of
        `out_shape`. `count=False` for launches made only to compare the
        kernel with its plain version."""
        dev = self._check(xs)
        out = torch.empty(out_shape, dtype=self.out_dtype, device=dev)
        n = xs[0].numel()
        ins = (ctypes.c_void_p * len(xs))(*[x.data_ptr() for x in xs])
        with torch.cuda.device(dev):
            stream = ctypes.c_void_p(torch.cuda.current_stream(
                dev).cuda_stream)
            if self.template == "reduction":
                blocks = max(1, min(-(-n // (_THREADS * 8)),
                                    _REDUCE_MAX_BLOCKS))
                partials = torch.empty(blocks, dtype=torch.float32,
                                       device=dev)
                err = self._fn()(ins, out.data_ptr(), partials.data_ptr(),
                                 n, blocks, stream)
            else:
                vec_ok = int(all(
                    t.data_ptr() % (self.vec * t.element_size()) == 0
                    for t in (*xs, out)))
                work = n // self.vec if vec_ok else n
                blocks = max(1, min(-(-work // _THREADS),
                                    _sm_count(dev) * 8))
                err = self._fn()(ins, out.data_ptr(), n, vec_ok, blocks,
                                 stream)
        if err != 0:
            raise MXNetError(f"generated fusion kernel {self.tag} launch "
                             f"failed: CUDA error {err}")
        if count:
            self.launches += 1
            with _LOCK:
                _LAUNCHES[self.template] += 1
        return out


class _FusedFunction(torch.autograd.Function):
    """Forward through the group's kernel (or its plain version on the
    CPU); backward through the plain chain recomputed on the saved
    inputs."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        ctx.save_for_backward(*xs)
        out = group.run(*xs)
        if any(out is x for x in xs):
            out = out.clone()
        return out

    @staticmethod
    def backward(ctx, g):
        xs = ctx.saved_tensors
        need = ctx.needs_input_grad[1:]
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_(bool(n))
                      for x, n in zip(xs, need)]
            wrt = [x for x, n in zip(leaves, need) if n]
            y = ctx.group.plain_fn(*leaves)
            grads = iter(torch.autograd.grad(y, wrt, g, allow_unused=True)
                         if wrt else ())
        return (None, *[next(grads) if n else None for n in need])


class FusedGroup:
    """A group's fused callable for one bind signature (`in_avals`, a
    (shape, torch dtype) per external input): `kernel` is its
    GeneratedKernel on the card, None for a CPU bind."""

    def __init__(self, digest, template, spec, in_avals, out_shape,
                 out_dtype, kernel=None):
        self.digest = digest
        self.template = template
        self.spec = spec
        self.in_avals = tuple(in_avals)
        self.plain_fn = group_lax_fn(spec)
        self.out_shape = tuple(out_shape)
        self.out_dtype = out_dtype
        self.kernel = kernel

    def run(self, *xs):
        """The forward value, without autograd: the kernel on CUDA
        tensors, the plain version on CPU tensors."""
        dev = xs[0].device
        if dev.type == "cpu":
            return self.plain_fn(*xs)
        if dev.type != "cuda" or self.kernel is None:
            raise MXNetError(f"fusion group {self.digest} has no kernel for "
                             f"{dev}")
        return self.kernel(*xs, out_shape=self.out_shape)

    def __call__(self, *xs):
        return _FusedFunction.apply(self, *xs)


# ------------------------------------------------------------ parity
def _seeded_inputs(ext_avals, digest, device):
    """Parity inputs seeded from the group digest: floats in [0.5, 1.5]
    (away from activation kinks and division zeros)."""
    rs = np.random.RandomState(int(digest[:8], 16) & 0x7FFFFFFF)
    return [torch.from_numpy(rs.uniform(0.5, 1.5, s).astype(np.float32))
            .to(device=device, dtype=d) for s, d in ext_avals]


def parity_error(group, ins, got):
    """(max abs error, ok) of the output `got` of `group`'s kernel
    against its plain chain on the inputs `ins`.

    An elementwise chain is held to the plain chain in float32 on the
    upcast inputs, stored in the output dtype: the same arithmetic, so
    rtol 1e-6 (one rounding to the output dtype for bf16 and fp16). A
    reduction is held to the chain summed in float64, within
    REDUCE_RTOL of the sum of the magnitudes of its terms (float32
    accumulation in another order than the reference's; exact for max
    and min)."""
    with torch.no_grad():
        rtol = _LOWP_RTOL.get(group.out_dtype, PARITY_RTOL)
        atol = PARITY_ATOL
        if group.template == "reduction":
            xs = [x.double() for x in ins]
            want = group.plain_fn(*xs)
            op = group.spec[-1][0]
            if op in ("sum", "mean"):
                terms = group_lax_fn(group.spec[:-1])(*xs).abs()
                scale = terms.sum() if op == "sum" else terms.mean()
                atol += REDUCE_RTOL * float(scale)
        else:
            want = group.plain_fn(*[x.float() for x in ins])
        want = want.to(group.out_dtype).double()
        got = got.double()
        # an output that overflows its dtype agrees when both sides do
        same = (got == want) | (got.isnan() & want.isnan())
        err = torch.where(same, 0.0, (got - want).abs())
        ok = (tuple(got.shape) == tuple(want.shape)
              and bool((err <= atol + rtol * want.abs()).all()))
        return float(err.max()), ok


def _parity_ok(group, ext_avals, device):
    """The group's forward against the plain chain on digest-seeded
    inputs (`parity_error`)."""
    ins = _seeded_inputs(ext_avals, group.digest, device)
    if group.kernel is not None:
        got = group.kernel(*ins, out_shape=group.out_shape, count=False)
    else:
        got = group.run(*ins)
    return parity_error(group, ins, got)[1]


# -------------------------------------------------------------- planning
@dataclass(frozen=True)
class CodegenPlan:
    """Executor routing for one optimized symbol: `skip` are node
    indices computed inside a fused kernel, `fused` maps each group's
    output index to (callable, external (index, out_i) keys), and
    `cache_component` records every group's final decision."""

    skip: frozenset
    fused: dict
    cache_component: tuple


_EMPTY_PLAN = CodegenPlan(frozenset(), {}, ())


def _prepare(spec, ext_avals, digest, template):
    """Shape/dtype checks and source emission for one group and bind
    signature: ("demoted", reason) or ("emit", (source, out_shape,
    out_dtype))."""
    plain = group_lax_fn(spec)
    try:
        with torch.no_grad():
            out = plain(*[torch.empty(s, dtype=d, device="meta")
                          for s, d in ext_avals])
    except Exception:
        return ("demoted", "irregular_shapes")
    if (not all(d.is_floating_point for _, d in ext_avals)
            or not out.dtype.is_floating_point):
        return ("demoted", "unsupported_dtype")
    out_shape = tuple(out.shape)
    shapes = {tuple(s) for s, _ in ext_avals}
    if template == "reduction":
        if len(shapes) != 1:
            return ("demoted", "irregular_shapes")
    elif any(tuple(s) != out_shape for s, _ in ext_avals):
        return ("demoted", "irregular_shapes")
    try:
        source = group_source(spec, template, [d for _, d in ext_avals],
                              out.dtype, digest)
    except _Unsupported as e:
        return ("demoted", str(e))
    return ("emit", (source, out_shape, out.dtype))


def plan_for(symbol, input_shapes=None, device=None):
    """Codegen plan for an optimized (pipeline-stamped) symbol.

    `input_shapes` maps variable names to shapes (args + auxs); without
    it every candidate falls back with reason "irregular_shapes".
    `device` (the card when None) picks the build: on CUDA every new
    kernel of the bind is compiled (one nvcc each, started together),
    parity-checked, and raises MXNetError on any failure. Node indices
    refer to `symbol._topo` order."""
    from ..context import resolve_device
    from ..symbol import _graph_infer, _topo
    from .ir import Graph

    graph = Graph.from_symbol(symbol)
    groups = _groups_in(graph.nodes)
    if not groups:
        return _EMPTY_PLAN
    dev = resolve_device(device)
    cfg = codegen_config()
    order = _topo(symbol._outputs)
    shapes = dtypes = None
    if input_shapes:
        try:
            shapes, dtypes = _graph_infer(
                symbol._outputs,
                {k: tuple(v) for k, v in input_shapes.items()}, {},
                partial=True)
        except Exception:
            shapes = dtypes = None

    decided = []   # (tag, members, out, digest, spec, decision)
    to_build = {}  # cache key -> (digest, spec, template, avals, emitted)
    for tag in sorted(groups):
        members = sorted(groups[tag])
        out = members[-1]
        stamp = graph.nodes[out].extra.get("__fusion_codegen__", "")
        spec, ext = _group_spec(graph.nodes, members)
        if not cfg.enabled:
            # live check: a memoized candidate stamp may predate the knob
            decision = ("fallback", "disabled")
            digest = group_digest(spec, len(ext))
        elif stamp.startswith("candidate:"):
            digest = stamp[len("candidate:"):]
            decision = _lower(spec, ext, digest, order, shapes, dtypes, dev,
                              to_build)
        else:
            digest = group_digest(spec, len(ext))
            decision = ("fallback", stamp[len("fallback:"):]
                        if stamp.startswith("fallback:") else "unplanned")
        decided.append((tag, members, out, digest, spec, ext, decision))

    if to_build:
        _build(to_build, dev)

    skip, fused, component = set(), {}, []
    for tag, members, out, digest, spec, ext, decision in decided:
        decision = _resolved(decision)
        ops = [s[0] for s in spec]
        template = _template_of(spec)
        if decision[0] == "kernel":
            skip.update(members[:-1])
            fused[out] = (decision[1], tuple(ext))
            component.append((tag, f"kernel:{digest}"))
            _note_group(digest, tag, ops, template, "kernel")
        else:
            component.append((tag, f"fallback:{decision[1]}"))
            _note_group(digest, tag, ops, template, "fallback", decision[1])
    return CodegenPlan(frozenset(skip), fused, tuple(component))


def _lower(spec, ext, digest, order, shapes, dtypes, dev, to_build):
    """One candidate's decision for this bind: ("kernel", callable),
    ("fallback", reason), or ("pending", cache key) for a group whose
    kernel this bind builds."""
    if shapes is None:
        return ("fallback", "irregular_shapes")
    avals = []
    for src, oi in ext:
        s = shapes.get((order[src], oi))
        if s is None:
            return ("fallback", "irregular_shapes")
        d = (dtypes or {}).get((order[src], oi), np.float32)
        avals.append((tuple(int(x) for x in s), torch_dtype(d)))
    return _decide(spec, digest, avals, dev, to_build)


def _decide(spec, digest, avals, dev, to_build):
    """The decision for one group and input signature (shape, torch
    dtype) per external input, from the cache or queued in
    `to_build`."""
    key = (digest, tuple(avals), dev.type)
    with _LOCK:
        if key in _KERNELS:
            return _resolved(("pending", key))
    if key not in to_build:
        template = _template_of(spec)
        prepared = _prepare(spec, avals, digest, template)
        if prepared[0] == "demoted":
            with _LOCK:
                _KERNELS[key] = prepared
            return ("fallback", prepared[1])
        to_build[key] = (digest, spec, template, avals, prepared[1])
    return ("pending", key)


def _resolved(decision):
    """A ("pending", cache key) decision read back from the kernel cache
    as ("kernel", callable) or ("fallback", reason)."""
    if decision[0] != "pending":
        return decision
    with _LOCK:
        status, payload = _KERNELS[decision[1]]
    return ("kernel", payload) if status == "ok" else ("fallback", payload)


def build_groups(requests, device=None):
    """The fused callables of the given (spec, avals) groups on
    `device` (the card when None), each built, checked and cached as a
    bind builds it: one nvcc per new source, all started together.
    `avals` lists (shape, torch dtype) per external input. Raises
    MXNetError when a group cannot lower for that signature."""
    from ..context import resolve_device

    dev = resolve_device(device)
    to_build, decisions = {}, []
    for spec, avals in requests:
        digest = group_digest(spec, len(avals))
        decisions.append(_decide(spec, digest, [(tuple(s), d)
                                                for s, d in avals],
                                 dev, to_build))
    if to_build:
        _build(to_build, dev)
    out = []
    for decision in map(_resolved, decisions):
        if decision[0] != "kernel":
            raise MXNetError(f"fusion group does not lower: {decision[1]}")
        out.append(decision[1])
    return out


def _build(to_build, dev):
    """Compile every new kernel of a bind together (CUDA), then
    parity-check each group and record its callable. Raises MXNetError
    on a compiler, launch or parity failure."""
    kernels = {}
    if dev.type == "cuda":
        from .. import kernels as _kernels

        items = {}
        for key, (digest, spec, template, avals, emitted) in \
                to_build.items():
            source = emitted[0]
            tag = f"fusion_{template}_{digest}"
            items[source] = tag
            kernels[key] = GeneratedKernel(template, tag, source,
                                           [d for _, d in avals],
                                           emitted[2])
        _kernels.build_generated([(tag, src) for src, tag in items.items()])
    for key, (digest, spec, template, avals, emitted) in to_build.items():
        _, out_shape, out_dtype = emitted
        group = FusedGroup(digest, template, spec, avals, out_shape,
                           out_dtype, kernels.get(key))
        ok = _parity_ok(group, avals, dev)
        with _LOCK:
            _COUNTS["parity_checks"] += 1
            if not ok:
                _COUNTS["parity_failures"] += 1
        if not ok:
            raise MXNetError(
                f"fusion group {digest} ({template}): the generated kernel "
                f"disagrees with its plain version on seeded inputs "
                f"(passes.codegen.parity_error) on {dev}")
        with _LOCK:
            _COUNTS["kernels_built"] += 1
            _KERNELS[key] = ("ok", group)
