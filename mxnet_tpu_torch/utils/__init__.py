"""Utilities: the runtime config/flag system.

Every supported MXNET_* variable is declared once in a registry with
type, default and help, and read through the typed getter
`getenv(name)`. Only the knobs the ported slices read (decode serving,
the graph passes and the fusion codegen) are registered here.

`MXNET_DECODE_KERNEL` and `MXNET_FUSION_INTERPRET` have no counterpart:
the device of the tensors decides between a hand-written or generated
CUDA kernel (CUDA tensor) and its plain PyTorch version (CPU tensor).
"""
from __future__ import annotations

import os
from dataclasses import dataclass

from ..base import MXNetError


@dataclass
class EnvVar:
    name: str
    type: type
    default: object
    help: str


_ENV_REGISTRY: dict[str, EnvVar] = {}


def register_env(name, type_, default, help_):
    _ENV_REGISTRY[name] = EnvVar(name, type_, default, help_)


def getenv(name):
    """Typed read of a registered MXNET_* variable."""
    if name not in _ENV_REGISTRY:
        raise MXNetError(f"unknown env var {name!r}")
    spec = _ENV_REGISTRY[name]
    raw = os.environ.get(name)
    if raw is None:
        return spec.default
    if spec.type is bool:
        return raw not in ("0", "false", "False", "")
    return spec.type(raw)


register_env(
    "MXNET_DECODE_PAGE_SIZE", int, 16,
    "decoding: tokens per KV-cache page. Smaller pages waste fewer "
    "slots per sequence (worst case page_size-1 tokens) but grow the "
    "page table and the decode-step gather fan-out.",
)
register_env(
    "MXNET_DECODE_PAGES", int, 64,
    "decoding: total pages in the pre-allocated device KV pool "
    "(page 0 is reserved scratch, so capacity is PAGES-1). When it "
    "runs out the scheduler preempts the lowest-priority sequence "
    "instead of running out of memory.",
)
register_env(
    "MXNET_DECODE_MAX_BATCH", int, 4,
    "decoding: rows in the fixed-shape continuous decode batch. "
    "Every decode step runs at exactly this batch (inactive rows "
    "masked), which keeps the step shape grid finite and fully "
    "exercised at warmup.",
)
register_env(
    "MXNET_DECODE_PAGE_BUCKETS", str, "",
    "decoding: comma list of pages-per-sequence buckets (e.g. "
    "'2,4,8'); the decode-step shape is a function only of "
    "(max_batch, bucket). Empty = powers of two up to the "
    "pool-derived per-sequence maximum.",
)
register_env(
    "MXNET_DECODE_MERGED_STEP", bool, True,
    "decoding: run prefix-cache tail-prefill tokens as extra rows of "
    "the fixed-shape decode step (ragged paged attention). Applies "
    "when the prefix cache is on and speculative decoding is off; 0 "
    "restores the split grid of tail-prefill shapes per length "
    "bucket.",
)
register_env(
    "MXNET_DECODE_KV_DTYPE", str, "float32",
    "decoding: KV page-pool storage precision — float32 (default), "
    "bf16, or int8. int8 stores pages quantized with a float32 scale "
    "plane per (page, slot, head), quantized at scatter time and "
    "dequantized inside the attention kernel. fp8 is reserved.",
)
register_env(
    "MXNET_DECODE_RING_PREFILL", int, 0,
    "decoding: minimum padded prompt length that would route prefill "
    "through ring attention. Only 0 is accepted in this package.",
)
register_env(
    "MXNET_DECODE_MAX_TOKENS", int, 32,
    "decoding: default max_new_tokens for generate()/submit() when "
    "the request does not say (always also bounded by KV capacity).",
)
register_env(
    "MXNET_DECODE_QUEUE_CAP", int, 256,
    "decoding: bounded admission queue of the continuous-batching "
    "scheduler; a full queue fast-fails submit() with "
    "ServerBusyError.",
)
register_env(
    "MXNET_DECODE_PREFIX_CACHE", bool, True,
    "decoding: cache full prompt-prefix KV pages in a radix index "
    "and map them into new sequences instead of re-prefilling. "
    "Cached-but-idle pages are evicted LRU under pool pressure "
    "before any live sequence is preempted. 0 disables.",
)
register_env(
    "MXNET_DECODE_SPEC_K", int, 4,
    "decoding: draft tokens proposed per speculative step. The target "
    "verifies all K+1 positions in one fixed-shape multi-query pass "
    "and emits 1..K+1 tokens per step; output is distribution-"
    "identical to target-only decoding (exactly equal under greedy). "
    "Only active when a draft model is loaded.",
)
register_env(
    "MXNET_DECODE_SPEC_DRAFT", str, "",
    "decoding: default draft-model spec for DecodedModel. 'self' = the "
    "target drafts for itself (acceptance ~1). Empty = no draft; "
    "speculative decoding is then off unless a draft params dict is "
    "passed explicitly.",
)
register_env(
    "MXNET_DECODE_SAMPLING_TEMPERATURE", float, 0.0,
    "decoding: default sampling temperature for requests that do not "
    "pass SamplingParams. <= 0 is greedy argmax; > 0 samples inside "
    "the decode step from the request's (seed, position) stream.",
)
register_env(
    "MXNET_DECODE_SAMPLING_TOP_K", int, 0,
    "decoding: default top-k cutoff for sampled requests (0 = off).",
)
register_env(
    "MXNET_DECODE_SAMPLING_TOP_P", float, 1.0,
    "decoding: default nucleus (top-p) mass for sampled requests "
    "(1.0 = off).",
)
register_env(
    "MXNET_DECODE_SAMPLING_SEED", int, 0,
    "decoding: default per-request sampling seed.",
)
register_env(
    "MXNET_NUMERICS_DECODE_GUARD", bool, False,
    "numerics: decode-tier logits guard — each decode step also "
    "keeps a device-side count of non-finite logits on active rows "
    "and of int8 K/V clips, drained into decodingStats "
    "(nonfinite_logit_*, quant_clip_*).",
)
register_env(
    "MXNET_GRAPH_PASSES", str, "1",
    "graph-optimization pass pipeline run on every bind "
    "(mxnet_tpu_torch.passes): '1'/'on' = the default pipeline (dce, "
    "fold, cse, canonicalize, fusion_hints, codegen); '0'/'off' "
    "bypasses it; a comma list selects and orders passes.",
)
register_env(
    "MXNET_PASS_FOLD_MAX", int, 65536,
    "constant folding's per-tensor element cap: a constant subgraph "
    "whose result exceeds this many elements stays in the graph.",
)
register_env(
    "MXNET_FUSION_CODEGEN", bool, True,
    "fusion codegen (passes.codegen): lower __fusion_group__ chains to "
    "generated CUDA kernels at bind time. 0 = every group runs op by op "
    "(counted as fallback 'disabled').",
)
register_env(
    "MXNET_FUSION_MIN_GROUP", int, 2,
    "fusion codegen: minimum elementwise ops in a fusion group before a "
    "kernel is generated; smaller groups fall back with reason "
    "'too_small'.",
)
