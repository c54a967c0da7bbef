"""Utilities: the runtime config/flag system.

Every supported MXNET_* variable is declared once in a registry with
type, default and help, and read through the typed getter
`getenv(name)`. Only the knobs the ported slices read are registered
here.

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


def describe_env():
    """All registered vars with current values (env_var.md analog)."""
    lines = []
    for spec in sorted(_ENV_REGISTRY.values(), key=lambda s: s.name):
        cur = getenv(spec.name)
        lines.append(
            f"{spec.name}={cur!r} (default {spec.default!r}) — "
            f"{spec.help}"
        )
    return "\n".join(lines)


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
    "MXNET_DISPATCH_AHEAD", int, 2,
    "max in-flight training steps the fit loop keeps dispatched ahead "
    "of the card (module/base_module.py _DispatchWindow): batch N+1 is "
    "staged while step N runs; each in-flight step holds its batch and "
    "activations in device memory. 0 blocks on every step.",
)
register_env(
    "MXNET_TPU_OPT_STATE_DTYPE", str, "",
    "dtype for optimizer state (momentum/moments) in the fused train "
    "step, e.g. 'bfloat16'; the update computes in float32 and rounds "
    "back on store (parallel/dp_step.py). Empty = weight dtype.",
)
register_env(
    "MXNET_TPU_OPT_BUCKET", bool, False,
    "flat-bucket optimizer update in the fused train step: ONE "
    "apply_dense over all trainable parameters held as views into one "
    "flat buffer (and one per optimizer-state leaf) instead of one per "
    "parameter; off when the parameters' dtypes or state structures "
    "differ (parallel/dp_step.py _bucket_plan).",
)
register_env(
    "MXNET_TPU_BUCKET_FUSED", bool, False,
    "fused train steps for BucketingModule: each bucket captures its "
    "own step over the one canonical parameter and state storage, and "
    "a bucket switch hands the step count and flags over "
    "(module/bucketing_module.py _ensure_owner); the default keeps the "
    "buckets' shared-array eager updates.",
)
register_env(
    "MXNET_TPU_FAULT_INJECT", str, "",
    "fault injection (mxnet_tpu_torch.fault): 'epoch:N' raises after "
    "epoch N's checkpoint is durable; 'step:N' raises at global batch "
    "N, the mid-epoch hard resume case; 'kill:step:N' sends SIGKILL to "
    "the process at global batch N, with no unwind, finally or atexit; "
    "'nan:step:N[:param]' poisons one gradient with NaN on the card at "
    "fused step N and training goes on (FaultInjector, "
    "parse_nan_inject). Fires once.",
)
register_env(
    "MXNET_PROFILING", bool, True,
    "profiling: executable accounting of every captured program (the "
    "fused train step and its k-step replays, the decode cells, the "
    "exec cache's binds) into the deviceStats view, and the HBM "
    "pre-flight at bind. 0 skips all recording.",
)
register_env(
    "MXNET_PROFILING_HBM_STRICT", bool, False,
    "profiling: the HBM pre-flight raises HBMPreflightError instead of "
    "warning when a bind's estimated footprint exceeds the card's "
    "memory.",
)
register_env(
    "MXNET_PROFILING_DEVICE_MEM_BYTES", int, 0,
    "profiling: device memory cap in bytes for the HBM pre-flight; 0 "
    "asks torch.cuda.get_device_properties (none on the CPU).",
)
register_env(
    "MXNET_PROFILING_OPT_FACTOR", str, "2.0",
    "profiling: optimizer-state bytes per gradient byte assumed by the "
    "HBM pre-flight (2.0 = Adam's two moments).",
)
register_env(
    "MXNET_PROFILING_TOPK", int, 20,
    "profiling: rows of the deviceTimelineStats top-K table.",
)
register_env(
    "MXNET_PROFILING_MAX_SIGS", int, 64,
    "profiling: per-program cap on recorded input signatures.",
)
register_env(
    "MXNET_CALIBRATION_CACHE", str,
    "~/.cache/mxnet_tpu/calibration.json",
    "profiling: CalibrationStore file (measured step/forward seconds "
    "keyed by canonical graph digest, platform and kind), the JAX "
    "package's format.",
)
register_env(
    "MXNET_NUMERICS", bool, False,
    "numerics: enable the run-health layer in fit (a sentinel row per "
    "fused step, drained in one fetch per MXNET_NUMERICS_INTERVAL "
    "steps, anomaly rules, first-bad-op attribution).",
)
register_env(
    "MXNET_NUMERICS_INTERVAL", int, 10,
    "numerics: steps between sentinel drains; <= 0 drains only at "
    "epoch ends.",
)
register_env(
    "MXNET_NUMERICS_HISTORY", int, 64,
    "numerics: sentinel rows kept in the in-memory history ring.",
)
register_env(
    "MXNET_NUMERICS_RUNLOG", str, "",
    "numerics: path of the append-only JSONL run event log; '' "
    "disables.",
)
register_env(
    "MXNET_NUMERICS_SPIKE", str, "8.0",
    "numerics: grad-norm spike threshold (x its EWMA).",
)
register_env(
    "MXNET_NUMERICS_ATTRIBUTION", bool, True,
    "numerics: on a nonfinite anomaly, replay the saved step inputs "
    "through the executor's monitored pass to name the first op "
    "whose output is non-finite.",
)
register_env(
    "MXNET_GRAPH_PASSES", str, "1",
    "graph-optimization pass pipeline run on every bind "
    "(mxnet_tpu_torch.passes): '1'/'on' = the default pipeline (dce, "
    "fold, cse, canonicalize, fusion_hints, codegen); '0'/'off' "
    "bypasses it; a comma list selects and orders passes, e.g. "
    "'dce,fold,cse,layout,canonicalize,fusion_hints,codegen' to add "
    "the opt-in NCHW->NHWC layout rewrite.",
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
register_env(
    "MXNET_EXEC_CACHE", bool, True,
    "process-wide bind-plan cache (exec_cache): executors bound to the "
    "same graph signature + shapes share one plan (optimized graph, "
    "walk order, fusion kernels). 0 disables sharing: every bind builds "
    "a private plan.",
)
register_env(
    "MXNET_EXEC_CACHE_SIZE", int, 64,
    "LRU bound on retained exec_cache entries.",
)
register_env(
    "MXNET_EXEC_CACHE_DIR", str, "",
    "disk tier of the exec cache (mxnet_tpu_torch.exec_cache_disk): a "
    "directory holding per-entry records (optimized graph JSON, input "
    "signatures, layout, fusion decisions, walk order) plus the kernel "
    "libraries each plan launches, as blobs checked by their sha256. A "
    "process restart then rebinds a seen graph with no plan built and "
    "no nvcc run (cache_stats()['disk_hits'] counts the wins). Empty = "
    "in-memory cache only.",
)
register_env(
    "MXNET_EXEC_CACHE_DISK_BYTES", int, 1 << 30,
    "size cap in bytes on the MXNET_EXEC_CACHE_DIR entry store: after "
    "every write the least-recently-used entries (record + library "
    "blobs; hit time = record mtime) are evicted until the store fits. "
    "0 disables eviction.",
)
register_env(
    "MXNET_BUNDLE_STRICT", bool, False,
    "serving bundles: escalate restore degradations to errors. By "
    "default a bundle written under another environment (torch, CUDA, "
    "card) loads with a warning and builds its plans and kernels as a "
    "plain load does; strict mode raises BundleError instead.",
)
register_env(
    "MXNET_BUNDLE_VERIFY", bool, True,
    "serving bundles: verify the manifest's parameter content hash "
    "(over array names, dtypes, shapes, bytes) on load_bundle; a "
    "mismatch raises BundleError. 0 skips hashing.",
)
register_env(
    "MXNET_BUNDLE_QUANTIZE", str, "",
    "serving bundles: default save_bundle quantization scheme. 'int8' "
    "stores the parameter set weight-only int8 with per-channel "
    "(last-axis) float32 scales, about 4x smaller; restore dequantizes "
    "on load. Empty (default) stores full precision. The explicit "
    "save_bundle(quantize=...) argument wins over this env.",
)
register_env(
    "MXNET_BUNDLE_QUANTIZE_OVERRIDE", bool, False,
    "serving bundles: load a bundle whose manifest quantization record "
    "and stored arrays DISAGREE about precision (stripped scale planes "
    "or stripped record). Default refuses with BundleError; 1 "
    "downgrades the refusal to a warning.",
)
register_env(
    "MXNET_FLEET_REPLICAS", int, 2,
    "fleet: number of replica worker processes the router spawns at "
    "start (mxnet_tpu.fleet.FleetRouter / tools/mx_fleet.py). Each "
    "replica restores the SAME serving bundle via load_bundle, so "
    "spin-up is zero-trace/zero-compile; the autoscaler may grow or "
    "shrink the set afterwards within [min_replicas, max_replicas] "
    "(docs/fleet.md).",
)
register_env(
    "MXNET_FLEET_PORT", int, 0,
    "fleet: TCP port the router's control-plane listener binds on "
    "127.0.0.1 (replicas dial back to it, the CLI's status/scale/"
    "drain commands use it too). 0 = pick an ephemeral port and "
    "report it in status() / the start banner — the default for "
    "tests and single-host serving.",
)
register_env(
    "MXNET_FLEET_HEARTBEAT_MS", int, 200,
    "fleet: replica heartbeat period in ms. Every beat carries queue "
    "depth, the servingStats/decodingStats snapshot, and the radix-"
    "cache digest (full cached_prefixes advertisement only when the "
    "digest changed) — the inputs of prefix-affinity routing and "
    "autoscaling. A replica silent for 5 heartbeat periods is marked "
    "dead and its in-flight requests are re-admitted elsewhere.",
)
register_env(
    "MXNET_FLEET_QUEUE_HIGH", int, 8,
    "fleet autoscaler: grow threshold — when the mean per-replica "
    "queue depth stays at or above this for `patience` consecutive "
    "observations, one replica is added (up to max_replicas). Set "
    "well above MXNET_FLEET_QUEUE_LOW; the gap is the hysteresis "
    "band that stops scale flapping.",
)
register_env(
    "MXNET_FLEET_QUEUE_LOW", int, 1,
    "fleet autoscaler: shrink threshold — when the mean per-replica "
    "queue depth stays at or below this for `patience` consecutive "
    "observations, one replica is drained and removed (down to "
    "min_replicas). Shrink always goes through drain: the victim "
    "stops admitting, finishes or hands off live decodes, then "
    "exits — zero request loss.",
)
register_env(
    "MXNET_FLEET_DRAIN_TIMEOUT_MS", int, 5000,
    "fleet: how long a draining replica may run live decodes to "
    "completion before the rest are handed off (each unfinished "
    "request's resume state — tokens so far + sampling seed/position "
    "— returns to the router for re-admission elsewhere, bit-"
    "identical under counter-based sampling). Also the router's "
    "escalation deadline: a replica that missed it is killed and "
    "its requests re-admitted from the router's own token record.",
)
register_env(
    "MXNET_ELASTIC_PORT", int, 0,
    "elastic training: TCP port the ElasticCoordinator's membership "
    "listener binds on 127.0.0.1 (worker agents dial it with a hello "
    "frame; `fit_elastic` reads it when no --connect endpoint is "
    "given). 0 = pick an ephemeral port and report it in status() — "
    "the default for tests and single-host runs (docs/elastic.md).",
)
register_env(
    "MXNET_ELASTIC_HEARTBEAT_MS", int, 200,
    "elastic training: worker heartbeat period in ms. Every beat "
    "carries the worker's last completed global step, its exec-cache "
    "trace count (the zero-retrace evidence after a re-grow) and its "
    "post-step param digest (cross-worker bitwise divergence shows "
    "up as a counted mismatch, not silent drift). A worker silent "
    "for 5 periods is declared dead and a shrink transition starts.",
)
register_env(
    "MXNET_ELASTIC_QUIESCE_TIMEOUT_MS", int, 5000,
    "elastic training: how long the coordinator waits at the quiesce "
    "barrier for every surviving worker to acknowledge the step "
    "boundary before declaring stragglers dead and resharding "
    "without them. The quiesce wall (time actually spent here) is "
    "reported per transition in elasticStats.",
)
register_env(
    "MXNET_ELASTIC_LOGICAL_SHARDS", int, 0,
    "elastic training: number of LOGICAL data/gradient shards the "
    "job is cut into — fixed for the job lifetime so the training "
    "arithmetic (which examples form global step N, the order their "
    "micro-batch gradients combine in) is invariant to membership "
    "and final params stay bit-identical across shrink/re-grow. "
    "Physical workers own logical shards round-robin (shard s -> "
    "rank s % world). 0 = use the world size at job start.",
)
register_env(
    "MXNET_ELASTIC_MIN_WORLD", int, 1,
    "elastic training: smallest membership the job may shrink to. A "
    "death that would take the world below this parks the job at the "
    "quiesce barrier (state persisted via the numerics run log) "
    "until a joiner arrives instead of continuing under-provisioned.",
)
register_env(
    "MXNET_ELASTIC_REJOIN_MS", int, 10000,
    "elastic training: worker auto-rejoin budget. When a worker "
    "loses its coordinator connection (coordinator restart, network "
    "blip) `fit_elastic` keeps re-dialing the endpoint with fresh "
    "hello frames for this many ms before giving up; a successful "
    "re-dial joins as a fresh member and is bootstrapped through the "
    "normal re-grow transition — no manual restart choreography.",
)
register_env(
    "MXNET_SERVING_MAX_BATCH", int, 8,
    "serving: largest batch bucket of the dynamic batcher; a bucket "
    "group flushes the moment it reaches this size.",
)
register_env(
    "MXNET_SERVING_MAX_WAIT_US", int, 2000,
    "serving: max microseconds a partial batch waits for co-riders "
    "before flushing (the latency bound of the batching tradeoff).",
)
register_env(
    "MXNET_SERVING_QUEUE_CAP", int, 256,
    "serving: bounded request-queue admission limit per model; a full "
    "queue fast-fails submits with ServerBusyError.",
)
register_env(
    "MXNET_SERVING_BUCKETS", str, "",
    "serving: comma-separated batch buckets (e.g. '1,2,4,8') "
    "overriding the powers-of-two default grid up to MAX_BATCH.",
)
register_env(
    "MXNET_SERVING_LENGTH_BUCKETS", str, "",
    "serving: comma-separated ragged-axis buckets (e.g. '16,32,64') "
    "for models whose input_specs declare an 'L' axis.",
)
register_env(
    "MXNET_TELEMETRY_PORT", str, "",
    "telemetry: a TCP port starts the in-process HTTP exporter "
    "(telemetry.http: /metrics, /statusz, /healthz), attached by "
    "serving.ModelServer and Module.fit; '0' binds an ephemeral port "
    "(telemetry.exporter_port()). Unset: no server.",
)
register_env(
    "MXNET_TELEMETRY_SPANS", int, 2048,
    "telemetry: capacity of the always-on span ring. 0 disables span "
    "recording.",
)
register_env(
    "MXNET_TELEMETRY_FLIGHT_DIR", str, "",
    "telemetry: directory the flight recorder writes crash dumps into "
    "(last spans + full stats snapshot as JSON, atomic tmp+rename) on "
    "unhandled exceptions. Unset: off.",
)
register_env(
    "MXNET_TPU_XLA_TRACE_DIR", str, "",
    "profiler: when set, profiler_set_state('run') also captures a "
    "torch.profiler trace (CPU activity, and CUDA activity on the card) "
    "into this directory; its events merge into dump_profile's file at "
    "pid >= 1000. The name is the JAX package's.",
)
register_env(
    "MXNET_TUNING_CACHE", str, "~/.cache/mxnet_tpu/tuning.json",
    "autotuner persistence (passes.Autotuner): JSON of tuning choices "
    "(layout / multistep_k / bucket_grid) keyed by canonical graph "
    "digest + platform, the JAX package's format and default path (a "
    "card's records are platform 'gpu'); delete the file to re-tune.",
)
register_env(
    "MXNET_DATA_WORKERS", int, 2,
    "data: producer threads per DataLoader decoding batches into "
    "bounded per-worker queues (mxnet_tpu_torch.data). Batch order is "
    "deterministic for ANY worker count: batch k always comes from "
    "worker k % MXNET_DATA_WORKERS.",
)
register_env(
    "MXNET_DATA_QUEUE_CAP", int, 4,
    "data: max decoded batches each loader worker buffers; a producer "
    "that runs ahead blocks (backpressure bounds host RAM).",
)
register_env(
    "MXNET_DATA_DEVICE_PREFETCH", int, 2,
    "data: batches DevicePrefetchIter keeps staged on the card ahead of "
    "the step (pinned ring, side-stream copies; 2 = double-buffered). "
    "0 = synchronous copy inline in next(): every batch then counts as "
    "an input stall.",
)
register_env(
    "MXNET_DATA_SEED", int, 0,
    "data: default shuffle seed of ShardedSampler/DataLoader. The "
    "epoch permutation is a pure function of (seed, epoch), the JAX "
    "package's order bit for bit, so resume replays the same stream.",
)
register_env(
    "MXNET_TPU_MEM_FRACTION", str, "",
    "fraction of the card's memory this process's caching allocator "
    "may take (torch.cuda.set_per_process_memory_fraction; the "
    "JAX package's HBM pool knob). Read at import; "
    "`context.set_memory_fraction` is the call form.",
)
