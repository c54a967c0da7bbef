"""DecodeEngine: the device half of continuous batching.

Owns the paged KV pool (one pre-allocated (layers, pages, page_size,
heads, head_dim) buffer per K and V), the block allocator over it, and
the decoder weights, and runs its calls on a fixed grid of shapes:

  prefill  one shape per prompt length bucket (batch 1, dense causal
           attention that scatters K/V into the sequence's pages)
  tail     one tail-prefill shape per length bucket (prefix-cache hits
           with the merged step off: only the uncached prompt tail
           runs, attending over the shared pages through the
           multi-query path, page table padded to the largest bucket)
  decode   one shape per pages-per-sequence bucket; the step shape is a
           function only of (step_rows, bucket) — step_rows = max_batch
           plus, in merged mode, page_size tail rows — never of real
           lengths or batch composition. In merged mode the rows mix
           decode queries and prefix-cache tail-prefill prompt tokens
           through the ragged paged attention kernel
  draft/   with a draft model, one K-token draft proposer and one
  verify   K+1-position target verifier per pages bucket; the draft
           keeps parallel K/V pools indexed by the same page ids (see
           speculative.py), and prefills through its own prefill and
           tail shapes
  copy     one page copy (copy-on-write fork support; the draft pools
           follow the target's)

The JAX package jits one program per grid cell and donates the pools.
Here the pools are updated in place, so their addresses never change,
and a step's inputs travel in one packed int32 host array (tokens,
lengths, active, use_draft, seeds, temperatures, top-k, top-p and the
page table) with one host-to-device copy. On the CPU every call runs
eagerly. On CUDA each decode cell, and each bucket's draft-propose +
verify pair, is captured once into a `torch.cuda.CUDAGraph` with
static device input buffers — twice, for steps where every row is
greedy and for steps where a row samples, whose graph also holds the
sampler — and a step copies its packed array into the cell's buffer,
replays the graph and reads its tokens back in its one fetch. Prefill
and tail prefill stay eager on both. A capture that fails raises
MXNetError naming the cell; the card never falls back to eager steps.

A "trace" is a capture on CUDA and a first call at a grid cell on the
CPU: `trace_counts()`/`traces()` count them, `warmup()` visits every
cell, so steady state adds none (`traces_since_warmup`). Each capture
lands in the profiling layer's deviceStats (capture seconds, the bytes
it added to the graph pool), and the end of `warmup()` times one masked
decode step a pages bucket into the CalibrationStore
(`decode_step[<bucket>]`).

A prompt whose length bucket reaches `ring_prefill` prefills through
ring attention over `seq_mesh_for(bucket)` (`_ring_attn`; one entry on
one card); its pages are decoded through B4/B5 as any other. The engine
is not thread-safe: exactly one scheduler thread drives it.
"""
from __future__ import annotations

import contextlib
import hashlib
import logging
import time

import numpy as np
import torch

from .. import profiler as _profiler
from .. import random as _random
from .. import utils as _utils
from ..base import MXNetError
from ..context import resolve_device
from ..serving.batcher import pick_bucket
from . import attention as _attn
from . import config as _cfg
from . import model as _model
from . import quant as _quant
from . import speculative as _spec
from .blocks import SCRATCH_PAGE, BlockAllocator, PageError, pages_needed

# warn once about a failed calibration harvest
_calibration_warned = False

# the packed step array: these per-row fields, then the page table
_FIELDS = ("tokens", "lengths", "active", "use_draft", "seeds", "temps",
           "top_ks", "top_ps")


class _Graph:
    """One captured cell: its static device input buffer, the pinned
    host array a step stages its packed inputs in, the output tensors
    the graph writes, and the kernel calls it makes a replay."""

    __slots__ = ("graph", "inputs", "staging", "output", "launches")

    def __init__(self, graph, inputs, staging, output, launches):
        self.graph = graph
        self.inputs = inputs
        self.staging = staging
        self.output = output
        self.launches = launches


class DecodeEngine:
    def __init__(self, params, cfg, *, max_batch=None, page_size=None,
                 num_pages=None, page_buckets=None, ring_prefill=None,
                 draft_params=None, draft_cfg=None, spec_k=None,
                 prefix_cache=None, merged_step=None, kv_dtype=None,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        # prompts whose length bucket reaches it prefill through ring
        # attention over seq_mesh_for(bucket) (0: never)
        self.ring_prefill = ring_prefill if ring_prefill is not None \
            else _cfg.ring_prefill()
        self._ring_fns = {}
        self.kv_dtype = _quant.canonical(
            kv_dtype if kv_dtype is not None else _cfg.kv_dtype())
        self.max_batch = max_batch if max_batch is not None \
            else _cfg.max_batch()
        self.page_size = page_size if page_size is not None \
            else _cfg.page_size()
        self.num_pages = num_pages if num_pages is not None \
            else _cfg.num_pages()
        if page_buckets is None:
            page_buckets = _cfg.page_buckets()
        if page_buckets is None:
            # a sequence can never own more pages than the pool (or
            # than max_len covers) — cap the default grid there
            cap = min(self.num_pages - 1, cfg.max_len // self.page_size)
            page_buckets = _cfg.default_page_buckets(max(1, cap))
        self.page_buckets = tuple(sorted(set(int(b)
                                             for b in page_buckets)))
        if self.page_buckets[-1] * self.page_size > cfg.max_len:
            raise PageError(
                f"largest page bucket {self.page_buckets[-1]} x "
                f"page_size {self.page_size} exceeds the model's "
                f"max_len {cfg.max_len}")
        if self.page_buckets[-1] > self.num_pages - 1:
            raise PageError(
                f"page bucket {self.page_buckets[-1]} exceeds pool "
                f"capacity {self.num_pages - 1}")

        self.allocator = BlockAllocator(self.num_pages, self.page_size)
        self.model = _model.as_decoder(params, cfg, self.device).eval()
        shape = (cfg.n_layers, self.num_pages, self.page_size,
                 cfg.n_heads, cfg.head_dim)
        self._k = _quant.make_pool(shape, self.kv_dtype, self.device)
        self._v = _quant.make_pool(shape, self.kv_dtype, self.device)
        self.prefix_cache_enabled = prefix_cache if prefix_cache \
            is not None else _cfg.prefix_cache()
        self.spec_k = int(spec_k) if spec_k is not None else _cfg.spec_k()
        self.draft_cfg = None
        self.draft_model = None
        if draft_params is not None and self.spec_k > 0:
            dcfg = draft_cfg if draft_cfg is not None else cfg
            if dcfg.vocab != cfg.vocab:
                raise PageError(
                    f"draft vocab {dcfg.vocab} != target {cfg.vocab}: "
                    "speculative decoding needs one token space")
            if dcfg.max_len < cfg.max_len:
                raise PageError(
                    f"draft max_len {dcfg.max_len} < target "
                    f"{cfg.max_len}: the draft must cover every "
                    "position the target can reach")
            self.draft_cfg = dcfg
            # a self-draft shares the target's weights (not its pools)
            self.draft_model = self.model if draft_params is params \
                else _model.as_decoder(draft_params, dcfg,
                                       self.device).eval()
            dshape = (dcfg.n_layers, self.num_pages, self.page_size,
                      dcfg.n_heads, dcfg.head_dim)
            self._dk = _quant.make_pool(dshape, self.kv_dtype, self.device)
            self._dv = _quant.make_pool(dshape, self.kv_dtype, self.device)
        # merged ragged step: prefix-cache tail-prefill tokens ride the
        # decode step as extra rows through the ragged paged kernel.
        # Requires the prefix cache (the only producer of tails) and no
        # speculation (the verify pair owns its own multi-query shape)
        want_merged = merged_step if merged_step is not None \
            else _cfg.merged_step()
        self.merged_step_enabled = bool(
            want_merged and self.prefix_cache_enabled
            and not self.spec_enabled)
        self.tail_budget = self.page_size if self.merged_step_enabled \
            else 0
        self.step_rows = self.max_batch + self.tail_budget
        self._attn = (_attn.ragged_paged_attention
                      if self.merged_step_enabled else _attn.paged_attention)
        self._attn_multi = _attn.get_multi_kernel()
        # the program family of this configuration, for the profiling
        # layer's records (deviceStats, CalibrationStore)
        self._digest = hashlib.sha1(repr(
            (cfg, self.max_batch, self.page_size, self.num_pages,
             self.draft_cfg, self.spec_k if self.spec_enabled else 0,
             self.step_rows if self.merged_step_enabled else 0,
             self.kv_dtype)).encode()).hexdigest()[:12]
        # the paged attention a decode step launches (what a bundle's
        # manifest records as its kernel): B4/B5 on the card, the plain
        # version on the host
        self.kernel_name = "paged_attention" \
            if self.device.type == "cuda" else "plain"
        self._trace_counts = {}
        self._warm = False
        self._use_graphs = self.device.type == "cuda"
        self._graphs = {}
        self._graph_pool = None
        self._capture_stream = None
        self._warm_bodies = set()
        # MXNET_NUMERICS_DECODE_GUARD: each decode step also keeps a
        # device vector (nonfinite rows, int8 clips); they drain to the
        # host in one fetch (drain_guard)
        self._guard = bool(_utils.getenv("MXNET_NUMERICS_DECODE_GUARD"))
        self._guard_pending = []

    # ------------------------------------------------------ properties
    @property
    def spec_enabled(self):
        """True when a draft model is loaded and K > 0: the scheduler
        routes steps through spec_step instead of step."""
        return self.draft_model is not None and self.spec_k > 0

    @property
    def max_context(self):
        """Tokens the largest bucket covers — the hard length cap."""
        return self.page_buckets[-1] * self.page_size

    @property
    def prefill_buckets(self):
        """Prompt length buckets: one per page bucket."""
        return tuple(b * self.page_size for b in self.page_buckets)

    def library_blobs(self):
        """[(library, sighash, file)] of the kernel libraries the
        engine's steps launch (the paged attention's on the card, none
        on the host): what a bundle carries as the engine record's
        blobs."""
        if self.device.type != "cuda":
            return []
        from .. import kernels

        lib = kernels.library_path("paged_attention")
        return [("paged_attention", kernels.sighash_of(lib),
                 kernels.library_file(lib))]

    def traces(self):
        """Total captures (CUDA) or first calls at a grid cell (CPU) so
        far (module docstring)."""
        return sum(self._trace_counts.values())

    def trace_counts(self):
        return dict(self._trace_counts)

    def pool_stats(self):
        st = self.allocator.stats()
        per_tok = (_quant.kv_bytes_per_token(self._k)
                   + _quant.kv_bytes_per_token(self._v))
        return {
            "pages_total": st["pages_total"],
            "pages_free": st["pages_free"],
            "kv_occupancy": round(
                st["pages_in_use"] / max(1, st["pages_total"]), 4),
            "free_low_watermark": st["free_low_watermark"],
            "pages_allocated": st["pages_allocated"],
            "kv_dtype": self.kv_dtype,
            "kv_bytes_per_token": round(per_tok, 2),
            "pool_capacity_tokens": (self.num_pages - 1)
            * self.page_size,
        }

    def _note_trace(self, name, capture=False):
        """Count a capture, or the first eager call at a cell."""
        if capture:
            self._trace_counts[name] = self._trace_counts.get(name, 0) + 1
        elif name not in self._trace_counts:
            self._trace_counts[name] = 1

    def _to_device(self, *arrays):
        """Host int arrays -> device int32 tensors in ONE copy."""
        flat = [np.asarray(a).astype(np.int32).ravel() for a in arrays]
        packed = torch.from_numpy(np.concatenate(flat)).to(self.device)
        out, at = [], 0
        for a, f in zip(arrays, flat):
            out.append(packed[at:at + f.size].view(np.shape(a)))
            at += f.size
        return out

    # --------------------------------------------- fixed-dtype packing
    @staticmethod
    def _samp_scalars(seed=0, temperature=0.0, top_k=0, top_p=1.0):
        """Sampling params as fixed-dtype scalars."""
        return (np.uint32(int(seed) & 0xFFFFFFFF), np.float32(temperature),
                np.int32(top_k), np.float32(top_p))

    def _samp_arrays(self, seeds, temps, top_ks, top_ps, rows=None):
        """(rows,) sampling arrays, defaulting to greedy, fixed dtypes,
        padded up to `rows` (default step_rows)."""
        b = rows if rows is not None else self.step_rows

        def _fill(arr, dtype, fill):
            if arr is None:
                return np.full((b,), fill, dtype)
            arr = np.asarray(arr, dtype)
            if len(arr) < b:
                arr = np.concatenate(
                    [arr, np.full((b - len(arr),), fill, dtype)])
            return arr

        return (_fill(seeds, np.uint32, 0), _fill(temps, np.float32, 0.0),
                _fill(top_ks, np.int32, 0), _fill(top_ps, np.float32, 1.0))

    @staticmethod
    def _pack(tokens, page_table, lengths, active, use_draft, sarr):
        """The step's inputs as one int32 array (module docstring): the
        _FIELDS rows in order, float fields as their bits, then the
        (rows, bucket) page table."""
        fields = (np.asarray(tokens, np.int32), np.asarray(lengths, np.int32),
                  np.asarray(active, np.int32),
                  np.asarray(use_draft, np.int32)) + tuple(
                      np.asarray(a).view(np.int32) for a in sarr)
        return np.concatenate(fields + (np.asarray(page_table, np.int32)
                                        .ravel(),))

    @staticmethod
    def _unpack(buf, rows, bucket):
        """Device views of a packed step array (see `_pack`)."""
        f = {name: buf[i * rows:(i + 1) * rows]
             for i, name in enumerate(_FIELDS)}
        f["active"] = f["active"] != 0
        f["use_draft"] = f["use_draft"] != 0
        f["seeds"] = f["seeds"].long() & 0xFFFFFFFF
        f["temps"] = f["temps"].view(torch.float32)
        f["top_ps"] = f["top_ps"].view(torch.float32)
        f["table"] = buf[len(_FIELDS) * rows:].view(rows, bucket)
        return f

    # -------------------------------------------------- numerics guard
    _GUARD_CAP = 1024  # device vectors between drains

    def drain_guard(self):
        """Pending guard vectors -> host in one fetch; [] when empty or
        the guard is off. Each entry is (nonfinite_rows, quant_clips)
        of one drained step."""
        if not self._guard_pending:
            return []
        pending, self._guard_pending = self._guard_pending, []
        host = torch.stack(pending).cpu().numpy()
        _profiler.count_host_sync("blocking_fetches")
        _profiler.count_host_sync("metric_fetches")
        return [(int(v[0]), int(v[1])) for v in host]

    # ---------------------------------------------------------- warmup
    @torch.no_grad()
    def warmup(self):
        """Visit the full grid: the page copy, every prefill length
        bucket (full, and tail when the split grid is on, for the draft
        too when speculation is on), and every pages bucket's decode
        step and draft/verify pair — on CUDA both graphs of each, the
        greedy and the sampling one. All writes of the dry runs land in
        the scratch page (length 0, tables all-scratch), which is never
        read unmasked. Idempotent."""
        if self._warm:
            return self
        self.copy_page(SCRATCH_PAGE, SCRATCH_PAGE)
        max_pages = pages_needed(self.max_context, self.page_size)
        for lb in self.prefill_buckets:
            tokens = np.zeros((lb,), np.int32)
            page_ids = np.zeros((pages_needed(lb, self.page_size),),
                                np.int32)
            full_ids = np.zeros((max_pages,), np.int32)
            for draft in (False, True) if self.spec_enabled else (False,):
                self._prefill(tokens, 0, page_ids, draft=draft)
                if self.prefix_cache_enabled \
                        and not self.merged_step_enabled:
                    self._tail(tokens, 0, 0, full_ids, draft=draft)
        r, b = self.step_rows, self.max_batch
        variants = (False, True) if self._use_graphs else (False,)
        # largest first: the eager run before a body's first capture
        # then launches every kernel the smaller buckets capture (the
        # paged kernel's merge runs only past CHUNK_PAGES)
        for bucket in reversed(self.page_buckets):
            for sampled in variants:
                temps = np.full((r,), float(sampled), np.float32)
                self.step(np.zeros((r,), np.int32),
                          np.zeros((r, bucket), np.int32),
                          np.zeros((r,), np.int32), np.zeros((r,), bool),
                          temps=temps)
                if self.spec_enabled:
                    self.spec_step(
                        np.zeros((b,), np.int32),
                        np.zeros((b, bucket), np.int32),
                        np.zeros((b,), np.int32), np.zeros((b,), bool),
                        np.zeros((b,), bool), temps=temps[:b])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._harvest_calibration()
        self._guard_pending = []  # warmup rows are all-masked noise
        self._warm = True
        return self

    def _harvest_calibration(self):
        """One timed warm decode step a pages bucket (greedy, every row
        masked) into the profiling CalibrationStore:
        `decode_step[<bucket>]`, and `decode_step` for the largest."""
        try:
            from .. import profiling as _profiling

            if not _profiling.profiling_enabled():
                return
            store = _profiling.calibration_store()
            platform = "gpu" if self.device.type == "cuda" \
                else self.device.type
            r = self.step_rows
            for bucket in self.page_buckets:
                t0 = time.perf_counter()
                self.step(np.zeros((r,), np.int32),
                          np.zeros((r, bucket), np.int32),
                          np.zeros((r,), np.int32), np.zeros((r,), bool))
                seconds = time.perf_counter() - t0
                store.record(self._digest, platform,
                             f"decode_step[{bucket}]", seconds)
                if bucket == self.page_buckets[-1]:
                    store.record(self._digest, platform, "decode_step",
                                 seconds)
        except Exception as e:
            global _calibration_warned
            if not _calibration_warned:
                _calibration_warned = True
                logging.getLogger(__name__).warning(
                    "decode calibration harvest failed for engine %s: %s "
                    "— continuing without measured-cost records",
                    self._digest, e)

    # -------------------------------------------------------- prefill
    def _prefill(self, tokens, n, page_ids, sargs=None, draft=False):
        lb = len(tokens)
        name = "draft_prefill" if draft else "prefill"
        self._note_trace(f"{name}@{lb}")
        tok_t, ids_t = self._to_device(tokens[None], page_ids)
        model, k, v = self._models(draft)
        return _model.prefill_forward(
            model, tok_t, n, k, v, ids_t, *(sargs or ()),
            cfg=model.cfg, attn_fn=self._ring_attn(lb))

    def _ring_attn(self, length_bucket):
        """The ring-attention prefill's attention for a length bucket at
        or above `ring_prefill` (over seq_mesh_for(bucket): on one card
        a mesh of one entry, as the JAX package's on one chip), else
        None (dense)."""
        if not self.ring_prefill or length_bucket < self.ring_prefill:
            return None
        fn = self._ring_fns.get(length_bucket)
        if fn is None:
            from ..parallel.ring_attention import (ring_attention,
                                                   seq_mesh_for)

            mesh = seq_mesh_for(length_bucket)

            def fn(q, k, v):
                return ring_attention(q, k, v, mesh=mesh, causal=True)

            fn.mesh = mesh
            self._ring_fns[length_bucket] = fn
        return fn

    def _tail(self, tokens, start, n, page_ids, sargs=None, draft=False):
        lb = len(tokens)
        name = "draft_tail" if draft else "prefill_tail"
        self._note_trace(f"{name}@{lb}")
        tok_t, ids_t = self._to_device(tokens[None], page_ids)
        model, k, v = self._models(draft)
        return _model.tail_prefill_forward(
            model, tok_t, start, n, k, v, ids_t, *(sargs or ()),
            cfg=model.cfg, attn_multi=self._attn_multi)

    def _models(self, draft):
        if draft:
            return self.draft_model, self._dk, self._dv
        return self.model, self._k, self._v

    @torch.no_grad()
    def prefill(self, token_ids, table, *, start=0, seed=0,
                temperature=0.0, top_k=0, top_p=1.0):
        """Fill `table`'s pages with the prompt's K/V; returns the first
        generated token (host int), sampled on the (seed, position =
        prompt length) stream when temperature > 0. `table` must already
        cover pages_needed(len(token_ids)).

        `start > 0` is the prefix-cache hit path of the split grid:
        positions < start already live in (shared) pages, so only the
        tail runs, through the tail family. In merged-step mode a hit's
        tail rides the decode step's ragged rows instead and `start`
        is refused here. With a draft model loaded, the same prompt
        also prefills the draft pools (same pages, draft-shaped K/V)."""
        n = len(token_ids)
        sargs = self._samp_scalars(seed, temperature, top_k, top_p) \
            if temperature > 0 else None
        drafts = (False, True) if self.spec_enabled else (False,)
        if start and self.merged_step_enabled:
            raise PageError(
                "tail prefill has no dedicated shape in merged-step "
                "mode: the scheduler feeds tail tokens through step() "
                "rows (merged_step=False restores the split tail-prefill "
                "grid)")
        if start:
            tail = token_ids[start:]
            lb = pick_bucket(len(tail), self.prefill_buckets)
            tokens = np.zeros((lb,), np.int32)
            tokens[:len(tail)] = tail
            max_pages = pages_needed(self.max_context, self.page_size)
            page_ids = np.full((max_pages,), SCRATCH_PAGE, np.int32)
            page_ids[:len(table)] = table
            # the draft's first token is never used: its prefill is greedy
            toks = [self._tail(tokens, start, n, page_ids,
                               None if d else sargs, draft=d)
                    for d in drafts]
        else:
            lb = pick_bucket(n, self.prefill_buckets)
            tokens = np.zeros((lb,), np.int32)
            tokens[:n] = token_ids
            page_ids = np.full((pages_needed(lb, self.page_size),),
                               SCRATCH_PAGE, np.int32)
            page_ids[:len(table)] = table
            toks = [self._prefill(tokens, n, page_ids,
                                  None if d else sargs, draft=d)
                    for d in drafts]
        # the first token must reach the host to stream/EOS-check —
        # the one deliberate sync of the prefill path
        return int(toks[0])

    # -------------------------------------------------------- step cells
    def _decode_body(self, buf, rows, bucket, sampled):
        f = self._unpack(buf, rows, bucket)
        samp = ((f["seeds"], f["temps"], f["top_ks"], f["top_ps"])
                if sampled else ())
        return _model.decode_forward(
            self.model, f["tokens"], self._k, self._v, f["table"],
            f["lengths"], f["active"], *samp, cfg=self.cfg,
            attn=self._attn, with_stats=self._guard)

    def _spec_body(self, buf, rows, bucket, sampled):
        f = self._unpack(buf, rows, bucket)
        samp = (f["seeds"], f["temps"], f["top_ks"], f["top_ps"])
        drafts, q_dists = _spec.draft_propose_forward(
            self.draft_model, f["tokens"], self._dk, self._dv, f["table"],
            f["lengths"], f["active"], *samp, cfg=self.draft_cfg,
            attn=_attn.paged_attention, k=self.spec_k, sampled=sampled)
        tokens_out, n_emit = _spec.verify_forward(
            self.model, f["tokens"], drafts, q_dists, self._k, self._v,
            f["table"], f["lengths"], f["active"], f["use_draft"], *samp,
            cfg=self.cfg, attn_multi=self._attn_multi, k=self.spec_k,
            sampled=sampled)
        # one output tensor, so the step reads it back in one fetch
        return torch.cat([tokens_out, n_emit[:, None]], dim=1)

    def _cell_names(self, kind, bucket):
        if kind == "decode":
            return (f"decode@{bucket}",)
        return (f"draft@{bucket}", f"verify@{bucket}")

    def _capture(self, kind, bucket, sampled, size, rows):
        """Capture one cell's graph on the engine's capture stream over
        all-zero inputs (every row inactive, tables all scratch). The
        first capture of each body (decode or spec, greedy or sampling)
        runs it eagerly first, so lazy initialisations — the stream's
        cuBLAS workspace, the kernel library's function attributes —
        happen outside a capture. Every graph allocates from one pool:
        steps replay one at a time on one stream, so their intermediates
        may share it. (torch.cuda.graph would also synchronise and empty
        the caching allocator before each of the grid's captures.)"""
        body = self._decode_body if kind == "decode" else self._spec_body
        name = f"{'+'.join(self._cell_names(kind, bucket))}" \
            f"{' (sampling)' if sampled else ''}"
        inputs = torch.zeros(size, dtype=torch.int32, device=self.device)
        staging = torch.empty(size, dtype=torch.int32, pin_memory=True)
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
            self._capture_stream = torch.cuda.Stream(self.device)
        graph = torch.cuda.CUDAGraph()
        side, main = self._capture_stream, \
            torch.cuda.current_stream(self.device)
        reserved = torch.cuda.memory_reserved(self.device)
        t0 = time.perf_counter()
        try:
            side.wait_stream(main)
            with torch.cuda.stream(side):
                if (kind, sampled) not in self._warm_bodies:
                    body(inputs, rows, bucket, sampled)
                    self._warm_bodies.add((kind, sampled))
                with _attn.recording_launches() as launches:
                    graph.capture_begin(pool=self._graph_pool,
                                        capture_error_mode="thread_local")
                    try:
                        output = body(inputs, rows, bucket, sampled)
                    finally:
                        graph.capture_end()
            main.wait_stream(side)
        except Exception as e:
            _random.recover_after_failed_capture(self.device)
            raise MXNetError(
                f"CUDA graph capture of the {name} cell (rows {rows}, "
                f"page bucket {bucket}) failed: {type(e).__name__}: "
                f"{e}") from e
        capture_s = time.perf_counter() - t0
        for cell in self._cell_names(kind, bucket):
            self._note_trace(cell, capture=True)
        from ..profiling import _accounting

        _accounting.record_program(
            self._digest, name, compile_s=capture_s,
            arg_bytes=inputs.nbytes, out_bytes=output.nbytes,
            temp_bytes=torch.cuda.memory_reserved(self.device) - reserved,
            device=self.device, graphed=True)
        return _Graph(graph, inputs, staging, output, dict(launches))

    def _run(self, kind, bucket, sampled, packed, rows):
        """Run one step cell on a packed input array: eagerly on the
        CPU (or inside `eager()`), else by replaying its graph."""
        if not self._use_graphs:
            for cell in self._cell_names(kind, bucket):
                self._note_trace(cell)
            buf = torch.from_numpy(packed).to(self.device)
            body = self._decode_body if kind == "decode" \
                else self._spec_body
            return body(buf, rows, bucket, sampled)
        key = (kind, bucket, sampled)
        g = self._graphs.get(key)
        if g is None:
            g = self._graphs[key] = self._capture(kind, bucket, sampled,
                                                  packed.size, rows)
        g.staging.numpy()[:] = packed
        g.inputs.copy_(g.staging, non_blocking=True)
        g.graph.replay()
        _attn.credit_launches(g.launches)
        return g.output

    @contextlib.contextmanager
    def eager(self):
        """Run steps eagerly inside the block, also on CUDA: the check
        that a graph's step is bit-identical to its eager one."""
        saved, self._use_graphs = self._use_graphs, False
        try:
            yield self
        finally:
            self._use_graphs = saved

    # -------------------------------------------------------- hot path
    @torch.no_grad()
    def step(self, tokens, page_table, lengths, active, seeds=None,
             temps=None, top_ks=None, top_ps=None):
        """One continuous-decode step. Row arrays are the fixed
        (step_rows, ...) shapes — max_batch decode rows plus, in merged
        mode, tail_budget ragged tail-prefill rows; narrower inputs are
        padded with masked rows so every call replays one warmed shape,
        and the return is sliced back to the caller's width. Per-row
        sampling params default to greedy. `page_table.shape[1]` should
        be a configured bucket (another width works but counts as a
        trace). Returns next tokens as a host array (one fetch per
        step)."""
        page_table = np.asarray(page_table, np.int32)
        bucket = page_table.shape[1]
        b_in = len(tokens)
        r = self.step_rows
        tokens = self._pad_rows(tokens, np.int32, 0)
        lengths = self._pad_rows(lengths, np.int32, 0)
        active = self._pad_rows(active, bool, False)
        if page_table.shape[0] < r:
            page_table = np.concatenate(
                [page_table, np.full((r - page_table.shape[0], bucket),
                                     SCRATCH_PAGE, np.int32)])
        sarr = self._samp_arrays(seeds, temps, top_ks, top_ps)
        packed = self._pack(tokens, page_table, lengths, active,
                            np.zeros((r,), bool), sarr)
        res = self._run("decode", bucket, bool((sarr[1] > 0).any()),
                        packed, r)
        if self._guard:
            res, guard = res
            self._guard_pending.append(guard.clone())
            if len(self._guard_pending) > self._GUARD_CAP:
                del self._guard_pending[:-self._GUARD_CAP]
        return res.cpu().numpy()[:b_in]

    def _pad_rows(self, arr, dtype, fill):
        arr = np.asarray(arr, dtype)
        if len(arr) < self.step_rows:
            arr = np.concatenate(
                [arr, np.full((self.step_rows - len(arr),), fill, dtype)])
        return arr

    @torch.no_grad()
    def spec_step(self, tokens, page_table, lengths, active, use_draft,
                  seeds=None, temps=None, top_ks=None, top_ps=None):
        """One speculative step: the draft proposes K tokens, the target
        verifies K+1 positions; the drafts and their distributions stay
        on the device between the two. Returns (tokens_out (B, K+1),
        n_emit (B,)) as host arrays in ONE fetch — row b emits
        tokens_out[b, :n_emit[b]]."""
        page_table = np.asarray(page_table, np.int32)
        rows = len(tokens)
        sarr = self._samp_arrays(seeds, temps, top_ks, top_ps, rows=rows)
        packed = self._pack(tokens, page_table, lengths, active, use_draft,
                            sarr)
        out = self._run("spec", page_table.shape[1],
                        bool((sarr[1] > 0).any()), packed, rows)
        out = out.cpu().numpy()
        return out[:, :-1], out[:, -1]

    @torch.no_grad()
    def copy_page(self, src, dst):
        """Device copy of one page, in place, in every layer of every
        pool (data and scale plane together; the draft pools track the
        target's COW decisions): the COW half of
        `BlockAllocator.make_writable`."""
        self._note_trace("copy_page")
        pools = [self._k, self._v]
        if self.draft_model is not None:
            pools += [self._dk, self._dv]
        for pool in pools:
            pool.data[:, dst] = pool.data[:, src]
            if pool.scale is not None:
                pool.scale[:, dst] = pool.scale[:, src]

    # ----------------------------------------------------- test hooks
    def read_page(self, layer, page):
        """Host copy of one page's (K, V), dequantized to float32."""
        return (_quant.dequant_page(self._k, layer, page).cpu().numpy(),
                _quant.dequant_page(self._v, layer, page).cpu().numpy())

    def read_page_raw(self, layer, page):
        """Host copy of one page's stored (K, V, k_scale, v_scale)
        (scale entries are None on non-int8 pools)."""
        k, v = self._k, self._v
        return (k.data[layer, page].cpu().numpy(),
                v.data[layer, page].cpu().numpy(),
                None if k.scale is None
                else k.scale[layer, page].cpu().numpy(),
                None if v.scale is None
                else v.scale[layer, page].cpu().numpy())

    @torch.no_grad()
    def probe_logits(self, tokens, page_table, lengths, active):
        """Logits of one decode step over the CURRENT pool state (at the
        caller's width, no padding), leaving the pools as they were:
        the entries the step writes are saved first and restored after.
        Counts no trace."""
        tok_t, tbl_t, len_t, act_t = self._to_device(
            tokens, page_table, lengths, active)
        act_t = act_t.bool()
        w_pages, slots, _ = _model.write_targets(
            tbl_t, len_t, act_t, self.page_size)
        pools = (self._k, self._v)
        # advanced indexing copies: these are the entries as they were
        saved = [(p.data[:, w_pages, slots],
                  None if p.scale is None else p.scale[:, w_pages, slots])
                 for p in pools]
        logits, _ = _model.decode_logits(
            self.model, tok_t, self._k, self._v, tbl_t, len_t, act_t,
            cfg=self.cfg, attn=self._attn)
        for p, (data, scale) in zip(pools, saved):
            p.data[:, w_pages, slots] = data
            if scale is not None:
                p.scale[:, w_pages, slots] = scale
        return logits.float().cpu().numpy()


def quant_parity_probe(params, cfg, prompt, max_new=16, *,
                       kv_dtype="int8", page_size=None, num_pages=None,
                       page_buckets=None, device=None):
    """Teacher-forced A/B of one greedy decode at float32 vs
    `kv_dtype`: the float32 arm's token stream is replayed through both
    engines token by token, so every step compares the two precisions
    over identical context.

    Returns a dict: `top1_agreement` (fraction of positions where the
    quantized argmax matches float32's), `logit_drift_max` /
    `logit_drift_mean` (abs logit gap via `probe_logits`),
    `kv_pool_capacity_ratio` (measured bytes-per-token ratio),
    `retraces` (quantized arm's post-warmup traces — must be 0), and
    `tokens` (the float32 greedy stream)."""
    names = ("float32", kv_dtype)
    engines, tables, firsts = {}, {}, {}
    for name in names:
        engines[name] = DecodeEngine(
            params, cfg, max_batch=1, page_size=page_size,
            num_pages=num_pages, page_buckets=page_buckets,
            prefix_cache=False, merged_step=False, kv_dtype=name,
            device=device).warmup()
    ref, alt = engines["float32"], engines[kv_dtype]
    prompt = [int(t) for t in prompt]
    total = len(prompt) + int(max_new)
    if total > ref.max_context:
        raise PageError(
            f"probe needs {total} tokens > context capacity "
            f"{ref.max_context}")
    need = pages_needed(total, ref.page_size)
    bucket = pick_bucket(need, ref.page_buckets)
    p_need = pages_needed(len(prompt), ref.page_size)
    for name in names:
        tables[name] = engines[name].allocator.alloc(need)
        firsts[name] = engines[name].prefill(prompt, tables[name][:p_need])
    floor = {name: engines[name].traces() for name in names}
    agree = 1 if firsts[kv_dtype] == firsts["float32"] else 0
    n_cmp = 1
    drift_max, drift_sum = 0.0, 0.0
    tok = firsts["float32"]
    tokens_out = [tok]
    for t in range(int(max_new) - 1):
        length = len(prompt) + t
        lg, out = {}, {}
        for name in names:
            tbl = np.full((1, bucket), SCRATCH_PAGE, np.int32)
            tbl[0, :need] = tables[name]
            lg[name] = engines[name].probe_logits(
                np.array([tok], np.int32), tbl,
                np.array([length], np.int32), np.array([True], bool))[0]
            out[name] = int(engines[name].step(
                [tok], tbl, [length], [True])[0])
        gap = np.abs(lg[kv_dtype] - lg["float32"])
        drift_max = max(drift_max, float(gap.max()))
        drift_sum += float(gap.mean())
        agree += 1 if out[kv_dtype] == out["float32"] else 0
        n_cmp += 1
        tok = out["float32"]
        tokens_out.append(tok)
    ref_bpt = ref.pool_stats()["kv_bytes_per_token"]
    alt_bpt = alt.pool_stats()["kv_bytes_per_token"]
    return {
        "kv_dtype": kv_dtype,
        "top1_agreement": round(agree / n_cmp, 4),
        "positions_compared": n_cmp,
        "logit_drift_max": round(drift_max, 6),
        "logit_drift_mean": round(drift_sum / max(1, n_cmp - 1), 6),
        "kv_pool_capacity_ratio": round(ref_bpt / alt_bpt, 4),
        "kv_bytes_per_token_float32": ref_bpt,
        "kv_bytes_per_token_quant": alt_bpt,
        "retraces": alt.traces() - floor[kv_dtype],
        "tokens": tokens_out,
    }
