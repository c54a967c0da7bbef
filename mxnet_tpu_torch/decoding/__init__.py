"""mxnet_tpu_torch.decoding — continuous-batching autoregressive serving
over a paged, ragged KV cache, in PyTorch with a hand-written CUDA
paged-attention kernel for Hopper.

  blocks     free-list page allocator + per-sequence page tables with
             refcounts (prefix sharing, copy-on-write fork)
  attention  paged attention: the CUDA kernel (csrc/paged_attention.cu)
             for CUDA tensors, the plain gather version for CPU
             tensors; and the multi-query path (plain torch, as the JAX
             package's) of tail prefill and speculative verify
  model      the decoder contract: reference / prefill / tail-prefill /
             decode-step forwards over one `Decoder` module
  engine     DecodeEngine — owns the device page pools and the fixed
             grid of call shapes (zero steady-state traces); on CUDA
             each step cell replays a captured CUDA graph
  scheduler  ContinuousScheduler + DecodedModel — per-step admission,
             eviction, priority preemption, streaming DecodeFuture,
             drain and hand-off (RequestHandedOff, admit_resumed)
  prefix     PrefixCache — radix index over cached prompt KV pages
  quant      precision-polymorphic page pools (float32 | bf16 | int8
             with per-(page, slot, head) scale planes)
  sampling   SamplingParams + the (seed, position, salt) counter
             streams: temperature/top-k/top-p inside the step, the JAX
             package's Gumbel noise bit for bit
  speculative draft-proposes-K / target-verifies-K+1 forwards over the
             same page tables (distribution-identical output, exact
             under greedy)
  stats      DecodeStats and the decoding_stats() snapshot

    from mxnet_tpu_torch import decoding as dec
    cfg = dec.DecoderConfig(vocab=32000, d_model=1024, n_layers=16,
                            n_heads=16, d_ff=4096, max_len=2048)
    model = dec.DecodedModel("lm", 1, dec.init_decoder_params(cfg), cfg,
                             max_batch=8, num_pages=1024)   # on CUDA
    for tok in model.stream(prompt_ids, max_new_tokens=64): ...
"""
from . import attention, blocks, config, engine, model, prefix, quant, \
    sampling, scheduler, speculative, stats
from .attention import (get_multi_kernel, paged_attention,
                        paged_attention_multi, paged_attention_plain,
                        ragged_paged_attention)
from .blocks import (SCRATCH_PAGE, BlockAllocator, PageError,
                     PagePoolExhausted, pages_needed)
from .engine import DecodeEngine, quant_parity_probe
from .model import (Decoder, DecoderConfig, init_decoder_params,
                    params_from_jax, reference_logits)
from .prefix import PrefixCache, page_digests
from .quant import KVPool
from .sampling import SamplingParams
from .scheduler import (ContinuousScheduler, DecodeFuture, DecodedModel,
                        RequestHandedOff, TokenStream)
from .stats import DecodeStats, decoding_stats, reset_decoding_stats

__all__ = [
    "BlockAllocator", "ContinuousScheduler", "DecodeEngine",
    "DecodeFuture", "DecodeStats", "DecodedModel", "Decoder",
    "DecoderConfig", "KVPool", "PageError", "PagePoolExhausted",
    "PrefixCache", "RequestHandedOff", "SCRATCH_PAGE", "SamplingParams",
    "TokenStream", "attention", "blocks", "config", "decoding_stats",
    "engine", "get_multi_kernel", "init_decoder_params", "model",
    "page_digests", "paged_attention", "paged_attention_multi",
    "paged_attention_plain", "pages_needed", "params_from_jax", "prefix",
    "quant", "quant_parity_probe", "ragged_paged_attention",
    "reference_logits", "reset_decoding_stats", "sampling", "scheduler",
    "speculative", "stats",
]
