"""Sampling inside the decode step: temperature / top-k / top-p over
per-sequence counter-based random streams.

The decode tier's reproducibility contract: a token drawn for request
R at sequence position P is a pure function of (R.seed, P) — never of
batch composition, scheduling order, or how many times the sequence was
preempted and readmitted. Every draw derives its key as

    fold_in(fold_in(PRNGKey(seed), position), salt)

on the threefry2x32 chain of `mxnet_tpu_torch.random`, which rebuilds
jax.random's key derivation and its float32 draws bit for bit on torch
integers. So the Gumbel noise, the accept uniforms and the keys are the
JAX package's own, bit for bit, and a readmitted sequence replays the
identical stream: re-prefill restores the cache, the position counter
restores the randomness.

Every function works on rows at once — the JAX package's `jax.vmap`
calls become a leading batch axis: logits (..., V) with per-row seeds,
positions and parameters as int/float tensors of the leading shape.
Keys stay int64 tensors on the step's device, so a step reads nothing
back to the host and can be captured in a CUDA graph. Greedy rows
(temperature 0) take the argmax exactly and consume no random bits.

Filtering semantics (the standard ones, as the JAX package's):

  temperature  logits / max(t, eps); t <= 0 means greedy argmax
  top_k        keep the k highest logits (0 = off; ties at the k-th
               value are all kept)
  top_p        keep the smallest set of tokens whose probability mass
               reaches p, by descending probability (1.0 = off; the
               first token crossing p is included: the mass BEFORE a
               token is compared with p, and at least one token stays)

Sampling from the filtered distribution uses the Gumbel-max trick —
argmax(filtered_logits + gumbel) — exact categorical sampling with one
key and no cumsum/searchsorted numerics. Sort, softmax and cumsum round
differently from XLA's, so a token of the port can differ from the JAX
package's only where the top-2 gap of `filtered + g` or the distance of
a token's preceding mass to top_p is within rounding.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import random as _random

NEG_INF = -1e30

# stream salts: one independent substream per draw KIND at a position
SALT_TOKEN = 0      # the emitted token (plain sampled decode, bonus)
SALT_DRAFT = 1      # the draft model's proposal
SALT_ACCEPT = 2     # the speculative accept/reject uniform
SALT_RESAMPLE = 3   # the residual-distribution resample


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration (host-side; the scheduler
    packs these into per-row device arrays). Defaults resolve through
    MXNET_DECODE_SAMPLING_* when constructed via `resolve()`."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    @staticmethod
    def resolve(sampling=None, seed=None):
        """Normalize a user-supplied SamplingParams | dict | None,
        filling unset fields from the MXNET_DECODE_SAMPLING_* env
        defaults."""
        from . import config as _cfg

        if sampling is None:
            return SamplingParams(
                temperature=_cfg.sampling_temperature(),
                top_k=_cfg.sampling_top_k(),
                top_p=_cfg.sampling_top_p(),
                seed=_cfg.sampling_seed() if seed is None else int(seed))
        if isinstance(sampling, dict):
            sampling = SamplingParams(**sampling)
        if seed is not None:
            sampling = SamplingParams(
                temperature=sampling.temperature, top_k=sampling.top_k,
                top_p=sampling.top_p, seed=int(seed))
        return sampling

    def validate(self, vocab):
        from ..serving.batcher import ServingError
        if self.temperature < 0:
            raise ServingError("temperature must be >= 0 (0 = greedy)")
        if not 0 <= self.top_k <= vocab:
            raise ServingError(f"top_k must be in [0, {vocab}]")
        if not 0.0 < self.top_p <= 1.0:
            raise ServingError("top_p must be in (0, 1]")
        return self


def greedy_tokens(logits):
    """(..., V) logits -> (...) int64 argmax token ids (first index on
    ties, as jnp.argmax)."""
    return torch.argmax(logits, dim=-1)


def stream_key(seed, position, salt):
    """The (seed, position, salt) -> key derivation (module docstring):
    PRNGKey(seed) is (0, seed), then fold_in of the position, then of
    the salt. Arguments are int64 tensors (broadcasting) or ints; the
    seed is taken modulo 2^32."""
    dev = next((x.device for x in (seed, position) if torch.is_tensor(x)),
               None)
    seed = torch.as_tensor(seed, dtype=torch.int64, device=dev) & 0xFFFFFFFF
    position = torch.as_tensor(position, dtype=torch.int64, device=dev)
    key = _random.fold_in((torch.zeros_like(seed), seed), position)
    return _random.fold_in(key, salt)


def gumbel(key, vocab):
    """(S..., V) Gumbel noise of the keys of shape S in one vectorised
    pass: jax.random.gumbel(key, (V,)) of each key, bit for bit."""
    return _random.gumbel(key, (vocab,))


def _rows(x, like, dtype):
    """A per-row parameter as a tensor of `like`'s leading shape."""
    x = torch.as_tensor(x, dtype=dtype, device=like.device)
    return x.expand(like.shape[:-1])


def filter_logits(scaled, top_k, top_p):
    """Apply top-k then top-p to already-temperature-scaled logits
    (..., V), masking dropped entries to NEG_INF. `top_k`/`top_p` are
    per-row; 0 / 1.0 disable the respective filter."""
    v = scaled.shape[-1]
    top_k = _rows(top_k, scaled, torch.int64)
    top_p = _rows(top_p, scaled, torch.float32)
    desc = torch.sort(scaled, dim=-1, descending=True).values
    k = torch.where(top_k > 0, top_k, torch.full_like(top_k, v)).clamp(1, v)
    kth = desc.gather(-1, (k - 1)[..., None])
    keep = scaled >= kth
    probs = torch.softmax(desc, dim=-1)
    below = (torch.cumsum(probs, dim=-1) - probs) < top_p[..., None]
    n_keep = below.sum(dim=-1).clamp_min(1)
    pth = desc.gather(-1, (n_keep - 1)[..., None])
    keep = keep & (scaled >= pth)
    return torch.where(keep, scaled, torch.full_like(scaled, NEG_INF))


def _scale(logits, temperature):
    greedy = _rows(temperature, logits, torch.float32) <= 0.0
    t = torch.where(greedy, torch.ones_like(greedy, dtype=torch.float32),
                    _rows(temperature, logits, torch.float32))
    return greedy, logits / t[..., None]


def sampling_dist(logits, temperature, top_k, top_p):
    """Each row's effective token distribution (..., V) — softmax of
    the filtered scaled logits; a one-hot argmax where temperature is 0
    (greedy is the zero-temperature limit, exactly). Feeds speculative
    accept/resample, which needs explicit p/q probabilities."""
    greedy, scaled = _scale(logits, temperature)
    p = torch.softmax(filter_logits(scaled, top_k, top_p), dim=-1)
    onehot = torch.nn.functional.one_hot(
        greedy_tokens(logits), logits.shape[-1]).to(p.dtype)
    return torch.where(greedy[..., None], onehot, p)


def sample_token(logits, seed, position, temperature, top_k, top_p,
                 salt=SALT_TOKEN, noise=None):
    """Draw one token id per row (int64 (...)) from `logits` (..., V)
    under each row's sampling params, on its (seed, position, salt)
    stream. temperature <= 0 reproduces argmax bit for bit. `noise`, when
    given, is that stream's Gumbel draw already made (a caller that
    batches several draws into one pass)."""
    greedy, scaled = _scale(logits, temperature)
    filtered = filter_logits(scaled, top_k, top_p)
    if noise is None:
        noise = gumbel(stream_key(seed, position, salt), logits.shape[-1])
    sampled = greedy_tokens(filtered + noise)
    return torch.where(greedy, greedy_tokens(logits), sampled)


def sample_from_dist(dist, seed, position, salt):
    """Draw from explicit probability vectors (..., V) via Gumbel-max on
    log-probabilities (speculative residual resampling). `salt` may be a
    tensor broadcasting against `position`."""
    g = gumbel(stream_key(seed, position, salt), dist.shape[-1])
    return greedy_tokens(torch.log(torch.clamp_min(dist, 1e-38)) + g)


def accept_uniform(seed, position):
    """The accept/reject uniform for the token at `position`, one per
    row: jax.random.uniform(stream_key(seed, position, SALT_ACCEPT))."""
    return _random.uniform(stream_key(seed, position, SALT_ACCEPT), ())
