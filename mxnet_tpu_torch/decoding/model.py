"""A minimal autoregressive decoder with paged-KV decode semantics.

The decode tier needs a model contract: an embedding, a stack of
attention+MLP blocks, and tied-logits output, expressed as functions
over one `Decoder` module —

  reference_logits      dense causal forward over a whole (B, T) buffer
                        (the unbatched reference of the parity tests)
  prefill_forward       dense causal forward over a padded prompt that
                        also scatters per-layer K/V into the paged pool
                        and returns the first generated token
  tail_prefill_forward  the prompt pass of a prefix-cache hit: only the
                        uncached tail runs, its queries attending over
                        the shared pages through the multi-query path
  decode_forward        one fixed-shape decode step: embed the last
                        token of every row, append its K/V to the pool
                        through the page table, attend over the pages,
                        return each row's next token

Each returns a greedy token, or, given sampling parameters, the token
drawn on the row's (seed, position) stream (decoding/sampling.py): the
first token at position `length`, each decode token at `lengths + 1`.

The JAX package expresses these as pure functions of a flat {name:
array} dict under jit with the pools donated. Here the weights live in
`Decoder`, an nn.Module whose parameters map one to one to those flat
names (`embed`, `pos`, `ln_f`, `l{i}.ln1/ln2/wq/wk/wv/wo/w1/w2`), the
functions run eagerly, and K/V are written into the pools in place.
Projections keep the JAX layout, `x @ W` with W stored (in, out), and
go to torch.matmul; the paged attention of the decode step is the
hand-written kernel of decoding/attention.py.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from . import quant as _quant
from . import sampling as _sampling
from .blocks import SCRATCH_PAGE
from .sampling import greedy_tokens

NEG_INF = -1e30


@dataclass(frozen=True)
class DecoderConfig:
    """Architecture hyperparameters."""

    vocab: int = 64
    d_model: int = 32
    n_layers: int = 2
    n_heads: int = 2
    d_ff: int = 64
    max_len: int = 256
    eos_id: int = 1

    @property
    def head_dim(self):
        if self.d_model % self.n_heads:
            raise ValueError("d_model must divide into n_heads")
        return self.d_model // self.n_heads


def init_decoder_params(cfg, seed=0):
    """Seeded random weights as a flat {name: float32 ndarray} dict,
    bit-identical to the JAX package's for the same seed."""
    rs = np.random.RandomState(seed)

    def w(*shape):
        scale = 1.0 / math.sqrt(shape[0])
        return (rs.uniform(-scale, scale, shape)).astype(np.float32)

    params = {
        "embed": w(cfg.vocab, cfg.d_model),
        "pos": w(cfg.max_len, cfg.d_model) * 0.1,
        "ln_f": np.ones((cfg.d_model,), np.float32),
    }
    for i in range(cfg.n_layers):
        params[f"l{i}.ln1"] = np.ones((cfg.d_model,), np.float32)
        params[f"l{i}.ln2"] = np.ones((cfg.d_model,), np.float32)
        for nm in ("wq", "wk", "wv", "wo"):
            params[f"l{i}.{nm}"] = w(cfg.d_model, cfg.d_model)
        params[f"l{i}.w1"] = w(cfg.d_model, cfg.d_ff)
        params[f"l{i}.w2"] = w(cfg.d_ff, cfg.d_model)
    return params


_LAYER_SHAPES = (("ln1", "d"), ("ln2", "d"), ("wq", "dd"), ("wk", "dd"),
                 ("wv", "dd"), ("wo", "dd"), ("w1", "df"), ("w2", "fd"))


def _empty(shape):
    return nn.Parameter(torch.empty(shape), requires_grad=False)


class DecoderLayer(nn.Module):
    """One attention+MLP block: ln1, ln2 (D,), wq/wk/wv/wo (D, D),
    w1 (D, F), w2 (F, D)."""

    def __init__(self, cfg):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        dims = {"d": (d,), "dd": (d, d), "df": (d, f), "fd": (f, d)}
        for name, kind in _LAYER_SHAPES:
            setattr(self, name, _empty(dims[kind]))


class Decoder(nn.Module):
    """The decoder's weights: embed (V, D), pos (max_len, D), ln_f
    (D,), and `layers[i]` holding the flat names `l{i}.*`."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.embed = _empty((cfg.vocab, cfg.d_model))
        self.pos = _empty((cfg.max_len, cfg.d_model))
        self.ln_f = _empty((cfg.d_model,))
        self.layers = nn.ModuleList(
            DecoderLayer(cfg) for _ in range(cfg.n_layers))

    @staticmethod
    def flat_names(cfg):
        names = ["embed", "pos", "ln_f"]
        for i in range(cfg.n_layers):
            names += [f"l{i}.{nm}" for nm, _ in _LAYER_SHAPES]
        return names

    def _param(self, name):
        if name.startswith("l") and "." in name:
            idx, nm = name[1:].split(".", 1)
            return getattr(self.layers[int(idx)], nm)
        return getattr(self, name)

    @torch.no_grad()
    def load_flat(self, flat):
        """Copy a flat {name: array} dict into the parameters; every
        name must be present with its exact shape."""
        for name in self.flat_names(self.cfg):
            if name not in flat:
                raise KeyError(f"missing decoder weight {name!r}")
            p = self._param(name)
            src = torch.from_numpy(np.array(flat[name], np.float32))
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(
                    f"weight {name!r}: shape {tuple(src.shape)} != "
                    f"{tuple(p.shape)}")
            p.copy_(src)
        return self

    def flat_params(self):
        """{flat name: float32 ndarray} host copy of the weights."""
        return {name: self._param(name).detach().cpu().numpy()
                for name in self.flat_names(self.cfg)}


def params_from_jax(flat, cfg, device="cpu"):
    """The port's decoder built from the JAX package's flat params dict
    (numpy or jax arrays, names as `init_decoder_params` makes them),
    so both packages compute the same function."""
    return Decoder(cfg).to(device).load_flat(flat)


def as_decoder(params, cfg, device):
    """A `Decoder` on `device` from a Decoder or a flat dict."""
    if isinstance(params, Decoder):
        return params.to(device)
    return params_from_jax(params, cfg, device)


def _rms(x, g):
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return x * torch.rsqrt(var + 1e-6) * g


def _qkv(layer, x, cfg):
    """(..., D) -> q/k/v each (..., H, Dh)."""
    shape = tuple(x.shape[:-1]) + (cfg.n_heads, cfg.head_dim)
    q = (x @ layer.wq).reshape(shape)
    k = (x @ layer.wk).reshape(shape)
    v = (x @ layer.wv).reshape(shape)
    return q, k, v


def _mlp(layer, x):
    return torch.relu(x @ layer.w1) @ layer.w2


def _dense_causal_attention(q, k, v, scale):
    """(B, T, H, Dh) causal attention, fp32 softmax."""
    t = q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    idx = torch.arange(t, device=q.device)
    causal = idx[:, None] >= idx[None, :]
    s = torch.where(causal[None, None], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    w = e / e.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


# ------------------------------------------------------------- reference
@torch.no_grad()
def reference_logits(model, tokens, cfg):
    """Dense causal forward: tokens (B, T) int -> logits (B, T, V)."""
    scale = 1.0 / math.sqrt(cfg.head_dim)
    tokens = torch.as_tensor(tokens, device=model.embed.device).long()
    b, t = tokens.shape
    x = model.embed[tokens] + model.pos[:t][None]
    for layer in model.layers:
        q, k, v = _qkv(layer, _rms(x, layer.ln1), cfg)
        o = _dense_causal_attention(q, k, v, scale)
        x = x + o.reshape(b, t, cfg.d_model) @ layer.wo
        x = x + _mlp(layer, _rms(x, layer.ln2))
    x = _rms(x, model.ln_f)
    return x @ model.embed.T


# -------------------------------------------------------------- sampling
def _pick_token(logits, seed, position, temperature, top_k, top_p):
    """Single-position token choice: greedy argmax when no sampling
    params were threaded through (seed None), else the counter-keyed
    sampler (sampling.sample_token) on the logits' device."""
    if seed is None:
        return greedy_tokens(logits)

    def dev(x, dtype):
        return torch.as_tensor(x, dtype=dtype, device=logits.device)

    return _sampling.sample_token(
        logits, dev(seed, torch.int64), dev(position, torch.int64),
        dev(temperature, torch.float32), dev(top_k, torch.int64),
        dev(top_p, torch.float32))


# --------------------------------------------------------------- prefill
@torch.no_grad()
def prefill_forward(model, tokens, length, k_pages, v_pages, page_ids,
                    seed=None, temperature=None, top_k=None, top_p=None,
                    *, cfg):
    """Prompt pass: tokens (1, Tb) padded to a length bucket, `length`
    (int) the true prompt length, page_ids (ceil(Tb/P),) the sequence's
    pages (padded with scratch 0), all on the model's device.

    Scatters every layer's K/V for positions < length into the pools
    in place (positions >= length land in the scratch page) and
    returns the first token as a device scalar: sampled on the (seed,
    position=length) stream when sampling params are given, greedy
    otherwise."""
    scale = 1.0 / math.sqrt(cfg.head_dim)
    k_pages = _quant.as_pool(k_pages)
    v_pages = _quant.as_pool(v_pages)
    page_size = k_pages.page_size
    tokens = tokens.long()
    _, t = tokens.shape
    pos = torch.arange(t, device=tokens.device)
    tgt_pages = torch.where(pos < length, page_ids.long()[pos // page_size],
                            torch.full_like(pos, SCRATCH_PAGE))
    slots = pos % page_size

    x = model.embed[tokens] + model.pos[:t][None]
    for i, layer in enumerate(model.layers):
        q, k, v = _qkv(layer, _rms(x, layer.ln1), cfg)
        _quant.kv_scatter(k_pages, i, tgt_pages, slots, k[0])
        _quant.kv_scatter(v_pages, i, tgt_pages, slots, v[0])
        o = _dense_causal_attention(q, k, v, scale)
        x = x + o.reshape(1, t, cfg.d_model) @ layer.wo
        x = x + _mlp(layer, _rms(x, layer.ln2))
    last = _rms(x[0, length - 1], model.ln_f)
    return _pick_token(last @ model.embed.T, seed, length, temperature,
                       top_k, top_p)


# ---------------------------------------------------- prefix-cache tail
@torch.no_grad()
def tail_prefill_forward(model, tokens, start, length, k_pages, v_pages,
                         page_ids, seed=None, temperature=None, top_k=None,
                         top_p=None, *, cfg, attn_multi):
    """Tail-only prompt pass for a prefix-cache hit: positions [0,
    start) already live in shared pages (K/V is a pure function of the
    token prefix), so only the tail [start, length) is computed here.

    tokens (1, Tb) holds the TAIL tokens padded to a length bucket;
    start/length are ints (absolute); page_ids covers the FULL table
    padded to the engine's largest bucket. Each layer scatters the tail
    K/V into its pages and attends the tail queries over the context
    gathered from the pages (shared prefix + just-written tail) with
    per-query causal masks through `attn_multi`. Returns the first
    token as `prefill_forward` does."""
    k_pages = _quant.as_pool(k_pages)
    v_pages = _quant.as_pool(v_pages)
    page_size = k_pages.page_size
    tokens = tokens.long()
    page_ids = page_ids.long()
    _, t = tokens.shape
    cap = page_ids.shape[0] * page_size
    pos = start + torch.arange(t, device=tokens.device)     # absolute
    valid = (pos < length) & (pos < cap)
    col = torch.clamp(pos // page_size, 0, page_ids.shape[0] - 1)
    tgt_pages = torch.where(valid, page_ids[col],
                            torch.full_like(pos, SCRATCH_PAGE))
    slots = pos % page_size
    pos_safe = torch.clamp(pos, 0, cfg.max_len - 1)
    table = page_ids[None].to(torch.int32)

    x = model.embed[tokens] + model.pos[pos_safe][None]
    for i, layer in enumerate(model.layers):
        q, k, v = _qkv(layer, _rms(x, layer.ln1), cfg)
        _quant.kv_scatter(k_pages, i, tgt_pages, slots, k[0])
        _quant.kv_scatter(v_pages, i, tgt_pages, slots, v[0])
        o = attn_multi(q, k_pages.layer(i), v_pages.layer(i), table,
                       pos_safe[None])
        x = x + o.reshape(1, t, cfg.d_model) @ layer.wo
        x = x + _mlp(layer, _rms(x, layer.ln2))
    last = _rms(x[0, length - 1 - start], model.ln_f)
    return _pick_token(last @ model.embed.T, seed, length, temperature,
                       top_k, top_p)


# ---------------------------------------------------------------- decode
def write_targets(page_table, lengths, active, page_size):
    """Where a decode step writes each row's new K/V and how much
    context it attends: (pages, slots, ctx_len). Inactive rows (and a
    row already at its table's capacity) write to the scratch page and
    attend one position."""
    b, bp = page_table.shape
    rows = torch.arange(b, device=page_table.device)
    in_cap = lengths < bp * page_size
    col = torch.clamp(lengths // page_size, 0, bp - 1).long()
    w_pages = torch.where(active & in_cap, page_table[rows, col].long(),
                          torch.full_like(col, SCRATCH_PAGE))
    slots = (lengths % page_size).long()
    ctx_len = torch.where(active, lengths + 1,
                          torch.ones_like(lengths)).to(torch.int32)
    return w_pages, slots, ctx_len


@torch.no_grad()
def decode_logits(model, tokens, k_pages, v_pages, page_table, lengths,
                  active, *, cfg, attn):
    """The shared decode-step body: embed each row's last token, append
    its K/V at index `lengths` through the page table (in place),
    attend over the pages with `attn`, and return (logits (B, V),
    clips) — `clips` the device count of this step's int8 K/V clips
    (0 for float pools). tokens/lengths (B,) int32, active (B,) bool,
    page_table (B, Bp) int32, all on the model's device."""
    k_pages = _quant.as_pool(k_pages)
    v_pages = _quant.as_pool(v_pages)
    b = tokens.shape[0]
    page_table = page_table.to(torch.int32).contiguous()
    w_pages, slots, ctx_len = write_targets(
        page_table, lengths, active, k_pages.page_size)

    clips = torch.zeros((), dtype=torch.int32, device=tokens.device)
    pos = torch.clamp(lengths, 0, cfg.max_len - 1).long()
    x = model.embed[tokens.long()] + model.pos[pos]
    for i, layer in enumerate(model.layers):
        q, k, v = _qkv(layer, _rms(x, layer.ln1), cfg)
        clips = clips + _quant.kv_scatter(k_pages, i, w_pages, slots, k)
        clips = clips + _quant.kv_scatter(v_pages, i, w_pages, slots, v)
        o = attn(q.contiguous(), k_pages.layer(i), v_pages.layer(i),
                 page_table, ctx_len)
        x = x + o.reshape(b, cfg.d_model) @ layer.wo
        x = x + _mlp(layer, _rms(x, layer.ln2))
    x = _rms(x, model.ln_f)
    return x @ model.embed.T, clips


@torch.no_grad()
def decode_forward(model, tokens, k_pages, v_pages, page_table, lengths,
                   active, seeds=None, temps=None, top_ks=None,
                   top_ps=None, *, cfg, attn, with_stats=False):
    """One decode step over the full fixed-shape batch. With seeds /
    temps / top_ks / top_ps (B,) device tensors the next token is drawn
    per row on its (seed, position=lengths+1) stream (temperature 0 =
    exact greedy); without them it is the argmax. Returns next_tokens
    (B,) int64 on the device; with_stats=True (the
    MXNET_NUMERICS_DECODE_GUARD path) also returns a (2,) int32 device
    vector [nonfinite_rows, quant_clips]: active rows whose logits hold
    NaN/Inf, and K/V values this step's int8 writes had to clip."""
    logits, clips = decode_logits(
        model, tokens, k_pages, v_pages, page_table, lengths, active,
        cfg=cfg, attn=attn)
    if seeds is None:
        next_tokens = greedy_tokens(logits)
    else:
        next_tokens = _sampling.sample_token(
            logits, seeds, lengths.long() + 1, temps, top_ks, top_ps)
    if not with_stats:
        return next_tokens
    bad_rows = (~torch.isfinite(logits)).any(dim=-1) & active
    guard = torch.stack([bad_rows.sum(dtype=torch.int32), clips])
    return next_tokens, guard
