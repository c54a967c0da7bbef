"""Speculative decoding over the paged KV cache: a small draft model
proposes K tokens per step, the target model verifies all K+1
positions in one fixed-shape pass over the same page tables.

Both models' K/V entries are pure functions of the token prefix, so the
draft keeps a PARALLEL pool of pages indexed by the exact same page
ids/tables the target uses — no second allocator, no second scheduler.
The allocator's refcount/COW decisions apply to both pools (the engine
copies draft pages alongside target pages on COW breaks), and
prefix-cache hits share draft K/V for free.

Rollback is by page-table truncation, never by copy: a step that
accepts n < K drafts leaves the rejected entries in the pages BEYOND
the advanced length, where every attention read masks them out and the
next step's writes at positions [length', length'+K] overwrite every
stale entry before anything can unmask it.

The accept rule is the standard speculative-sampling one (accept draft
d_j with probability min(1, p_j(d_j)/q_j(d_j)); on the first
rejection, resample from normalize(max(p_j - q_j, 0))), which makes the
emitted stream distribution-identical to target-only decoding — and
exactly equal under greedy, where p/q degenerate to one-hots and the
rule reduces to "accept while the draft matches the target argmax".
All randomness rides the (seed, position, salt) streams of `sampling`.
Sampled speculative output is distribution-identical to target-only
sampling, not bit-identical across preempt/readmit (the bonus token's
stream position depends on where a step started).

A per-row `use_draft` flag lets requests opt out inside the same
fixed-shape pass: opted-out rows force zero accepts and their
correction slot is a direct sample from the target distribution on the
plain-decode (seed, position, TOKEN) stream.

Both forwards take `sampled`: False when no row of the step samples
(every temperature is 0). Each then skips the Gumbel draws and the
explicit distributions and takes the argmax short-cuts, which give the
tokens the full rule gives greedy rows. The draft's K steps go through
the paged attention kernel (B4/B5 on the card); the verifier's K+1
queries go through the multi-query path (attention.paged_attention_
multi), which the JAX package also computes outside Pallas.
"""
from __future__ import annotations

import torch

from . import quant as _quant
from . import sampling as _sampling
from .blocks import SCRATCH_PAGE
from .model import _mlp, _qkv, _rms, decode_logits


@torch.no_grad()
def draft_propose_forward(model, last_tokens, k_pages, v_pages, page_table,
                          lengths, active, seeds, temps, top_ks, top_ps, *,
                          cfg, attn, k, sampled=True):
    """K unrolled draft decode steps, each feeding its token back as
    the next step's input. Returns (drafts (B, K) int64, q_dists (B, K,
    V) — the draft's sampling distribution at each position, which the
    verify accept ratio needs — or None when not `sampled`). Draft
    tokens ride the SALT_DRAFT stream at the position they would be
    emitted (lengths+1+j); the K Gumbel draws are made in one pass
    before the steps, since their keys do not depend on the tokens."""
    offs = torch.arange(k, device=lengths.device)
    noise = None
    if sampled:
        pos = lengths.long()[:, None] + 1 + offs
        noise = _sampling.gumbel(
            _sampling.stream_key(seeds[:, None], pos, _sampling.SALT_DRAFT),
            cfg.vocab)
    tok = last_tokens
    drafts, q_dists = [], []
    for j in range(k):
        logits, _ = decode_logits(model, tok, k_pages, v_pages, page_table,
                                  lengths + j, active, cfg=cfg, attn=attn)
        if sampled:
            q_dists.append(_sampling.sampling_dist(logits, temps, top_ks,
                                                   top_ps))
            tok = _sampling.sample_token(
                logits, seeds, lengths.long() + 1 + j, temps, top_ks,
                top_ps, salt=_sampling.SALT_DRAFT, noise=noise[:, j])
        else:
            tok = _sampling.greedy_tokens(logits)
        drafts.append(tok)
    return (torch.stack(drafts, dim=1),
            torch.stack(q_dists, dim=1) if sampled else None)


@torch.no_grad()
def verify_forward(model, last_tokens, drafts, q_dists, k_pages, v_pages,
                   page_table, lengths, active, use_draft, seeds, temps,
                   top_ks, top_ps, *, cfg, attn_multi, k, sampled=True):
    """The target's verify step: score positions lengths..lengths+K in
    one multi-query pass, accept/resample on the device.

    Writes the K+1 input tokens' K/V at positions lengths..lengths+K
    through the page table (the host guarantees those pages are
    exclusively owned), attends each query j over context <=
    lengths+j, then runs the accept rule per row. Returns (tokens_out
    (B, K+1) int64, n_emit (B,) int64): row b emits
    tokens_out[b, :n_emit[b]], where slot n_acc holds the
    correction/bonus token and slots before it are the accepted
    drafts."""
    k_pages = _quant.as_pool(k_pages)
    v_pages = _quant.as_pool(v_pages)
    page_size = k_pages.page_size
    b, bp = page_table.shape
    s = k + 1
    dev = last_tokens.device
    rows = torch.arange(b, device=dev)
    offs = torch.arange(s, device=dev)
    lengths = lengths.long()
    tokens_in = torch.cat([last_tokens.long()[:, None], drafts], dim=1)
    pos = lengths[:, None] + offs[None, :]              # (B, S) writes
    in_cap = pos < bp * page_size
    col = torch.clamp(pos // page_size, 0, bp - 1)
    w_pages = torch.where(active[:, None] & in_cap,
                          page_table.long().gather(1, col),
                          torch.full_like(pos, SCRATCH_PAGE))
    slots = pos % page_size
    pos_safe = torch.clamp(pos, 0, cfg.max_len - 1)
    table = page_table.to(torch.int32).contiguous()

    x = model.embed[tokens_in] + model.pos[pos_safe]
    for i, layer in enumerate(model.layers):
        q, kk, vv = _qkv(layer, _rms(x, layer.ln1), cfg)
        _quant.kv_scatter(k_pages, i, w_pages, slots, kk)
        _quant.kv_scatter(v_pages, i, w_pages, slots, vv)
        o = attn_multi(q, k_pages.layer(i), v_pages.layer(i), table,
                       pos_safe)
        x = x + o.reshape(b, s, cfg.d_model) @ layer.wo
        x = x + _mlp(layer, _rms(x, layer.ln2))
    logits = _rms(x, model.ln_f) @ model.embed.T      # (B, S, V)

    acc = use_draft & active
    n_acc = torch.zeros((b,), dtype=torch.int64, device=dev)
    if not sampled:
        # every row greedy: p and q are one-hots, a draft is accepted
        # where it is the target's argmax, and every correction and the
        # bonus is the target's argmax at its slot
        corr_all = _sampling.greedy_tokens(logits)     # (B, S)
        for j in range(k):
            acc = acc & (corr_all[:, j] == drafts[:, j])
            n_acc = n_acc + acc.long()
    else:
        temps_s, top_ks_s, top_ps_s = (x[:, None] for x in
                                       (temps, top_ks, top_ps))
        p_dists = _sampling.sampling_dist(logits, temps_s, top_ks_s,
                                          top_ps_s)    # (B, S, V)
        # accept run: a_j = [all drafts before j accepted] & u_j < p/q
        u = _sampling.accept_uniform(seeds[:, None],
                                     lengths[:, None] + 1 + offs[:k])
        for j in range(k):
            d_j = drafts[:, j]
            p_d = p_dists[rows, j, d_j]
            q_d = q_dists[rows, j, d_j]
            acc = acc & (u[:, j] < p_d / torch.clamp_min(q_d, 1e-9))
            n_acc = n_acc + acc.long()
        # correction candidates, one per possible rejection slot (plus
        # the bonus slot K, reached only on a clean sweep), drawn in one
        # pass: K residual resamples, then K+1 direct target samples
        pj = p_dists[:, :k]
        resid = torch.clamp_min(pj - q_dists, 0.0)
        rs = resid.sum(dim=-1, keepdim=True)
        resid_dist = torch.where(rs > 1e-9, resid / torch.clamp_min(rs, 1e-9),
                                 pj)
        salts = torch.cat([
            torch.full((k,), _sampling.SALT_RESAMPLE, device=dev),
            torch.full((s,), _sampling.SALT_TOKEN, device=dev)])
        positions = lengths[:, None] + 1 + torch.cat([offs[:k], offs])
        draws = _sampling.sample_from_dist(
            torch.cat([resid_dist, p_dists], dim=1), seeds[:, None],
            positions, salts)                          # (B, 2K+1)
        # greedy rows take the argmax directly: one-hot residuals make it
        # exact, and bypassing the draw keeps greedy seed-independent
        greedy = (temps <= 0.0)[:, None]
        gd = _sampling.greedy_tokens(p_dists)          # (B, S)
        r = torch.where(greedy, gd[:, :k], draws[:, :k])
        t = torch.where(greedy, gd, draws[:, k:])
        corr_all = torch.cat(
            [torch.where(use_draft[:, None], r, t[:, :k]), t[:, k:]], dim=1)
    correction = corr_all[rows, n_acc]
    tokens_out = torch.cat(
        [drafts, torch.zeros((b, 1), dtype=drafts.dtype, device=dev)], dim=1)
    tokens_out[rows, n_acc] = correction
    n_emit = torch.where(active, n_acc + 1, torch.zeros_like(n_acc))
    return tokens_out, n_emit
