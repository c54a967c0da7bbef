"""Env-knob resolution for the decode tier (registered in
mxnet_tpu_torch.utils).

Resolution order everywhere: explicit constructor argument > MXNET_*
env var > built-in default.
"""
from __future__ import annotations

from .. import utils
from ..serving.batcher import _parse_buckets


def page_size():
    return utils.getenv("MXNET_DECODE_PAGE_SIZE")


def num_pages():
    return utils.getenv("MXNET_DECODE_PAGES")


def max_batch():
    return utils.getenv("MXNET_DECODE_MAX_BATCH")


def page_buckets():
    raw = utils.getenv("MXNET_DECODE_PAGE_BUCKETS")
    return _parse_buckets(raw) if raw else None


def merged_step():
    return bool(utils.getenv("MXNET_DECODE_MERGED_STEP"))


def kv_dtype():
    # validated/normalized by decoding.quant.canonical at engine build
    return str(utils.getenv("MXNET_DECODE_KV_DTYPE") or "float32")


def ring_prefill():
    return utils.getenv("MXNET_DECODE_RING_PREFILL")


def max_tokens():
    return utils.getenv("MXNET_DECODE_MAX_TOKENS")


def queue_cap():
    return utils.getenv("MXNET_DECODE_QUEUE_CAP")


def prefix_cache():
    return bool(utils.getenv("MXNET_DECODE_PREFIX_CACHE"))


def spec_k():
    return utils.getenv("MXNET_DECODE_SPEC_K")


def spec_draft():
    return utils.getenv("MXNET_DECODE_SPEC_DRAFT")


def sampling_temperature():
    return utils.getenv("MXNET_DECODE_SAMPLING_TEMPERATURE")


def sampling_top_k():
    return utils.getenv("MXNET_DECODE_SAMPLING_TOP_K")


def sampling_top_p():
    return utils.getenv("MXNET_DECODE_SAMPLING_TOP_P")


def sampling_seed():
    return utils.getenv("MXNET_DECODE_SAMPLING_SEED")


def default_page_buckets(max_pages_per_seq):
    """Powers of two up to max_pages_per_seq (inclusive): each bucket
    is one decode-step shape, so the grid stays logarithmic."""
    out, b = [], 1
    while b < max_pages_per_seq:
        out.append(b)
        b *= 2
    out.append(max_pages_per_seq)
    return tuple(out)
