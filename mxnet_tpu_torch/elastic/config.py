"""Env-knob resolution for the elastic tier (mxnet_tpu/elastic/config.py;
the six MXNET_ELASTIC_* knobs are registered in the port's `utils` with
the JAX package's names, types, defaults and help, so `describe_env()`
lists them).

Resolution order everywhere: explicit constructor argument > MXNET_*
env var > built-in default (the serving/decoding/fleet convention).
"""
from __future__ import annotations

from .. import utils


def port():
    return utils.getenv("MXNET_ELASTIC_PORT")


def heartbeat_ms():
    return utils.getenv("MXNET_ELASTIC_HEARTBEAT_MS")


def quiesce_timeout_ms():
    return utils.getenv("MXNET_ELASTIC_QUIESCE_TIMEOUT_MS")


def logical_shards():
    return utils.getenv("MXNET_ELASTIC_LOGICAL_SHARDS")


def min_world():
    return utils.getenv("MXNET_ELASTIC_MIN_WORLD")


def rejoin_ms():
    return utils.getenv("MXNET_ELASTIC_REJOIN_MS")
