"""Env-knob resolution for the fleet tier (mxnet_tpu/fleet/config.py;
the six MXNET_FLEET_* knobs are registered in the port's `utils` with
the JAX package's types, defaults and help).

Resolution order everywhere: explicit constructor argument > MXNET_*
env var > built-in default (the serving/decoding config convention).
"""
from __future__ import annotations

from .. import utils


def replicas():
    return utils.getenv("MXNET_FLEET_REPLICAS")


def port():
    return utils.getenv("MXNET_FLEET_PORT")


def heartbeat_ms():
    return utils.getenv("MXNET_FLEET_HEARTBEAT_MS")


def queue_high():
    return utils.getenv("MXNET_FLEET_QUEUE_HIGH")


def queue_low():
    return utils.getenv("MXNET_FLEET_QUEUE_LOW")


def drain_timeout_ms():
    return utils.getenv("MXNET_FLEET_DRAIN_TIMEOUT_MS")
