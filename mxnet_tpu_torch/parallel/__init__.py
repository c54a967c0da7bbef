"""The multi-device machinery (mxnet_tpu/parallel/): long-context
attention (the plain reference and the flash forward, whose CUDA kernel
is csrc/flash_attention.cu), ring and Ulysses attention over a 'seq'
mesh axis, the device mesh helpers, the KVStore('tpu') facade over the
worker processes' gloo group, the fused train step with its mesh, the
pipeline schedule over a 'pipe' axis and the mixture of experts over an
'expert' axis.
"""
from .attention import attention, attention_reference
from .kvstore_tpu import KVStoreTPU
from .mesh import (current_mesh, data_parallel_mesh, default_mesh,
                   make_mesh, set_mesh)
from .moe import init_moe_params, moe_ffn, top1_gating
from .pipeline import pipeline_apply
from .ring_attention import ring_attention, ulysses_attention

__all__ = ["KVStoreTPU", "attention", "attention_reference",
           "current_mesh", "data_parallel_mesh", "default_mesh",
           "init_moe_params", "make_mesh", "moe_ffn", "pipeline_apply",
           "ring_attention", "set_mesh", "top1_gating",
           "ulysses_attention"]
