"""Long-context attention (mxnet_tpu/parallel/attention.py): the plain
reference and the flash forward, whose CUDA kernel is
csrc/flash_attention.cu.

The multi-device half of the JAX package's `parallel` (mesh helpers, the
KVStore facade, ring and Ulysses attention, the pipeline and MoE
helpers) is not ported yet; it needs torch.distributed across cards.
"""
from .attention import attention, attention_reference

__all__ = ["attention", "attention_reference"]
