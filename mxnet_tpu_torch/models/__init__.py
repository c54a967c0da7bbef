"""Model zoo: functions returning Symbols that end in SoftmaxOutput,
ready for Module.fit. Ported so far: the MLP and Inception-ResNet-v2."""
from .inception_resnet_v2 import get_inception_resnet_v2
from .mlp import get_mlp

__all__ = ["get_inception_resnet_v2", "get_mlp"]
