"""Model zoo: functions returning Symbols that end in a loss head, ready
for Module. Ported so far: the MLP, Inception-ResNet-v2 and the
transformer regression tower."""
from .inception_resnet_v2 import get_inception_resnet_v2
from .mlp import get_mlp
from .transformer import get_transformer

__all__ = ["get_inception_resnet_v2", "get_mlp", "get_transformer"]
