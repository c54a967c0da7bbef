"""Operator library: one registry, torch implementations.

Importing this package registers every op. Only the ops of the ported
slices are here: the elementwise and reduction ops the fusion pass can
group (passes/transforms.py ELEMWISE_OPS, passes/codegen.py REDUCE_OPS),
the layers of the image-classification models (Convolution, Pooling,
BatchNorm, FullyConnected, Dropout, Activation), Concat / flatten /
reshape / SliceChannel, the SoftmaxOutput, regression and MakeLoss
heads, the constant sources of the folding pass, the transformer's
RingAttention (one device), the adam_update op and the Custom op
(Python-defined operators, `operator.py`). The rest of the op
library waits for later slices.
"""
from . import registry  # noqa: F401
from . import elemwise  # noqa: F401
from . import broadcast_reduce  # noqa: F401
from . import matrix  # noqa: F401
from . import nn  # noqa: F401
from . import optimizer_ops  # noqa: F401
from . import parallel_ops  # noqa: F401
from . import custom  # noqa: F401
