"""Operator library: one registry, torch implementations.

Importing this package registers every op of mxnet_tpu/ops/.
"""
from . import registry  # noqa: F401
from . import elemwise  # noqa: F401
from . import broadcast_reduce  # noqa: F401
from . import matrix  # noqa: F401
from . import indexing  # noqa: F401
from . import init_sample  # noqa: F401
from . import ordering  # noqa: F401
from . import nn  # noqa: F401
from . import optimizer_ops  # noqa: F401
from . import rnn_op  # noqa: F401
from . import custom  # noqa: F401
from . import parallel_ops  # noqa: F401
from . import vision  # noqa: F401
