"""Inception-ResNet-v2 (Szegedy et al. 2016): inception towers whose
concat projects back to the trunk width and adds in as a scaled residual
(block35 / block17 / block8 at scales 0.17 / 0.1 / 0.2). The same graph
as mxnet_tpu/models/inception_resnet_v2.py, node for node.

On this port every residual `net + scale * proj` (+ relu) is one fusion
group, lowered to a generated CUDA kernel (passes/codegen.py): 39
scale_bias_act groups and the elementwise b8_final group at full depth.
The `repeats` knob shrinks the three residual stages for tests and small
budgets without changing any tensor shape.
"""
from .. import symbol as sym


def _conv(data, nf, kernel=(1, 1), stride=(1, 1), pad=(0, 0),
          name=None, act=True):
    c = sym.Convolution(data, name=f"{name}_conv", num_filter=nf,
                        kernel=kernel, stride=stride, pad=pad,
                        no_bias=True)
    b = sym.BatchNorm(c, name=f"{name}_bn", fix_gamma=True, eps=2e-5)
    if not act:
        return b
    return sym.Activation(b, name=f"{name}_relu", act_type="relu")


def _residual(net, towers, trunk, scale, name, act=True):
    """concat(towers) -> 1x1 back to trunk width -> net + scale*proj.
    The inception-resnet signature move."""
    mixed = sym.Concat(*towers, dim=1, name=f"{name}_mixed")
    proj = _conv(mixed, trunk, name=f"{name}_proj", act=False)
    out = net + proj * scale
    if act:
        return sym.Activation(out, name=f"{name}_relu",
                              act_type="relu")
    return out


def _block35(net, name):
    t1 = _conv(net, 32, name=f"{name}_b1")
    t2 = _conv(net, 32, name=f"{name}_b2r")
    t2 = _conv(t2, 32, (3, 3), pad=(1, 1), name=f"{name}_b2")
    t3 = _conv(net, 32, name=f"{name}_b3r")
    t3 = _conv(t3, 48, (3, 3), pad=(1, 1), name=f"{name}_b3a")
    t3 = _conv(t3, 64, (3, 3), pad=(1, 1), name=f"{name}_b3b")
    return _residual(net, [t1, t2, t3], 320, 0.17, name)


def _block17(net, name):
    t1 = _conv(net, 192, name=f"{name}_b1")
    t2 = _conv(net, 128, name=f"{name}_b2r")
    t2 = _conv(t2, 160, (1, 7), pad=(0, 3), name=f"{name}_b2a")
    t2 = _conv(t2, 192, (7, 1), pad=(3, 0), name=f"{name}_b2b")
    return _residual(net, [t1, t2], 1088, 0.1, name)


def _block8(net, name, act=True):
    t1 = _conv(net, 192, name=f"{name}_b1")
    t2 = _conv(net, 192, name=f"{name}_b2r")
    t2 = _conv(t2, 224, (1, 3), pad=(0, 1), name=f"{name}_b2a")
    t2 = _conv(t2, 256, (3, 1), pad=(1, 0), name=f"{name}_b2b")
    return _residual(net, [t1, t2], 2080, 0.2, name, act=act)


def get_inception_resnet_v2(num_classes=1000, repeats=(10, 20, 9),
                            dropout=0.2):
    """Build the Inception-ResNet-v2 classifier Symbol (299^2 input).

    repeats=(a, b, c) sets the block35/block17/block8 stage depths;
    the canonical net is (10, 20, 9)."""
    data = sym.Variable("data")
    # stem: 299 -> 35 spatial, 192 channels
    net = _conv(data, 32, (3, 3), stride=(2, 2), name="stem1a")
    net = _conv(net, 32, (3, 3), name="stem2a")
    net = _conv(net, 64, (3, 3), pad=(1, 1), name="stem2b")
    net = sym.Pooling(net, kernel=(3, 3), stride=(2, 2),
                      pool_type="max", name="stem_pool3a")
    net = _conv(net, 80, name="stem3b")
    net = _conv(net, 192, (3, 3), name="stem4a")
    net = sym.Pooling(net, kernel=(3, 3), stride=(2, 2),
                      pool_type="max", name="stem_pool5a")

    # mixed 5b: 4 towers -> 320 channels
    t1 = _conv(net, 96, name="m5b_b1")
    t2 = _conv(net, 48, name="m5b_b2r")
    t2 = _conv(t2, 64, (5, 5), pad=(2, 2), name="m5b_b2")
    t3 = _conv(net, 64, name="m5b_b3r")
    t3 = _conv(t3, 96, (3, 3), pad=(1, 1), name="m5b_b3a")
    t3 = _conv(t3, 96, (3, 3), pad=(1, 1), name="m5b_b3b")
    t4 = sym.Pooling(net, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                     pool_type="avg", name="m5b_pool")
    t4 = _conv(t4, 64, name="m5b_b4")
    net = sym.Concat(t1, t2, t3, t4, dim=1, name="m5b_concat")

    for i in range(repeats[0]):
        net = _block35(net, f"b35_{i + 1}")

    # reduction A: 320 -> 1088 channels, stride 2
    t1 = _conv(net, 384, (3, 3), stride=(2, 2), name="redA_b1")
    t2 = _conv(net, 256, name="redA_b2r")
    t2 = _conv(t2, 256, (3, 3), pad=(1, 1), name="redA_b2a")
    t2 = _conv(t2, 384, (3, 3), stride=(2, 2), name="redA_b2b")
    t3 = sym.Pooling(net, kernel=(3, 3), stride=(2, 2),
                     pool_type="max", name="redA_pool")
    net = sym.Concat(t1, t2, t3, dim=1, name="redA_concat")

    for i in range(repeats[1]):
        net = _block17(net, f"b17_{i + 1}")

    # reduction B: 1088 -> 2080 channels, stride 2
    t1 = _conv(net, 256, name="redB_b1r")
    t1 = _conv(t1, 384, (3, 3), stride=(2, 2), name="redB_b1")
    t2 = _conv(net, 256, name="redB_b2r")
    t2 = _conv(t2, 288, (3, 3), stride=(2, 2), name="redB_b2")
    t3 = _conv(net, 256, name="redB_b3r")
    t3 = _conv(t3, 288, (3, 3), pad=(1, 1), name="redB_b3a")
    t3 = _conv(t3, 320, (3, 3), stride=(2, 2), name="redB_b3b")
    t4 = sym.Pooling(net, kernel=(3, 3), stride=(2, 2),
                     pool_type="max", name="redB_pool")
    net = sym.Concat(t1, t2, t3, t4, dim=1, name="redB_concat")

    for i in range(repeats[2]):
        net = _block8(net, f"b8_{i + 1}")
    net = _block8(net, "b8_final", act=False)

    net = _conv(net, 1536, name="head_conv")
    net = sym.Pooling(net, kernel=(1, 1), global_pool=True,
                      pool_type="avg", name="head_pool")
    net = sym.Flatten(net)
    if dropout:
        net = sym.Dropout(net, p=dropout)
    net = sym.FullyConnected(net, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(net, name="softmax")
