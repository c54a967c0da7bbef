"""MLP classifier, as mxnet_tpu/models/mlp.py."""
from .. import symbol as sym


def get_mlp(num_classes=10, hidden=(128, 64)):
    data = sym.Variable("data")
    net = data
    for i, h in enumerate(hidden):
        net = sym.FullyConnected(net, name=f"fc{i + 1}", num_hidden=h)
        net = sym.Activation(net, name=f"relu{i + 1}", act_type="relu")
    net = sym.FullyConnected(net, name="fc_out", num_hidden=num_classes)
    return sym.SoftmaxOutput(net, name="softmax")
