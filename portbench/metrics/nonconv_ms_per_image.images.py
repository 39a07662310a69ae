"""Device time of every kernel not launched under a convolution operator,
a traced image: BN, ReLU, the adds, the pads, the pools, the dense layer
and the boundary packing and unpacking."""
CONV_OPS = ("aten::conv2d", "aten::convolution", "aten::_convolution",
            "aten::cudnn_convolution")


def read(run):
    t = run.trace
    if t is None:
        return None
    images = len(run.traced) * run.units["images"]
    nonconv = t.total_kernel_s() - t.kernel_s_under(CONV_OPS)
    return nonconv * 1e3 / images
