"""The convolutions' least time over the device time of the kernels that
the convolution operators launched, in the traced batches.  Least time:
each convolution's FLOPs over the fp32 peak or its input, weight and
output bytes over the HBM bandwidth, whichever is larger, counted by the
benchmark at the cell's microbatch."""
from portbench import arith

CONV_OPS = ("aten::conv2d", "aten::convolution", "aten::_convolution",
            "aten::cudnn_convolution")


def read(run):
    t = run.trace
    if t is None:
        return None
    device_s = t.kernel_s_under(CONV_OPS)
    if device_s <= 0:
        return None
    mix = run.cell.traffic
    ref = run.cell.reference
    mb = mix["batch"] // mix["microbatches"]
    calls = len(run.traced) * mix["microbatches"]
    least = calls * arith.convs_least_s(
        ref.conv_costs(run.cell.config["model"], mb),
        run.peaks["fp32_flops"], run.peaks["hbm_bytes_per_s"])
    return 100.0 * least / device_s
