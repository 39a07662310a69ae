"""The depthwise convolutions' least time over the device time of the
kernels launched under the CNN forward's depthwise span (``cnn.dwconv``),
in the traced batches.  Least time: each depthwise call's FLOPs over the
fp32 peak or its input, weight and output bytes over the HBM bandwidth,
whichever is larger (the reference's ``dwconv_costs``, counted by the
benchmark at the cell's microbatch), times the traced microbatches.
Nothing to read where the program opens no depthwise spans."""
from portbench import arith


def read(run):
    t = run.trace
    if t is None:
        return None
    try:
        from repro_torch.models.layers import DWCONV_SPAN
    except ImportError:
        return None
    if not any(e.name == DWCONV_SPAN for e in t.cpu):
        return None
    device_s = t.kernel_s_under((DWCONV_SPAN,))
    if device_s <= 0:
        return None
    mix = run.cell.traffic
    mb = mix["batch"] // mix["microbatches"]
    calls = len(run.traced) * mix["microbatches"]
    least = calls * arith.convs_least_s(
        run.cell.reference.dwconv_costs(run.cell.config["model"], mb),
        run.peaks["fp32_flops"], run.peaks["hbm_bytes_per_s"])
    return 100.0 * least / device_s
