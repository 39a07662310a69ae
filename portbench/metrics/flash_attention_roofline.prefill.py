"""The flash_attention kernels' least time over their device time in the
traced batches.  Least time: the benchmark's copy of the kernel's cost
(4 D flops an unmasked causal pair; q, k, v and the output once) at the
cell's microbatch, over the fp32 peak or the HBM bandwidth, whichever is
larger, a call for every block and microbatch."""
from portbench import arith


def read(run):
    t = run.trace
    if t is None:
        return None
    device_s, launches = t.kernel_s("flash_attention")
    if launches == 0 or device_s <= 0:
        return None
    m, mix = run.cell.config["model"], run.cell.traffic
    mb = mix["batch"] // mix["microbatches"]
    flops, nbytes = arith.attention_cost(mb, m["n_heads"], m["n_kv_heads"],
                                         mix["seq"], mix["seq"],
                                         m["head_dim"], 4)
    least = launches * arith.least_s(flops, nbytes, run.peaks["fp32_flops"],
                                     run.peaks["hbm_bytes_per_s"])
    return 100.0 * least / device_s
