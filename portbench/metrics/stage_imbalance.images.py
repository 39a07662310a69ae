"""The largest over the plan's stages of the device seconds of the
kernels launched under the stage's span (``spmd.stage.<s>``: the hop into
the stage, the stage, and for the last the copy into the output buffer),
over the stages' mean, in the traced batches: how far the balanced plan
is from balanced in what the card does while the schedule runs.  Nothing
to read where the program opens no stage spans."""


def read(run):
    t = run.trace
    if t is None:
        return None
    try:
        from repro_torch.launch.pipeline_spmd import stage_spans
    except ImportError:
        return None
    secs = [t.kernel_s_under((name,)) for name in
            stage_spans(run.cell.config["plan"]["stages"])]
    if sum(secs) <= 0:
        return None
    return max(secs) / (sum(secs) / len(secs))
