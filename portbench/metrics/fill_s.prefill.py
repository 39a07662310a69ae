"""The executor's weight fill at set-up (``SpmdPipelineExecutor.fill_s``:
the stages' weights streamed from pinned host copies onto their cards,
with the shape-only bring-up overlapped)."""


def read(run):
    return run.probes.get("fill_s")
