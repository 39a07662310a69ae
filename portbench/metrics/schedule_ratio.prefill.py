"""The median unprofiled batch's time over (M + S - 1) schedule steps of
the slowest stage, each stage timed alone on its card by the executor's
``achieved_stage_times()`` after the window: 1 when the schedule runs at
the bound its bubble sets, more for the hops, the embedding and head
outside the pipe, and the host."""
import statistics


def read(run):
    p = run.probes
    if not p.get("achieved_stage_s"):
        return None
    steps = p["n_microbatches"] + p["n_stages"] - 1
    batch = statistics.median(t for i, t in enumerate(run.batch_s)
                              if i not in run.traced)
    return batch / (steps * max(p["achieved_stage_s"]))
