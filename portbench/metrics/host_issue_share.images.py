"""The share of a batch's time in which the host was not waiting in a
CUDA synchronize call, over the traced run's unprofiled batches: near 1
when the host paces the card, near the issue's share when the card paces
the host.  Host clock: the executor's call synchronises its last stage
itself, so the time until ``ex(x)`` returns is the whole batch, and the
harness times the synchronize calls (``harness.HostWaits``) with no
profiler running."""


def read(run):
    keep = [i for i in range(len(run.wait_s)) if i not in run.traced]
    if not keep:
        return None
    busy = sum(run.batch_s[i] for i in keep)
    return 1.0 - sum(run.wait_s[i] for i in keep) / busy
