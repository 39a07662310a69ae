"""The device's idle time inside the executor's calls, as a share of the
traced batches' wall time: over every ``spmd.call`` span, its length less
the part of it the card's device intervals cover, summed, averaged over
the cards and divided by the traced wall.  The schedule's fill and the
host's issue inside the call; the rest of ``device_idle.images`` falls
between calls, in the benchmark's loop.  Nothing to read where the
program opens no call spans."""
from portbench.trace import union_us


def read(run):
    t = run.trace
    if t is None or t.wall_s <= 0 or not t.devices:
        return None
    try:
        from repro_torch.launch.pipeline_spmd import CALL_SPAN
    except ImportError:
        return None
    calls = [(e.time_range.start, e.time_range.end) for e in t.cpu
             if e.name == CALL_SPAN]
    if not calls:
        return None
    idle_us = 0.0
    for d in t.devices:
        busy = [(lo, hi) for dd, lo, hi, _ in t.device_events if dd == d]
        for lo, hi in calls:
            inside = [(max(a, lo), min(b, hi)) for a, b in busy
                      if a < hi and b > lo]
            idle_us += hi - lo - union_us(inside)
    return idle_us / len(t.devices) / 1e6 / t.wall_s
