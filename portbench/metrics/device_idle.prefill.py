"""1 - the union of device intervals over the traced batches' wall time,
averaged over the cards."""


def read(run):
    t = run.trace
    if t is None or t.wall_s <= 0:
        return None
    return 1.0 - t.mean_busy_s() / t.wall_s
