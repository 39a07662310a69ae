"""The slowest stage's achieved time over the stages' mean (the paper's
work imbalance of a plan), each stage timed alone on its card by the
executor's ``achieved_stage_times()`` after the window."""


def read(run):
    times = run.probes.get("achieved_stage_s")
    if not times:
        return None
    return max(times) / (sum(times) / len(times))
