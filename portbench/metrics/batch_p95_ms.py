"""The 95th percentile, over every batch of the window, of the time from
issuing a batch to its outputs being on the device and synchronised."""
import statistics


def read(run):
    if len(run.batch_s) < 20:
        return None
    return statistics.quantiles(run.batch_s, n=20)[-1] * 1e3
