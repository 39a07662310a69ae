"""Process start to the start of the window: imports, weights made from
the seed, the plan, the executor's weight streaming and bring-up, the
input pool and the warm-up batches."""


def read(run):
    return run.setup_s
