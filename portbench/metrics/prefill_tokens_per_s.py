"""Prompt tokens prefilled in the window over the window's time (host
clock; each batch ends in a synchronise of the mesh's cards)."""


def read(run):
    return run.rate("tokens")
