"""setup_s: process start to the window's start (host clock): weights
made on the card from the seed, packed, kernels loaded from build/, the
cell's shapes warmed, lanes filled."""


def read(run):
    return run.setup_s
