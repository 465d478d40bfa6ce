"""setup_s: from the process's start to the end of the warm batch:
imports, CUDA, the kernels' build or load, the pool made from the seed,
one batch of the cell's shape (host clock)."""


def read(run):
    return run.setup_s
