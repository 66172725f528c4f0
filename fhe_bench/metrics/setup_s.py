"""setup_s: Set-up seconds: from the start of the run (imports, the
kernels' build where the checkout has none, context, keys, plans, pool,
warm-up) to the start of the measured window."""


def read(run):
    return run.setup_s
