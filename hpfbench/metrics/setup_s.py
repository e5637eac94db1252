"""``setup_s``: seconds from the start of the run's process to the start
of its window (imports, the card's start, the inputs made from the seed,
the kernels loaded from the checkout's build cache, one warm call of every
shape the window uses), on the host's clock."""


def read(run):
    return run.setup_s
