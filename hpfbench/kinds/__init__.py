"""The drivers of the traffic kinds, one module a kind (``traffic/<mix>.json``
names its ``kind``).  Each defines ``Cell(cfg, traffic, seed, device,
trace, arm)`` with ``setup()``, ``window(seconds)``, ``finish(trace)``,
``release()``, ``numbers()`` and ``describe()`` (a line for standard
error), and the records its metric readers read."""


def model_seed(seed: int) -> int:
    """The model's ``random_seed`` for a run's ``--seed`` (positive, as
    ``HPF`` draws from the clock for 0)."""
    return int(seed) + 1
