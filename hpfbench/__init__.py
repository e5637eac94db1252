"""The benchmark of ``hpfrec_tpu_torch`` on an NVIDIA H100.

One command runs one cell (a configuration under a traffic mix) once::

    python3 -m hpfbench.run --workload <config>.<mix> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name from ``BENCHMARK.json``: the
configuration in ``configs/<config>.json``, the traffic mix in
``traffic/<mix>.json`` (whose ``kind`` names the driver in
``kinds/<kind>.py``), each metric's reader in ``metrics/<metric>.py`` and
the cell's correctness limits in ``limits/<workload>.json``.  The work
counts behind every roofline and utilization are in ``work/``; the plain
reference that decides ``correct`` is in ``reference/``, which imports
nothing of the program.  See ``README.md``.
"""
