"""Per-fit accounting (``FitStats``, surfaced on the model as
``fit_stats_``) and the fit's trace (``maybe_trace``).

Port of ``hpfrec_tpu/utils/profiling.py:FitStats`` and ``maybe_trace``.
Device work is asynchronous, so on a CUDA device every phase ends with
``torch.cuda.synchronize()``: a phase then owns the device time of the
work it enqueued.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Optional


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def maybe_trace(profile_dir):
    """With a ``profile_dir``, run the wrapped region under
    ``torch.profiler.profile`` (CPU activity, and CUDA activity when a CUDA
    device is present) and write its Chrome trace to
    ``profile_dir/trace.json``, readable in Perfetto or chrome://tracing;
    without one, do nothing."""
    if not profile_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(profile_dir, TRACE_FILE))


@dataclass
class FitStats:
    """End-to-end fit statistics.

    ``wall_seconds`` spans the whole ``fit`` call, host data layer and
    kernel build included, so ``nnz_per_second`` is an end-to-end figure.
    ``phases`` attributes the wall time (seconds):

    - ``reindex``        host triplet ingest, filtering and reindexing
    - ``host_pack``      CSR builds + ELL packing (full batch: both sides
      concurrently, this is the span; SVI: the CSR/CSC and the metric
      layout)
    - ``kernel_build``   building or loading the CUDA kernels (0 on CPU)
    - ``valset``         validation-set ingest and upload
    - ``transfer``       host->device upload of the layouts and the state
    - ``iterations``     the CAVI iteration blocks (full batch)
    - ``user_epochs`` / ``item_epochs``  the SVI epochs of each side
    - ``metric_checks``  convergence checks + the final metric

    ``wall_seconds - sum(phases.values())`` is unattributed glue.
    """

    nnz: int = 0
    iterations: int = 0
    wall_seconds: float = 0.0
    phases: dict = field(default_factory=dict)
    device: Optional[object] = None  # a torch.device; CUDA phases synchronize
    _t0: float = field(default=0.0, repr=False)

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def stop(self, iterations: int):
        self.wall_seconds = time.perf_counter() - self._t0
        self.iterations = iterations
        return self

    def _sync(self):
        if self.device is not None and self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, name: str):
        """Accumulate the wrapped region's wall time under ``name``."""
        t0 = time.perf_counter()
        try:
            yield
            self._sync()
        finally:
            self.add_phase(name, time.perf_counter() - t0)

    def add_phase(self, name: str, seconds: float):
        self.phases[name] = self.phases.get(name, 0.0) + seconds

    @property
    def nnz_per_second(self) -> float:
        if self.wall_seconds <= 0:
            return 0.0
        return self.nnz * self.iterations / self.wall_seconds

    def phase_report(self) -> str:
        """One line per phase, largest first, with share of wall time."""
        if not self.phases or self.wall_seconds <= 0:
            return ""
        lines = []
        for name, s in sorted(self.phases.items(), key=lambda kv: -kv[1]):
            lines.append("  %-20s %8.2fs  (%4.1f%%)"
                         % (name, s, 100.0 * s / self.wall_seconds))
        other = self.wall_seconds - sum(self.phases.values())
        lines.append("  %-20s %8.2fs  (%4.1f%%)"
                     % ("(unattributed)", other, 100.0 * other / self.wall_seconds))
        return "\n".join(lines)
