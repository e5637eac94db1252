"""Per-call accounting (``FitStats``, surfaced on the model as
``fit_stats_``; ``TopNStats``, as ``topn_stats_``) and the fit's trace
(``maybe_trace``).

Port of ``hpfrec_tpu/utils/profiling.py:FitStats`` and ``maybe_trace``.
A call's phases are timed on the host clock, always.  While a
``torch.profiler`` records, the call and each of its phases also open a
``torch.profiler.record_function`` of a fixed name (``<root>`` and
``<root>.<phase>``: ``hpf.fit.transfer``, ``hpf.topN_batch.gather``), so
they land on the profiler's timeline, the clock of its kernels and
copies, nested as they run; when none records, no annotation is entered.
Device work is asynchronous, so on a CUDA device every phase of a fit
ends with ``torch.cuda.synchronize()``: a phase then owns the device time
of the work it enqueued.  ``TopNStats`` takes no device and adds no
synchronize: a ``topN_batch`` call waits on its answers' copy back.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Optional

import torch

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
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(profile_dir, TRACE_FILE))


def annotate(name: str):
    """``torch.profiler.record_function(name)`` while a profiler records
    in this process, else a context that does nothing."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def device_bytes(device, *objs) -> int:
    """Bytes of the distinct storages of the tensors on ``device``'s type
    held in ``objs`` (tensors, and tuples, lists and dataclasses of them):
    what an upload placed there."""
    seen, todo, total = set(), list(objs), 0
    while todo:
        o = todo.pop()
        if isinstance(o, torch.Tensor):
            if o.device.type == device.type:
                s = o.untyped_storage()
                if s.data_ptr() not in seen:
                    seen.add(s.data_ptr())
                    total += s.nbytes()
        elif isinstance(o, (tuple, list)):
            todo.extend(o)
        elif is_dataclass(o):
            todo.extend(getattr(o, f.name) for f in fields(o))
    return total


@dataclass
class CallStats:
    """The wall and the phases of one call, and what it moved.

    ``wall_seconds`` spans the whole call; ``phases`` maps a phase's name
    to its seconds (a phase run twice adds up), and ``unattributed_seconds``
    is the glue outside every phase.  A phase named in ``NESTED`` runs
    inside another phase, whose seconds hold its own.  ``bytes_to_device`` /
    ``bytes_to_host`` count the call's copies between host and device."""

    ROOT = "call"  # the call's annotation; its phases' are ROOT + "." + name
    COUNTERS = ("bytes_to_device", "bytes_to_host")
    NESTED = ()

    wall_seconds: float = 0.0
    phases: dict = field(default_factory=dict)
    device: Optional[object] = None  # a torch.device; CUDA phases synchronize
    bytes_to_device: int = 0
    bytes_to_host: int = 0

    @contextlib.contextmanager
    def run(self):
        """Time the wrapped call into ``wall_seconds``, under ``ROOT``."""
        t0 = time.perf_counter()
        try:
            with annotate(self.ROOT):
                yield self
        finally:
            self.wall_seconds = time.perf_counter() - t0

    def _sync(self):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, name: str):
        """Accumulate the wrapped region's wall time under ``name``."""
        t0 = time.perf_counter()
        try:
            with annotate(self.ROOT + "." + name):
                yield
                self._sync()
        finally:
            self.add_phase(name, time.perf_counter() - t0)

    def add_phase(self, name: str, seconds: float):
        self.phases[name] = self.phases.get(name, 0.0) + seconds

    @property
    def unattributed_seconds(self) -> float:
        """``wall_seconds`` less the seconds of the phases that no other
        phase holds."""
        return self.wall_seconds - sum(s for name, s in self.phases.items()
                                       if name not in self.NESTED)

    def phase_report(self) -> str:
        """One line per phase, largest first, with share of wall time, then
        the counters."""
        if not self.phases or self.wall_seconds <= 0:
            return ""
        lines = []
        for name, s in sorted(self.phases.items(), key=lambda kv: -kv[1]):
            lines.append("  %-20s %8.2fs  (%4.1f%%)"
                         % (name, s, 100.0 * s / self.wall_seconds))
        other = self.unattributed_seconds
        lines.append("  %-20s %8.2fs  (%4.1f%%)"
                     % ("(unattributed)", other, 100.0 * other / self.wall_seconds))
        lines.append("  " + ", ".join("%s %d" % (c, getattr(self, c)) for c in self.COUNTERS))
        return "\n".join(lines)


@dataclass
class FitStats(CallStats):
    """End-to-end fit statistics (``HPF.fit``).

    ``wall_seconds`` spans the whole ``fit`` call, from the triplets'
    ingest to the fitted attributes on the host, so ``nnz_per_second`` is
    an end-to-end figure.  ``phases`` attributes the wall time (seconds):

    - ``reindex``        triplet ingest: the coercion and, with
      ``reindex``, the host's filter and factorize; the upload, and
      without ``reindex`` the filter and id checks on the device
    - ``valset``         validation-set ingest and upload
    - ``init_state``     the state's seeded start: on a CUDA device drawn
      on the card by K14 from numpy's seeded key (the host draw in the
      table-sharded engine), on the CPU drawn by numpy; or the
      checkpoint's, on resume
    - ``host_pack``      both sides' key sorts on the device, then the
      engine's structures: the ELL layouts' plan on the host and fill
      (K15), the COO stream, the table-sharded tiles on the host (the
      sides copied back), SVI's metric layout or stream
    - ``kernel_build``   building or loading the CUDA kernels (0 on CPU)
    - ``transfer``       host->device upload of the layouts' row ids and
      reassembly arrays (the table-sharded tiles) and the state
    - ``iterations``     the CAVI iteration blocks (full batch)
    - ``user_epochs`` / ``item_epochs``  the SVI epochs of each side
    - ``epoch_offsets``  inside each SVI epoch's phase: the host's part of
      the epoch (the shuffle, the permuted rows' offsets, the permutation's
      and the offsets' uploads), before K9 and the batches are issued
    - ``metric_checks``  convergence checks + the final metric
    - ``checkpoints``    checkpoint writes
    - ``copy_back``      Theta and Beta divided where the state is, and
      their copy to the host with the state's (``keep_all_objs``)
    - ``save``           ``save_folder``'s files
    - ``metadata``       the seen-items CSR (``keep_data``) and the id dicts

    Counters: ``nnz``, ``iterations``, ``checks`` (convergence checks
    run), ``bytes_to_device`` (the triplets, what the layouts' fill and
    reassembly read from the host, the validation set and a state drawn on
    the host; not a start drawn on the card, nor the 2.5 KB key it is
    drawn from), ``bytes_to_host`` (what the fit copied back: Theta and
    Beta, the state where it is kept, the seen-items CSR's entries),
    ``staged_bytes`` (the part of it that crossed from a card through
    ``ops.staging``'s pinned ring; 0 on the CPU), ``device_draws`` (the
    MT19937 words drawn on the card for the start: ``2 (nU + nI) k``,
    twice that in float64; 0 where the host drew it) and ``batches`` (the
    SVI batches run, each epoch's row count over its batch size rounded
    up; 0 in full batch).
    """

    ROOT = "hpf.fit"
    COUNTERS = ("nnz", "iterations", "checks", "bytes_to_device", "bytes_to_host",
                "staged_bytes", "device_draws", "batches")
    NESTED = ("epoch_offsets",)

    nnz: int = 0
    iterations: int = 0
    checks: int = 0
    staged_bytes: int = 0
    device_draws: int = 0
    batches: int = 0

    @property
    def nnz_per_second(self) -> float:
        if self.wall_seconds <= 0:
            return 0.0
        return self.nnz * self.iterations / self.wall_seconds


@dataclass
class TopNStats(CallStats):
    """One ``HPF.topN_batch`` call.  ``phases``:

    - ``rows``    the ids' mapping to rows and back, and the seen lists'
      gather when they are masked
    - ``beta``    Beta's device copy, from the model's cache (uploaded
      where the cache misses)
    - ``gather``  a chunk's Theta rows indexed on the host and copied to
      the device (with its seen pairs when masked)
    - ``rank``    K6 and its merge enqueued
    - ``fetch``   the wait for a chunk's answers and their copy back

    Counters: ``users``, ``chunks``, ``bytes_to_device`` (Theta rows, seen
    pairs, and Beta where it was uploaded) and ``bytes_to_host`` (the
    answers).
    """

    ROOT = "hpf.topN_batch"
    COUNTERS = ("users", "chunks", "bytes_to_device", "bytes_to_host")

    users: int = 0
    chunks: int = 0
