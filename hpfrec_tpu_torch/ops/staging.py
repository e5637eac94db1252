"""A fit's large results brought back to the host: ``to_host``.

Every array a fit hands back (Theta and Beta, the state, the seen-items
CSR) crosses through this one function, which returns fresh arrays that
numpy owns (never a view of a buffer below), so that the model can turn
their write flag off and on and a caller can keep them after the model is
gone.

The path follows the tensor's device:

- a CUDA tensor crosses in chunks through a small ring of pinned host
  buffers, kept for the life of the process: a copy stream waits on the
  current stream (so no copy overtakes the kernels that wrote the tensor),
  then each chunk goes ``non_blocking`` into the next free buffer with an
  event after it; the host waits on chunk i's event and copies it into the
  destination with the native helpers' threaded byte copy while chunks
  i+1... still cross the link.  A buffer takes a new chunk only after the
  host has copied it out.
- a CPU tensor is copied into the destination straight from its own
  memory, in the same chunks by the same threaded copy.

Fresh host memory is slow to fill the first time: every page faults.
``HostArrays`` allocates the destinations ahead and touches their pages on
a thread of its own, which a fit starts before its loop so that the faults
are taken while the card iterates; ``to_host`` fills those arrays where
they match a tensor's shape and dtype, and allocates the others.

Without the native helpers a chunk is filled by ``np.copyto``: the same
bits.  ``to_host.staged_bytes`` counts the bytes that crossed the ring.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

# a chunk of a tensor, and the ring's buffers: RING buffers of CHUNK_BYTES
# each (64 MiB of pinned memory in all)
CHUNK_BYTES = 16 << 20
RING = 4
# the threaded copy's block: a thread takes this many bytes at a time
_BLOCK = 1 << 21


class _Ring:
    """The pinned buffers (and their numpy views), and a device's copy
    stream and an event a buffer."""

    def __init__(self):
        self.bufs = [torch.empty(CHUNK_BYTES, dtype=torch.uint8, pin_memory=True)
                     for _ in range(RING)]
        self.host = [b.numpy() for b in self.bufs]
        self._per_device = {}

    def on(self, device):
        """``(stream, events)`` of ``device``."""
        if device not in self._per_device:
            self._per_device[device] = (torch.cuda.Stream(device=device),
                                        [torch.cuda.Event() for _ in self.bufs])
        return self._per_device[device]


_ring = None
_lock = threading.Lock()


def _fill(dst: np.ndarray, src: np.ndarray) -> None:
    from .. import _native

    if _native.available():
        _native.copy_bytes(dst, src, _BLOCK)
    else:
        np.copyto(dst, src)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's bytes, flat."""
    return t.reshape(-1).view(torch.uint8)


class HostArrays:
    """Fresh host arrays of the given ``(shape, dtype)`` pairs, allocated
    and their pages touched on a thread of their own, for ``to_host`` to
    fill."""

    def __init__(self, specs):
        self._made = {}
        self._thread = threading.Thread(target=self._make, args=(list(specs),), daemon=True)
        self._thread.start()

    def _make(self, specs):
        from .. import _native

        for shape, dtype in specs:
            a = np.empty(shape, dtype=dtype)
            flat = a.reshape(-1).view(np.uint8)
            if _native.available():
                _native.touch_pages(flat)
            else:
                flat[::4096] = 0
            self._made.setdefault((tuple(shape), np.dtype(dtype)), []).append(a)

    def take(self, shape, dtype):
        """One of the arrays of this shape and dtype (after the thread has
        made them all), or None where none is left."""
        self._thread.join()
        left = self._made.get((tuple(shape), np.dtype(dtype)))
        return left.pop() if left else None


def to_host(tensors, ready: Optional[HostArrays] = None,
            _chunk_bytes: int = CHUNK_BYTES) -> list:
    """Fresh numpy arrays, each owning its memory, equal to the tensors
    bit for bit (``t.cpu().numpy()``), in their order: taken from
    ``ready`` where it holds one of a tensor's shape and dtype, else
    allocated.  ``_chunk_bytes`` (at most ``CHUNK_BYTES``) cuts a tensor
    into pieces; the tests set it small."""
    global _ring
    if not 0 < _chunk_bytes <= CHUNK_BYTES:
        raise ValueError("to_host: a chunk of 1 to %d bytes" % CHUNK_BYTES)
    tensors = [t.contiguous() for t in tensors]
    outs = []
    for t in tensors:
        dtype = torch.empty((), dtype=t.dtype).numpy().dtype
        out = None if ready is None else ready.take(tuple(t.shape), dtype)
        outs.append(np.empty(tuple(t.shape), dtype=dtype) if out is None else out)
    staged = []
    for t, out in zip(tensors, outs):
        dst = out.reshape(-1).view(np.uint8)
        if t.is_cuda:
            staged += [(t, dst, o, min(_chunk_bytes, dst.shape[0] - o))
                       for o in range(0, dst.shape[0], _chunk_bytes)]
            continue
        src = _bytes(t).numpy()
        for o in range(0, dst.shape[0], _chunk_bytes):
            _fill(dst[o:o + _chunk_bytes], src[o:o + _chunk_bytes])
    if not staged:
        return outs
    with _lock:
        if _ring is None:
            _ring = _Ring()
        ring = _ring
        copiers = {}
        for t, *_ in staged:
            if t.device not in copiers:
                copiers[t.device] = ring.on(t.device)
                copiers[t.device][0].wait_stream(torch.cuda.current_stream(t.device))
        inflight = []
        try:
            for j, (t, dst, o, n) in enumerate(staged):
                b = j % len(ring.bufs)
                if len(inflight) == len(ring.bufs):
                    _copy_out(ring.host, *inflight.pop(0))
                stream, events = copiers[t.device]
                with torch.cuda.stream(stream):
                    ring.bufs[b][:n].copy_(_bytes(t)[o:o + n], non_blocking=True)
                    events[b].record()
                inflight.append((events[b], b, dst, o, n))
            while inflight:
                _copy_out(ring.host, *inflight.pop(0))
        finally:
            # no copy may outlive the call: its source could be freed, its
            # buffer reused
            for stream, _ in copiers.values():
                stream.synchronize()
        to_host.staged_bytes += sum(n for *_, n in staged)
    return outs


to_host.staged_bytes = 0


def _copy_out(host, event, b: int, dst: np.ndarray, o: int, n: int) -> None:
    event.synchronize()
    _fill(dst[o:o + n], host[b][:n])
