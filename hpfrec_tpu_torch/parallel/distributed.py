"""Process-group set-up for data-parallel fits (one process per device).

Port of ``hpfrec_tpu/parallel/distributed.py`` over
``torch.distributed.init_process_group``.  Usage, the same script in every
process::

    from hpfrec_tpu_torch.parallel import distributed
    mesh = distributed.initialize()      # under torchrun: its environment
    model = HPF(k=30, mesh=mesh)
    model.fit(counts_df)                 # the same data in every process

or with explicit arguments, as JAX's ``jax.distributed.initialize`` takes
them: ``initialize("10.0.0.1:29500", num_processes=8, process_id=rank)``.

The device is a CUDA card unless the caller names ``device="cpu"``; the
backend is NCCL for a CUDA device and gloo for the CPU.  gloo on a CUDA
device (two ranks on one card, which NCCL refuses) runs only when the
caller names ``backend="gloo"``; nothing falls back from NCCL to gloo, or
from the card to the CPU.

A group that ``initialize`` creates is destroyed at interpreter exit (an
``atexit`` handler), unless the caller destroyed it first: a gloo group
whose threads outlive the interpreter's teardown can abort the process.
A group the caller created is left to the caller.
"""

from __future__ import annotations

import atexit
import datetime
import os
import warnings
from typing import Optional

import torch

from .mesh import Mesh, make_mesh

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def _device_and_backend(device, backend, local_rank):
    """The rank's device and the backend for it.  Without ``device``, CUDA
    device ``local_rank`` (modulo the card count), whatever the backend: a
    CPU rank runs only where the caller names ``device="cpu"``, and with no
    CUDA this raises.  Without ``backend``, NCCL for a CUDA device and gloo
    for the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a data-parallel rank on %s but CUDA is not available; pass "
                               "device='cpu' for a CPU mesh (gloo)" % device)
        if device.index is None:
            device = torch.device("cuda", local_rank % torch.cuda.device_count())
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError("backend must be 'nccl' or 'gloo', got %r" % (backend,))
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the NCCL backend needs a CUDA device, got %s" % device)
    return device, backend


def _destroy_at_exit(group):
    """Exit handler of a group that :func:`initialize` created: destroy it
    if it is still the default group (a no-op once the caller destroyed
    it, or replaced it by a group of its own)."""
    import torch.distributed as dist

    if dist.is_initialized() and dist.group.WORLD is group:
        dist.destroy_process_group()


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               initialization_timeout: Optional[int] = None, *,
               backend: Optional[str] = None, device=None) -> Mesh:
    """Initialize ``torch.distributed`` (a no-op if it already is) and
    return this process's :class:`Mesh`.

    With no coordinator and no process count, torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``,
    ``LOCAL_RANK``) sets up the group; without that environment the
    process continues alone, in a group of one, and says so at warning
    level.  With explicit arguments a misconfigured job fails here: an
    initialization error raises ``RuntimeError``, and so does a group whose
    size is not ``num_processes``.  The rank computes on a CUDA device
    (``LOCAL_RANK`` or ``process_id`` picks the card) and raises without
    one, unless ``device="cpu"`` is named.  ``coordinator_address`` is
    ``host:port`` (a TCP rendezvous, as JAX's) or a ``torch.distributed``
    init URL (``tcp://...``, ``file://...``); ``initialization_timeout`` is
    in seconds.  A group created here is destroyed at exit unless the
    caller destroys it first."""
    import torch.distributed as dist

    env = os.environ
    local_rank = int(env.get("LOCAL_RANK", process_id or 0))
    device, backend = _device_and_backend(device, backend, local_rank)
    if not dist.is_initialized():
        kwargs = {}
        if initialization_timeout is not None:
            kwargs["timeout"] = datetime.timedelta(seconds=initialization_timeout)
        if num_processes is None and coordinator_address is None:
            if all(name in env for name in _TORCHRUN_ENV):
                kwargs["init_method"] = "env://"
                what = "the torchrun environment"
            else:
                warnings.warn(
                    "no torchrun environment (%s); continuing single-process. "
                    "Pass coordinator_address/num_processes/process_id explicitly "
                    "for a multi-process job." % ", ".join(_TORCHRUN_ENV))
                kwargs.update(store=dist.HashStore(), world_size=1, rank=0)
                what = "a single process"
        else:
            if coordinator_address is None:
                kwargs["init_method"] = "env://"
            elif "://" in coordinator_address:
                kwargs["init_method"] = coordinator_address
            else:
                kwargs["init_method"] = "tcp://" + coordinator_address
            if num_processes is not None:
                kwargs["world_size"] = num_processes
            if process_id is not None:
                kwargs["rank"] = process_id
            what = "coordinator %r (num_processes=%s, process_id=%s)" % (
                coordinator_address, num_processes, process_id)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        try:
            dist.init_process_group(backend, **kwargs)
        except Exception as e:
            raise RuntimeError("torch.distributed.init_process_group failed for %s: %s"
                               % (what, e)) from e
        atexit.register(_destroy_at_exit, dist.group.WORLD)
    if num_processes is not None and dist.get_world_size() != num_processes:
        raise RuntimeError(
            "torch.distributed came up with %d processes but %d were requested — "
            "refusing to train on a partial mesh." % (dist.get_world_size(), num_processes))
    mesh = make_mesh(device=device)
    from .engine import barrier

    barrier(mesh)  # the backend's communicator comes up here, not in a fit's first exchange
    return mesh
