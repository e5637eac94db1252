"""The data-parallel "mesh" of the port: one process per device.

Port of ``hpfrec_tpu/parallel/mesh.py``.  JAX drives every local device
from one process, so its 1-D ``Mesh`` is a list of devices and
``mesh=None`` means all of them.  PyTorch drives one device from one
process: a :class:`Mesh` is this process's rank in a ``torch.distributed``
process group, its device, and the group's size.  ``mesh=None`` in
``HPF`` stays one device (there is no ``default_mesh``).

Data parallelism as in the JAX package: the factor tables are replicated
on every rank, the nonzeros are split over the ranks, and each rank's
partial sums meet in a collective (``parallel/engine.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch


@dataclass(frozen=True)
class Mesh:
    """One rank of a data-parallel group.

    group : the ``torch.distributed`` process group (None: the default
        group of ``init_process_group``)
    world_size, rank : the group's size and this process's rank in it
    device : the ``torch.device`` this rank computes on
    """

    group: Optional[Any]
    world_size: int
    rank: int
    device: torch.device

    @property
    def backend(self) -> str:
        import torch.distributed as dist

        return str(dist.get_backend(self.group))


def make_mesh(group=None, device=None) -> Mesh:
    """The mesh of this process in ``group`` (None: the default group),
    computing on ``device``: without it, the current CUDA device, whatever
    the backend (a rank runs on the CPU only where the caller names
    ``device="cpu"``, and with no CUDA this raises).  Needs
    ``torch.distributed`` to be initialized (``distributed.initialize``)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialized torch.distributed process group; "
            "call hpfrec_tpu_torch.parallel.distributed.initialize() first")
    backend = str(dist.get_backend(group))
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh on %s but CUDA is not available; pass "
                               "device='cpu' for a CPU mesh" % device)
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("an NCCL group computes on a CUDA device, not %s" % device)
    return Mesh(group=group, world_size=dist.get_world_size(group),
                rank=dist.get_rank(group), device=device)
