"""Data-parallel fits over ``torch.distributed``, one process per device:
``distributed.initialize`` sets up the process group and returns this
rank's :class:`Mesh`; ``HPF(mesh=...)`` fits on it (``engine``)."""

from .mesh import Mesh, make_mesh  # noqa: F401
