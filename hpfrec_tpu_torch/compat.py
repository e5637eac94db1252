"""Module-level helpers mirroring the reference's ``cython_loops`` Python
API surface (used by its sister package ``ctpfrec``; reference
``hpfrec/cython_loops.pxi:11-42``).  A copy of ``hpfrec_tpu/compat.py``
over the port's own data layer."""

from __future__ import annotations

import numpy as np

c_real_t = np.float32
obj_ind_type = np.int32


def cast_real_t(n):
    """Reference ``cast_real_t`` (``cython_loops.pxi:11``)."""
    return c_real_t(n)


def cast_int(n):
    return int(np.int32(n))


def cast_ind_type(n):
    return int(obj_ind_type(n))


def get_csc_data(ix_u, ix_i, Y, nU, nI):
    """CSC arrays of the (user, item, count) triplets — the item-major
    layout used by item epochs (reference ``cython_loops.pxi:22-25``).
    Returns (indptr, indices, data)."""
    from .utils.data import build_csr

    ix_u = np.asarray(ix_u, dtype=np.int32)
    ix_i = np.asarray(ix_i, dtype=np.int32)
    Y = np.asarray(Y)
    indptr, indices, data = build_csr(ix_i, ix_u, Y, int(nI), int(nU))
    return indptr.astype(obj_ind_type), indices.astype(obj_ind_type), data.astype(c_real_t)


def get_unique_items_batch(users_this_batch, st_ix_u, ix_i, nthreads, return_ix=False):
    """Unique items touched by a user batch (reference
    ``cython_loops.pxi:27-42``): two-pass degree prefix + gather, then
    unique.  ``st_ix_u`` is the (nU+1,) CSR indptr; ``ix_i`` the column
    array."""
    users = np.asarray(users_this_batch, dtype=np.int64)
    st_ix_u = np.asarray(st_ix_u, dtype=np.int64)
    ix_i = np.asarray(ix_i)
    counts = st_ix_u[users + 1] - st_ix_u[users]
    st_pos = np.zeros(len(users) + 1, dtype=np.int64)
    np.cumsum(counts, out=st_pos[1:])
    from .utils.data import gather_batch_nonzeros

    _, _, cols = gather_batch_nonzeros(
        st_ix_u, ix_i, np.zeros(ix_i.shape[0], dtype=np.float32), users)
    items = np.unique(cols)
    if return_ix:
        return items, st_pos
    return items
