"""A fit's triplets sorted into both sides' CSR on its device.

Every fit takes this path, on a card or on the CPU (K15a and K15b take
their plain versions below for CPU tensors): the host coerces the input
(no copies) and, with ``reindex=True``, filters and factorizes it as
``utils.data.process_data`` does; then the triplets go up once, in the
dtypes they arrive in, and the device does the rest:

- ``upload_triplets``: the low-count filter as an order-preserving
  compaction (its count read back, so the host warns as ``process_data``
  does), K15a (``narrow_ids``: the ids narrowed to int32 and their least
  and largest values, read back once for the negative-id check and,
  without a shape, the table sizes), the counts cast to the state dtype
  (``.to`` rounds to nearest, as ``np.require`` does);
- ``sort_sides``: a stable sort by user of the input order, then a stable
  sort by item of the user-sorted stream (``torch.sort(..., stable=True)``
  and the payload's gathers): the orders the native counting sort gives
  (``_native.coo_to_csr``), so every row lists its entries in the same
  order as ``build_csr``'s; each side's row pointers from its sorted keys
  by K15b (``csr_indptr``), copied back for the host's plan
  (``ops.ell.plan_ell``).

Each engine builds what it needs from the two ``Csr`` sides: the ELL
engine its layouts (``ops.ell.pack_ell``, K15, then ``device_ell``; a
rank's slice of every bucket on a mesh), the blocked-COO engine its
stream from the user side (``ops.cavi.coo_stream``), SVI its
``EpochSide``s (``Csr.epoch_side``), the table-sharded engine its own
host packer from ``Csr.to_host``; the seen-items CSR is the user side's
``Csr.seen``.  K15a and K15b count their launches in ``.launches``.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils import data as data_utils
from .ell import _INT32_MAX, _upload
from .staging import to_host

_ID_DTYPES = (np.dtype(np.int32), np.dtype(np.int64))
_VALUE_DTYPES = (np.dtype(np.float32), np.dtype(np.float64))


class Csr(NamedTuple):
    """One side's CSR on the fit's device, each row's entries in the order
    of the stream it was sorted from: row pointers on the host and on the
    device.  A user side kept only for ``seen()`` drops its ``vals``
    (None)."""

    indptr: np.ndarray  # (n_rows + 1,) int64, host
    cols: torch.Tensor  # (nnz,) int32, the other side's ids
    vals: Optional[torch.Tensor]  # (nnz,) the state dtype
    indptr_dev: torch.Tensor  # (n_rows + 1,) int32

    def seen(self, ready=None):
        """The seen-items CSR on the host, ``(indptr int64, indices
        int32)``: a user side's entries copied back (``staging.to_host``,
        into an array of ``ready`` where it holds one)."""
        return self.indptr, to_host([self.cols], ready)[0]

    def to_host(self) -> "Csr":
        """This side with its entries copied to the host (CPU tensors)."""
        return self._replace(cols=self.cols.cpu(),
                             vals=None if self.vals is None else self.vals.cpu())

    def row_ids(self, r0: int = 0, r1: Optional[int] = None):
        """The row of every entry of rows ``[r0, r1)`` (int32, where the
        entries are)."""
        r1 = self.indptr.shape[0] - 1 if r1 is None else r1
        rows = torch.arange(r0, r1, dtype=torch.int32, device=self.cols.device)
        return torch.repeat_interleave(rows, torch.diff(self.indptr_dev[r0:r1 + 1]),
                                       output_size=int(self.indptr[r1] - self.indptr[r0]))

    def epoch_side(self):
        """SVI's ``EpochSide`` of this side, where it is."""
        from .svi import EpochSide

        return EpochSide(y=self.vals, cols=self.cols, indptr=self.indptr_dev,
                         deg=np.diff(self.indptr).astype(np.int32))


class DeviceTriplets:
    """The filtered triplets on the device in input order, as
    ``upload_triplets`` leaves them (``ix_u`` / ``ix_i`` int32, ``y`` in the
    state dtype), with what ``process_data`` gives besides: the table sizes
    and the id mappings.  ``sort_sides`` takes the tensors."""

    def __init__(self, y, ix_u, ix_i, nusers, nitems, user_mapping, item_mapping,
                 bytes_to_device):
        self.y, self.ix_u, self.ix_i = y, ix_u, ix_i
        self.nnz = int(y.shape[0])
        self.nusers, self.nitems = int(nusers), int(nitems)
        self.user_mapping, self.item_mapping = user_mapping, item_mapping
        self.bytes_to_device = int(bytes_to_device)


# ---- K15a: ids narrowed, their least and largest --------------------------

def _narrow_ids_plain(ids):
    wide = ids.to(torch.int64)
    return wide.to(torch.int32), torch.stack([wide.min(), wide.max()])


def narrow_ids(ids):
    """K15a: ``(ids as int32, (min, max) as an int64 (2,) tensor)`` of a
    non-empty int32 or int64 id tensor (int32 ids come back as they are).
    One launch for CUDA tensors (counted in ``.launches``); the plain
    version for CPU tensors."""
    if not ids.is_cuda:
        return _narrow_ids_plain(ids)
    from .. import _cuda

    _cuda.check(ids, dtype=ids.dtype)
    if ids.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"narrow_ids: int32 or int64 ids, not {ids.dtype}")
    same = ids.dtype == torch.int32
    out = ids if same else torch.empty(ids.shape, dtype=torch.int32, device=ids.device)
    minmax = torch.empty(2, dtype=torch.int64, device=ids.device)
    _cuda.launch("ids_narrow_i32" if same else "ids_narrow_i64", None, None, ids,
                 ids.numel(), None if same else out, minmax)
    narrow_ids.launches += 1
    return out, minmax


narrow_ids.launches = 0


# ---- K15b: a sorted side's row pointers ---------------------------------

def _csr_indptr_plain(keys, n_rows: int):
    rows = torch.arange(n_rows + 1, dtype=torch.int32, device=keys.device)
    return torch.searchsorted(keys, rows).to(torch.int32)


def csr_indptr(keys, n_rows: int):
    """K15b: the ``(n_rows + 1,)`` int32 row pointers of sorted int32
    ``keys`` in ``[0, n_rows)``: ``indptr[r]`` is the first position whose
    key is ``r`` or more.  One launch for CUDA tensors (counted in
    ``.launches``); the plain version for CPU tensors."""
    if not keys.is_cuda:
        return _csr_indptr_plain(keys, n_rows)
    from .. import _cuda

    _cuda.check(keys, dtype=torch.int32)
    indptr = torch.empty(n_rows + 1, dtype=torch.int32, device=keys.device)
    _cuda.launch("csr_indptr", None, None, keys, keys.numel(), int(n_rows), indptr)
    csr_indptr.launches += 1
    return indptr


csr_indptr.launches = 0


# ---- the path -------------------------------------------------------------

def _host_array(a, dtypes, cast):
    """``a`` as a native-order ndarray of one of ``dtypes`` (as it is where
    it already is one), else ``a.astype(cast)``: what goes up."""
    a = np.asarray(a)
    if a.dtype in dtypes:
        return a
    return a.astype(cast)


def _to_device(a: np.ndarray, device):
    with warnings.catch_warnings():
        # a read-only input is only read
        warnings.simplefilter("ignore", UserWarning)
        t = _upload(a, a.dtype, device)
    return t if device.type == "cuda" else t.clone()


def upload_triplets(input_df, stop_crit: str, reindex: bool, dtype,
                    device) -> DeviceTriplets:
    """``process_data``'s ingest with the triplets on ``device``: the same
    filter, checks, warnings, errors, sizes and mappings, and the same
    arrays in input order (not sorted by user; ``sort_sides`` sorts).
    Ids other than int32 / int64 are cast to int64 on the host and counts
    other than float32 / float64 to ``dtype``, as ``process_data`` casts
    them.  Raises ``ValueError`` for more triplets than int32 indexes."""
    device = torch.device(device)
    u, i, y, nusers, nitems, forced_no_reindex = data_utils.coerce_triplets(input_df)
    if int(np.shape(y)[0]) > _INT32_MAX:
        raise ValueError("too many nonzeros for int32 indexing: %d" % int(np.shape(y)[0]))
    if forced_no_reindex:
        reindex = False
    tdt = torch.float64 if np.dtype(dtype) == np.float64 else torch.float32
    user_mapping = item_mapping = None
    if reindex:
        u, i, y = data_utils.filter_low_counts(u, i, y, stop_crit)
        if y.shape[0] == 0:
            raise ValueError("Input data has no valid observations.")
        codes_u, codes_i, user_mapping, item_mapping = data_utils.reindex_ids(u, i)
        nusers, nitems = int(user_mapping.shape[0]), int(item_mapping.shape[0])
        up = [_to_device(np.ascontiguousarray(codes_u), device),
              _to_device(np.ascontiguousarray(codes_i), device),
              _to_device(_host_array(y, _VALUE_DTYPES, dtype), device)]
        ix_u, ix_i, yt = up
    else:
        up = [_to_device(_host_array(u, _ID_DTYPES, np.int64), device),
              _to_device(_host_array(i, _ID_DTYPES, np.int64), device),
              _to_device(_host_array(y, _VALUE_DTYPES, dtype), device)]
        ut, it, yt = up
        keep = torch.nonzero(~(yt <= data_utils.low_count_threshold(stop_crit))).squeeze(1)
        n_keep = int(keep.shape[0])
        if n_keep < yt.shape[0]:
            data_utils.warn_low_counts()
            ut, it, yt = ut[keep], it[keep], yt[keep]
        del keep
        if n_keep == 0:
            raise ValueError("Input data has no valid observations.")
        ix_u, mm_u = narrow_ids(ut)
        ix_i, mm_i = narrow_ids(it)
        del ut, it
        lo_u, hi_u, lo_i, hi_i = torch.cat([mm_u, mm_i]).tolist()
        if lo_u < 0 or lo_i < 0:
            raise ValueError("With reindex=False, all IDs must be non-negative integers.")
        if nusers is None:
            nusers = hi_u + 1
        if nitems is None:
            nitems = hi_i + 1
    sent = sum(t.numel() * t.element_size() for t in up)
    del up
    return DeviceTriplets(yt.to(tdt), ix_u, ix_i, nusers, nitems, user_mapping, item_mapping,
                          sent)


def sort_sides(trip: DeviceTriplets, items: bool = True):
    """Both sides' CSR from the device triplets, which it takes from
    ``trip``: ``(user, item)`` ``Csr``s on the device (``item`` None unless
    ``items``).  Every row's entries keep their order in the stream it was
    sorted from: a user's in input order, an item's in user order."""
    u, i, y = trip.ix_u, trip.ix_i, trip.y
    trip.ix_u = trip.ix_i = trip.y = None
    su, order = torch.sort(u, stable=True)
    del u
    u_cols, u_vals = i[order], y[order]
    del i, y, order
    ptrs = [csr_indptr(su, trip.nusers)]
    sides = [(u_cols, u_vals)]
    if items:
        si, order = torch.sort(u_cols, stable=True)
        sides.append((su[order], u_vals[order]))
        del order
        ptrs.append(csr_indptr(si, trip.nitems))
        del si
    del su
    host = torch.cat(ptrs).cpu().numpy().astype(np.int64)
    user = Csr(host[:trip.nusers + 1], *sides[0], ptrs[0])
    if not items:
        return user, None
    return user, Csr(host[trip.nusers + 1:], *sides[1], ptrs[1])
