"""A fit's triplets sorted into both sides' CSR on the device.

A fit on one card (``HPF._ingest_on_card``) takes this path in place of
``utils.data.process_data`` and the host CSR builds: the host coerces the
input (no copies) and, with ``reindex=True``, filters and factorizes it as
before; then the triplets go up once, in the dtypes they arrive in, and
the card does the rest:

- ``upload_triplets``: the low-count filter as an order-preserving
  compaction (its count read back, so the host warns as before), K15a
  (``narrow_ids``: the ids narrowed to int32 and their least and largest
  values, read back once for the negative-id check and, without a shape,
  the table sizes), the counts cast to the state dtype (``.to`` rounds to
  nearest, as ``np.require`` does);
- ``sort_sides``: a stable sort by user of the input order, then a stable
  sort by item of the user-sorted stream (``torch.sort(..., stable=True)``
  and the payload's gathers): the orders the native counting sort gives
  (``_native.coo_to_csr``), so every row lists its entries in the same
  order; each side's row pointers from its sorted keys by K15b
  (``csr_indptr``), copied back for the host's plan (``ops.ell.plan_ell``).

``ops.ell.pack_ell`` (K15) then fills the full-batch layouts from these
sides, and SVI takes them as its ``EpochSide``s.  K15a and K15b take their
plain versions below for CPU tensors (the CPU tests hold the whole path
to the host's arrays) and count their launches in ``.launches``.

A fit reads both ingests through one interface: ``csr_sides``,
``pack_side`` / ``pack_layouts`` and ``epoch_sides`` take either
``process_data``'s host arrays or ``upload_triplets``' device ones, and
give ``Csr`` sides whose ``seen()`` is the seen-items CSR on the host;
only the O(nnz) passes differ.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from ..utils import data as data_utils
from .ell import _INT32_MAX, _upload, build_ell, build_layouts, pack_ell

_ID_DTYPES = (np.dtype(np.int32), np.dtype(np.int64))
_VALUE_DTYPES = (np.dtype(np.float32), np.dtype(np.float64))


class Csr(NamedTuple):
    """One side's CSR, each row's entries in input order: row pointers on
    the host; the entries on the host (``build_csr``'s arrays), or on the
    device after ``sort_sides``, with int32 row pointers there too.  A
    user side kept only for ``seen()`` drops its ``vals`` (None)."""

    indptr: np.ndarray  # (n_rows + 1,) int64, host
    cols: Union[np.ndarray, torch.Tensor]  # (nnz,) int32, the other side's ids
    vals: Union[np.ndarray, torch.Tensor]  # (nnz,) the state dtype
    indptr_dev: Optional[torch.Tensor] = None  # (n_rows + 1,) int32, on the device

    @property
    def on_device(self) -> bool:
        return self.indptr_dev is not None

    def seen(self):
        """The seen-items CSR on the host, ``(indptr int64, indices
        int32)``: a user side's entries (copied back from the device)."""
        cols = self.cols
        return self.indptr, cols.cpu().numpy() if isinstance(cols, torch.Tensor) else cols


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
                    device) -> Optional[DeviceTriplets]:
    """``process_data``'s ingest with the triplets on ``device``: the same
    filter, checks, warnings, errors, sizes and mappings, and the same
    arrays in input order (not sorted by user; ``sort_sides`` sorts).
    Ids other than int32 / int64 are cast to int64 on the host and counts
    other than float32 / float64 to ``dtype``, as ``process_data`` casts
    them.  None when the input holds more triplets than int32 indexes
    (``process_data`` then takes it)."""
    device = torch.device(device)
    u, i, y, nusers, nitems, forced_no_reindex = data_utils.coerce_triplets(input_df)
    if int(np.shape(y)[0]) > _INT32_MAX:
        return None
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


# ---- one interface over both ingests ------------------------------------

def csr_sides(pdata, items: bool = True):
    """Both sides' CSR of a fit's triplets, ``(user, item)`` ``Csr``s
    (``item`` None unless ``items``): sorted on the device (``sort_sides``,
    which takes the tensors) after ``upload_triplets``, else built on the
    host by ``build_csr`` from ``process_data``'s arrays."""
    if isinstance(pdata, DeviceTriplets):
        return sort_sides(pdata, items)
    u, i, y = pdata.ix_u, pdata.ix_i, pdata.y
    user = Csr(*data_utils.build_csr(u, i, y, pdata.nusers, pdata.nitems))
    item = Csr(*data_utils.build_csr(i, u, y, pdata.nitems, pdata.nusers)) if items else None
    return user, item


def pack_side(csr: Csr, dtype, pad_shards: int = 1):
    """A side's untiled ELL layout from its CSR: K15 on the device
    (``pack_ell``, an ``EllPack``) for a side sorted there, else
    ``build_ell`` on the host (an ``EllLayout``, ``pad_shards`` as there).
    ``ops.ell.ell_to_device`` places either."""
    if csr.on_device:
        return pack_ell(csr.indptr, csr.cols, csr.vals)
    return build_ell(csr.indptr, csr.cols, csr.vals, int(csr.indptr.shape[0]) - 1,
                     dtype=dtype, pad_shards=pad_shards)


def pack_layouts(pdata, dtype, pad_shards: int = 1):
    """A full-batch fit's layouts, ``((user, item) packed sides, user
    Csr)``: on the device both sides' ``csr_sides`` then ``pack_side``,
    keeping the user side for the seen-items CSR; on the host
    ``build_layouts`` (the two sides in two threads, CSR included), which
    keeps none (None)."""
    if not isinstance(pdata, DeviceTriplets):
        return build_layouts(pdata, dtype, pad_shards), None
    user, item = csr_sides(pdata)
    return (pack_side(user, dtype), pack_side(item, dtype)), user


def epoch_sides(user: Optional[Csr], item: Optional[Csr], dtype, device):
    """SVI's ``EpochSide``s of the sides given (None for a side not
    given), and the bytes that took from the host: a side sorted on the
    device is used where it is, a host side is uploaded (``epoch_side``)."""
    from ..utils.profiling import device_bytes
    from .svi import EpochSide, epoch_side

    device = torch.device(device)
    out, sent = [], 0
    for csr in (user, item):
        if csr is None:
            out.append(None)
        elif csr.on_device:
            out.append(EpochSide(y=csr.vals, cols=csr.cols, indptr=csr.indptr_dev,
                                 deg=np.diff(csr.indptr).astype(np.int32)))
        else:
            out.append(epoch_side(csr.indptr, csr.cols, csr.vals, dtype, device))
            sent += device_bytes(device, out[-1])
    return out[0], out[1], sent
