"""Host-side data layer: ingestion, filtering, reindexing, CSR, the
validation set and the blocked COO stream.

A jax-free copy of ``hpfrec_tpu/utils/data.py`` (reference
``hpfrec/__init__.py:434-633``).  pandas is optional here: DataFrame input
needs it, ndarray and scipy ``coo_array`` input do not, and reindexing and
id mapping have numpy and native fallbacks.  The O(nnz) passes use the
native helpers in ``_native`` when they built, numpy/scipy otherwise.
``gather_batch_nonzeros`` serves ``compat.get_unique_items_batch``;
``hyperparams_txt`` the ``save_folder`` export.
"""

from __future__ import annotations

import os
import warnings
from typing import NamedTuple, Optional

import numpy as np


class ProcessedData(NamedTuple):
    """Flat, filtered, reindexed COO triplets (host numpy, user-sorted
    whenever ``sorted_by_user``)."""

    y: np.ndarray  # (nnz,) real dtype
    ix_u: np.ndarray  # (nnz,) int32
    ix_i: np.ndarray  # (nnz,) int32
    nusers: int
    nitems: int
    user_mapping: Optional[np.ndarray]
    item_mapping: Optional[np.ndarray]
    sorted_by_user: bool

    @property
    def nnz(self) -> int:
        return int(self.y.shape[0])


def _pandas():
    try:
        import pandas as pd
    except ImportError:
        return None
    return pd


def coerce_triplets(input_df):
    """Accept a pandas DataFrame with UserId/ItemId/Count columns, an
    (n, >=3) ndarray, or a scipy COO array.  Returns (u, i, y, nusers,
    nitems, forced_no_reindex); nusers/nitems are None unless the input
    dictates them."""
    from scipy.sparse import issparse

    if isinstance(input_df, np.ndarray):
        assert len(input_df.shape) > 1
        assert input_df.shape[1] >= 3
        return (np.asarray(input_df[:, 0]), np.asarray(input_df[:, 1]),
                np.asarray(input_df[:, 2]), None, None, False)
    if issparse(input_df) and input_df.format == "coo":
        nusers, nitems = input_df.shape
        return (np.asarray(input_df.row), np.asarray(input_df.col),
                np.asarray(input_df.data), int(nusers), int(nitems), True)
    pd = _pandas()
    if pd is not None and isinstance(input_df, pd.DataFrame):
        assert input_df.shape[0] > 0
        for col in ("UserId", "ItemId", "Count"):
            assert col in input_df.columns, f"'{col}' column missing"
        return (input_df["UserId"].to_numpy(), input_df["ItemId"].to_numpy(),
                input_df["Count"].to_numpy(), None, None, False)
    raise ValueError(
        "'input_df' must be a pandas data frame, numpy array, or scipy sparse coo_array.")


def low_count_threshold(stop_crit: str):
    """Counts at or below this are dropped: 0 for maxiter/diff-norm, 0.9 for
    likelihood criteria (reference ``hpfrec/__init__.py:462-475``)."""
    return 0 if stop_crit in ("maxiter", "diff-norm") else 0.9


def warn_low_counts(what: str = "counts_df"):
    warnings.warn(
        f"'{what}' contains observations with a count value less than 1, "
        "these will be ignored.")


def filter_low_counts(u, i, y, stop_crit: str, what: str = "counts_df"):
    """Drop observations with Count <= ``low_count_threshold(stop_crit)``."""
    low = y <= low_count_threshold(stop_crit)
    if int(low.sum()) > 0:
        warn_low_counts(what)
        keep = ~low
        u, i, y = u[keep], i[keep], y[keep]
    return u, i, y


def _factorize(values):
    """First-occurrence-order factorize: ``pd.factorize`` when pandas is
    installed, the native ``factorize_i64`` (integer ids) otherwise."""
    values = np.asarray(values)
    pd = _pandas()
    if pd is not None:
        return pd.factorize(values)
    return _factorize_native(values)


def _factorize_native(values):
    from .._native import factorize_i64

    if not np.issubdtype(values.dtype, np.integer):
        raise TypeError("reindexing non-integer ids needs pandas")
    codes, uniques = factorize_i64(values.astype(np.int64, copy=False))
    return codes, uniques.astype(values.dtype, copy=False)


def reindex_ids(u, i):
    """Factorize-based reindex (reference ``hpfrec/__init__.py:477-483``).
    Returns (codes_u, codes_i, user_mapping, item_mapping)."""
    codes_u, user_mapping = _factorize(u)
    codes_i, item_mapping = _factorize(i)
    user_mapping = np.require(user_mapping, requirements=["ENSUREARRAY"]).reshape(-1)
    item_mapping = np.require(item_mapping, requirements=["ENSUREARRAY"]).reshape(-1)
    return (codes_u.astype(np.int32, copy=False),
            codes_i.astype(np.int32, copy=False), user_mapping, item_mapping)


def map_to_training_ids(values, mapping):
    """Map raw IDs to training row indices; unknown -> -1 (reference uses
    ``pd.Categorical(...).codes``, ``hpfrec/__init__.py:561-562``)."""
    pd = _pandas()
    if pd is None:
        return _map_numpy(values, mapping)
    codes = pd.Index(mapping).get_indexer(np.asarray(values))
    return np.require(codes, requirements=["ENSUREARRAY"]).astype(np.int64, copy=False)


def _map_numpy(values, mapping):
    """``map_to_training_ids`` without pandas: binary search in the sorted
    (unique, non-empty) mapping."""
    values = np.asarray(values).reshape(-1)
    order = np.argsort(mapping, kind="stable")
    srt = np.asarray(mapping)[order]
    pos = np.clip(np.searchsorted(srt, values), 0, len(srt) - 1)
    return np.where(srt[pos] == values, order[pos], -1).astype(np.int64)


def process_data(input_df, stop_crit: str, reindex: bool, dtype=np.float32,
                 sort_by_user: bool = True) -> ProcessedData:
    """Full training-data pipeline (reference ``_process_data``,
    ``hpfrec/__init__.py:434-523``).  No fit calls it: a fit ingests
    through ``ops.ingest.upload_triplets``, which the tests hold to it."""
    u, i, y, nusers, nitems, forced_no_reindex = coerce_triplets(input_df)
    if forced_no_reindex:
        reindex = False
    u, i, y = filter_low_counts(u, i, y, stop_crit)
    if y.shape[0] == 0:
        raise ValueError("Input data has no valid observations.")

    user_mapping = item_mapping = None
    if reindex:
        ix_u, ix_i, user_mapping, item_mapping = reindex_ids(u, i)
        nusers = int(user_mapping.shape[0])
        nitems = int(item_mapping.shape[0])
    else:
        ix_u = np.asarray(u).astype(np.int64, copy=False)
        ix_i = np.asarray(i).astype(np.int64, copy=False)
        if ix_u.shape[0] and (ix_u.min() < 0 or ix_i.min() < 0):
            raise ValueError("With reindex=False, all IDs must be non-negative integers.")
        if nusers is None:
            nusers = int(ix_u.max()) + 1
        if nitems is None:
            nitems = int(ix_i.max()) + 1

    ix_u = ix_u.astype(np.int32, copy=False)
    ix_i = ix_i.astype(np.int32, copy=False)
    y = np.require(y, dtype=dtype, requirements=["C_CONTIGUOUS"])

    if sort_by_user:
        from .. import _native

        if _native.available():
            # O(nnz) counting sort through the native CSR builder
            indptr, ix_i, y = _native.coo_to_csr(ix_u, ix_i, y, nusers)
            ix_u = np.repeat(np.arange(nusers, dtype=np.int32),
                             np.diff(indptr).astype(np.int64))
        else:
            order = np.argsort(ix_u, kind="stable")
            ix_u = np.ascontiguousarray(ix_u[order])
            ix_i = np.ascontiguousarray(ix_i[order])
            y = np.ascontiguousarray(y[order])

    return ProcessedData(y=y, ix_u=ix_u, ix_i=ix_i, nusers=nusers,
                         nitems=nitems, user_mapping=user_mapping,
                         item_mapping=item_mapping,
                         sorted_by_user=bool(sort_by_user))


def process_valset(val_set, stop_crit: str, reindex: bool, user_mapping,
                   item_mapping, nusers: int, nitems: int, dtype=np.float32,
                   is_valset: bool = True):
    """Validation / eval-set pipeline (reference ``_process_valset``,
    ``hpfrec/__init__.py:525-585``).  Returns (y, ix_u, ix_i) or None when a
    validation set ends up empty (with the criterion-switch warning)."""
    from scipy.sparse import issparse

    if isinstance(val_set, np.ndarray):
        assert len(val_set.shape) > 1
        assert val_set.shape[1] >= 3
        u, i, y = val_set[:, 0], val_set[:, 1], val_set[:, 2]
    elif issparse(val_set) and val_set.format == "coo":
        assert val_set.shape[0] <= nusers
        assert val_set.shape[1] <= nitems
        u, i, y = val_set.row, val_set.col, val_set.data
    elif _pandas() is not None and isinstance(val_set, _pandas().DataFrame):
        assert val_set.shape[0] > 0
        for col in ("UserId", "ItemId", "Count"):
            assert col in val_set.columns
        u = val_set["UserId"].to_numpy()
        i = val_set["ItemId"].to_numpy()
        y = val_set["Count"].to_numpy()
    else:
        raise ValueError(
            "'val_set' must be a pandas data frame, numpy array, or sparse coo_array.")

    thr = 0 if stop_crit == "val-llk" else 0.9
    low = np.asarray(y) <= thr
    if low.sum() > 0:
        warnings.warn(
            "'val_set' contains observations with a count value less than 1, "
            "these will be ignored.")
        keep = ~low
        u, i, y = np.asarray(u)[keep], np.asarray(i)[keep], np.asarray(y)[keep]

    if reindex:
        cu = map_to_training_ids(u, user_mapping)
        ci = map_to_training_ids(i, item_mapping)
        keep = (cu != -1) & (ci != -1)
        cu, ci, y = cu[keep], ci[keep], np.asarray(y)[keep]
        if cu.shape[0] == 0:
            if is_valset:
                warnings.warn(
                    "Validation set has no combinations of users and items in common "
                    "with training set. If 'stop_crit' was set to 'val-llk', will now "
                    "be switched to 'train-llk'.")
                return None
            raise ValueError(
                "'input_df' has no combinations of users and items in common with "
                "the training set.")
    else:
        cu = np.asarray(u).astype(np.int64, copy=False)
        ci = np.asarray(i).astype(np.int64, copy=False)

    return (np.require(y, dtype=dtype, requirements=["C_CONTIGUOUS"]),
            cu.astype(np.int32, copy=False), ci.astype(np.int32, copy=False))


class BlockedHost(NamedTuple):
    """Blocked (nblocks, B) numpy layout ready for device placement."""

    y: np.ndarray
    ix_u: np.ndarray
    ix_i: np.ndarray
    nnz: int  # number of real (non-padding) entries


def _next_multiple(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _next_pow2(x: int) -> int:
    return 1 << max(0, int(x - 1).bit_length())


def block_shape(nnz: int, block_size: Optional[int] = None, n_shards: int = 1,
                min_align: int = 8):
    """``(B, nblocks)`` of ``block_coo``'s stream of ``nnz`` triplets."""
    if block_size is None:
        block_size = min(_next_multiple(nnz, min_align), 1 << 18)
    B = int(block_size)
    return B, _next_multiple(max(1, -(-nnz // B)), n_shards)


def block_coo(y: np.ndarray, ix_u: np.ndarray, ix_i: np.ndarray,
              block_size: Optional[int] = None, n_shards: int = 1,
              min_align: int = 8) -> BlockedHost:
    """Pad the COO stream and reshape to (nblocks, B), as
    ``hpfrec_tpu.utils.data.block_coo``.  Padding rows have y=0 (inert in
    every metric) and index 0 (in-bounds); ``nblocks`` is a multiple of
    ``n_shards``.  No fit calls it (``ops.cavi.blocked_stream`` blocks a
    fit's streams)."""
    nnz = int(y.shape[0])
    B, nblocks = block_shape(nnz, block_size, n_shards, min_align)
    total = nblocks * B

    def _pad(a):
        out = np.zeros(total, dtype=a.dtype)
        out[:nnz] = a
        return out.reshape(nblocks, B)

    return BlockedHost(y=_pad(y), ix_u=_pad(ix_u), ix_i=_pad(ix_i), nnz=nnz)


def share(bounds: np.ndarray, n_ranks: int, rank: int):
    """The runs ``[i0, i1)`` of rank ``rank`` when the runs with offsets
    ``bounds`` (non-decreasing, (n_runs + 1,)) are split at run boundaries
    into ``n_ranks`` near-equal shares of positions: share j ends at the
    first boundary at or after ``bounds[0] + total * (j + 1) / n_ranks``.
    A data-parallel fit cuts the user-sorted stream (``ops.cavi.coo_stream``)
    and each SVI batch (``ops.svi``) so."""
    bounds = np.asarray(bounds, dtype=np.int64)
    total = int(bounds[-1] - bounds[0])
    target = lambda j: int(bounds[0]) + total * j // n_ranks  # noqa: E731
    cut = lambda j: (0 if j == 0 else len(bounds) - 1 if j == n_ranks  # noqa: E731
                     else int(np.searchsorted(bounds, target(j), side="left")))
    return cut(rank), cut(rank + 1)


def build_csr(ix_u: np.ndarray, ix_i: np.ndarray, y: np.ndarray, nusers: int,
              nitems: int):
    """CSR over the training triplets: (indptr (nU+1,) int64, indices int32,
    data); the native counting sort when available, scipy otherwise.  No
    fit calls it (``ops.ingest.sort_sides`` sorts a fit's sides)."""
    from .. import _native

    if _native.available():
        return _native.coo_to_csr(ix_u, ix_i, y, nusers)
    from scipy.sparse import coo_array

    X = coo_array((y, (ix_u, ix_i)), shape=(nusers, nitems)).tocsr()
    return (X.indptr.astype(np.int64, copy=False),
            X.indices.astype(np.int32, copy=False), X.data)


def gather_batch_nonzeros(indptr, indices, data, rows: np.ndarray):
    """Concatenate the CSR slices of ``rows``: returns (y, ix_row, ix_col)
    where ``ix_row`` repeats each row id by its degree.  This is the
    reference's two-pass batch gather (``cython_loops.pxi:27-42, 770-797``)."""
    from .. import _native

    if _native.available():
        return _native.gather_rows(indptr, indices, data, rows)
    rows64 = rows.astype(np.int64, copy=False)
    starts = indptr[rows64]
    counts = (indptr[rows64 + 1] - starts).astype(np.int64)
    total = int(counts.sum())
    # vectorized ragged gather: position j within the output maps to
    # indices[starts[r_j] + (j - out_start[r_j])]
    out_r = np.repeat(rows.astype(np.int32, copy=False), counts)
    ends = np.cumsum(counts)
    gather_ix = np.repeat(starts - (ends - counts), counts) + np.arange(total, dtype=np.int64)
    return data[gather_ix], out_r, indices[gather_ix]


def hyperparams_txt(path: str, a, a_prime, b_prime, c, c_prime, d_prime, k, random_seed):
    """Write hyperparameters.txt in the reference's exact format
    (``hpfrec/__init__.py:494-506``)."""
    with open(os.path.join(path, "hyperparameters.txt"), "w") as pf:
        pf.write("a: %.3f\n" % a)
        pf.write("a_prime: %.3f\n" % a_prime)
        pf.write("b_prime: %.3f\n" % b_prime)
        pf.write("c: %.3f\n" % c)
        pf.write("c_prime: %.3f\n" % c_prime)
        pf.write("d_prime: %.3f\n" % d_prime)
        pf.write("k: %d\n" % k)
        if random_seed is not None:
            pf.write("random seed: %d\n" % random_seed)
        else:
            pf.write("random seed: None\n")
