"""ctypes binding of the hand-written CUDA kernels (``csrc/*.cu``).

Every C entry point is ``int hpf_<name>_<f32|f64>(..., void* stream)``
(``int hpf_<name>(..., void* stream)`` for the few that take no floats): it
launches on the given stream, does not synchronize, allocates nothing, and
returns ``cudaGetLastError()``.  :func:`launch` passes tensor pointers and
PyTorch's current stream, and raises when the return code is not 0.
"""

from __future__ import annotations

import ctypes

import torch

# Warps (= segments or rows) per 256-thread block; must match
# csrc/common.cuh kWarpsPerBlock.
WARPS_PER_BLOCK = 8
# Widest k the kernels are instantiated for (8 elements per lane).
MAX_K = 256

_P = ctypes.c_void_p
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64
_D = ctypes.c_double

# argument types of each entry point, before the trailing stream
_SIGNATURES = {
    # t_self, t_other, rows, cols, vals, out, m, w, k, col_off, wps
    "ell_phi_sums": [_P, _P, _P, _P, _P, _P, _I64, _I32, _I32, _I64, _I32],
    # the same with bfloat16 tables and float32 out; typed by vals
    "ell_phi_sums_bf16": [_P, _P, _P, _P, _P, _P, _I64, _I32, _I32, _I64, _I32],
    # t_self, t_other, table, nb, blocks, out, k: every bucket of a side
    "ell_phi_sums_all": [_P, _P, _P, _I32, _I64, _P, _I32],
    # the same with bfloat16 tables and float32 out; typed by the vals
    "ell_phi_sums_all_bf16": [_P, _P, _P, _I32, _I64, _P, _I32],
    # seg, inv_perm, split_indptr, split_seg_pos, chunk_sums (scratch), out,
    # n_rows, k, n_chunks, P
    "segment_table_sums": [_P, _P, _P, _P, _P, _P, _I64, _I32, _I64, _I32],
    # sums, scaler_old, colsum_other, prior, scaler_shape, add_scaler,
    # shp, rte, tab, scaler_new, partials, n, n_real, k, rows a tile, nblocks
    "table_update": [_P, _P, _P, _D, _D, _D, _P, _P, _P, _P, _P, _I64, _I64, _I32, _I32, _I32],
    # shp, rte, tab, partials, n, k, rows a tile, nblocks
    "table_derive": [_P, _P, _P, _P, _I64, _I32, _I32, _I32],
    # the same two with a bfloat16 tab
    "table_update_bf16": [_P, _P, _P, _D, _D, _D, _P, _P, _P, _P, _P, _I64, _I64, _I32, _I32,
                          _I32],
    "table_derive_bf16": [_P, _P, _P, _P, _I64, _I32, _I32, _I32],
    # x, out, n, stepwise: the kernels' digamma, elementwise
    "digamma_eval": [_P, _P, _I64, _I32],
    # partials, colsum, nblocks, k
    "colsum_finish": [_P, _P, _I32, _I32],
    # theta, beta, rows, cols, vals, partials, m, w, k, col_off, full_llk, wps
    "ell_llk": [_P, _P, _P, _P, _P, _P, _I64, _I32, _I32, _I64, _I32, _I32],
    # theta, beta, y, iu, ii, partials, n, k, full_llk, triplets a warp, nblocks
    "coo_llk": [_P, _P, _P, _P, _P, _P, _I64, _I32, _I32, _I64, _I64],
    # y, cols, indptr, perm, offsets, e_y, e_row, e_col, nnz, n_rows
    "epoch_gather": [_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64],
    # t_loc, t_oth, y, rows, cols, bounds, base, seg_rows, nq, skeys, order,
    # runs, scale, head_l, tail_l, gsum_l, head_o, tail_o, gsum_o, s_loc,
    # s_oth, omask, n, n_oth, k
    "batch_phi_sums": [_P, _P, _P, _P, _P, _P, _I64, _P, _I64, _P, _P, _P, _P, _P, _P,
                       _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I32],
    # t_tab, b_tab, y, ix_u, ix_i, user_bounds, n_users, item_keys,
    # item_users, item_pos, item_runs, scale, head_u, tail_u, gsum_u, head_i,
    # tail_i, gsum_i, su, si, n, n_items, k
    "coo_phi_sums": [_P, _P, _P, _P, _P, _P, _I64, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                     _P, _P, _P, _I64, _I64, _I32],
    # shp_in, rte_in, sums, mask, scaler_in, colsum, prior, scaler_shape,
    # add_scaler, step, mult, blend_all, global, shp_out, rte_out,
    # scaler_out, partials, n, k, nblocks
    "svi_pass": [_P, _P, _P, _P, _P, _P, _D, _D, _D, _D, _D, _I32, _I32, _P, _P, _P,
                 _P, _I64, _I32, _I32],
    # theta, beta, iu, ii, out, partials (or NULL), n, k, pairs a warp, nblocks
    "predict_pairs": [_P, _P, _P, _P, _P, _P, _I64, _I32, _I64, _I64],
    # a, b, partials, n, nblocks
    "theta_diff": [_P, _P, _P, _I64, _I32],
    # theta, beta, iu, ii, partials (scratch), out, n, k, pairs a warp, nblocks
    "rowsum_dot": [_P, _P, _P, _P, _P, _P, _I64, _I32, _I64, _I64],
    # theta_rows, beta, scores, b, nI, k, range_w, R
    "topn_score": [_P, _P, _P, _I32, _I64, _I32, _I64, _I32],
    # theta_rows, beta, mask (or NULL), W, cand, b, nI, k, n, range_w, R
    "topn_fused": [_P, _P, _P, _I64, _P, _I32, _I64, _I32, _I32, _I64, _I32],
    # y, elogb, beta_colsum, theta0, g_shp0, g_rte0, k_rte0, a, k_shp,
    # add_k_rte, maxiter, stop_thr, P, k, out (Theta, G_shp, G_rte, count),
    # phi (or NULL)
    "fold_in": [_P, _P, _P, _P, _P, _P, _D, _D, _D, _D, _I32, _D, _I64, _I32, _P, _P],
    # key (624 uint32), pos, words (uint32 scratch, a word a float32 value,
    # two a float64 value), g_rte, l_rte, g_shp, l_shp, n_u, n_i, prior_u,
    # prior_i: a state's seeded start
    "mt19937_init": [_P, _I32, _P, _P, _P, _P, _P, _I64, _I64, _D, _D],
    # cols, vals (a side's CSR), seg_src, seg_len, btab (nb x 3: first
    # segment, first slot, width), nb, n_segs, out_cols, out_vals: K15
    "ell_fill": [_P, _P, _P, _P, _P, _I32, _I64, _P, _P],
}
# entry points without a float type: name -> argument types before the stream
_UNTYPED = {
    # seg (float32), inv_perm, split_indptr, split_seg_pos, chunk_sums
    # (float32 scratch), out (float64), n_rows, k, n_chunks, P
    "segment_table_sums_f32_f64": [_P, _P, _P, _P, _P, _P, _I64, _I32, _I64, _I32],
    # rows, m, mask
    "row_mask": [_P, _I64, _P],
    # scores, rows, items, npairs, b, nI
    "topn_mask": [_P, _P, _P, _I64, _I32, _I64],
    # scores, vals, idx, cand (or NULL), b, nI, n, P
    "topn_select": [_P, _P, _P, _P, _I32, _I64, _I32, _I32],
    # mask, rows, items, npairs, b, nI, W
    "topn_bitmask": [_P, _P, _P, _I64, _I32, _I64, _I64],
    # cand, vals, idx, b, m, n
    "topn_merge": [_P, _P, _P, _I32, _I32, _I32],
    # ids (int32 / int64), n, out (int32, or NULL), minmax (int64 x 2): K15a
    "ids_narrow_i32": [_P, _I64, _P, _P],
    "ids_narrow_i64": [_P, _I64, _P, _P],
    # keys (sorted int32), n, n_rows, indptr (int32, n_rows + 1): K15b
    "csr_indptr": [_P, _I64, _I64, _P],
}

_lib = None


def load():
    """Build (first use) and load the kernel library."""
    global _lib
    if _lib is None:
        from .build import build_kernels

        lib = ctypes.CDLL(build_kernels())
        for name, args in _SIGNATURES.items():
            for suffix in ("f32", "f64"):
                fn = getattr(lib, f"hpf_{name}_{suffix}")
                fn.argtypes = [*args, _P]
                fn.restype = ctypes.c_int
        for name, args in _UNTYPED.items():
            fn = getattr(lib, f"hpf_{name}")
            fn.argtypes = [*args, _P]
            fn.restype = ctypes.c_int
        lib.hpf_error_string.argtypes = [ctypes.c_int]
        lib.hpf_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(*tensors, dtype):
    """Raise unless every tensor is a contiguous CUDA tensor of ``dtype`` on
    one device."""
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"expected CUDA tensors on {dev}, got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"expected {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("expected contiguous tensors")


def launch(name: str, dtype, k, *args):
    """Launch ``hpf_<name>`` for ``dtype`` (None: the untyped entry point)
    on the current stream of the first tensor argument's device; ``k`` is
    checked against the kernels' range unless it is None."""
    if dtype is not None and dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: kernels take float32 or float64, not {dtype}")
    if k is not None and not 1 <= k <= MAX_K:
        raise ValueError(f"{name}: k={k} outside the kernels' range 1..{MAX_K}")
    lib = load()
    suffix = "" if dtype is None else "_f64" if dtype == torch.float64 else "_f32"
    fn = getattr(lib, f"hpf_{name}{suffix}")
    device = next(a.device for a in args if isinstance(a, torch.Tensor))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a
                   for a in args], stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: "
                           f"{lib.hpf_error_string(err).decode()} ({err})")
