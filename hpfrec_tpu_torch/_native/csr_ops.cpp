// Native host-side data-layer kernels for hpfrec_tpu.
//
// The reference implements its hot loops as Cython->C with OpenMP
// (reference hpfrec/cython_loops.pxi:547-825).  In the TPU framework
// the per-nonzero math lives on the device (XLA/Pallas); what remains
// host-bound at 48M+ nonzeros is the data layer: COO->CSR conversion,
// user-sorted layout construction, and the per-batch ragged gather used by
// SVI epochs (the reference's get_i_batch_pass1/2, pxi:770-797).  Those are
// the C++/OpenMP kernels here, exposed through ctypes (see __init__.py).
//
// Build: g++ -O3 -fopenmp -shared -fPIC (flags probed in build.py).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <utility>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

int has_openmp() {
#ifdef _OPENMP
    return 1;
#else
    return 0;
#endif
}

void set_num_threads(int n) {
#ifdef _OPENMP
    if (n > 0) omp_set_num_threads(n);
#else
    (void)n;
#endif
}

}  // extern "C"

// ---------------------------------------------------------------------
// COO -> CSR via counting sort (stable in column order of appearance).
// indptr must have nrows+1 slots.  O(nnz + nrows).
// ---------------------------------------------------------------------
template <typename T>
static void coo_to_csr_impl(const int32_t* rows, const int32_t* cols,
                            const T* vals, int64_t nnz, int64_t nrows,
                            int64_t* indptr, int32_t* out_cols, T* out_vals) {
    std::memset(indptr, 0, sizeof(int64_t) * (nrows + 1));
    // histogram (counts into indptr[1..nrows])
    for (int64_t i = 0; i < nnz; ++i) {
        ++indptr[(int64_t)rows[i] + 1];
    }
    for (int64_t r = 0; r < nrows; ++r) {
        indptr[r + 1] += indptr[r];
    }
    // stable placement using a scratch cursor
    int64_t* cursor = new int64_t[nrows];
    std::memcpy(cursor, indptr, sizeof(int64_t) * nrows);
    for (int64_t i = 0; i < nnz; ++i) {
        const int64_t pos = cursor[rows[i]]++;
        out_cols[pos] = cols[i];
        out_vals[pos] = vals[i];
    }
    delete[] cursor;
}

extern "C" {

void coo_to_csr_f32(const int32_t* rows, const int32_t* cols, const float* vals,
                    int64_t nnz, int64_t nrows, int64_t* indptr,
                    int32_t* out_cols, float* out_vals) {
    coo_to_csr_impl<float>(rows, cols, vals, nnz, nrows, indptr, out_cols, out_vals);
}

void coo_to_csr_f64(const int32_t* rows, const int32_t* cols, const double* vals,
                    int64_t nnz, int64_t nrows, int64_t* indptr,
                    int32_t* out_cols, double* out_vals) {
    coo_to_csr_impl<double>(rows, cols, vals, nnz, nrows, indptr, out_cols, out_vals);
}

// ---------------------------------------------------------------------
// Ragged batch gather: concatenate the CSR slices of `rows`.
// out_starts has nbatch+1 entries (exclusive prefix sum of row degrees,
// computed by a first pass).  Parallel over batch rows (the reference's
// get_i_batch_pass2 with prange, pxi:787-797).
// ---------------------------------------------------------------------
void gather_starts(const int64_t* indptr, const int64_t* rows, int64_t nbatch,
                   int64_t* out_starts) {
    out_starts[0] = 0;
    for (int64_t b = 0; b < nbatch; ++b) {
        const int64_t r = rows[b];
        out_starts[b + 1] = out_starts[b] + (indptr[r + 1] - indptr[r]);
    }
}

}  // extern "C"

template <typename T>
static void gather_rows_impl(const int64_t* indptr, const int32_t* indices,
                             const T* data, const int64_t* rows, int64_t nbatch,
                             const int64_t* out_starts, int32_t* out_rows,
                             int32_t* out_cols, T* out_vals) {
#pragma omp parallel for schedule(dynamic, 64)
    for (int64_t b = 0; b < nbatch; ++b) {
        const int64_t r = rows[b];
        const int64_t st_in = indptr[r];
        const int64_t st_out = out_starts[b];
        const int64_t deg = indptr[r + 1] - st_in;
        for (int64_t j = 0; j < deg; ++j) {
            out_rows[st_out + j] = (int32_t)r;
            out_cols[st_out + j] = indices[st_in + j];
            out_vals[st_out + j] = data[st_in + j];
        }
    }
}

extern "C" {

void gather_rows_f32(const int64_t* indptr, const int32_t* indices,
                     const float* data, const int64_t* rows, int64_t nbatch,
                     const int64_t* out_starts, int32_t* out_rows,
                     int32_t* out_cols, float* out_vals) {
    gather_rows_impl<float>(indptr, indices, data, rows, nbatch, out_starts,
                            out_rows, out_cols, out_vals);
}

void gather_rows_f64(const int64_t* indptr, const int32_t* indices,
                     const double* data, const int64_t* rows, int64_t nbatch,
                     const int64_t* out_starts, int32_t* out_rows,
                     int32_t* out_cols, double* out_vals) {
    gather_rows_impl<double>(indptr, indices, data, rows, nbatch, out_starts,
                             out_rows, out_cols, out_vals);
}

}  // extern "C"

// ---------------------------------------------------------------------
// ELL bucket fill: scatter CSR segments into a padded (m, w) bucket.
// seg_start/seg_len index into indices/data; row r of the bucket gets
// segment r's entries left-aligned, zero padding elsewhere (caller
// pre-zeroes).  Parallel over segments.
// ---------------------------------------------------------------------
template <typename T>
static void ell_fill_impl(const int64_t* seg_start, const int64_t* seg_len,
                          const int32_t* indices, const T* data, int64_t nseg,
                          int64_t w, int32_t* out_cols, T* out_vals) {
#pragma omp parallel for schedule(dynamic, 256)
    for (int64_t s = 0; s < nseg; ++s) {
        const int64_t st = seg_start[s];
        const int64_t len = seg_len[s];
        int32_t* oc = out_cols + s * w;
        T* ov = out_vals + s * w;
        for (int64_t j = 0; j < len; ++j) {
            oc[j] = indices[st + j];
            ov[j] = data[st + j];
        }
    }
}

extern "C" {

void ell_fill_f32(const int64_t* seg_start, const int64_t* seg_len,
                  const int32_t* indices, const float* data, int64_t nseg,
                  int64_t w, int32_t* out_cols, float* out_vals) {
    ell_fill_impl<float>(seg_start, seg_len, indices, data, nseg, w, out_cols, out_vals);
}

void ell_fill_f64(const int64_t* seg_start, const int64_t* seg_len,
                  const int32_t* indices, const double* data, int64_t nseg,
                  int64_t w, int32_t* out_cols, double* out_vals) {
    ell_fill_impl<double>(seg_start, seg_len, indices, data, nseg, w, out_cols, out_vals);
}

}  // extern "C"

// ---------------------------------------------------------------------
// In-place per-row sort of CSR entries by column id (stable, so duplicate
// (row, col) entries keep their relative order like numpy's stable
// argsort of the combined key).  The column-tiled ELL packing needs cols
// sorted within rows; the counting-sort CSR builders preserve input
// order, and the numpy fallback (full-key stable argsort) measured ~18 s
// at 38.7M nonzeros.  Parallel over rows; already-sorted rows are
// detected and skipped.
// ---------------------------------------------------------------------
template <typename T>
static void sort_csr_cols_impl(const int64_t* indptr, int64_t nrows,
                               int32_t* indices, T* data) {
#ifdef _OPENMP
#pragma omp parallel
#endif
    {
        std::vector<std::pair<int32_t, T>> buf;
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 64)
#endif
        for (int64_t r = 0; r < nrows; ++r) {
            const int64_t st = indptr[r], en = indptr[r + 1];
            if (en - st <= 1) continue;
            bool sorted = true;
            for (int64_t j = st + 1; j < en; ++j) {
                if (indices[j] < indices[j - 1]) { sorted = false; break; }
            }
            if (sorted) continue;
            buf.resize((size_t)(en - st));
            for (int64_t j = st; j < en; ++j) {
                buf[(size_t)(j - st)] = {indices[j], data[j]};
            }
            std::stable_sort(buf.begin(), buf.end(),
                             [](const std::pair<int32_t, T>& a,
                                const std::pair<int32_t, T>& b) {
                                 return a.first < b.first;
                             });
            for (int64_t j = st; j < en; ++j) {
                indices[j] = buf[(size_t)(j - st)].first;
                data[j] = buf[(size_t)(j - st)].second;
            }
        }
    }
}

extern "C" {

void sort_csr_cols_f32(const int64_t* indptr, int64_t nrows, int32_t* indices,
                       float* data) {
    sort_csr_cols_impl<float>(indptr, nrows, indices, data);
}

void sort_csr_cols_f64(const int64_t* indptr, int64_t nrows, int32_t* indices,
                       double* data) {
    sort_csr_cols_impl<double>(indptr, nrows, indices, data);
}

}  // extern "C"

extern "C" {

// ---------------------------------------------------------------------
// Factorize int64 ids in first-occurrence order (pd.factorize semantics
// for integer keys).  Returns the number of uniques.
// ---------------------------------------------------------------------
int64_t factorize_i64(const int64_t* ids, int64_t n, int32_t* codes,
                      int64_t* uniques) {
    std::unordered_map<int64_t, int32_t> table;
    table.reserve((size_t)(n / 2 + 16));
    int32_t next = 0;
    for (int64_t i = 0; i < n; ++i) {
        auto it = table.find(ids[i]);
        if (it == table.end()) {
            table.emplace(ids[i], next);
            uniques[next] = ids[i];
            codes[i] = next;
            ++next;
        } else {
            codes[i] = it->second;
        }
    }
    return (int64_t)next;
}

}  // extern "C"
