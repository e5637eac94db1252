// Native host-side data-layer helpers of hpfrec_tpu_torch.
//
// The reference implements its hot loops as Cython->C with OpenMP
// (reference hpfrec/cython_loops.pxi:547-825).  In the port the
// per-nonzero math lives on the device (CUDA kernels); what remains
// host-bound at 48M+ nonzeros is the data layer: COO->CSR conversion,
// user-sorted layout construction, and the per-batch ragged gather used by
// SVI epochs (the reference's get_i_batch_pass1/2, pxi:770-797).  Those are
// the C++ loops here, exposed through ctypes (see __init__.py), with the
// threaded first touch and byte copy of a fit's host results.
//
// Build (build.py): g++ -O3 -shared -fPIC -fopenmp against the OpenMP
// runtime that PyTorch has loaded, else -pthread -DHPF_STD_THREADS (the same
// loops on std::thread), else serial.  Every parallel loop owns its rows, so
// every output is the same whatever the thread count.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <utility>
#include <vector>

#if defined(_OPENMP)
// The runtime's one entry point used here; declared rather than taken from
// omp.h, which a compiler with OpenMP support may still lack.
extern "C" int omp_get_max_threads(void);
#elif defined(HPF_STD_THREADS)
#include <atomic>
#include <thread>
#endif

// Threads of a parallel loop; 0: the runtime's default.
static int g_threads = 0;

static int loop_threads() {
#if defined(_OPENMP)
    return g_threads > 0 ? g_threads : omp_get_max_threads();
#elif defined(HPF_STD_THREADS)
    const unsigned n = std::thread::hardware_concurrency();
    return g_threads > 0 ? g_threads : (n > 0 ? (int)n : 1);
#else
    return 1;
#endif
}

// body(lo, hi) over [0, n) in chunks of `chunk` rows, each chunk taken by the
// next free thread (OpenMP's schedule(dynamic, chunk)).
template <typename F>
static void parallel_chunks(int64_t n, int64_t chunk, F body) {
    const int64_t nchunks = (n + chunk - 1) / chunk;
#if defined(_OPENMP)
#pragma omp parallel for schedule(dynamic, 1) num_threads(loop_threads())
    for (int64_t c = 0; c < nchunks; ++c) {
        body(c * chunk, std::min(n, (c + 1) * chunk));
    }
#elif defined(HPF_STD_THREADS)
    const int64_t nt = std::min<int64_t>(loop_threads(), nchunks);
    std::atomic<int64_t> next{0};
    auto work = [&]() {
        for (int64_t c = next++; c < nchunks; c = next++) {
            body(c * chunk, std::min(n, (c + 1) * chunk));
        }
    };
    std::vector<std::thread> pool;
    for (int64_t t = 1; t < nt; ++t) pool.emplace_back(work);
    work();
    for (auto& t : pool) t.join();
#else
    for (int64_t c = 0; c < nchunks; ++c) {
        body(c * chunk, std::min(n, (c + 1) * chunk));
    }
#endif
}

extern "C" {

// 0: serial, 1: OpenMP, 2: std::thread
int threads_runtime() {
#if defined(_OPENMP)
    return 1;
#elif defined(HPF_STD_THREADS)
    return 2;
#else
    return 0;
#endif
}

int num_threads() { return loop_threads(); }

void set_num_threads(int n) { g_threads = n > 0 ? n : 0; }

}  // extern "C"

// ---------------------------------------------------------------------
// COO -> CSR via counting sort (stable in column order of appearance).
// indptr must have nrows+1 slots.  O(nnz + nrows * chunks).  The input is
// cut into one contiguous chunk a thread (at most 16, each of 64K entries
// or more); each chunk counts its rows, a serial pass turns the counts
// into indptr and each chunk's first slot in each row, and each chunk
// places its entries from there.  A row's entries keep their input order,
// so the result is the one-thread result bit for bit.
// ---------------------------------------------------------------------
template <typename T>
static void coo_to_csr_impl(const int32_t* rows, const int32_t* cols,
                            const T* vals, int64_t nnz, int64_t nrows,
                            int64_t* indptr, int32_t* out_cols, T* out_vals) {
    const int64_t nchunk = std::max<int64_t>(
        1, std::min<int64_t>(std::min<int64_t>(loop_threads(), 16), nnz >> 16));
    const int64_t per = (nnz + nchunk - 1) / nchunk;
    std::vector<int64_t> cursor((size_t)(nchunk * nrows), 0);
    parallel_chunks(nchunk, 1, [&](int64_t c, int64_t) {
        int64_t* count = cursor.data() + c * nrows;
        for (int64_t i = c * per, end = std::min(nnz, (c + 1) * per); i < end; ++i) {
            ++count[rows[i]];
        }
    });
    indptr[0] = 0;
    for (int64_t r = 0; r < nrows; ++r) {
        int64_t pos = indptr[r];
        for (int64_t c = 0; c < nchunk; ++c) {
            const int64_t n = cursor[(size_t)(c * nrows + r)];
            cursor[(size_t)(c * nrows + r)] = pos;
            pos += n;
        }
        indptr[r + 1] = pos;
    }
    parallel_chunks(nchunk, 1, [&](int64_t c, int64_t) {
        int64_t* cur = cursor.data() + c * nrows;
        for (int64_t i = c * per, end = std::min(nnz, (c + 1) * per); i < end; ++i) {
            const int64_t pos = cur[rows[i]]++;
            out_cols[pos] = cols[i];
            out_vals[pos] = vals[i];
        }
    });
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
    parallel_chunks(nbatch, 64, [&](int64_t lo, int64_t hi) {
        for (int64_t b = lo; b < hi; ++b) {
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
    });
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
    parallel_chunks(nseg, 256, [&](int64_t lo, int64_t hi) {
        for (int64_t s = lo; s < hi; ++s) {
            const int64_t st = seg_start[s];
            const int64_t len = seg_len[s];
            int32_t* oc = out_cols + s * w;
            T* ov = out_vals + s * w;
            for (int64_t j = 0; j < len; ++j) {
                oc[j] = indices[st + j];
                ov[j] = data[st + j];
            }
        }
    });
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
    parallel_chunks(nrows, 64, [&](int64_t lo, int64_t hi) {
        std::vector<std::pair<int32_t, T>> buf;
        for (int64_t r = lo; r < hi; ++r) {
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
    });
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
// A parallel byte copy: dst[0, n) = src[0, n), in blocks of `block` bytes
// taken by the threads as they come free.  A fit's results come back to
// the host through it, one staged chunk at a time, while the next chunks
// still cross the link.
// ---------------------------------------------------------------------
void copy_bytes(char* dst, const char* src, int64_t n, int64_t block) {
    parallel_chunks(n, block, [&](int64_t lo, int64_t hi) {
        std::memcpy(dst + lo, src + lo, (size_t)(hi - lo));
    });
}

// First touch of fresh memory: a zero written every 4 KB, in blocks of
// `block` bytes over the threads, so that its pages are faulted in.  The
// fit's host results are touched so while the card still iterates.
void touch_pages(char* dst, int64_t n, int64_t block) {
    parallel_chunks(n, block, [&](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; i += 4096) dst[i] = 0;
    });
}

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
