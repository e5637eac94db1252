// K7 — phi sums of one SVI mini-batch, both sides, and the other side's
// touched-row mask.
//
// Replaces hpfrec_tpu/ops/svi.py:phi_sums_tables (svi.py:31-38, over
// hpfrec_tpu/ops/cavi.py:_phi_block) as the chunk body of svi_run_batches
// runs it (svi.py:254-276).  A batch is a slice of the epoch stream (K9):
// triplets (y, row, col), grouped by local row (one contiguous run per
// batch row, batch rows in shuffled order).  With t_loc / t_oth the exp
// tables of the local / other side and
//   scale_s = y_s / <t_loc[row_s], t_oth[col_s]>,
//   s_loc[r] = t_loc[r] (.) sum_{s: row_s = r} scale_s t_oth[col_s],
//   s_oth[c] = t_oth[c] (.) sum_{s: col_s = c} scale_s t_loc[row_s],
//   omask[c] = some col_s == c,
// which is phi = scale (t_loc (.) t_oth) summed per row on each side, the
// common factor of a row taken out of its sum.  s_loc must arrive zeroed
// (rows outside the batch stay 0); s_oth and omask are written in full.
//
// What bounds it on the card: gathers.  Each triplet reads one random row
// of t_oth (k * sizeof(T) bytes) on the local pass and one row of t_loc
// on the other pass; the batch's t_loc rows (~100K users or 40K items)
// mostly stay in the 50 MB L2.  A dot and 2k flops per triplet are far
// under the bandwidth line.
//
// Design.  Sums are segmented reductions over a key-grouped stream, with
// no atomics, in a fixed order, so a batch gives the same bits every run:
// - The stream is cut into chunks of kChunk slots; one warp walks a chunk,
//   k over the lanes, 4 row gathers in flight, and keeps a running sum for
//   the current key.  A run that lies wholly inside its chunk is
//   multiplied by its row factor and stored (the only writer of that row).
//   A run cut by a chunk edge leaves its partial in head[chunk] (the
//   chunk's first run) or tail[chunk] (its last run).
// - A finish pass (one warp per key) adds a cut run's partials in a fixed
//   two-level order.  Groups of kGroup chunks that lie inside one run are
//   first added, chunk by chunk, by a warp each (phi_group_kernel) into a
//   second-level partial; the finish then adds the run's first partial,
//   the heads of the chunks outside such groups and the groups' partials,
//   in stream order.  So a row of any length -- the rank-1 item of a Zipf
//   side holds ~2.9M of an item epoch's slots, ~11,300 chunks -- is spread
//   over many warps, and its finish adds ~kGroup + chunks / kGroup partials
//   one after another, not one a chunk.  The order depends only on the
//   run's bounds, kChunk and kGroup: a batch gives the same bits every run.
// - Local side: the batch stream is already grouped; the local pass also
//   writes scale_s.  Its finish pass takes each batch row's bounds from the
//   epoch offsets.
// - Other side: the wrapper sorts the batch's col ids (a stable sort of
//   int keys: it moves indices, adds no floats).  One coalesced pass over
//   the sorted keys writes each present key's run bounds into a zeroed
//   (n_oth, 2) array; the other pass walks the sorted order and reuses
//   scale_s; its finish pass runs one warp per other-side row, reads the
//   row's run from that array (no search), writes zeros and omask = 0
//   where the run is empty.
//
// K7c — the same sums over a whole fit's training stream, the blocked-COO
// engine's E-step: replaces hpfrec_tpu/ops/cavi.py:phi_segment_sums
// (cavi.py:92-113, driven by cavi_step and run_cavi_block, :116-177).
// Local side = users over the user-sorted stream, other side = items; the
// wrapper hands over the user run bounds and, built once per fit from one
// stable counting sort, the item-ordered stream's keys, user ids
// (item_users) and run bounds, and for each user-ordered triplet its
// position in item order (item_pos).  No per-call sort or bounds pass, and
// no mask.  Only the nnz real triplets are walked: a padded tail (index 0,
// y = 0) would give user 0 a second run, and with one writer per run that
// second, all-zero run would overwrite user 0's sum.
//
// K7c's chunk passes are its own (coo_user_pass_kernel,
// coo_item_pass_kernel): at the MillionSong shape the item-side table
// (Theta, 1,019,318 x 50 float32 = 204 MB) is four times the L2, so each
// slot's row gather goes to HBM, and the SVI kernel's walk (three dependent
// loads a slot on the item side: order, then rows / scale, then the row;
// four slots in flight, uniform index loads) left most of the card's
// memory parallelism unused.  Here:
// - a warp reads 32 slots' ids (and y or scale) with one coalesced load a
//   lane, the next 32 slots' while it adds these, and hands them out with
//   shuffles; run starts come from one ballot over the 32 keys, so a key
//   is shuffled only where a run starts;
// - kCooGather row gathers are issued before any of their arithmetic;
// - the user pass keeps the user's row in registers for its run (it was
//   re-read every slot), adds its eight dots over the lanes at once
//   (transposed_sums) with one division a lane, and writes each scale to
//   its slot's position in item order (a scattered store nothing waits
//   on), so the item pass reads item_users and the scales in its own
//   order: one dependent level (the row) instead of three;
// - both passes run four blocks an SM at k <= 64 in float32 (at most 64
//   registers; left to ptxas they took 64-97 and the user pass two
//   blocks).
// Every slot's arithmetic and every run's order of adds are the SVI
// kernel's (the dot over the lanes, then y / dot, then the k-wide
// multiply-adds in slot order), so K7c gives the same bits as it did on
// phi_chunk_kernel.  No kernel here spills at any KPL (ptxas -v, sm_90a).
#include "common.cuh"

namespace hpf {

constexpr int kChunk = 256;
constexpr int kGroup = 64;  // chunks per second-level partial (ops/svi.py _PHI_GROUP)
constexpr int kPhiUnroll = 4;
constexpr int kCooGather = 8;  // K7c: row gathers in flight a warp
constexpr unsigned kFull = 0xffffffffu;

// One chunk of a key-grouped stream.  LOCAL: position j is triplet j,
// key = rows[j], vector t_oth[cols[j]], scale computed here and stored;
// the key's factor row is t_loc[key].  OTHER: position j is triplet
// order[j], key = skeys[j], vector t_loc[rows[order[j]]], scale read back;
// factor row t_oth[key].
template <int KPL, bool LOCAL, typename T>
__global__ void __launch_bounds__(kThreads)
    phi_chunk_kernel(const T* __restrict__ t_loc, const T* __restrict__ t_oth,
                     const T* __restrict__ y, const int32_t* __restrict__ rows,
                     const int32_t* __restrict__ cols, const int32_t* __restrict__ skeys,
                     const int64_t* __restrict__ order, T* __restrict__ scale,
                     T* __restrict__ out, T* __restrict__ head, T* __restrict__ tail, int64_t n,
                     int k) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int64_t chunk = (int64_t)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int64_t c0 = chunk * kChunk;
  if (c0 >= n) return;  // no block-level synchronization in this kernel
  const int64_t c1 = c0 + kChunk < n ? c0 + kChunk : n;
  const int32_t* keys = LOCAL ? rows : skeys;
  const T* fac_tab = LOCAL ? t_loc : t_oth;

  T acc[KPL];
#pragma unroll
  for (int q = 0; q < KPL; ++q) acc[q] = T(0);
  int32_t cur = keys[c0];
  int64_t run_start = c0;

  auto emit = [&](int64_t rs, int64_t re) {
    const bool before = rs == c0 && c0 > 0 && keys[c0 - 1] == cur;
    const bool after = re == c1 && c1 < n && keys[c1] == cur;
    T* dst;
    if (!before && !after) {
      dst = out + (int64_t)cur * k;
      const T* f = fac_tab + (int64_t)cur * k;
#pragma unroll
      for (int q = 0; q < KPL; ++q) {
        const int c = lane + kWarp * q;
        if (c < k) dst[c] = f[c] * acc[q];
      }
      return;
    }
    dst = (rs == c0 ? head : tail) + chunk * k;
#pragma unroll
    for (int q = 0; q < KPL; ++q) {
      const int c = lane + kWarp * q;
      if (c < k) dst[c] = acc[q];
    }
  };

  for (int64_t j0 = c0; j0 < c1; j0 += kPhiUnroll) {
    int32_t key[kPhiUnroll];
    T v[kPhiUnroll][KPL], sc[kPhiUnroll];
#pragma unroll
    for (int u = 0; u < kPhiUnroll; ++u) {
      const int64_t j = j0 + u;
      const bool live = j < c1;
      key[u] = live ? keys[j] : cur;
      if constexpr (LOCAL) {
        const T* vrow = t_oth + (int64_t)(live ? cols[j] : 0) * k;
        const T* lrow = t_loc + (int64_t)(live ? rows[j] : 0) * k;
        T d = T(0);
#pragma unroll
        for (int q = 0; q < KPL; ++q) {
          const int c = lane + kWarp * q;
          v[u][q] = (live && c < k) ? vrow[c] : T(0);
          d += (live && c < k) ? lrow[c] * v[u][q] : T(0);
        }
        sc[u] = d;  // reduced below
      } else {
        const int64_t s = live ? order[j] : 0;
        const T* vrow = t_loc + (int64_t)(live ? rows[s] : 0) * k;
        sc[u] = live ? scale[s] : T(0);
#pragma unroll
        for (int q = 0; q < KPL; ++q) {
          const int c = lane + kWarp * q;
          v[u][q] = (live && c < k) ? vrow[c] : T(0);
        }
      }
    }
    if constexpr (LOCAL) {
#pragma unroll
      for (int u = 0; u < kPhiUnroll; ++u) sc[u] = warp_sum(sc[u]);
    }
#pragma unroll
    for (int u = 0; u < kPhiUnroll; ++u) {
      const int64_t j = j0 + u;
      if (j >= c1) break;
      if (key[u] != cur) {
        emit(run_start, j);
        cur = key[u];
        run_start = j;
#pragma unroll
        for (int q = 0; q < KPL; ++q) acc[q] = T(0);
      }
      T s = sc[u];
      if constexpr (LOCAL) {
        s = y[j] / s;
        if (lane == 0) scale[j] = s;
      }
#pragma unroll
      for (int q = 0; q < KPL; ++q) acc[q] += s * v[u][q];
    }
  }
  emit(run_start, c1);
}

// Second-level partials: one warp per group q of kGroup consecutive chunks
// adds their heads in chunk order into gsum[q], where the slot before the
// group and the slot after it hold the same key.  Keys are grouped (each
// key's slots contiguous), so then every chunk of the group lies inside
// one run and its head is the whole chunk's sum.
template <int KPL, typename T>
__global__ void __launch_bounds__(kThreads)
    phi_group_kernel(const int32_t* __restrict__ keys, const T* __restrict__ head,
                     T* __restrict__ gsum, int64_t n, int64_t ngroups, int k) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int64_t q = (int64_t)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (q >= ngroups) return;
  const int64_t c0 = q * kGroup * kChunk, c1 = (q + 1) * kGroup * kChunk;
  if (c0 == 0 || c1 >= n || keys[c0 - 1] != keys[c1]) return;
  T sum[KPL];
#pragma unroll
  for (int p = 0; p < KPL; ++p) sum[p] = T(0);
  const T* h = head + q * kGroup * k;
  for (int j = 0; j < kGroup; j += 4) {
    T v[4][KPL];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int p = 0; p < KPL; ++p) {
        const int c = lane + kWarp * p;
        v[u][p] = c < k ? h[(int64_t)(j + u) * k + c] : T(0);
      }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int p = 0; p < KPL; ++p) sum[p] += v[u][p];
  }
#pragma unroll
  for (int p = 0; p < KPL; ++p) {
    const int c = lane + kWarp * p;
    if (c < k) gsum[q * k + c] = sum[p];
  }
}

// Sum of a run [lo, hi) cut by chunk edges, from the chunk partials, in a
// fixed order: the first chunk's partial, then, chunk by chunk, the head of
// each later chunk, except that a group of kGroup chunks that starts at a
// multiple of kGroup and ends before the run's last chunk adds as its one
// second-level partial (phi_group_kernel wrote it: the slots around such a
// group belong to this run).  The order depends only on (lo, hi, kChunk,
// kGroup), and the longest run costs ~kGroup + chunks / kGroup dependent
// adds.
template <int KPL, typename T>
__device__ __forceinline__ void add_cut_run(const T* __restrict__ head, const T* __restrict__ tail,
                                            const T* __restrict__ gsum, int64_t lo, int64_t hi,
                                            int lane, int k, T* sum) {
  const int64_t j0 = lo / kChunk, j1 = (hi - 1) / kChunk;
  const T* first = (lo == j0 * kChunk ? head : tail) + j0 * k;
#pragma unroll
  for (int q = 0; q < KPL; ++q) {
    const int c = lane + kWarp * q;
    sum[q] = c < k ? first[c] : T(0);
  }
  for (int64_t j = j0 + 1; j <= j1;) {
    const T* h;
    if (j % kGroup == 0 && j + kGroup <= j1) {
      h = gsum + (j / kGroup) * k;
      j += kGroup;
    } else {
      h = head + j * k;
      ++j;
    }
#pragma unroll
    for (int q = 0; q < KPL; ++q) {
      const int c = lane + kWarp * q;
      if (c < k) sum[q] += h[c];
    }
  }
}

// Local finish: one warp per batch row q; its run is [bounds[q] - base,
// bounds[q + 1] - base).  Runs inside one chunk were stored by the chunk
// pass.
template <int KPL, typename T>
__global__ void __launch_bounds__(kThreads)
    phi_local_finish_kernel(const T* __restrict__ t_loc, const int32_t* __restrict__ bounds,
                            int64_t base, const int32_t* __restrict__ seg_rows,
                            const T* __restrict__ head, const T* __restrict__ tail,
                            const T* __restrict__ gsum, T* __restrict__ s_loc, int64_t nq,
                            int k) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int64_t q = (int64_t)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (q >= nq) return;
  const int64_t lo = bounds[q] - base, hi = bounds[q + 1] - base;
  if (hi <= lo || lo / kChunk == (hi - 1) / kChunk) return;
  T sum[KPL];
  add_cut_run<KPL, T>(head, tail, gsum, lo, hi, lane, k, sum);
  const int64_t r = seg_rows != nullptr ? seg_rows[q] : q;  // K7c: row q itself
  const T* f = t_loc + r * k;
  T* dst = s_loc + r * k;
#pragma unroll
  for (int q2 = 0; q2 < KPL; ++q2) {
    const int c = lane + kWarp * q2;
    if (c < k) dst[c] = f[c] * sum[q2];
  }
}

// K7c's chunk passes.  One warp walks a chunk of kChunk slots of a
// key-grouped stream, 32 slots at a time: lane l loads slot g0 + l's key
// and its other fields (coalesced); a ballot marks the slots that start a
// new run (a key unlike the slot before); then groups of kCooGather slots
// gather their rows first and add them in slot order.  The emit of a run
// is phi_chunk_kernel's: a whole run is multiplied by its factor row and
// stored, a run cut by a chunk edge leaves its partial in head / tail for
// the finish passes.

// The mask of slots among g0 .. g0 + cnt - 1 (lane = slot - g0) whose key
// differs from the slot before; ``cur`` is the key of slot g0 - 1 (or, at
// the chunk's first slot, that slot's own key).
__device__ __forceinline__ unsigned run_starts(int32_t my_key, int32_t cur, int lane, int cnt) {
  const int32_t prev = __shfl_up_sync(kFull, my_key, 1);
  return __ballot_sync(kFull, lane < cnt && my_key != (lane == 0 ? cur : prev));
}

// Stores a run's sum: [rs, re) of the chunk [c0, c1); f is the run's factor
// row (KPL a lane), read only when the run lies inside the chunk.
template <int KPL, typename T>
__device__ __forceinline__ void coo_emit(const int32_t* __restrict__ keys, int32_t cur,
                                         int64_t rs, int64_t re, int64_t c0, int64_t c1,
                                         int64_t n, int64_t chunk, const T* f, const T* acc,
                                         T* __restrict__ out, T* __restrict__ head,
                                         T* __restrict__ tail, int lane, int k) {
  const bool before = rs == c0 && c0 > 0 && keys[c0 - 1] == cur;
  const bool after = re == c1 && c1 < n && keys[c1] == cur;
  if (!before && !after) {
    T* dst = out + (int64_t)cur * k;
#pragma unroll
    for (int q = 0; q < KPL; ++q) {
      const int c = lane + kWarp * q;
      if (c < k) dst[c] = f[q] * acc[q];
    }
    return;
  }
  T* dst = (rs == c0 ? head : tail) + chunk * k;
#pragma unroll
  for (int q = 0; q < KPL; ++q) {
    const int c = lane + kWarp * q;
    if (c < k) dst[c] = acc[q];
  }
}

template <int KPL, typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ tab, int32_t r, int lane, int k,
                                         T* row) {
  const T* p = tab + (int64_t)r * k;
#pragma unroll
  for (int q = 0; q < KPL; ++q) {
    const int c = lane + kWarp * q;
    row[q] = c < k ? p[c] : T(0);
  }
}

// The user pass over the user-sorted stream: key = ix_u[j], vector
// b_tab[ix_i[j]], scale_j = y[j] / <t_tab[ix_u[j]], b_tab[ix_i[j]]>, stored
// at scale_i[item_pos[j]].  The run's user row (also its factor row) stays
// in registers.
template <int KPL, typename T>
__global__ void __launch_bounds__(kThreads, KPL * sizeof(T) <= 8 ? 4 : 1)
    coo_user_pass_kernel(const T* __restrict__ t_tab, const T* __restrict__ b_tab,
                         const T* __restrict__ y, const int32_t* __restrict__ ix_u,
                         const int32_t* __restrict__ ix_i, const int32_t* __restrict__ item_pos,
                         T* __restrict__ scale_i, T* __restrict__ su, T* __restrict__ head,
                         T* __restrict__ tail, int64_t n, int k) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int64_t chunk = (int64_t)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int64_t c0 = chunk * kChunk;
  if (c0 >= n) return;  // no block-level synchronization in this kernel
  const int64_t c1 = c0 + kChunk < n ? c0 + kChunk : n;

  T acc[KPL], urow[KPL];
#pragma unroll
  for (int q = 0; q < KPL; ++q) acc[q] = T(0);
  int32_t cur = ix_u[c0];
  int64_t run_start = c0;
  load_row<KPL, T>(t_tab, cur, lane, k, urow);

  int64_t jl = c0 + lane < c1 ? c0 + lane : c0;
  int32_t my_key = ix_u[jl], my_col = ix_i[jl], my_pos = item_pos[jl];
  T my_y = y[jl];
  for (int64_t g0 = c0; g0 < c1; g0 += kWarp) {
    const int cnt = c1 - g0 < kWarp ? (int)(c1 - g0) : kWarp;
    jl = g0 + kWarp + lane < c1 ? g0 + kWarp + lane : c0;
    const int32_t nx_key = ix_u[jl], nx_col = ix_i[jl], nx_pos = item_pos[jl];
    const T nx_y = y[jl];
    const unsigned starts = run_starts(my_key, cur, lane, cnt);
    for (int u0 = 0; u0 < cnt; u0 += kCooGather) {
      T v[kCooGather][KPL], d[kCooGather];
#pragma unroll
      for (int u = 0; u < kCooGather; ++u) {
        const bool live = u0 + u < cnt;
        const int32_t col = __shfl_sync(kFull, my_col, u0 + u);
        const T* vrow = b_tab + (int64_t)(live ? col : 0) * k;
#pragma unroll
        for (int q = 0; q < KPL; ++q) {
          const int c = lane + kWarp * q;
          v[u][q] = (live && c < k) ? vrow[c] : T(0);
        }
      }
      if (((starts >> u0) & ((1u << kCooGather) - 1u)) == 0) {
        // every slot of the group on the current run's user row
#pragma unroll
        for (int u = 0; u < kCooGather; ++u) {
          const bool live = u0 + u < cnt;
          d[u] = T(0);
#pragma unroll
          for (int q = 0; q < KPL; ++q) {
            const int c = lane + kWarp * q;
            d[u] += (live && c < k) ? urow[q] * v[u][q] : T(0);
          }
        }
      } else {
        // a run starts in the group: each slot reads its own user row
#pragma unroll
        for (int u = 0; u < kCooGather; ++u) {
          const bool live = u0 + u < cnt;
          const int32_t key = __shfl_sync(kFull, my_key, u0 + u);
          const T* lrow = t_tab + (int64_t)(live ? key : 0) * k;
          d[u] = T(0);
#pragma unroll
          for (int q = 0; q < KPL; ++q) {
            const int c = lane + kWarp * q;
            d[u] += (live && c < k) ? lrow[c] * v[u][q] : T(0);
          }
        }
      }
      // one division a lane: the scale of the slot whose dot it holds
      constexpr int kOwn = kWarp / kCooGather;
      const T dot = transposed_sums<kCooGather, T>(d, lane);
      const T scale = __shfl_sync(kFull, my_y, u0 + lane / kOwn) / dot;
#pragma unroll
      for (int u = 0; u < kCooGather; ++u) {
        const int src = u0 + u;
        if (src >= cnt) break;
        if ((starts >> src) & 1u) {
          coo_emit<KPL, T>(ix_u, cur, run_start, g0 + src, c0, c1, n, chunk, urow, acc, su,
                           head, tail, lane, k);
          cur = __shfl_sync(kFull, my_key, src);
          run_start = g0 + src;
#pragma unroll
          for (int q = 0; q < KPL; ++q) acc[q] = T(0);
          load_row<KPL, T>(t_tab, cur, lane, k, urow);
        }
        const T s = __shfl_sync(kFull, scale, u * kOwn);
        if (lane == src) scale_i[my_pos] = s;
#pragma unroll
        for (int q = 0; q < KPL; ++q) acc[q] += s * v[u][q];
      }
    }
    my_key = nx_key;
    my_col = nx_col;
    my_pos = nx_pos;
    my_y = nx_y;
  }
  coo_emit<KPL, T>(ix_u, cur, run_start, c1, c0, c1, n, chunk, urow, acc, su, head, tail, lane,
                   k);
}

// The item pass over the item-ordered stream: key = item_keys[j], vector
// t_tab[item_users[j]], scale scale_i[j] (the user pass wrote it); the
// factor row b_tab[key] is read where a whole run is stored.
template <int KPL, typename T>
__global__ void __launch_bounds__(kThreads, KPL * sizeof(T) <= 8 ? 4 : 1)
    coo_item_pass_kernel(const T* __restrict__ t_tab, const T* __restrict__ b_tab,
                         const int32_t* __restrict__ item_keys,
                         const int32_t* __restrict__ item_users, const T* __restrict__ scale_i,
                         T* __restrict__ si, T* __restrict__ head, T* __restrict__ tail,
                         int64_t n, int k) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int64_t chunk = (int64_t)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int64_t c0 = chunk * kChunk;
  if (c0 >= n) return;  // no block-level synchronization in this kernel
  const int64_t c1 = c0 + kChunk < n ? c0 + kChunk : n;

  T acc[KPL], f[KPL];
#pragma unroll
  for (int q = 0; q < KPL; ++q) acc[q] = f[q] = T(0);
  int32_t cur = item_keys[c0];
  int64_t run_start = c0;
  auto emit = [&](int64_t re) {
    const bool whole = !(run_start == c0 && c0 > 0 && item_keys[c0 - 1] == cur) &&
                       !(re == c1 && c1 < n && item_keys[c1] == cur);
    if (whole) load_row<KPL, T>(b_tab, cur, lane, k, f);
    coo_emit<KPL, T>(item_keys, cur, run_start, re, c0, c1, n, chunk, f, acc, si, head, tail,
                     lane, k);
  };

  int64_t jl = c0 + lane < c1 ? c0 + lane : c0;
  int32_t my_key = item_keys[jl], my_user = item_users[jl];
  T my_s = scale_i[jl];
  for (int64_t g0 = c0; g0 < c1; g0 += kWarp) {
    const int cnt = c1 - g0 < kWarp ? (int)(c1 - g0) : kWarp;
    jl = g0 + kWarp + lane < c1 ? g0 + kWarp + lane : c0;
    const int32_t nx_key = item_keys[jl], nx_user = item_users[jl];
    const T nx_s = scale_i[jl];
    const unsigned starts = run_starts(my_key, cur, lane, cnt);
    for (int u0 = 0; u0 < cnt; u0 += kCooGather) {
      T v[kCooGather][KPL];
#pragma unroll
      for (int u = 0; u < kCooGather; ++u) {
        const bool live = u0 + u < cnt;
        const int32_t user = __shfl_sync(kFull, my_user, u0 + u);
        const T* vrow = t_tab + (int64_t)(live ? user : 0) * k;
#pragma unroll
        for (int q = 0; q < KPL; ++q) {
          const int c = lane + kWarp * q;
          v[u][q] = (live && c < k) ? vrow[c] : T(0);
        }
      }
#pragma unroll
      for (int u = 0; u < kCooGather; ++u) {
        const int src = u0 + u;
        if (src >= cnt) break;
        if ((starts >> src) & 1u) {
          emit(g0 + src);
          cur = __shfl_sync(kFull, my_key, src);
          run_start = g0 + src;
#pragma unroll
          for (int q = 0; q < KPL; ++q) acc[q] = T(0);
        }
        const T s = __shfl_sync(kFull, my_s, src);
#pragma unroll
        for (int q = 0; q < KPL; ++q) acc[q] += s * v[u][q];
      }
    }
    my_key = nx_key;
    my_user = nx_user;
    my_s = nx_s;
  }
  emit(c1);
}

// Run bounds of the sorted other-side keys, one thread a position: the
// position that starts key c's run writes runs[c].x, the one that ends it
// runs[c].y.  runs arrives zeroed, so an absent key reads the empty [0, 0).
__global__ void run_bounds_kernel(const int32_t* __restrict__ skeys, int2* __restrict__ runs,
                                  int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < n; j += stride) {
    const int32_t key = skeys[j];
    if (j == 0 || skeys[j - 1] != key) runs[key].x = (int32_t)j;
    if (j == n - 1 || skeys[j + 1] != key) runs[key].y = (int32_t)(j + 1);
  }
}

// Other finish: one warp per other-side row c; its run in the sorted keys
// is runs[c] (empty where c has no slot).
template <int KPL, typename T>
__global__ void __launch_bounds__(kThreads)
    phi_other_finish_kernel(const T* __restrict__ t_oth, const int2* __restrict__ runs,
                            const T* __restrict__ head, const T* __restrict__ tail,
                            const T* __restrict__ gsum, T* __restrict__ s_oth,
                            uint8_t* __restrict__ omask, int64_t n_oth, int k) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int64_t r = (int64_t)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (r >= n_oth) return;
  const int2 run = runs[r];
  const int64_t lo = run.x, hi = run.y;
  if (omask != nullptr && lane == 0) omask[r] = hi > lo ? 1 : 0;
  T* dst = s_oth + r * k;
  if (hi <= lo) {
#pragma unroll
    for (int q = 0; q < KPL; ++q) {
      const int c = lane + kWarp * q;
      if (c < k) dst[c] = T(0);
    }
    return;
  }
  if (lo / kChunk == (hi - 1) / kChunk) return;
  T sum[KPL];
  add_cut_run<KPL, T>(head, tail, gsum, lo, hi, lane, k, sum);
  const T* f = t_oth + r * k;
#pragma unroll
  for (int q = 0; q < KPL; ++q) {
    const int c = lane + kWarp * q;
    if (c < k) dst[c] = f[c] * sum[q];
  }
}

inline unsigned warp_blocks(int64_t warps) {
  return (unsigned)((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

template <int KPL, typename T>
cudaError_t launch_batch_phi(const T* t_loc, const T* t_oth, const T* y, const int32_t* rows,
                             const int32_t* cols, const int32_t* bounds, int64_t base,
                             const int32_t* seg_rows, int64_t nq, const int32_t* skeys,
                             const int64_t* order, int2* runs, T* scale,
                             T* head_l, T* tail_l, T* gsum_l, T* head_o, T* tail_o, T* gsum_o,
                             T* s_loc, T* s_oth, uint8_t* omask, int64_t n, int64_t n_oth, int k,
                             cudaStream_t stream) {
  if (n < 0 || nq < 0 || n_oth <= 0 || n > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int64_t nchunks = (n + kChunk - 1) / kChunk;
  const int64_t ngroups = (nchunks + kGroup - 1) / kGroup;
  cudaError_t err;
  if (n > 0) {
    phi_chunk_kernel<KPL, true, T><<<warp_blocks(nchunks), kThreads, 0, stream>>>(
        t_loc, t_oth, y, rows, cols, nullptr, nullptr, scale, s_loc, head_l, tail_l, n, k);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    phi_group_kernel<KPL, T><<<warp_blocks(ngroups), kThreads, 0, stream>>>(
        rows, head_l, gsum_l, n, ngroups, k);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if (nq > 0) {
      phi_local_finish_kernel<KPL, T><<<warp_blocks(nq), kThreads, 0, stream>>>(
          t_loc, bounds, base, seg_rows, head_l, tail_l, gsum_l, s_loc, nq, k);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    int64_t blocks = (n + kThreads - 1) / kThreads;
    if (blocks > 65536) blocks = 65536;
    run_bounds_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(skeys, runs, n);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    phi_chunk_kernel<KPL, false, T><<<warp_blocks(nchunks), kThreads, 0, stream>>>(
        t_loc, t_oth, y, rows, nullptr, skeys, order, scale, s_oth, head_o, tail_o, n, k);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    phi_group_kernel<KPL, T><<<warp_blocks(ngroups), kThreads, 0, stream>>>(
        skeys, head_o, gsum_o, n, ngroups, k);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  phi_other_finish_kernel<KPL, T><<<warp_blocks(n_oth), kThreads, 0, stream>>>(
      t_oth, runs, head_o, tail_o, gsum_o, s_oth, omask, n_oth, k);
  return cudaGetLastError();
}

// K7c: the user pass (it writes the item-ordered scales), the user side's
// group and finish passes, then the item pass and the item side's.
template <int KPL, typename T>
cudaError_t launch_coo_phi(const T* t_tab, const T* b_tab, const T* y, const int32_t* ix_u,
                           const int32_t* ix_i, const int32_t* user_bounds, int64_t n_users,
                           const int32_t* item_keys, const int32_t* item_users,
                           const int32_t* item_pos, const int2* item_runs, T* scale_i,
                           T* head_u, T* tail_u, T* gsum_u, T* head_i, T* tail_i, T* gsum_i,
                           T* su, T* si, int64_t n, int64_t n_items, int k,
                           cudaStream_t stream) {
  if (n < 0 || n_users < 0 || n_items <= 0 || n > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int64_t nchunks = (n + kChunk - 1) / kChunk;
  const int64_t ngroups = (nchunks + kGroup - 1) / kGroup;
  cudaError_t err;
  if (n > 0) {
    coo_user_pass_kernel<KPL, T><<<warp_blocks(nchunks), kThreads, 0, stream>>>(
        t_tab, b_tab, y, ix_u, ix_i, item_pos, scale_i, su, head_u, tail_u, n, k);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    phi_group_kernel<KPL, T><<<warp_blocks(ngroups), kThreads, 0, stream>>>(
        ix_u, head_u, gsum_u, n, ngroups, k);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if (n_users > 0) {
      phi_local_finish_kernel<KPL, T><<<warp_blocks(n_users), kThreads, 0, stream>>>(
          t_tab, user_bounds, 0, nullptr, head_u, tail_u, gsum_u, su, n_users, k);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    coo_item_pass_kernel<KPL, T><<<warp_blocks(nchunks), kThreads, 0, stream>>>(
        t_tab, b_tab, item_keys, item_users, scale_i, si, head_i, tail_i, n, k);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    phi_group_kernel<KPL, T><<<warp_blocks(ngroups), kThreads, 0, stream>>>(
        item_keys, head_i, gsum_i, n, ngroups, k);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  phi_other_finish_kernel<KPL, T><<<warp_blocks(n_items), kThreads, 0, stream>>>(
      b_tab, item_runs, head_i, tail_i, gsum_i, si, nullptr, n_items, k);
  return cudaGetLastError();
}

}  // namespace hpf

extern "C" {

// K7: runs (n_oth, 2) int32 must arrive zeroed; the kernels write each
// present other-side key's run bounds there.
int hpf_batch_phi_sums_f32(const float* t_loc, const float* t_oth, const float* y,
                           const int32_t* rows, const int32_t* cols, const int32_t* bounds,
                           int64_t base, const int32_t* seg_rows, int64_t nq,
                           const int32_t* skeys, const int64_t* order, int32_t* runs,
                           float* scale, float* head_l, float* tail_l, float* gsum_l,
                           float* head_o, float* tail_o, float* gsum_o, float* s_loc,
                           float* s_oth, uint8_t* omask, int64_t n, int64_t n_oth, int32_t k,
                           void* stream) {
  HPF_DISPATCH_KPL(k, hpf::launch_batch_phi, t_loc, t_oth, y, rows, cols, bounds, base, seg_rows,
                   nq, skeys, order, (int2*)runs, scale, head_l, tail_l, gsum_l, head_o,
                   tail_o, gsum_o, s_loc, s_oth, omask, n, n_oth, k, (cudaStream_t)stream);
}

int hpf_batch_phi_sums_f64(const double* t_loc, const double* t_oth, const double* y,
                           const int32_t* rows, const int32_t* cols, const int32_t* bounds,
                           int64_t base, const int32_t* seg_rows, int64_t nq,
                           const int32_t* skeys, const int64_t* order, int32_t* runs,
                           double* scale, double* head_l, double* tail_l, double* gsum_l,
                           double* head_o, double* tail_o, double* gsum_o, double* s_loc,
                           double* s_oth, uint8_t* omask, int64_t n, int64_t n_oth, int32_t k,
                           void* stream) {
  HPF_DISPATCH_KPL(k, hpf::launch_batch_phi, t_loc, t_oth, y, rows, cols, bounds, base, seg_rows,
                   nq, skeys, order, (int2*)runs, scale, head_l, tail_l, gsum_l, head_o,
                   tail_o, gsum_o, s_loc, s_oth, omask, n, n_oth, k, (cudaStream_t)stream);
}

// K7c: t_tab (n_users, k), b_tab (n_items, k); the stream y / ix_u / ix_i
// (n,) sorted by user, user_bounds (n_users + 1,) its user runs; in item
// order (the stable sort of ix_i): item_keys (n,) the item ids, item_users
// (n,) the user ids, item_runs (n_items, 2) each item's run; item_pos (n,)
// each user-ordered triplet's position in item order.  scale (n,) is
// scratch (written in item order); su must arrive zeroed, si is written in
// full.
int hpf_coo_phi_sums_f32(const float* t_tab, const float* b_tab, const float* y,
                         const int32_t* ix_u, const int32_t* ix_i, const int32_t* user_bounds,
                         int64_t n_users, const int32_t* item_keys, const int32_t* item_users,
                         const int32_t* item_pos, const int32_t* item_runs, float* scale,
                         float* head_u, float* tail_u, float* gsum_u, float* head_i,
                         float* tail_i, float* gsum_i, float* su, float* si, int64_t n,
                         int64_t n_items, int32_t k, void* stream) {
  HPF_DISPATCH_KPL(k, hpf::launch_coo_phi, t_tab, b_tab, y, ix_u, ix_i, user_bounds, n_users,
                   item_keys, item_users, item_pos, (const int2*)item_runs, scale, head_u,
                   tail_u, gsum_u, head_i, tail_i, gsum_i, su, si, n, n_items, k,
                   (cudaStream_t)stream);
}

int hpf_coo_phi_sums_f64(const double* t_tab, const double* b_tab, const double* y,
                         const int32_t* ix_u, const int32_t* ix_i, const int32_t* user_bounds,
                         int64_t n_users, const int32_t* item_keys, const int32_t* item_users,
                         const int32_t* item_pos, const int32_t* item_runs, double* scale,
                         double* head_u, double* tail_u, double* gsum_u, double* head_i,
                         double* tail_i, double* gsum_i, double* su, double* si, int64_t n,
                         int64_t n_items, int32_t k, void* stream) {
  HPF_DISPATCH_KPL(k, hpf::launch_coo_phi, t_tab, b_tab, y, ix_u, ix_i, user_bounds, n_users,
                   item_keys, item_users, item_pos, (const int2*)item_runs, scale, head_u,
                   tail_u, gsum_u, head_i, tail_i, gsum_i, su, si, n, n_items, k,
                   (cudaStream_t)stream);
}

}  // extern "C"
