// Jonker-Volgenant min-cost assignment as a one-warp __device__ routine.
//
// Replaces the solve core of the TPU kernels in
// smartedgesensor3dhumanpose_tpu/ops/hungarian_pallas.py (_jv_kernel and
// jv_core_batched), which K1 (jv_assign.cu) launches on its own, K2
// (association_fold.cu) embeds once per camera and K3 (tracker_scan.cu)
// once per frame. The block prefix scan below is shared by K2 and K3.
//
// What bounds it on an H100: nothing the card is rated for. A solve of
// n <= 120 columns is a sequential walk: the row reduction, then for each
// row left free a Dijkstra search of at most n + 1 steps, each a relaxation
// of n columns followed by one argmin, then an augmenting walk of at most
// n + 1 steps. The bytes (one cost row per step) and the flops are
// thousands of times below the card's bandwidth and arithmetic rate; the
// time is the latency of the dependent steps.
//
// Design: one warp per problem, at every n. Lane t holds columns t + 32 k
// and rows t + 32 k for k < S = n / 32 + 1 slots (the n + 1 columns, the
// virtual one included, in groups of 32; 1 <= S <= 4), and the whole solver
// state lives in its registers: v, minv, way, used, roc and uc (the
// potential of the row matched to the column) per column, the row minima
// per row. One template per S with every slot loop unrolled; a slot is
// picked by comparison (pick), never by a runtime index into a register
// array, which would go to local memory. The loops are written without
// branches (selects, clamped indices), so their loads issue together. A
// search step is: two shuffles from one lane for roc[j0] and its row's
// potential; S cost loads; S relaxations and a lane-local argmin in
// ascending column order; the warp's lexicographic (value, column) argmin
// as two __reduce_min_sync (value as an order-preserving key, then the
// least column holding it) and one shuffle for the value. No block barrier,
// and no solver state in shared memory (only the row reduction's claims
// pass through it). The augment walks the predecessor chain by
// shuffles. Both data-dependent loops keep the n + 1 step backstop of the
// TPU kernel, so no step goes back to the host. The TPU kernel's 8-sublane
// problem packing and scalar-only loop carries were Mosaic limits and are
// not carried over.
//
// Semantics (reproduced exactly, including every tie rule):
//  * row reduction: u[i] = min_j cost(i, j); each active row i < n_rows is
//    pre-assigned to its first argmin column, the lowest claiming row
//    winning a contested column (one shared-memory atomicMin pass);
//  * the augmenting search runs only for rows still free, in ascending
//    order, skipping rows with row_active == 0; delta ties go to the lowest
//    column;
//  * roc[j] = row matched to column j (-1 = free).
//
// Arithmetic is float32 with every operation rounded on its own (the build
// passes --fmad=false), in the order of the plain PyTorch version
// (ops/hungarian.py::_jv_plain: cost - u[i0] - v, then minv - delta,
// u + delta, v - delta), so the two agree bit for bit. The argmin is a
// lexicographic minimum, which does not depend on how the columns are cut
// into slots; its key orders floats as the comparisons do (+0 = -0) and
// delta is the winning column's own value.

#pragma once

#include <cuda_runtime.h>

namespace ses3d {

constexpr int kLanes = 128;   // threads per block of K2 and K3
constexpr int kMaxN = 120;    // columns + the virtual column fit 4 slots of 32
constexpr float kInf = 3.0e38f;

// Register slots per lane for n columns: the n + 1 columns in groups of 32.
__host__ __device__ constexpr int jv_slots(int n) { return n / 32 + 1; }

// a[k] for a warp-uniform runtime k < S, by comparison (no local memory).
template <int S, class T>
__device__ __forceinline__ T pick(const T (&a)[S], int k) {
  T x = a[0];
#pragma unroll
  for (int kk = 1; kk < S; ++kk) {
    if (kk == k) x = a[kk];
  }
  return x;
}

// An unsigned key whose order is the float order (+0 and -0 equal).
__device__ __forceinline__ unsigned ordered_key(float x) {
  const unsigned b = __float_as_uint(x == 0.0f ? 0.0f : x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// Solve the assignment of rows [0, n_rows) to columns [0, n) in one warp,
// 1 <= n_rows <= n <= kMaxN, jv_slots(n) <= S. `cost(i, j)` returns the
// float cost of row i, column j, for any i < n_rows and j < n; `row_active`
// (may be null) is read as row_active[i] != 0. `claim` is shared memory of
// at least n ints that the warp may overwrite. On return lane t holds in
// roc[k] the row matched to column t + 32 k, or -1 (the virtual column n
// holds the last row placed). All 32 lanes of the warp must call it.
//
// Column lanes also keep uc, a copy of the potential of the row matched to
// their column, updated with the same float operations as the row's own
// (a row is on the search tree exactly when its column is used), so a
// search step fetches roc[j0] and u[roc[j0]] from one lane together.
template <int S, class Cost, class Mask>
__device__ __forceinline__ void jv_solve_warp(const Cost& cost, int n,
                                              int n_rows, const Mask* row_active,
                                              int* claim, int (&roc)[S]) {
  const unsigned full = 0xffffffffu;
  const int t = threadIdx.x & 31;
  bool active[S];  // row t + 32 k exists and is not skipped
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int i = t + 32 * k;
    const bool skip = row_active != nullptr && row_active[i < n_rows ? i : 0] == 0;
    active[k] = i < n_rows && !skip;
  }

  // Row reduction: lane t scans rows t + 32 k for their minimum and first
  // argmin, the S rows side by side. No branch (a lane past the last row
  // scans row 0 and drops the result), so the loads go out together.
  float u[S];  // row minimum, the potential of row t + 32 k until it is placed
  int amin[S];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    u[k] = kInf;
    amin[k] = n;
  }
#pragma unroll 8
  for (int j = 0; j < n; ++j) {
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const float c = cost(t + 32 * k < n_rows ? t + 32 * k : 0, j);
      const bool lower = c < u[k];
      u[k] = lower ? c : u[k];
      amin[k] = lower ? j : amin[k];
    }
  }
  // Column j goes to the lowest active row whose first argmin it is.
#pragma unroll
  for (int k = 0; k < S; ++k) {
    if (t + 32 * k < n) claim[t + 32 * k] = n_rows;  // no claim yet
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < S; ++k) {
    if (active[k] && amin[k] < n) atomicMin(&claim[amin[k]], t + 32 * k);
  }
  __syncwarp();
  unsigned pending[S];  // rows left free by the reduction, group k's
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int j = t + 32 * k;  // column j and row i = j of this slot
    const int w = j < n ? claim[j] : n_rows;
    roc[k] = w < n_rows ? w : -1;
    const bool won = amin[k] < n && claim[amin[k]] == j;
    pending[k] = __ballot_sync(full, active[k] && !won);
  }
  __syncwarp();
  float uc[S];  // potential of the row matched to column t + 32 k
#pragma unroll
  for (int k = 0; k < S; ++k) uc[k] = 0.0f;
#pragma unroll
  for (int s = 0; s < S; ++s) {
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int w = roc[k] < 0 ? 0 : roc[k];
      const float x = __shfl_sync(full, u[s], w & 31);
      if (roc[k] >= 0 && (w >> 5) == s) uc[k] = x;
    }
  }

  float v[S];  // potential of column t + 32 k
#pragma unroll
  for (int k = 0; k < S; ++k) v[k] = 0.0f;

  // Rows left free by the reduction, in ascending order. An augmenting path
  // only moves matched rows between columns, so a row matched now is still
  // matched when the loop reaches it, and a free row is still free (its
  // potential still its row minimum).
#pragma unroll 1
  for (int g = 0; g < S; ++g) {
    for (unsigned todo = pick(pending, g); todo; todo &= todo - 1u) {
      const int r = 32 * g + __ffs(todo) - 1;
      const float u_r = __shfl_sync(full, pick(u, g), r & 31);
      float minv[S];
      int way[S];
      unsigned used = 0u;  // bit k: column t + 32 k is on the search tree
#pragma unroll
      for (int k = 0; k < S; ++k) {
        minv[k] = kInf;
        way[k] = n;
        if (t + 32 * k == n) {  // the virtual column holds row r
          roc[k] = r;
          uc[k] = u_r;
        }
      }
      // Dijkstra search from the virtual column n.
      int j0 = n;
      for (int step = 0; step <= n + 1; ++step) {
        const int i0 = __shfl_sync(full, pick(roc, j0 >> 5), j0 & 31);
        const float u_i0 = __shfl_sync(full, pick(uc, j0 >> 5), j0 & 31);
        if (i0 < 0) break;
        if ((j0 & 31) == t) used |= 1u << (j0 >> 5);
        float c[S];
#pragma unroll
        for (int k = 0; k < S; ++k) c[k] = cost(i0, t + 32 * k < n ? t + 32 * k : 0);
        float best = kInf;
        int best_j = t;
#pragma unroll
        for (int k = 0; k < S; ++k) {
          const int j = t + 32 * k;
          const bool live = j < n && !((used >> k) & 1u);
          const float cur = c[k] - u_i0 - v[k];
          const bool better = live && cur < minv[k];
          minv[k] = better ? cur : minv[k];
          way[k] = better ? j0 : way[k];
          const float masked = live ? minv[k] : kInf;
          const bool take = k == 0 || masked < best;
          best = take ? masked : best;
          best_j = take ? j : best_j;
        }
        // The lexicographic (value, column) argmin over the warp: the
        // least value, then the least column holding it, and that column's
        // own value as delta.
        const unsigned key = ordered_key(best);
        const unsigned least = __reduce_min_sync(full, key);
        const int j1 = static_cast<int>(
            __reduce_min_sync(full, key == least ? static_cast<unsigned>(best_j) : ~0u));
        const float delta = __shfl_sync(full, best, j1 & 31);
#pragma unroll
        for (int k = 0; k < S; ++k) {
          if ((used >> k) & 1u) {
            uc[k] = uc[k] + delta;
            v[k] = v[k] - delta;
          } else if (t + 32 * k < n) {
            minv[k] = minv[k] - delta;
          }
        }
        j0 = j1;
      }
      // Augment along the predecessor chain back to the virtual column.
      int j = j0;
      for (int step = 0; j != n && step <= n + 1; ++step) {
        const int jp = __shfl_sync(full, pick(way, j >> 5), j & 31);
        const int from = __shfl_sync(full, pick(roc, jp >> 5), jp & 31);
        const float u_from = __shfl_sync(full, pick(uc, jp >> 5), jp & 31);
#pragma unroll
        for (int k = 0; k < S; ++k) {
          if (t + 32 * k == j) {
            roc[k] = from;
            uc[k] = u_from;
          }
        }
        j = jp;
      }
    }
  }
}

// The solve's result for a block of kLanes threads; also the claim scratch.
struct JvShared {
  int roc[kLanes];  // row matched to each column, -1 if free
};

// jv_solve_warp with its result written to s.roc, -1 past the S slots.
template <int S, class Cost, class Mask>
__device__ __forceinline__ void jv_solve_to_shared(const Cost& cost, int n,
                                                   int n_rows,
                                                   const Mask* row_active,
                                                   JvShared& s) {
  int roc[S];
  jv_solve_warp<S>(cost, n, n_rows, row_active, s.roc, roc);
  const int t = threadIdx.x;
#pragma unroll
  for (int k = 0; k < S; ++k) s.roc[t + 32 * k] = roc[k];
#pragma unroll
  for (int k = S; k < kLanes / 32; ++k) s.roc[t + 32 * k] = -1;
}

// jv_solve_to_shared for n >= 32, out of line (see jv_solve_block).
template <class Cost, class Mask>
__device__ __noinline__ void jv_solve_wide(const Cost cost, int n, int n_rows,
                                           const Mask* row_active, JvShared& s) {
  switch (jv_slots(n)) {
    case 2:
      jv_solve_to_shared<2>(cost, n, n_rows, row_active, s);
      break;
    case 3:
      jv_solve_to_shared<3>(cost, n, n_rows, row_active, s);
      break;
    default:
      jv_solve_to_shared<4>(cost, n, n_rows, row_active, s);
      break;
  }
}

// The solve for a block of kLanes threads (K2, K3): warp 0 runs
// jv_solve_warp while the other warps wait at one barrier. On return
// s.roc[j] holds the row matched to column j, or -1. All threads of the
// block must call it. A kernel that embeds it is built twice and launches
// the instance its n needs: kWide = false (n < 32 only) inlines the
// one-slot routine; kWide = true calls the 2-4 slot routines out of line.
// One instance for both cost the kernels' other phases on every frame:
// inlined, the wide routines took their registers; called, the call alone
// slowed the one-slot frames.
template <bool kWide, class Cost, class Mask>
__device__ void jv_solve_block(const Cost& cost, int n, int n_rows,
                               const Mask* row_active, JvShared& s) {
  if (threadIdx.x < 32) {
    if constexpr (kWide) {
      jv_solve_wide(cost, n, n_rows, row_active, s);
    } else {
      jv_solve_to_shared<1>(cost, n, n_rows, row_active, s);
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// The wide solve: kMaxN < n <= kMaxNWide columns, one block per problem.
//
// The warp routine keeps the n + 1 columns in registers and stops at four
// slots of 32. Past that the solver state lives in shared memory (JvWide):
// v, minv, way, used and roc per column, the row potentials u and the
// pending flags per row. A block of kWideThreads threads stripes the
// columns over its threads (thread t owns columns t, t + kWideThreads, ...
// and alone reads or writes their v, minv, way and used), and the cost rows
// are read from device memory through the functor (a 1024 x 1024 problem
// is 4 MB, inside the L2).
//
// The row reduction gives each warp whole rows: its lanes scan a row's
// columns in stripes and reduce the lexicographic (value, column) minimum
// with two __reduce_min_sync. A search step: every thread relaxes its
// columns and keeps its own lexicographic minimum in ascending column
// order; each warp reduces with two __reduce_min_sync; lane 0 posts the
// warp's winner to a double-buffered slot; one __syncthreads; every thread
// then reduces the posted winners in warp order (the same answer in every
// thread) and applies the dual update to its own columns: u[roc[j]] += delta
// and v[j] -= delta on the search tree, minv[j] -= delta off it (a row is on
// the tree exactly when its column is, so the owners' row updates never
// collide). The augment is one thread's walk of the predecessor chain.
//
// Same semantics, tie rules, n + 1 step backstops and float operation
// order as jv_solve_warp and ops/hungarian.py::_jv_plain, so the result
// equals the plain version bit for bit. It is written to be simple and
// right; each search step pays one block barrier.
constexpr int kWideThreads = 256;
constexpr int kMaxNWide = 8192;

// Entries of each JvWide array for n columns: n + 1 rounded up to 16, so
// every array starts 16-byte aligned.
__host__ __device__ constexpr int jv_wide_entries(int n) { return (n + 1 + 15) / 16 * 16; }

// Dynamic shared memory of the wide state: five 4-byte arrays and two byte
// arrays of jv_wide_entries(n) entries.
__host__ __device__ constexpr int jv_wide_smem_bytes(int n) {
  return 22 * jv_wide_entries(n);
}

struct JvWide {
  float* v;             // potential of each column (the virtual one too)
  float* minv;          // least reduced cost reaching each column
  float* u;             // potential of each row
  int* way;             // predecessor column on the search tree; the row
                        // reduction's argmin per row until the searches
  int* roc;             // row matched to each column, -1 if free
  unsigned char* used;  // column on the search tree
  unsigned char* pend;  // row left free by the row reduction
};

__device__ inline JvWide jv_wide_layout(void* smem, int n) {
  const int m = jv_wide_entries(n);
  float* f = static_cast<float*>(smem);
  JvWide s;
  s.v = f;
  s.minv = f + m;
  s.u = f + 2 * m;
  s.way = reinterpret_cast<int*>(f + 3 * m);
  s.roc = reinterpret_cast<int*>(f + 4 * m);
  s.used = reinterpret_cast<unsigned char*>(f + 5 * m);
  s.pend = s.used + m;
  return s;
}

// Solve the assignment of rows [0, n_rows) to columns [0, n) in one block
// of kWideThreads threads, 1 <= n_rows <= n <= kMaxNWide; `cost` and
// `row_active` as for jv_solve_warp. On return (after a block barrier)
// s.roc[j] holds the row matched to column j, or -1. All threads of the
// block must call it.
template <class Cost, class Mask>
__device__ void jv_solve_shared(const Cost& cost, int n, int n_rows,
                                const Mask* row_active, const JvWide& s) {
  constexpr int kWarps = kWideThreads / 32;
  constexpr unsigned kNone = ~0u;  // a thread or warp without columns
  __shared__ unsigned post_key[2][kWarps];
  __shared__ unsigned post_col[2][kWarps];
  __shared__ float post_val[2][kWarps];
  const unsigned full = 0xffffffffu;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;

  for (int j = t; j <= n; j += kWideThreads) {
    s.roc[j] = n_rows;  // no claim yet
    s.v[j] = 0.0f;
  }
  __syncthreads();

  // Row reduction: u[i] = the row's minimum; each active row claims its
  // first argmin column, the lowest claiming row wins (atomicMin).
  for (int i = warp; i < n_rows; i += kWarps) {
    float best = kInf;
    int best_j = n;
    for (int j = lane; j < n; j += 32) {
      const float c = cost(i, j);
      const bool lower = c < best;
      best = lower ? c : best;
      best_j = lower ? j : best_j;
    }
    const unsigned key = ordered_key(best);
    const unsigned least = __reduce_min_sync(full, key);
    const int amin = static_cast<int>(
        __reduce_min_sync(full, key == least ? static_cast<unsigned>(best_j) : kNone));
    const float umin = __shfl_sync(full, best, amin & 31);
    if (lane == 0) {
      s.u[i] = umin;
      s.way[i] = amin;
      const bool act = row_active == nullptr || row_active[i] != 0;
      if (act && amin < n) atomicMin(&s.roc[amin], i);
    }
  }
  __syncthreads();
  for (int i = t; i < n_rows; i += kWideThreads) {
    const bool act = row_active == nullptr || row_active[i] != 0;
    const int a = s.way[i];
    s.pend[i] = act && !(a < n && s.roc[a] == i);
  }
  __syncthreads();
  for (int j = t; j <= n; j += kWideThreads) {
    if (s.roc[j] >= n_rows) s.roc[j] = -1;
  }
  __syncthreads();

  // Rows left free by the reduction, in ascending order (as jv_solve_warp).
  int parity = 0;
  for (int r = 0; r < n_rows; ++r) {
    if (!s.pend[r]) continue;
    for (int j = t; j <= n; j += kWideThreads) {
      s.minv[j] = kInf;
      s.way[j] = n;
      s.used[j] = 0;
    }
    if (t == 0) s.roc[n] = r;  // the virtual column holds row r
    __syncthreads();
    // Dijkstra search from the virtual column n.
    int j0 = n;
    for (int step = 0; step <= n + 1; ++step) {
      const int i0 = s.roc[j0];
      if (i0 < 0) break;
      const float u_i0 = s.u[i0];
      if (j0 % kWideThreads == t) s.used[j0] = 1;
      float best = kInf;
      unsigned best_j = kNone;
      for (int j = t; j < n; j += kWideThreads) {
        const bool live = !s.used[j];
        const float cur = cost(i0, j) - u_i0 - s.v[j];
        if (live && cur < s.minv[j]) {
          s.minv[j] = cur;
          s.way[j] = j0;
        }
        const float masked = live ? s.minv[j] : kInf;
        const bool take = best_j == kNone || masked < best;
        best = take ? masked : best;
        best_j = take ? static_cast<unsigned>(j) : best_j;
      }
      // The lexicographic (value, column) argmin: within the warp, then
      // across the posted warp winners; delta is the winning column's value.
      const unsigned key = best_j == kNone ? kNone : ordered_key(best);
      const unsigned least = __reduce_min_sync(full, key);
      const unsigned col = __reduce_min_sync(full, key == least ? best_j : kNone);
      const unsigned holder = __ballot_sync(full, key == least && best_j == col);
      const float val = __shfl_sync(full, best, __ffs(holder) - 1);
      if (lane == 0) {
        post_key[parity][warp] = least;
        post_col[parity][warp] = col;
        post_val[parity][warp] = val;
      }
      __syncthreads();
      unsigned k1 = post_key[parity][0];
      unsigned j1 = post_col[parity][0];
      float delta = post_val[parity][0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
        const unsigned kw = post_key[parity][w];
        const unsigned jw = post_col[parity][w];
        const bool take = kw < k1 || (kw == k1 && jw < j1);
        k1 = take ? kw : k1;
        j1 = take ? jw : j1;
        delta = take ? post_val[parity][w] : delta;
      }
      parity ^= 1;
      for (int j = t; j <= n; j += kWideThreads) {
        if (s.used[j]) {
          const int i = s.roc[j];
          s.u[i] = s.u[i] + delta;
          s.v[j] = s.v[j] - delta;
        } else if (j < n) {
          s.minv[j] = s.minv[j] - delta;
        }
      }
      j0 = static_cast<int>(j1);
    }
    __syncthreads();
    // Augment along the predecessor chain back to the virtual column.
    if (t == 0) {
      int j = j0;
      for (int step = 0; j != n && step <= n + 1; ++step) {
        const int jp = s.way[j];
        s.roc[j] = s.roc[jp];
        j = jp;
      }
    }
    __syncthreads();
  }
}

// Inclusive prefix sum of `x` over the block's 128 threads; `total` gets
// the block's sum. All 128 threads must call it.
__device__ inline int block_inclusive_scan(int x, int* warp_sums, int& total) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(full, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  int prefix = 0;
  int sum = 0;
  for (int w = 0; w < kLanes / 32; ++w) {
    if (w < warp) prefix += warp_sums[w];
    sum += warp_sums[w];
  }
  total = sum;
  __syncthreads();
  return x + prefix;
}

}  // namespace ses3d
