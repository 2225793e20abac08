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
// virtual one included, in groups of 32; 1 <= S <= 4 in K2 and K3, up to 8
// in K1), and up to 8 slots the whole solver state lives in its registers: v, minv, way, used, roc and uc (the
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
// not carried over. Past 8 slots (K1 only) a block solves the problem with
// the state in shared memory (jv_solve_block_smem, below).
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
// 1 <= n_rows <= n, jv_slots(n) <= S (n <= kMaxN in K2 and K3, n <=
// kMaxNReg in K1). `cost(i, j)` returns the
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
// The wide solve: past kMaxNReg columns (K1 only), one block per problem
// with the solver state in shared memory.
//
// jv_solve_warp keeps a lane's columns in registers; K1 instantiates it up
// to 8 slots (n <= kMaxNReg = 255). Past that the state lives in shared
// memory (JvWideState): one float4 per column (v; minv, NaN once the column
// is used: a used column's minv is never read again in that search; uc, the
// potential of the matched row as in jv_solve_warp; way) and roc, then the
// row minimum and a pending flag per row. One block of jv_block_warps(n)
// warps solves the problem (jv_solve_block_smem), thread t owning columns
// t + T k, ~4 of them: a step's column work is shared by the block's warps,
// and their winners meet in shared memory at one block barrier per step.
// One warp per problem with the same state in shared memory measured slower
// at every width from 256 to 4096 (it issues every column's work itself).
//
// A search step is one pass over a thread's columns (jv_wide_pass) that
// applies the previous step's dual update (used: uc + delta and v - delta;
// else minv - delta), marks j0 used, relaxes row i0 (cost - u[i0] - v) and
// keeps the thread's lexicographic argmin in ascending column order; then
// the lexicographic argmin over the warp and over the warps' posts. Each
// column gets the same float operations in the same order as in
// ops/hungarian.py::_jv_plain, only one pass later; the search's last update
// is applied by one more pass before the augment, which one thread walks.
// The pass loads the cost of a chunk of columns ahead of the chunk it
// relaxes, branch-free, so a cost row read from device memory pays about one
// latency per step; where the R x C tile fits the block, K1 stages it in
// shared memory instead.
constexpr int kMaxNReg = 255;  // K1's register routine: jv_slots(255) = 8
constexpr int kMaxNWide = 8192;
constexpr int kMaxBlockWarps = 16;

// Warps of the block routine for n columns: ~4 columns per thread (n + 1
// columns over 128 threads per warp group), 2 to kMaxBlockWarps.
__host__ __device__ constexpr int jv_block_warps(int n) {
  const int w = (n + 128) / 128;
  return w < 2 ? 2 : (w > kMaxBlockWarps ? kMaxBlockWarps : w);
}

// Entries of each per-column array for n columns: n + 1 rounded up to 16.
__host__ __device__ constexpr int jv_wide_entries(int n) { return (n + 1 + 15) / 16 * 16; }

// Bytes of the shared state for n columns (rows <= n): a float4 and an int
// per column, a float and a byte per row; a multiple of 16.
__host__ __device__ constexpr int jv_wide_state_bytes(int n) {
  return 25 * jv_wide_entries(n);
}

struct JvWideState {
  float4* col;          // per column: v, minv (NaN once used), uc, way (int bits)
  int* roc;             // row matched to each column, -1 if free
  float* u;             // row minimum of each row
  unsigned char* pend;  // row left free by the row reduction
};

__device__ inline JvWideState jv_wide_layout(void* smem, int n) {
  const int m = jv_wide_entries(n);
  JvWideState s;
  s.col = static_cast<float4*>(smem);
  s.roc = reinterpret_cast<int*>(s.col + m);
  s.u = reinterpret_cast<float*>(s.roc + m);
  s.pend = reinterpret_cast<unsigned char*>(s.u + m);
  return s;
}

// One thread's share of a search step: its columns j = t0 + stride k,
// k < slots, j <= n (the virtual column n included). kFirst: the search's
// first step (minv and way start afresh, no update to apply). Updates the
// thread's lexicographic (value, column) argmin in best, best_j.
template <bool kFirst, int kChunk, class Cost>
__device__ __forceinline__ void jv_wide_pass(const Cost& cost, const JvWideState& s, int n,
                                             int t0, int stride, int slots, int i0,
                                             float u_i0, int j0, float delta, float& best,
                                             int& best_j) {
  const float used_mark = __int_as_float(0x7fffffff);  // a NaN
  float next[kChunk];
#pragma unroll
  for (int q = 0; q < kChunk; ++q) {
    const int j = t0 + stride * q;
    next[q] = cost(i0, j < n ? j : 0);
  }
  for (int k0 = 0; k0 < slots; k0 += kChunk) {
    float c[kChunk];
#pragma unroll
    for (int q = 0; q < kChunk; ++q) c[q] = next[q];
    if (k0 + kChunk < slots) {
#pragma unroll
      for (int q = 0; q < kChunk; ++q) {
        const int j = t0 + stride * (k0 + kChunk + q);
        next[q] = cost(i0, j < n ? j : 0);
      }
    }
    float4 x[kChunk];
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      const int j = t0 + stride * (k0 + q);
      x[q] = s.col[j <= n ? j : n];
    }
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      if (k0 + q >= slots) break;
      const int j = t0 + stride * (k0 + q);
      float v = x[q].x;
      float mv = kFirst ? kInf : x[q].y;
      float uc = x[q].z;
      int way = kFirst ? n : __float_as_int(x[q].w);
      bool was_used = false;
      if (!kFirst) {  // the previous step's dual update
        was_used = mv != mv;
        uc = was_used ? uc + delta : uc;
        v = was_used ? v - delta : v;
        mv = was_used ? mv : mv - delta;
      }
      const bool used = was_used || j == j0;
      const bool live = j < n && !used;
      const float cur = c[q] - u_i0 - v;
      const bool better = live && cur < mv;
      mv = better ? cur : mv;
      way = better ? j0 : way;
      const float masked = live ? mv : kInf;
      const bool take = masked < best;
      best = take ? masked : best;
      best_j = take ? j : best_j;
      if (j <= n) s.col[j] = make_float4(v, used ? used_mark : mv, uc, __int_as_float(way));
    }
  }
}

// The last step's dual update on the search tree, over a thread's columns
// (minv is reset by the next search).
__device__ __forceinline__ void jv_wide_flush(const JvWideState& s, int n, int t0, int stride,
                                              float delta) {
  for (int j = t0; j <= n; j += stride) {
    float4 x = s.col[j];
    if (x.y != x.y) {
      x.x = x.x - delta;
      x.z = x.z + delta;
      s.col[j] = x;
    }
  }
}

// Augment along the predecessor chain back to the virtual column; the row's
// potential moves with it. One thread.
__device__ __forceinline__ void jv_wide_augment(const JvWideState& s, int n, int j0) {
  int j = j0;
  for (int step = 0; j != n && step <= n + 1; ++step) {
    const int jp = __float_as_int(s.col[j].w);
    s.roc[j] = s.roc[jp];
    s.col[j].z = s.col[jp].z;
    j = jp;
  }
}

// The lexicographic (value, column) minimum of a row over the warp's column
// stripes j = lane + 32 k: (first argmin, minimum).
template <class Cost>
__device__ __forceinline__ int jv_wide_row_min(const Cost& cost, int i, int n, float& umin) {
  const unsigned full = 0xffffffffu;
  const int t = threadIdx.x & 31;
  float best = kInf;
  int best_j = n;
#pragma unroll 16
  for (int j = t; j < n; j += 32) {
    const float c = cost(i, j);
    const bool lower = c < best;
    best = lower ? c : best;
    best_j = lower ? j : best_j;
  }
  const unsigned key = ordered_key(best);
  const unsigned least = __reduce_min_sync(full, key);
  const int amin = static_cast<int>(
      __reduce_min_sync(full, key == least ? static_cast<unsigned>(best_j) : ~0u));
  umin = __shfl_sync(full, best, amin & 31);
  return amin;
}

// The block routine's meeting place: each warp's winner of a search step,
// double-buffered so one barrier per step suffices.
struct JvPosts {
  unsigned key[2][kMaxBlockWarps];
  unsigned col[2][kMaxBlockWarps];
  float val[2][kMaxBlockWarps];
};

// Solve the assignment of rows [0, n_rows) to columns [0, n) in one block of
// T = 32 jv_block_warps(n) threads (blockDim.x), 1 <= n_rows <= n,
// kMaxNReg < n <= kMaxNWide, the state in `s`; `cost` and `row_active` as for
// jv_solve_warp. Thread t owns columns t + T k; one block barrier per search
// step. On return (after a block barrier) s.roc[j] holds the row matched to
// column j, or -1. All threads of the block must call it.
template <class Cost, class Mask>
__device__ void jv_solve_block_smem(const Cost& cost, int n, int n_rows,
                                    const Mask* row_active, const JvWideState& s,
                                    JvPosts& post) {
  constexpr int kChunk = 4;
  const unsigned full = 0xffffffffu;
  const int t = threadIdx.x;
  const int T = blockDim.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int warps = T >> 5;
  const int slots = (n + T) / T;  // columns j <= n per thread, rounded up

  for (int j = t; j <= n; j += T) {
    s.roc[j] = n_rows;  // no claim yet
    s.col[j] = make_float4(0.0f, kInf, 0.0f, __int_as_float(n));
  }
  __syncthreads();
  // Row reduction, a row per warp at a time; the lowest claiming row wins a
  // column (atomicMin). Each row's argmin waits in its way slot.
  for (int i = warp; i < n_rows; i += warps) {
    float umin;
    const int amin = jv_wide_row_min(cost, i, n, umin);
    if (lane == 0) {
      s.u[i] = umin;
      const bool act = row_active == nullptr || row_active[i] != 0;
      if (act && amin < n) atomicMin(&s.roc[amin], i);
      s.col[i].w = __int_as_float(amin);
    }
  }
  __syncthreads();
  for (int i = t; i < n_rows; i += T) {
    const bool act = row_active == nullptr || row_active[i] != 0;
    const int a = __float_as_int(s.col[i].w);
    s.pend[i] = act && !(a < n && s.roc[a] == i);
  }
  __syncthreads();
  for (int j = t; j <= n; j += T) {
    const int w = s.roc[j];
    if (w >= n_rows) {
      s.roc[j] = -1;
    } else {
      s.col[j].z = s.u[w];
    }
  }
  __syncthreads();

  int parity = 0;
  for (int r = 0; r < n_rows; ++r) {
    if (!s.pend[r]) continue;
    if (t == n % T) {  // the virtual column holds row r
      s.roc[n] = r;
      s.col[n].z = s.u[r];
    }
    __syncthreads();
    int j0 = n;
    float delta = 0.0f;
    for (int step = 0; step <= n + 1; ++step) {
      const int i0 = s.roc[j0];
      const float u_i0 = s.col[j0].z;
      if (i0 < 0) break;
      float best = kInf;
      int best_j = t;
      if (step == 0) {
        jv_wide_pass<true, kChunk>(cost, s, n, t, T, slots, i0, u_i0, j0, delta, best, best_j);
      } else {
        jv_wide_pass<false, kChunk>(cost, s, n, t, T, slots, i0, u_i0, j0, delta, best, best_j);
      }
      // The lexicographic argmin within the warp, posted; then over the
      // posts, by every warp alike. delta is the winning column's value.
      unsigned key = ordered_key(best);
      unsigned least = __reduce_min_sync(full, key);
      unsigned col = __reduce_min_sync(full, key == least ? static_cast<unsigned>(best_j) : ~0u);
      float val = __shfl_sync(full, best, col & 31);
      if (lane == 0) {
        post.key[parity][warp] = least;
        post.col[parity][warp] = col;
        post.val[parity][warp] = val;
      }
      __syncthreads();
      const bool mine = lane < warps;
      key = mine ? post.key[parity][lane] : ~0u;
      col = mine ? post.col[parity][lane] : ~0u;
      val = mine ? post.val[parity][lane] : 0.0f;
      least = __reduce_min_sync(full, key);
      const unsigned j1 = __reduce_min_sync(full, key == least ? col : ~0u);
      const unsigned holder = __ballot_sync(full, key == least && col == j1);
      delta = __shfl_sync(full, val, __ffs(holder) - 1);
      parity ^= 1;
      j0 = static_cast<int>(j1);
    }
    jv_wide_flush(s, n, t, T, delta);
    __syncthreads();
    if (t == 0) jv_wide_augment(s, n, j0);
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
