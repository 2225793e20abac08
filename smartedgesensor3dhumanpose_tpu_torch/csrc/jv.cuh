// Jonker-Volgenant min-cost assignment as a block-wide __device__ routine.
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
// of n lanes followed by one block-wide argmin, then an augmenting walk of
// at most n + 1 steps. The bytes (one cost row per step) and the flops are
// thousands of times below the card's bandwidth and arithmetic rate; the
// time is the latency of the dependent steps.
//
// Design: one thread block of 128 threads per problem, one thread per
// column lane (and per row lane for the row potentials). The whole solver
// state (u, v, roc, minv, way, used, tree) lives in shared memory; a step is
// one relaxation per thread, a warp-shuffle argmin plus one shared-memory
// pass across the four warps, and one barrier. Both data-dependent loops run
// inside the block, with the n + 1 step backstop of the TPU kernel, so no
// step goes back to the host. The TPU kernel's 8-sublane problem packing and
// scalar-only loop carries were Mosaic limits and are not carried over.
//
// Semantics (reproduced exactly, including every tie rule):
//  * row reduction: u[i] = min_j cost(i, j); each active row i < n_rows is
//    pre-assigned to its first argmin column, the lowest claiming row
//    winning a contested column;
//  * the augmenting search runs only for rows still free, skipping rows
//    with row_active == 0; delta ties go to the lowest column;
//  * roc[j] = row matched to column j (-1 = free) is left in shared memory.
//
// Arithmetic is float32 with every operation rounded on its own (the build
// passes --fmad=false), in the order of the plain PyTorch version
// (ops/hungarian.py::_jv_plain), so the two agree bit for bit.

#pragma once

#include <cuda_runtime.h>

namespace ses3d {

constexpr int kLanes = 128;   // threads per block: one per column lane
constexpr int kMaxN = 120;    // columns + the virtual column must fit the lanes
constexpr float kInf = 3.0e38f;

struct JvShared {
  float u[kLanes];     // row potentials, row i at lane i
  float v[kLanes];     // column potentials (+ the virtual column n)
  float minv[kLanes];  // best reduced cost reaching each column
  int roc[kLanes];     // row matched to each column; roc[n] = row being placed
  int way[kLanes];     // predecessor column on the search tree
  int used[kLanes];    // column on the search tree
  int tree[kLanes];    // row on the search tree
  int aux[kLanes];     // scratch of the caller (K1: the inverse map)
  unsigned assigned[kLanes / 32];  // rows matched by the row reduction
  float red_val[2][kLanes / 32];   // argmin partials, double-buffered
  int red_idx[2][kLanes / 32];
};

// Block-wide lexicographic min of (val, idx): the lowest idx among the
// minimal values. All 128 threads must call it. One barrier: partials go
// to buffer `buf`, so a caller that alternates buffers needs one barrier of
// its own between two calls, not one inside.
__device__ inline void block_argmin(float val, int idx, JvShared& s, int buf,
                                    float& out_val, int& out_idx) {
  const unsigned full = 0xffffffffu;
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(full, val, off);
    const int oi = __shfl_down_sync(full, idx, off);
    if (ov < val || (ov == val && oi < idx)) {
      val = ov;
      idx = oi;
    }
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    s.red_val[buf][warp] = val;
    s.red_idx[buf][warp] = idx;
  }
  __syncthreads();
  float bv = s.red_val[buf][0];
  int bi = s.red_idx[buf][0];
  for (int w = 1; w < kLanes / 32; ++w) {
    const float wv = s.red_val[buf][w];
    const int wi = s.red_idx[buf][w];
    if (wv < bv || (wv == bv && wi < bi)) {
      bv = wv;
      bi = wi;
    }
  }
  out_val = bv;
  out_idx = bi;
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

// jv_solve_block for n < 32 columns, run by warp 0 alone: lane j holds
// column j (the virtual column n included) and row j, the solver state
// lives in registers, and a search step is warp shuffles with no block
// barrier. The same operations in the same order as the block routine, so
// the same result.
template <class Cost>
__device__ void jv_solve_warp(const Cost& cost, int n, int n_rows,
                              const int* row_active, JvShared& s) {
  const int t = threadIdx.x;
  if (t < 32) {
    const unsigned full = 0xffffffffu;
    // Row reduction: lane i scans row i for its minimum and first argmin.
    float u = 0.0f;  // potential of row t
    int amin = -1;
    if (t < n_rows) {
      u = kInf;
      amin = n;
#pragma unroll 8
      for (int j = 0; j < n; ++j) {
        const float c = cost(t, j);
        if (c < u) {
          u = c;
          amin = j;
        }
      }
      if (row_active != nullptr && row_active[t] == 0) amin = -1;
    }
    // Column j goes to the lowest active row whose first argmin it is: the
    // lowest lane of each group of lanes with the same claim.
    s.roc[t] = -1;
    __syncwarp();
    const bool claims = amin >= 0 && amin < n;
    const unsigned group = __match_any_sync(full, claims ? amin : -1 - t);
    if (claims && (group & ((1u << t) - 1u)) == 0u) s.roc[amin] = t;
    __syncwarp();
    int roc = s.roc[t];  // row matched to column t
    const unsigned assigned = __reduce_or_sync(full, roc >= 0 ? 1u << roc : 0u);
    const bool active = t < n_rows && (row_active == nullptr || row_active[t] != 0);
    float v = 0.0f;  // potential of column t

    // Rows left free by the reduction, in order (see jv_solve_block).
    for (unsigned pending = __ballot_sync(full, active) & ~assigned; pending;
         pending &= pending - 1u) {
      const int r = __ffs(pending) - 1;
      float minv = kInf;
      int way = n;
      bool used = false;
      bool tree = false;
      if (t == n) roc = r;
      int j0 = n;
      for (int step = 0; step <= n + 1; ++step) {
        const int i0 = __shfl_sync(full, roc, j0);
        if (i0 < 0) break;
        used = used || t == j0;
        tree = tree || t == i0;
        const float u_i0 = __shfl_sync(full, u, i0);
        float masked = kInf;
        if (t < n) {
          const float cur = cost(i0, t) - u_i0 - v;
          if (cur < minv && !used) {
            minv = cur;
            way = j0;
          }
          if (!used) masked = minv;
        }
        float val = masked;
        int idx = t;
        for (int off = 16; off > 0; off >>= 1) {
          const float ov = __shfl_down_sync(full, val, off);
          const int oi = __shfl_down_sync(full, idx, off);
          if (ov < val || (ov == val && oi < idx)) {
            val = ov;
            idx = oi;
          }
        }
        const float delta = __shfl_sync(full, val, 0);
        if (tree) u = u + delta;
        if (used) v = v - delta;
        if (!used && t < n) minv = minv - delta;
        j0 = __shfl_sync(full, idx, 0);
      }
      // Augment along the predecessor chain back to the virtual column.
      int j = j0;
      for (int step = 0; j != n && step <= n + 1; ++step) {
        const int jp = __shfl_sync(full, way, j);
        const int from = __shfl_sync(full, roc, jp);
        if (t == j) roc = from;
        j = jp;
      }
    }
    s.roc[t] = roc;
  } else {
    s.roc[t] = -1;
  }
  __syncthreads();
}

// Solve the assignment of rows [0, n_rows) to columns [0, n), n <= kMaxN,
// n_rows <= n. `cost(i, j)` returns the float cost of row i, column j.
// `row_active` (may be null) is read as row_active[i] != 0. On return
// s.roc[j] holds the row matched to column j, or -1. All threads of the
// block must call it; blockDim.x == kLanes. Below 32 columns the solve
// runs in one warp (jv_solve_warp).
template <class Cost>
__device__ void jv_solve_block(const Cost& cost, int n, int n_rows,
                               const int* row_active, JvShared& s) {
  if (n < 32) {
    jv_solve_warp(cost, n, n_rows, row_active, s);
    return;
  }
  const int t = threadIdx.x;

  // Row reduction: thread t scans row t for its minimum and first argmin.
  float rowmin = 0.0f;
  int amin = -1;
  if (t < n_rows) {
    rowmin = kInf;
    amin = n;
    for (int j = 0; j < n; ++j) {
      const float c = cost(t, j);
      if (c < rowmin) {
        rowmin = c;
        amin = j;
      }
    }
    if (row_active != nullptr && row_active[t] == 0) amin = -1;
  }
  s.u[t] = rowmin;
  s.v[t] = 0.0f;
  s.roc[t] = n_rows;  // no claim yet
  if (t < kLanes / 32) s.assigned[t] = 0u;
  __syncthreads();
  // Column j goes to the lowest active row whose first argmin it is.
  if (amin >= 0 && amin < n) atomicMin(&s.roc[amin], t);
  __syncthreads();
  if (s.roc[t] == n_rows) s.roc[t] = -1;
  if (s.roc[t] >= 0) atomicOr(&s.assigned[s.roc[t] >> 5], 1u << (s.roc[t] & 31));
  __syncthreads();

  // Rows left free by the reduction, in order. An augmenting path only
  // moves matched rows between columns, so a row matched now is still
  // matched when the loop reaches it, and a free row is still free.
  for (int r = 0; r < n_rows; ++r) {
    if (row_active != nullptr && row_active[r] == 0) continue;
    if ((s.assigned[r >> 5] >> (r & 31)) & 1u) continue;

    // Dijkstra search from the virtual column n, which holds row r.
    s.minv[t] = kInf;
    s.way[t] = n;
    s.used[t] = 0;
    s.tree[t] = 0;
    if (t == n) s.roc[t] = r;
    __syncthreads();
    int j0 = n;
    for (int step = 0; s.roc[j0] >= 0 && step <= n + 1; ++step) {
      const int i0 = s.roc[j0];
      const int used_t = s.used[t] | (t == j0);
      const int tree_t = s.tree[t] | (t == i0);
      float minv_t = s.minv[t];
      float masked = kInf;
      if (t < n) {
        const float cur = cost(i0, t) - s.u[i0] - s.v[t];
        if (cur < minv_t && !used_t) {
          minv_t = cur;
          s.way[t] = j0;
        }
        if (!used_t) masked = minv_t;
      }
      float delta;
      int j1;
      block_argmin(masked, t, s, step & 1, delta, j1);
      if (tree_t) s.u[t] = s.u[t] + delta;
      if (used_t) s.v[t] = s.v[t] - delta;
      s.minv[t] = (!used_t && t < n) ? minv_t - delta : minv_t;
      s.used[t] = used_t;
      s.tree[t] = tree_t;
      j0 = j1;
      __syncthreads();
    }

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

}  // namespace ses3d
