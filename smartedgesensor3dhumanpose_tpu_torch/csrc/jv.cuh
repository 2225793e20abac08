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
  int aux[kLanes];     // first argmin column per row; then the inverse map
  float red_val[kLanes / 32];
  int red_idx[kLanes / 32];
};

// Block-wide lexicographic min of (val, idx): the lowest idx among the
// minimal values. All 128 threads must call it.
__device__ inline void block_argmin(float val, int idx, JvShared& s,
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
    s.red_val[warp] = val;
    s.red_idx[warp] = idx;
  }
  __syncthreads();
  float bv = s.red_val[0];
  int bi = s.red_idx[0];
  for (int w = 1; w < kLanes / 32; ++w) {
    const float wv = s.red_val[w];
    const int wi = s.red_idx[w];
    if (wv < bv || (wv == bv && wi < bi)) {
      bv = wv;
      bi = wi;
    }
  }
  out_val = bv;
  out_idx = bi;
  __syncthreads();
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

// Solve the assignment of rows [0, n_rows) to columns [0, n), n <= kMaxN,
// n_rows <= n. `cost(i, j)` returns the float cost of row i, column j.
// `row_active` (may be null) is read as row_active[i] != 0. On return
// s.roc[j] holds the row matched to column j, or -1. All threads of the
// block must call it; blockDim.x == kLanes.
template <class Cost>
__device__ void jv_solve_block(const Cost& cost, int n, int n_rows,
                               const int* row_active, JvShared& s) {
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
  s.aux[t] = amin;
  __syncthreads();
  // Column t goes to the lowest active row whose first argmin it is.
  int winner = -1;
  if (t < n) {
    for (int i = 0; i < n_rows; ++i) {
      if (s.aux[i] == t) {
        winner = i;
        break;
      }
    }
  }
  s.roc[t] = winner;
  __syncthreads();

  for (int r = 0; r < n_rows; ++r) {
    if (row_active != nullptr && row_active[r] == 0) continue;
    if (__syncthreads_or(t < n && s.roc[t] == r)) continue;

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
      block_argmin(masked, t, s, delta, j1);
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
