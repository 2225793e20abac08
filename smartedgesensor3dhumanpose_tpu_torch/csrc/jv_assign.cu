// K1: batched rectangular linear-sum assignment, one warp per problem (one
// block per problem past 120 columns).
//
// Replaces the TPU kernels of smartedgesensor3dhumanpose_tpu/ops/
// hungarian_pallas.py: _jv_kernel (launched by _solve_padded, the single
// problem with a row_active mask that tracking.step solves every frame) and
// _jv_kernel_batched (_solve_padded_batched, the batched launch). Both are
// this one kernel, one warp per problem, several problems per block.
//
// What bounds it on the card: the latency of the solver's dependent steps
// (see jv.cuh); a 16 x 24 tracker problem moves about 2 KB. The design
// answers that by keeping every step on chip and every lane busy:
//  * the warp first copies its problem's R x C cost into shared memory with
//    coalesced loads (16-byte vectors where the pointer and C allow), at an
//    odd row stride, so the lanes that scan 32 different rows in the row
//    reduction hit 32 different banks; dummy columns (R > C) read as zero by
//    predicate and take no space;
//  * the solve (jv.cuh::jv_solve_warp) keeps its state in registers and
//    synchronises within the warp only (shuffles, warp reductions,
//    __syncwarp): there is no block barrier in K1;
//  * the inversion to col_of_row goes through the warp's own shared memory.
// A block holds up to kMaxPerBlock problems, one per warp (one per SM
// sub-partition), as far as their tiles fit the block's shared memory.
//
// Past 120 columns the warp routine has no register slots left: a problem
// of kMaxN < n <= kMaxNWide columns takes a block of its own and the wide
// routine (jv.cuh::jv_solve_shared), which keeps the solver state in shared
// memory and reads the cost rows from device memory
// (jv_assign_wide_kernel).
//
// Contract (hungarian.py:179-205): cost [B, R, C] float32, row-major; the
// problem is square-padded to n = max(R, C) <= kMaxNWide with zero-cost dummy
// columns (R > C); rows [0, R) are matched, skipping rows whose row_active
// byte is 0 (row_active [B, R] bool, or null for all rows). Output
// col_of_row [B, R] int32, -1 for unassigned rows and for rows matched to a
// dummy column. The shared-memory plan (problems per block, bytes) comes
// from the wrapper (ops/hungarian.py::jv_plan) and is checked here.

#include <cstdint>

#include <cuda_runtime.h>

#include "jv.cuh"

namespace {

constexpr int kMaxPerBlock = 4;          // warps (problems) per block
constexpr int kDefaultSmem = 48 * 1024;  // above this, the opt-in is needed

// Words of one staged cost row: the smallest odd count >= cols.
__host__ __device__ inline int tile_stride(int cols) { return cols | 1; }

// Shared memory of one problem: its staged cost tile, then one int per
// column slot for the claims and the inverse map.
__host__ __device__ inline int problem_bytes(int rows, int cols) {
  const int n = rows > cols ? rows : cols;
  return 4 * (rows * tile_stride(cols) + 32 * ses3d::jv_slots(n));
}

struct TileCost {
  const float* tile;
  int stride, cols;
  __device__ float operator()(int i, int j) const {
    return j < cols ? tile[i * stride + j] : 0.0f;
  }
};

template <int S>
__global__ void __launch_bounds__(32 * kMaxPerBlock)
jv_assign_kernel(const float* __restrict__ cost,
                 const unsigned char* __restrict__ row_active,
                 int* __restrict__ col_of_row, int batch, int rows, int cols,
                 int per_block) {
  extern __shared__ float4 dyn[];
  const int w = threadIdx.x >> 5;
  const int t = threadIdx.x & 31;
  const int b = blockIdx.x * per_block + w;
  if (b >= batch) return;  // a whole warp; no block barrier follows
  const int n = rows > cols ? rows : cols;
  const int stride = tile_stride(cols);
  float* tile = reinterpret_cast<float*>(dyn) + w * (problem_bytes(rows, cols) / 4);
  int* scratch = reinterpret_cast<int*>(tile + rows * stride);

  // Stage the problem's cost rows, coalesced.
  const float* src = cost + static_cast<size_t>(b) * rows * cols;
  const int count = rows * cols;
  if (cols % 4 == 0 && reinterpret_cast<uintptr_t>(cost) % 16 == 0) {
    const float4* src4 = reinterpret_cast<const float4*>(src);
    for (int q = t; q < count / 4; q += 32) {
      const float4 x = src4[q];
      const int i = 4 * q / cols;
      float* dst = tile + i * stride + (4 * q - i * cols);
      dst[0] = x.x;
      dst[1] = x.y;
      dst[2] = x.z;
      dst[3] = x.w;
    }
  } else {
    for (int e = t; e < count; e += 32) {
      const int i = e / cols;
      tile[i * stride + (e - i * cols)] = src[e];
    }
  }
  __syncwarp();

  int roc[S];
  ses3d::jv_solve_warp<S>(
      TileCost{tile, stride, cols}, n, rows,
      row_active ? row_active + static_cast<size_t>(b) * rows : nullptr,
      scratch, roc);

  // Invert roc (row of column) into col_of_row through the scratch.
#pragma unroll
  for (int k = 0; k < S; ++k) {
    if (t + 32 * k < rows) scratch[t + 32 * k] = -1;
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int j = t + 32 * k;
    if (j < n && roc[k] >= 0 && roc[k] < rows) scratch[roc[k]] = j < cols ? j : -1;
  }
  __syncwarp();
  int* out = col_of_row + static_cast<size_t>(b) * rows;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    if (t + 32 * k < rows) out[t + 32 * k] = scratch[t + 32 * k];
  }
}

// The cost of problem b read from device memory; dummy columns are zero.
struct GlobalCost {
  const float* cost;
  int cols;
  __device__ float operator()(int i, int j) const {
    return j < cols ? cost[static_cast<size_t>(i) * cols + j] : 0.0f;
  }
};

// One problem of kMaxN < n <= kMaxNWide columns per block.
__global__ void __launch_bounds__(ses3d::kWideThreads)
jv_assign_wide_kernel(const float* __restrict__ cost,
                      const unsigned char* __restrict__ row_active,
                      int* __restrict__ col_of_row, int rows, int cols) {
  extern __shared__ float4 dyn[];
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int n = rows > cols ? rows : cols;
  const ses3d::JvWide s = ses3d::jv_wide_layout(dyn, n);
  ses3d::jv_solve_shared(
      GlobalCost{cost + static_cast<size_t>(b) * rows * cols, cols}, n, rows,
      row_active ? row_active + static_cast<size_t>(b) * rows : nullptr, s);
  // Invert roc (row of column) into col_of_row.
  int* out = col_of_row + static_cast<size_t>(b) * rows;
  for (int i = t; i < rows; i += ses3d::kWideThreads) out[i] = -1;
  __syncthreads();
  for (int j = t; j < n; j += ses3d::kWideThreads) {
    const int i = s.roc[j];
    if (i >= 0 && i < rows) out[i] = j < cols ? j : -1;
  }
}

cudaError_t launch_wide(const float* cost, const unsigned char* row_active,
                        int* col_of_row, int batch, int rows, int cols,
                        int smem_bytes, cudaStream_t stream) {
  if (smem_bytes > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        jv_assign_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return err;
  }
  jv_assign_wide_kernel<<<batch, ses3d::kWideThreads, smem_bytes, stream>>>(
      cost, row_active, col_of_row, rows, cols);
  return cudaGetLastError();
}

template <int S>
cudaError_t launch(const float* cost, const unsigned char* row_active,
                   int* col_of_row, int batch, int rows, int cols,
                   int per_block, int smem_bytes, cudaStream_t stream) {
  if (smem_bytes > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        jv_assign_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return err;
  }
  const int blocks = (batch + per_block - 1) / per_block;
  jv_assign_kernel<S><<<blocks, 32 * per_block, smem_bytes, stream>>>(
      cost, row_active, col_of_row, batch, rows, cols, per_block);
  return cudaGetLastError();
}

}  // namespace

// The dynamic shared memory of a plan, as the wrapper must compute it: the
// warp kernel's per_block tiles up to kMaxN columns, one wide state past it
// (per_block must be 1 there).
extern "C" int ses3d_jv_assign_smem_bytes(int rows, int cols, int per_block) {
  const int n = rows > cols ? rows : cols;
  if (n > ses3d::kMaxN) return per_block * ses3d::jv_wide_smem_bytes(n);
  return per_block * problem_bytes(rows, cols);
}

// Returns cudaErrorInvalidValue, and launches nothing, for a shape outside
// the contract or a plan whose byte count is not this file's.
extern "C" int ses3d_jv_assign(const float* cost,
                               const unsigned char* row_active,
                               int* col_of_row, int batch, int rows, int cols,
                               int per_block, int smem_bytes, void* stream) {
  const int n = rows > cols ? rows : cols;
  if (batch < 1 || rows < 1 || cols < 0 || n > ses3d::kMaxNWide ||
      per_block < 1 || per_block > kMaxPerBlock ||
      (n > ses3d::kMaxN && per_block != 1) ||
      smem_bytes != ses3d_jv_assign_smem_bytes(rows, cols, per_block)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  if (n > ses3d::kMaxN) {
    return static_cast<int>(
        launch_wide(cost, row_active, col_of_row, batch, rows, cols, smem_bytes, s));
  }
  cudaError_t err;
  switch (ses3d::jv_slots(n)) {
    case 1:
      err = launch<1>(cost, row_active, col_of_row, batch, rows, cols, per_block, smem_bytes, s);
      break;
    case 2:
      err = launch<2>(cost, row_active, col_of_row, batch, rows, cols, per_block, smem_bytes, s);
      break;
    case 3:
      err = launch<3>(cost, row_active, col_of_row, batch, rows, cols, per_block, smem_bytes, s);
      break;
    default:
      err = launch<4>(cost, row_active, col_of_row, batch, rows, cols, per_block, smem_bytes, s);
      break;
  }
  return static_cast<int>(err);
}
