// K1: batched rectangular linear-sum assignment, one warp per problem (one
// block per problem past 255 columns).
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
//    predicate and take no space. Where the tile does not fit the block
//    (full squares past ~235 columns) the cost is read from device memory;
//  * up to n = kMaxNReg = 255 columns the solve keeps its state in
//    registers (jv.cuh::jv_solve_warp, 1-8 slots) and synchronises within
//    the warp only (shuffles, warp reductions, __syncwarp): no block
//    barrier; the inversion to col_of_row goes through the warp's own
//    shared memory. A block holds up to kMaxPerBlock problems, one per warp
//    (one per SM sub-partition), as far as they fit its shared memory;
//  * past 255 columns, up to kMaxNWide, one block of ~n / 128 warps solves
//    a problem with its state in shared memory (jv.cuh::
//    jv_solve_block_smem), one block barrier per search step: one warp per
//    problem there measured slower at every width from 256 to 4096.
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
constexpr int kSmemLimit = 232448;       // an H100 block's shared memory

// Words of one staged cost row: the smallest odd count >= cols.
__host__ __device__ inline int tile_stride(int cols) { return cols | 1; }

// Shared memory of one problem without its tile: up to kMaxNReg columns one
// int per register column slot (the claims, then the inverse map), past it
// the block's posts and the solver state.
__host__ __device__ inline int fixed_bytes(int n) {
  return n <= ses3d::kMaxNReg
             ? 4 * 32 * ses3d::jv_slots(n)
             : static_cast<int>(sizeof(ses3d::JvPosts)) + ses3d::jv_wide_state_bytes(n);
}

// Bytes of the staged R x C tile.
__host__ __device__ inline int tile_bytes(int rows, int cols) {
  return 4 * rows * tile_stride(cols);
}

// The tile is staged where one problem with it fits a block.
__host__ __device__ inline bool staged(int rows, int cols) {
  const int n = rows > cols ? rows : cols;
  return fixed_bytes(n) + tile_bytes(rows, cols) <= kSmemLimit;
}

// Shared memory of one problem: its staged tile (if staged) and the fixed
// part. Up to kMaxNReg the tile comes first; past it (one problem per
// block) last.
__host__ __device__ inline int problem_bytes(int rows, int cols) {
  const int n = rows > cols ? rows : cols;
  return fixed_bytes(n) + (staged(rows, cols) ? tile_bytes(rows, cols) : 0);
}

struct TileCost {
  const float* tile;
  int stride, cols;
  __device__ float operator()(int i, int j) const {
    return j < cols ? tile[i * stride + j] : 0.0f;
  }
};

// The cost of one problem read from device memory; dummy columns are zero.
struct GlobalCost {
  const float* cost;
  int cols;
  __device__ float operator()(int i, int j) const {
    return j < cols ? cost[static_cast<size_t>(i) * cols + j] : 0.0f;
  }
};

// Copy a problem's rows x cols cost into the tile at `stride`, coalesced, by
// one warp (16-byte loads where `vec` says cols and the pointer allow).
__device__ __forceinline__ void stage_tile(const float* src, float* tile, int rows,
                                           int cols, int stride, bool vec) {
  const int t = threadIdx.x & 31;
  const int count = rows * cols;
  if (vec) {
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
}

// Up to kMaxNReg columns: the state in registers, S = jv_slots(n) slots;
// the tile staged (kStaged) or the cost read from device memory.
template <int S, bool kStaged>
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
  int* scratch = reinterpret_cast<int*>(tile + (kStaged ? rows * stride : 0));
  const float* src = cost + static_cast<size_t>(b) * rows * cols;
  const unsigned char* act = row_active ? row_active + static_cast<size_t>(b) * rows : nullptr;

  int roc[S];
  if constexpr (kStaged) {
    stage_tile(src, tile, rows, cols, stride,
               cols % 4 == 0 && reinterpret_cast<uintptr_t>(cost) % 16 == 0);
    ses3d::jv_solve_warp<S>(TileCost{tile, stride, cols}, n, rows, act, scratch, roc);
  } else {
    ses3d::jv_solve_warp<S>(GlobalCost{src, cols}, n, rows, act, scratch, roc);
  }

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

// Past kMaxNReg columns: one problem per block of jv_block_warps(n) warps,
// the posts, then the state, then the tile (kStaged) in shared memory.
template <bool kStaged>
__global__ void __launch_bounds__(32 * ses3d::kMaxBlockWarps)
jv_assign_wide_kernel(const float* __restrict__ cost,
                      const unsigned char* __restrict__ row_active,
                      int* __restrict__ col_of_row, int batch, int rows, int cols,
                      int per_block) {
  extern __shared__ float4 dyn[];
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int n = rows > cols ? rows : cols;
  ses3d::JvPosts& post = *reinterpret_cast<ses3d::JvPosts*>(dyn);
  char* state = reinterpret_cast<char*>(dyn) + sizeof(ses3d::JvPosts);
  const ses3d::JvWideState s = ses3d::jv_wide_layout(state, n);
  const float* src = cost + static_cast<size_t>(b) * rows * cols;
  const unsigned char* act = row_active ? row_active + static_cast<size_t>(b) * rows : nullptr;
  if constexpr (kStaged) {
    const int stride = tile_stride(cols);
    float* tile = reinterpret_cast<float*>(state + ses3d::jv_wide_state_bytes(n));
    for (int e = t; e < rows * cols; e += blockDim.x) {
      const int i = e / cols;
      tile[i * stride + (e - i * cols)] = src[e];
    }
    __syncthreads();
    ses3d::jv_solve_block_smem(TileCost{tile, stride, cols}, n, rows, act, s, post);
  } else {
    ses3d::jv_solve_block_smem(GlobalCost{src, cols}, n, rows, act, s, post);
  }
  // Invert roc (row of column) into col_of_row.
  int* out = col_of_row + static_cast<size_t>(b) * rows;
  for (int i = t; i < rows; i += blockDim.x) out[i] = -1;
  __syncthreads();
  for (int j = t; j < n; j += blockDim.x) {
    const int i = s.roc[j];
    if (i >= 0 && i < rows) out[i] = j < cols ? j : -1;
  }
}

template <class Kernel>
cudaError_t launch(Kernel kernel, const float* cost, const unsigned char* row_active,
                   int* col_of_row, int batch, int rows, int cols,
                   int per_block, int smem_bytes, cudaStream_t stream) {
  if (smem_bytes > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
  }
  const int n = rows > cols ? rows : cols;
  const int blocks = (batch + per_block - 1) / per_block;
  const int threads = n > ses3d::kMaxNReg ? 32 * ses3d::jv_block_warps(n) : 32 * per_block;
  kernel<<<blocks, threads, smem_bytes, stream>>>(
      cost, row_active, col_of_row, batch, rows, cols, per_block);
  return cudaGetLastError();
}

// The register routine's instance for S slots, staged or not. Up to 7
// slots (n <= 223) one problem's tile always fits a block (223 x 223 is
// 199 KB), so only 8 slots have an instance that reads device memory.
template <int S>
auto* register_kernel(bool tile) {
  if constexpr (S < 8) {
    return &jv_assign_kernel<S, true>;
  } else {
    return tile ? &jv_assign_kernel<S, true> : &jv_assign_kernel<S, false>;
  }
}

}  // namespace

// The dynamic shared memory of a plan, as the wrapper must compute it:
// per_block problems, each its tile where it fits and the routine's fixed
// part (ops/hungarian.py::jv_plan).
extern "C" int ses3d_jv_assign_smem_bytes(int rows, int cols, int per_block) {
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
      (n > ses3d::kMaxNReg && per_block != 1) ||
      smem_bytes != ses3d_jv_assign_smem_bytes(rows, cols, per_block) ||
      smem_bytes > kSmemLimit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const bool tile = staged(rows, cols);
  const auto go = [&](auto kernel) {
    return static_cast<int>(launch(kernel, cost, row_active, col_of_row, batch, rows,
                                   cols, per_block, smem_bytes, s));
  };
  if (n > ses3d::kMaxNReg) {
    return tile ? go(&jv_assign_wide_kernel<true>) : go(&jv_assign_wide_kernel<false>);
  }
  switch (ses3d::jv_slots(n)) {
    case 1: return go(register_kernel<1>(tile));
    case 2: return go(register_kernel<2>(tile));
    case 3: return go(register_kernel<3>(tile));
    case 4: return go(register_kernel<4>(tile));
    case 5: return go(register_kernel<5>(tile));
    case 6: return go(register_kernel<6>(tile));
    case 7: return go(register_kernel<7>(tile));
    default: return go(register_kernel<8>(tile));
  }
}
