// K2: the greedy cross-view association fold, one frame per block.
//
// Replaces the TPU kernel smartedgesensor3dhumanpose_tpu/ops/
// association_pallas.py::_assoc_kernel (launched by _assoc_call): for each
// camera in order, (1) build the hypothesis x detection mean epipolar cost
// and veto votes from the pair-packed table through the hypotheses'
// observation identities, (2) apply the detection and gate masks, (3) run
// the ambiguity test and, when it fires, a JV solve (jv.cuh) of the clipped
// and tie-broken cost with detections as rows and hypotheses as columns,
// (4) extend or spawn hypotheses up to h_cap and count the drops.
//
// What bounds it on the card: latency. The fold is C dependent camera
// steps, each a few hundred gathered loads and at most one JV walk; at the
// demo shapes (16 cameras, 8 detections, 16 hypotheses) it touches ~130 KB
// of table and does no arithmetic worth a tensor core. The first version of
// this kernel (0.23 ms per demo frame on an H100 80GB HBM3, 700 W) spent its
// time in step (1): one lane per hypothesis, 16 of 128 lanes busy, each
// walking dp x C = 128 serial iterations, a shared-memory load and a branch
// before each dependent table load. This design takes 0.044 ms there
// (2.8 µs per camera step, a JV solve adding well under 1 µs): what is left
// is each step's chain of block barriers and shared-memory rounds. At the
// scaled shape (C 64, D 32) one 256 KB slice does not fit on chip, the
// gathers go to L2, and a chunk of 4 frames takes 1.8 ms.
//
// The design: the whole fold runs in one block with no host round trip; the
// hypothesis state det_slot [C, 128], the frame's confident-voter flags and
// usable detections, the per-step cost and mask tiles and the JV state stay
// in shared memory for the whole fold. Step (1) maps lanes to (hypothesis,
// detection) pairs (strided when h_cap x dp > 128; exactly 128 at the demo
// shape) and issues a pair's table loads of up to kChunk earlier cameras
// together, predicated, summing them afterwards in camera order. Where two
// of them fit (ops/association.py::fold_plan: 8 KB at the demo shape), the
// camera's whole table slice [C*D, D] is copied into shared memory with a
// TMA bulk copy (bulk_copy.cuh) during the previous camera step, so the
// gathers read shared memory; otherwise they read the table in device
// memory (L2) through the same code.
//
// Differences from the TPU kernel, none of them semantic:
//  * the one-hot MXU product that assembled the costs becomes a direct
//    gather and sum over each hypothesis' observed (camera, detection)
//    pairs, in IEEE fp32 (exact selection, no tensor cores; the bf16 form
//    of that product flipped near-gate decisions on the TPU);
//  * the kernel reads fusion's native table layout [C, C*D, D], so the
//    transpose and 8-padding of _pack_inputs are gone;
//  * one frame per block instead of eight frames per sublane group, so the
//    JV runs only for the frames that need it.
// Kept exactly: the sums over observations in camera order, with every
// operation rounded on its own (--fmad=false); the detection-major
// orientation of the solve with n = max(h_cap, dp) columns and dp = D
// rounded up to a multiple of 8 rows, row_active = this camera's usable
// detections only when h_cap >= dp, the _TIE_EPS (d+1)(h+1) tie-break above
// _CLIP, the 2 _CLIP tier for unusable detection rows, the mask-derived
// assignment when no solve is needed, and the spawn order (solver spawns in
// hypothesis order, then unhandled detections in detection order, two block
// prefix scans).
//
// Inputs: ctab [B, C, C*D, D] float32 (-1 where a pair is unusable),
// conf [B, C*D] float32 confident-voter flags (0/1), dok [B, C, D] int32.
// Outputs: det_slot [B, h_cap, C] int32 (-1 = camera not observed),
// counts [B, 2] int32 (n_hyp, n_dropped).

#include <cstdint>

#include <cuda_runtime.h>

#include "bulk_copy.cuh"
#include "jv.cuh"

namespace {

constexpr float kClip = 1.0e3f;   // fusion._ASSIGN_COST_CLIP
constexpr float kTieEps = 1.0e-3f;  // fusion._SOLVER_TIE_EPS
constexpr int kChunk = 16;  // earlier cameras whose table loads go out together

struct FoldParams {
  int cams, dets, dp, h_cap, n_jv, prefetch;
  float gate, max_cost;
};

__host__ __device__ inline int padded_dets(int dets) {
  return dets <= 8 ? 8 : (dets + 7) / 8 * 8;
}

__host__ __device__ inline int slice_bytes(int cams, int dets) {
  return 4 * cams * dets * dets;
}

// Dynamic shared memory, in this order: the two table slices (prefetch
// only), det_slot [C][128] int, conf [C*D] float, dok [C*D] int, the JV cost
// [dp][n_jv] float and the feasibility mask [dp][128] bytes.
__host__ __device__ inline int fold_smem_bytes(int cams, int dets, int h_cap,
                                               int prefetch) {
  const int dp = padded_dets(dets);
  const int n_jv = h_cap > dp ? h_cap : dp;
  return (prefetch ? 2 * slice_bytes(cams, dets) : 0) + cams * ses3d::kLanes * 4 +
         2 * cams * dets * 4 + dp * n_jv * 4 + dp * ses3d::kLanes;
}

struct SharedCost {
  const float* base;
  int ld;
  __device__ float operator()(int i, int j) const { return base[i * ld + j]; }
};

// kWide: the JV instance for n_jv >= 32 columns (jv.cuh::jv_solve_block).
template <bool kWide>
__global__ void __launch_bounds__(ses3d::kLanes)
association_fold_kernel(const float* __restrict__ ctab,
                        const float* __restrict__ conf,
                        const int* __restrict__ dok, int* __restrict__ det_slot,
                        int* __restrict__ counts, FoldParams p) {
  using ses3d::kLanes;
  __shared__ ses3d::JvShared s;
  __shared__ int dok_c[kLanes];     // this camera's usable detections (dp rows)
  __shared__ int n_obs[kLanes];     // cameras each hypothesis has observed
  __shared__ int handled[kLanes];   // detection taken by an assigned hypothesis
  __shared__ int dts1[kLanes];      // slot a solver-spawned detection lands in
  __shared__ int slot_det[kLanes];  // detection spawning into each slot
  __shared__ int warp_sums[kLanes / 32];
  __shared__ uint64_t slice_ready[2];

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int C = p.cams, D = p.dets, dp = p.dp, h_cap = p.h_cap, n_jv = p.n_jv;
  const int x_len = C * D;
  const int slice = x_len * D;  // floats of one camera's table slice
  extern __shared__ float4 dyn[];
  float* slices = reinterpret_cast<float*>(dyn);                // [2][slice]
  int* ds = reinterpret_cast<int*>(slices + (p.prefetch ? 2 * slice : 0));  // [C][128]
  float* conf_s = reinterpret_cast<float*>(ds + C * kLanes);   // [C*D]
  int* dok_s = reinterpret_cast<int*>(conf_s + x_len);         // [C*D]
  float* jvc = reinterpret_cast<float*>(dok_s + x_len);        // [dp][n_jv]
  unsigned char* mask = reinterpret_cast<unsigned char*>(jvc + dp * n_jv);  // [dp][128]

  const float* ct_b = ctab + static_cast<size_t>(b) * C * slice;
  if (p.prefetch && t == 0) {
    ses3d::mbar_init(&slice_ready[0]);
    ses3d::mbar_init(&slice_ready[1]);
  }
  __syncthreads();
  if (p.prefetch && t == 0) {
    ses3d::bulk_load(slices, ct_b, 4 * slice, &slice_ready[0]);
  }
  for (int c = 0; c < C; ++c) ds[c * kLanes + t] = -1;
  for (int i = t; i < x_len; i += kLanes) {
    conf_s[i] = conf[static_cast<size_t>(b) * x_len + i];
    dok_s[i] = dok[static_cast<size_t>(b) * x_len + i] != 0;
  }
  // Solver columns past h_cap (when dp > h_cap) stay 0 for the whole fold.
  for (int i = t; i < dp * (n_jv - h_cap); i += kLanes) {
    const int d = i / (n_jv - h_cap);
    jvc[d * n_jv + h_cap + (i - d * (n_jv - h_cap))] = 0.0f;
  }
  n_obs[t] = 0;
  int n_hyp = 0;
  int n_dropped = 0;
  const int h = t;  // hypothesis lane (steps 3-4)
  const bool live = h < h_cap;
  __syncthreads();

  for (int c = 0; c < C; ++c) {
    const float* ct_c;
    if (p.prefetch) {
      // Slice c has landed; slice c + 1 lands while this step runs.
      ses3d::mbar_wait(&slice_ready[c & 1], (c >> 1) & 1);
      ct_c = slices + (c & 1) * slice;
      if (t == 0 && c + 1 < C) {
        ses3d::bulk_load(slices + ((c + 1) & 1) * slice, ct_b + static_cast<size_t>(c + 1) * slice,
                         4 * slice, &slice_ready[(c + 1) & 1]);
      }
    } else {
      ct_c = ct_b + static_cast<size_t>(c) * slice;
    }
    dok_c[t] = (t < D) ? dok_s[c * D + t] : 0;
    __syncthreads();

    // (1)-(2) cost, veto and feasibility of each (hypothesis, detection
    // row) pair against this camera. Only cameras c1 < c can have been
    // observed: a pair's loads of a chunk of them go out together, then
    // are summed in camera order.
    for (int i = t; i < h_cap * dp; i += kLanes) {
      const int hh = i / dp;
      const int d = i - hh * dp;
      float total = 0.0f, n_used = 0.0f, votes_all = 0.0f, votes_conf = 0.0f;
      if (d < D) {
        for (int c0 = 0; c0 < c; c0 += kChunk) {
          float v[kChunk];
          float cf[kChunk];
          bool on[kChunk];
#pragma unroll
          for (int u = 0; u < kChunk; ++u) {
            const int c1 = c0 + u;
            const int s1 = c1 < c ? ds[c1 * kLanes + hh] : -1;
            on[u] = s1 >= 0;
            const int x = c1 * D + (on[u] ? s1 : 0);
            v[u] = on[u] ? ct_c[x * D + d] : 0.0f;
            cf[u] = on[u] ? conf_s[x] : 0.0f;
          }
#pragma unroll
          for (int u = 0; u < kChunk; ++u) {
            if (!on[u]) continue;
            if (v[u] >= 0.0f) {
              total = total + v[u];
              n_used = n_used + 1.0f;
            }
            if (v[u] > p.gate) {
              votes_all = votes_all + 1.0f;
              votes_conf = votes_conf + cf[u];
            }
          }
        }
      }
      const int n_obs_h = n_obs[hh];
      const float n_obs_f = fmaxf(static_cast<float>(n_obs_h), 1.0f);
      const float tolerance = 1.0f - 1.0f / (2.0f * n_obs_f);
      float cost = total / fmaxf(n_used, 1.0f);
      const float n_votes = (n_obs_h == 1) ? votes_all : votes_conf;
      bool veto = n_votes / n_obs_f > tolerance;
      if (n_used < 0.5f || n_obs_h == 0 || !dok_c[d]) {
        cost = p.max_cost;
        veto = true;
      }
      mask[d * kLanes + hh] = !veto && cost < p.gate;
      const float clipped = fminf(cost, kClip);
      const float tie = (kTieEps * static_cast<float>(d + 1)) *
                        static_cast<float>(hh + 1);
      float jv_cost = clipped >= kClip ? kClip + tie : clipped;
      if (!dok_c[d]) jv_cost = 2.0f * kClip;
      jvc[d * n_jv + hh] = jv_cost;
    }
    __syncthreads();

    // (3) ambiguity test (reference :628): a detection or a hypothesis
    // with more than one feasible pairing.
    int per_hyp = 0;
    int per_det = 0;
    if (live) {
      for (int d = 0; d < dp; ++d) per_hyp += mask[d * kLanes + h];
    }
    if (t < dp) {
      for (int hh = 0; hh < h_cap; ++hh) per_det += mask[t * kLanes + hh];
    }
    const bool need = __syncthreads_or(per_hyp > 1 || per_det > 1);
    int a = -1;  // detection assigned to hypothesis h
    if (need) {
      ses3d::jv_solve_block<kWide>(SharedCost{jvc, n_jv}, n_jv, dp,
                                   h_cap >= dp ? dok_c : nullptr, s);
      const int r = s.roc[h];
      if (live && r >= 0 && r < D) a = r;
    } else if (live) {
      for (int d = 0; d < dp; ++d) {
        if (mask[d * kLanes + h]) {
          a = d;
          break;
        }
      }
    }

    // (4) interpret the assignment (reference :636-673).
    const bool assigned_valid = a >= 0 && dok_c[a];
    const bool pair_ok = a >= 0 && mask[a * kLanes + h];
    const bool extend = assigned_valid && pair_ok;
    const bool spawn_from_hyp = assigned_valid && !pair_ok;
    handled[t] = 0;
    dts1[t] = -1;
    slot_det[t] = -1;
    __syncthreads();
    if (assigned_valid) handled[a] = 1;
    __syncthreads();
    const bool spawn_unhandled = t < dp && dok_c[t] && !handled[t];

    int total1, total2;
    const int cum1 = ses3d::block_inclusive_scan(spawn_from_hyp ? 1 : 0, warp_sums, total1);
    const int n1 = n_hyp + total1;
    const int cum2 = ses3d::block_inclusive_scan(spawn_unhandled ? 1 : 0, warp_sums, total2);
    const int n2 = n1 + total2;
    if (spawn_from_hyp) dts1[a] = n_hyp + cum1 - 1;
    __syncthreads();
    if (t < dp) {
      const int slot = spawn_unhandled ? n1 + cum2 - 1 : dts1[t];
      if (slot >= 0 && slot < h_cap) slot_det[slot] = t;
    }
    __syncthreads();
    const int obs = extend ? a : slot_det[h];
    ds[c * kLanes + h] = obs;
    n_obs[h] += obs >= 0;
    n_hyp = n2 < h_cap ? n2 : h_cap;
    n_dropped += n2 > h_cap ? n2 - h_cap : 0;
    __syncthreads();
  }

  int* out_b = det_slot + static_cast<size_t>(b) * h_cap * C;
  for (int i = t; i < h_cap * C; i += kLanes) {
    out_b[i] = ds[(i % C) * kLanes + i / C];
  }
  if (t == 0) {
    counts[2 * b] = n_hyp;
    counts[2 * b + 1] = n_dropped;
  }
}

}  // namespace

// The dynamic shared memory of a plan, as the wrapper must compute it.
extern "C" int ses3d_association_fold_smem_bytes(int cams, int dets, int h_cap,
                                                  int prefetch) {
  return fold_smem_bytes(cams, dets, h_cap, prefetch);
}

// Returns cudaErrorInvalidValue, and launches nothing, for a plan whose byte
// count is not this file's or that does not fit next to the kernel's static
// shared memory, or a prefetch the table's alignment does not allow.
extern "C" int ses3d_association_fold(const float* ctab, const float* conf,
                                      const int* dok, int* det_slot,
                                      int* counts, int batch, int cams,
                                      int dets, int h_cap, int prefetch,
                                      int smem_bytes, float gate,
                                      float max_cost, void* stream) {
  FoldParams p;
  p.cams = cams;
  p.dets = dets;
  p.dp = padded_dets(dets);
  p.h_cap = h_cap;
  p.n_jv = h_cap > p.dp ? h_cap : p.dp;
  p.prefetch = prefetch != 0;
  p.gate = gate;
  p.max_cost = max_cost;
  if (cams < 1 || dets < 1 || h_cap < 1 || p.n_jv > ses3d::kMaxN ||
      smem_bytes != fold_smem_bytes(cams, dets, h_cap, p.prefetch) ||
      (p.prefetch && (slice_bytes(cams, dets) % 16 != 0 ||
                      reinterpret_cast<uintptr_t>(ctab) % 16 != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto kernel =
      p.n_jv >= 32 ? association_fold_kernel<true> : association_fold_kernel<false>;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0;
  int optin = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (static_cast<size_t>(smem_bytes) + attr.sharedSizeBytes > static_cast<size_t>(optin)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch > 0) {
    kernel<<<batch, ses3d::kLanes, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
        ctab, conf, dok, det_slot, counts, p);
  }
  return static_cast<int>(cudaGetLastError());
}
