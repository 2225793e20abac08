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
// of table and does no arithmetic worth a tensor core. The design answers
// that by running the whole fold in one block with no host round trip: the
// hypothesis state det_slot [C, 128] (8 KB at C = 16), the per-step cost and
// mask tiles and the JV state stay in shared memory for the whole fold.
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
// Kept exactly: the detection-major orientation of the solve with
// n = max(h_cap, dp) columns and dp = D rounded up to a multiple of 8 rows,
// row_active = this camera's usable detections only when h_cap >= dp, the
// _TIE_EPS (d+1)(h+1) tie-break above _CLIP, the 2 _CLIP tier for unusable
// detection rows, the mask-derived assignment when no solve is needed, and
// the spawn order (solver spawns in hypothesis order, then unhandled
// detections in detection order, two block prefix scans).
//
// Inputs: ctab [B, C, C*D, D] float32 (-1 where a pair is unusable),
// conf [B, C*D] float32 confident-voter flags (0/1), dok [B, C, D] int32.
// Outputs: det_slot [B, h_cap, C] int32 (-1 = camera not observed),
// counts [B, 2] int32 (n_hyp, n_dropped).

#include <cuda_runtime.h>

#include "jv.cuh"

namespace {

constexpr float kClip = 1.0e3f;   // fusion._ASSIGN_COST_CLIP
constexpr float kTieEps = 1.0e-3f;  // fusion._SOLVER_TIE_EPS

struct FoldParams {
  int cams, dets, dp, h_cap, n_jv;
  float gate, max_cost;
};

struct SharedCost {
  const float* base;
  int ld;
  __device__ float operator()(int i, int j) const { return base[i * ld + j]; }
};

__global__ void __launch_bounds__(ses3d::kLanes)
association_fold_kernel(const float* __restrict__ ctab,
                        const float* __restrict__ conf,
                        const int* __restrict__ dok, int* __restrict__ det_slot,
                        int* __restrict__ counts, FoldParams p) {
  using ses3d::kLanes;
  __shared__ ses3d::JvShared s;
  __shared__ int dok_c[kLanes];     // this camera's usable detections (dp rows)
  __shared__ int handled[kLanes];   // detection taken by an assigned hypothesis
  __shared__ int dts1[kLanes];      // slot a solver-spawned detection lands in
  __shared__ int slot_det[kLanes];  // detection spawning into each slot
  __shared__ int warp_sums[kLanes / 32];
  extern __shared__ unsigned char dyn[];
  int* ds = reinterpret_cast<int*>(dyn);                      // [C][128]
  float* jvc = reinterpret_cast<float*>(ds + p.cams * kLanes);  // [dp][n_jv]
  unsigned char* mask =
      reinterpret_cast<unsigned char*>(jvc + p.dp * p.n_jv);  // [dp][128]

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int C = p.cams, D = p.dets, dp = p.dp, h_cap = p.h_cap;
  const size_t x_len = static_cast<size_t>(C) * D;
  const float* ct_b = ctab + static_cast<size_t>(b) * C * x_len * D;
  const float* conf_b = conf + static_cast<size_t>(b) * x_len;
  const int* dok_b = dok + static_cast<size_t>(b) * x_len;

  for (int c = 0; c < C; ++c) ds[c * kLanes + t] = -1;
  int n_hyp = 0;
  int n_dropped = 0;
  const int h = t;  // hypothesis lane
  const bool live = h < h_cap;

  for (int c = 0; c < C; ++c) {
    dok_c[t] = (t < D) ? (dok_b[c * D + t] != 0) : 0;
    __syncthreads();

    // (1)-(2) cost, veto and feasibility of hypothesis h against each
    // detection row d of camera c.
    int n_obs = 0;
    for (int c1 = 0; c1 < C; ++c1) n_obs += ds[c1 * kLanes + h] >= 0;
    const float n_obs_f = fmaxf(static_cast<float>(n_obs), 1.0f);
    const float tolerance = 1.0f - 1.0f / (2.0f * n_obs_f);
    const float* ct_c = ct_b + static_cast<size_t>(c) * x_len * D;
    int per_hyp = 0;
    for (int d = 0; d < dp; ++d) {
      float total = 0.0f, n_used = 0.0f, votes_all = 0.0f, votes_conf = 0.0f;
      if (live && d < D) {
        for (int c1 = 0; c1 < C; ++c1) {
          const int s1 = ds[c1 * kLanes + h];
          if (s1 < 0) continue;
          const int x = c1 * D + s1;
          const float v = ct_c[static_cast<size_t>(x) * D + d];
          if (v >= 0.0f) {
            total = total + v;
            n_used = n_used + 1.0f;
          }
          if (v > p.gate) {
            votes_all = votes_all + 1.0f;
            votes_conf = votes_conf + conf_b[x];
          }
        }
      }
      float cost = total / fmaxf(n_used, 1.0f);
      const float n_votes = (n_obs == 1) ? votes_all : votes_conf;
      bool veto = n_votes / n_obs_f > tolerance;
      if (n_used < 0.5f || n_obs == 0 || !dok_c[d]) {
        cost = p.max_cost;
        veto = true;
      }
      const bool m = !veto && cost < p.gate;
      mask[d * kLanes + h] = m;
      per_hyp += m;
      if (h < p.n_jv) {
        float v = 0.0f;
        if (live) {
          const float clipped = fminf(cost, kClip);
          const float tie = (kTieEps * static_cast<float>(d + 1)) *
                            static_cast<float>(h + 1);
          v = clipped >= kClip ? kClip + tie : clipped;
          if (!dok_c[d]) v = 2.0f * kClip;
        }
        jvc[d * p.n_jv + h] = v;
      }
    }
    __syncthreads();

    // (3) ambiguity test (reference :628): a detection or a hypothesis
    // with more than one feasible pairing.
    int per_det = 0;
    if (t < dp) {
      for (int hh = 0; hh < h_cap; ++hh) per_det += mask[t * kLanes + hh];
    }
    const bool need = __syncthreads_or(per_hyp > 1 || per_det > 1);
    int a = -1;  // detection assigned to hypothesis h
    if (need) {
      ses3d::jv_solve_block(SharedCost{jvc, p.n_jv}, p.n_jv, dp,
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
    ds[c * kLanes + h] = extend ? a : slot_det[h];
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

// Dynamic shared memory: det_slot [C][128] int, the JV cost [dp][n_jv]
// float and the feasibility mask [dp][128] bytes.
int fold_smem_bytes(int cams, int dp, int n_jv) {
  return cams * ses3d::kLanes * 4 + dp * n_jv * 4 + dp * ses3d::kLanes;
}

}  // namespace

extern "C" int ses3d_association_fold(const float* ctab, const float* conf,
                                      const int* dok, int* det_slot,
                                      int* counts, int batch, int cams,
                                      int dets, int h_cap, float gate,
                                      float max_cost, void* stream) {
  FoldParams p;
  p.cams = cams;
  p.dets = dets;
  p.dp = dets <= 8 ? 8 : (dets + 7) / 8 * 8;
  p.h_cap = h_cap;
  p.n_jv = h_cap > p.dp ? h_cap : p.dp;
  p.gate = gate;
  p.max_cost = max_cost;
  const int smem = fold_smem_bytes(cams, p.dp, p.n_jv);
  cudaError_t err = cudaFuncSetAttribute(
      association_fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch > 0) {
    association_fold_kernel<<<batch, ses3d::kLanes, smem,
                              static_cast<cudaStream_t>(stream)>>>(
        ctab, conf, dok, det_slot, counts, p);
  }
  return static_cast<int>(cudaGetLastError());
}
