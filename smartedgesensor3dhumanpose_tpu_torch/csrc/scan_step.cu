// Kernels S1 (scan_costs_kernel) and S2 (scan_extend_kernel): one camera
// step of the association's camera scan over a batch of frames, around
// the step's batched JV solve (kernel K1, csrc/jv_assign.cu), for sm_90a.
//
// They port no pallas_call. ops/association.py `_scan_camera` (the JAX
// package's fusion._associate_camera, the reference's
// skeleton_3d_triang_mult_node.cpp:562-674 for one camera) runs a step as
// ~115 small PyTorch kernels around the solve, and the 480 cameras of the
// Panoptic dome take 480 steps a chunk. These two compute the same step
// in two launches, from the fold inputs (the pair-cost table, the
// confident-voter flags, the usable detections) and the scan's carry
// (det_slot, the observation counts, n_hyp, n_dropped):
//   S1, one block per frame, one thread per (hypothesis h, detection d):
//      the mean cost over h's observations of the epipolar cost to d (its
//      sums in camera order, as _scan_camera and the fold add them), the
//      votes and vetoes, the feasible mask; then the frame's `need` (a
//      detection or hypothesis with more than one feasible pairing), each
//      hypothesis' pairing from the mask, and the solve's input: the tiered
//      cost where it is needed, else the trivial matrix, every row active
//      or none;
//   S2, one thread per frame: the assignment (the solve's where needed,
//      else the mask's), extend or spawn (solver spawns in hypothesis
//      order, then unhandled detections in detection order), the new
//      det_slot column, the counts.
// The float arithmetic is _scan_camera's, operation for operation (built
// with --fmad=false); the rest is integer. Built with -DSES3D_HOST by a C++
// compiler (no CUDA), this file gives the same phases one task after
// another on the host (`ses3d_scan_costs_host`, `ses3d_scan_extend_host`):
// the tests hold them to _scan_camera on the CPU through it.
//
// What bounds it: latency. S1 reads each hypothesis' observed cameras' row
// of the table (B H C D floats at most, 1.5 M a step at the dome's chunk);
// S2 is a few hundred integer operations a frame.

#include <cstddef>
#include <cstdint>

#ifdef SES3D_HOST
#define S_FN static inline
#define S_UNROLL
#else
#include <cuda_runtime.h>
#define S_FN __device__ __forceinline__
#define S_UNROLL _Pragma("unroll")
#endif

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kUnroll = 16;  // cameras whose loads S1 issues together

struct Step {
  const float* ctab;             // [B, C, C*D, D] the chunk's pair-cost table
  const float* conf;             // [B, C*D] confident-voter flags, 0 or 1
  const unsigned char* det_ok;   // [B, C, D] usable detections
  const float* tier;             // [H, D] the clip tier plus its tie-break
  const float* trivial;          // [H, D] a discarded problem's cost
  long long* det_slot;           // [B, H, C], -1 where unobserved
  long long* n_obs;              // [B, H] observations of each hypothesis
  long long* n_hyp;              // [B]
  long long* n_dropped;          // [B]
  float* cost;                   // [B, H, D] the solve's input
  unsigned char* row_active;     // [B, H]
  unsigned char* mask;           // [B, H, D] feasible pairings
  long long* from_mask;          // [B, H] each hypothesis' first feasible detection, -1
  unsigned char* need;           // [B]
  const int* solved;             // [B, H] the solve's column of each row
  int b, h, c, d, cam;
  float gate, max_cost, clip, invalid;
};

// S1, task (frame f, slot t = h * D + d): the pairing's cost, veto and mask
// (_scan_camera up to `mask`), and the tiered cost.
S_FN void costs(const Step& s, int f, int t, float* tiered) {
  const int hh = t / s.d, dd = t % s.d;
  const size_t row_len = static_cast<size_t>(s.c) * s.d;
  const float* table = s.ctab + ((static_cast<size_t>(f) * s.c + s.cam) * row_len) * s.d;
  const long long* slots = s.det_slot + (static_cast<size_t>(f) * s.h + hh) * s.c;
  const float* conf = s.conf + static_cast<size_t>(f) * row_len;
  // Sums over the hypothesis' observations in camera order; an unobserved
  // camera reads the -1 sentinel, adds exact zeros and counts nothing. The
  // cameras go kUnroll at a time: their slots, then their table entries
  // and flags, are loaded before any is added, so the loads overlap.
  float total = 0.0f, n_used = 0.0f, votes_all = 0.0f, votes_conf = 0.0f;
  for (int c0 = 0; c0 < s.c; c0 += kUnroll) {
    long long s1[kUnroll];
    S_UNROLL
    for (int u = 0; u < kUnroll; ++u) s1[u] = c0 + u < s.c ? slots[c0 + u] : -1;
    float v[kUnroll], cf[kUnroll];
    S_UNROLL
    for (int u = 0; u < kUnroll; ++u) {
      const size_t obs =
          static_cast<size_t>(c0 + u) * s.d + static_cast<size_t>(s1[u] < 0 ? 0 : s1[u]);
      v[u] = s1[u] >= 0 ? table[obs * s.d + dd] : -1.0f;
      cf[u] = s1[u] >= 0 ? conf[obs] : 0.0f;
    }
    S_UNROLL
    for (int u = 0; u < kUnroll; ++u) {
      const bool usable = v[u] >= 0.0f;
      const bool big = v[u] > s.gate;
      total = total + (usable ? v[u] : 0.0f);
      n_used = n_used + (usable ? 1.0f : 0.0f);
      votes_all = votes_all + (big ? 1.0f : 0.0f);
      votes_conf = votes_conf + (big ? cf[u] : 0.0f);
    }
  }
  const long long n_obs = s.n_obs[static_cast<size_t>(f) * s.h + hh];
  const float cost = total / (n_used < 1.0f ? 1.0f : n_used);
  const float n_votes = n_obs == 1 ? votes_all : votes_conf;
  const float n_obs_f = static_cast<float>(n_obs < 1 ? 1 : n_obs);
  const bool veto = n_votes / n_obs_f > 1.0f - 1.0f / (2.0f * n_obs_f);
  const bool ok = s.det_ok[(static_cast<size_t>(f) * s.c + s.cam) * s.d + dd] != 0;
  const bool barred = n_used < 0.5f || n_obs == 0 || !ok;
  const float c2 = barred ? s.max_cost : cost;
  const size_t out = static_cast<size_t>(f) * s.h * s.d + t;
  s.mask[out] = !(veto || barred) && c2 < s.gate;
  const float clipped = c2 > s.clip ? s.clip : c2;
  const float tier = clipped >= s.clip ? s.tier[t] : clipped;
  tiered[t] = ok ? tier : s.invalid;
}

// S1, frame f after its tasks: `need` and each hypothesis' pairing from
// the mask.
S_FN void frame_need(const Step& s, int f) {
  const unsigned char* m = s.mask + static_cast<size_t>(f) * s.h * s.d;
  bool need = false;
  for (int hh = 0; hh < s.h; ++hh) {
    int n = 0;
    long long first = -1;
    for (int dd = 0; dd < s.d; ++dd) {
      if (m[hh * s.d + dd]) {
        if (first < 0) first = dd;
        ++n;
      }
    }
    need = need || n > 1;
    s.from_mask[static_cast<size_t>(f) * s.h + hh] = first;
  }
  for (int dd = 0; dd < s.d; ++dd) {
    int n = 0;
    for (int hh = 0; hh < s.h; ++hh) n += m[hh * s.d + dd];
    need = need || n > 1;
  }
  s.need[f] = need;
}

// S1, task (frame f, slot t) after frame_need: the solve's input.
S_FN void solve_input(const Step& s, int f, int t, const float* tiered) {
  const bool need = s.need[f] != 0;
  const size_t out = static_cast<size_t>(f) * s.h * s.d + t;
  s.cost[out] = need ? tiered[t] : s.trivial[t];
  if (t % s.d == 0) s.row_active[static_cast<size_t>(f) * s.h + t / s.d] = need;
}

// S2, frame f: _scan_camera after the solve.
S_FN void extend(const Step& s, int f) {
  const int h = s.h, d = s.d;
  const size_t fh = static_cast<size_t>(f) * h;
  const unsigned char* ok = s.det_ok + (static_cast<size_t>(f) * s.c + s.cam) * d;
  const unsigned char* m = s.mask + fh * d;
  const bool need = s.need[f] != 0;
  // Per detection: the hypothesis assigned to it with a valid pairing
  // (handled), and the new slot it spawns (-1 none).
  constexpr int kMaxD = 128;
  long long det_to_slot[kMaxD];
  bool handled[kMaxD];
  for (int dd = 0; dd < d; ++dd) {
    det_to_slot[dd] = -1;
    handled[dd] = false;
  }
  long long n1 = s.n_hyp[f];
  for (int hh = 0; hh < h; ++hh) {
    const long long a = need ? static_cast<long long>(s.solved[fh + hh]) : s.from_mask[fh + hh];
    const bool on = a >= 0 && a < d;
    const bool valid = on && ok[a];
    if (valid) handled[a] = true;
    if (valid && !m[hh * d + a]) det_to_slot[a] = n1++;
  }
  long long n2 = n1;
  for (int dd = 0; dd < d; ++dd) {
    if (ok[dd] && !handled[dd]) det_to_slot[dd] = n2++;
  }
  for (int hh = 0; hh < h; ++hh) {
    const long long a = need ? static_cast<long long>(s.solved[fh + hh]) : s.from_mask[fh + hh];
    const bool on = a >= 0 && a < d;
    long long col = -1;
    if (on && ok[a] && m[hh * d + a]) {
      col = a;  // extend
    } else {
      for (int dd = 0; dd < d; ++dd) {
        if (det_to_slot[dd] == hh) col = dd;  // a spawn lands in slot hh
      }
    }
    s.det_slot[(fh + hh) * s.c + s.cam] = col;
    s.n_obs[fh + hh] += col >= 0;
  }
  s.n_hyp[f] = n2 < h ? n2 : h;
  s.n_dropped[f] += n2 - h > 0 ? n2 - h : 0;
}

}  // namespace

#ifndef SES3D_HOST

namespace {

__global__ void __launch_bounds__(kMaxThreads) scan_costs_kernel(Step s) {
  extern __shared__ float tiered[];
  const int f = blockIdx.x;
  const int n = s.h * s.d;
  for (int t = threadIdx.x; t < n; t += blockDim.x) costs(s, f, t, tiered);
  __syncthreads();
  if (threadIdx.x == 0) frame_need(s, f);
  __syncthreads();
  for (int t = threadIdx.x; t < n; t += blockDim.x) solve_input(s, f, t, tiered);
}

__global__ void scan_extend_kernel(Step s) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f < s.b) extend(s, f);
}

}  // namespace

// `step` points to a Step (a void pointer: a C entry's signature names no
// type of this file's unnamed namespace). Return the CUDA error, or
// cudaErrorInvalidValue for shapes they do not take (D > 128, a block's
// shared memory).
extern "C" int ses3d_scan_costs(const void* step, void* stream) {
  const Step* s = static_cast<const Step*>(step);
  if (s == nullptr || s->b < 0 || s->h < 1 || s->d < 1 || s->d > 128 ||
      s->h * s->d * 4 > 48 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (s->b > 0) {
    const int n = s->h * s->d;
    const int threads = n < kMaxThreads ? (n + 31) / 32 * 32 : kMaxThreads;
    scan_costs_kernel<<<s->b, threads, n * sizeof(float), static_cast<cudaStream_t>(stream)>>>(
        *s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ses3d_scan_extend(const void* step, void* stream) {
  const Step* s = static_cast<const Step*>(step);
  if (s == nullptr || s->b < 0 || s->d > 128) return static_cast<int>(cudaErrorInvalidValue);
  if (s->b > 0) {
    scan_extend_kernel<<<(s->b + 31) / 32, 32, 0, static_cast<cudaStream_t>(stream)>>>(*s);
  }
  return static_cast<int>(cudaGetLastError());
}

#else  // SES3D_HOST

#include <vector>

// The kernels' phases on the host, a frame (block) after another and a
// task (thread) after another: the same arithmetic, for the tests.
extern "C" int ses3d_scan_costs_host(const void* step) {
  const Step* s = static_cast<const Step*>(step);
  if (s == nullptr || s->b < 0 || s->h < 1 || s->d < 1 || s->d > 128) return 1;
  std::vector<float> tiered(static_cast<size_t>(s->h) * s->d);
  for (int f = 0; f < s->b; ++f) {
    for (int t = 0; t < s->h * s->d; ++t) costs(*s, f, t, tiered.data());
    frame_need(*s, f);
    for (int t = 0; t < s->h * s->d; ++t) solve_input(*s, f, t, tiered.data());
  }
  return 0;
}

extern "C" int ses3d_scan_extend_host(const void* step) {
  const Step* s = static_cast<const Step*>(step);
  if (s == nullptr || s->b < 0 || s->d > 128) return 1;
  for (int f = 0; f < s->b; ++f) extend(*s, f);
  return 0;
}

#endif  // SES3D_HOST
