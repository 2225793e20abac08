// Kernel E1 (pair_costs_kernel): the association's table of pair costs,
// ctab, for a chunk of frames in one launch, for sm_90a.
//
// It ports no pallas_call. fusion.fold_inputs (the reference's calcCost,
// skeleton_3d_triang_mult_node.cpp:335-390, evaluated once per frame for
// every camera pair c1 < c2) forms, per frame, pair, joint j and detections
// (d1 of c1, d2 of c2), the line of each detection's joint in the other
// camera, l1 = unit(F[c1, c2] [x1, y1, 1]) and l2 = unit(F[c1, c2]^T [x2,
// y2, 1]) with unit(l) = l / ||l_xy|| (1 where that is 0), and
//   num1 = x2 l10 + y2 l11 + l12   (the point of d2 against the line of d1)
//   num2 = x1 l20 + y1 l21 + l22   (the point of d1 against the line of d2)
//   term = |num1| + |num2| where both joints are confident, else 0.
// The pair's cost is the sum of the terms over the joints over the number
// of joints confident in both, written at ctab[b, c2, c1 * D + d1, d2], or
// -1 where no joint is (and for every c1 >= c2). In plain PyTorch
// (ops/epipolar.py pairwise_association_costs_packed and the scatter in
// fusion.py) that is some sixty passes over [frames, C(C-1)/2, J, D, D]
// values: ~150 ms a 32-frame chunk at the Panoptic dome's 480 cameras,
// against the ~1.9 GB table it produces. This kernel reads the keypoints
// and F and writes the table once; nothing per joint leaves the chip.
//
// Bit for bit with the plain version on the card (built with --fmad=false):
// the lines, unit() (rsqrtf, as torch.rsqrt) and the terms operation for
// operation, and the sum over the joints in the order PyTorch's CUDA
// reduction takes over the plain terms (joints innermost in memory): lane
// i of W = the largest power of two <= J holds t_i + t_{i+W}, then the
// lanes are combined by warp shuffles at offsets W/2, ..., 2, 1 (ATen's
// Reduce.cuh block_x_reduce; checked against torch 2.11 on the H100). The
// count of confident joints is exact in any order; the division is IEEE.
//
// Design: one block per (frame, c2), the frames of the heaviest c2 first
// (a block's work grows with c2). Its output is the contiguous slab ctab[b,
// c2] ([C, D, D]); camera c2's points and confident flags sit in shared
// memory. Each round takes `groups` cameras c1 < c2 (16 at D = 8), one
// thread per (c1, d1): each thread first forms the lines of (c2, d1's index
// as d2, every joint) in c1 into shared memory, then, after a barrier, its
// own line of (c1, d1, j) joint by joint and the terms of kSlots detections
// d2 at once, kept in registers as the partial sums of the reduction's tree,
// and writes its kSlots costs (two 16-byte stores at D = 8). Rows c1 >= c2
// are plain -1 stores. The keypoints (0.8 MB a dome frame) and F (8.3 MB)
// are read through L1 and L2. The tree over the skeleton's 17 joints and
// the padded detections (8) are compile-time constants: no branch between
// the leaves, shared-memory offsets folded (~15% faster than with both at
// run time, which other shapes take). What bounds it: the instruction
// rate, ~190 instructions a (pair, detection, joint) for 8 terms and 2
// lines, ~120 of them float32 operations; the table's bytes come second. 128 registers a thread, 4 blocks of 128
// threads an SM (more blocks spilled and ran slower; fewer ran slower).
//
// Built with -DSES3D_HOST by a C++ compiler (_kernels.host_library) the
// same phases run on the host, a block after another and a thread after
// another, for the tests; there the inverse norm is 1 / sqrtf, correctly
// rounded, as the tests' plain version takes it on the CPU.

#include <cstddef>
#include <cstdint>

#ifdef SES3D_HOST
#include <cmath>
#include <vector>
#define E_FN static inline
#define E_HD static inline
#define E_UNROLL
#else
#include <cuda_runtime.h>
#define E_FN __device__ __forceinline__
#define E_HD __host__ __device__ __forceinline__
#define E_UNROLL _Pragma("unroll")
#endif

namespace {

constexpr int kThreads = 128;  // the most threads a block takes: kThreads / D cameras a round
constexpr int kBlocksPerSm = 4;  // registers: at most 128 a thread
constexpr int kSlots = 8;        // detections d2 a thread sums at once
constexpr int kMaxJoints = 32;  // the confident flags of a detection are one 32-bit mask
// The port's input skeleton (skeleton.NUM_INPUT_JOINTS): its kernel knows
// the joints at compile time; other counts take the same kernel with the
// count at run time.
constexpr int kSkeletonJoints = 17;
constexpr int kMaxDets = kThreads;

struct Costs {
  const float* kp;  // [B, C, D, J, 3] normalized keypoints (x, y, conf)
  const float* F;   // [C, C, 3, 3] fundamental matrices (c1 -> c2)
  float* ctab;      // [B, C, C, D, D] out: [b, c2, c1, d1, d2]
  int b, c, d, j;
  int groups;       // cameras c1 a block takes a round
  float min_score;  // a joint is confident above it
};

// D padded to whole slots: the shared arrays' detection axis.
E_HD int padded(int d) { return (d + kSlots - 1) / kSlots * kSlots; }

// A block's shared memory: camera c2's points [J][Dp] and confident masks
// [Dp] (0 past D), and a round's lines of (c2, d2, j) in each of its
// cameras c1, [groups][J][3][Dp]. The arrays start 16-byte aligned.
struct Smem {
  float* x2;
  float* y2;
  unsigned* ok2;
  float* lines;
};

E_HD size_t smem_floats(int d, int j, int groups) {
  const size_t jd = static_cast<size_t>(j) * padded(d);
  return 2 * jd + padded(d) + 3 * static_cast<size_t>(groups) * jd;
}

E_FN Smem smem_at(float* base, const Costs& p) {
  const size_t jd = static_cast<size_t>(p.j) * padded(p.d);
  return Smem{base, base + jd, reinterpret_cast<unsigned*>(base + 2 * jd),
              base + 2 * jd + padded(p.d)};
}

// The plain unit()'s where(den > 0, rsqrt(den), 1).
E_FN float inv_norm(float den) {
#ifdef SES3D_HOST
  return den > 0.0f ? 1.0f / std::sqrt(den) : 1.0f;
#else
  return den > 0.0f ? rsqrtf(den) : 1.0f;
#endif
}

E_FN const float* kp_row(const Costs& p, int b, int cam, int det) {
  return p.kp + ((static_cast<size_t>(b) * p.c + cam) * p.d + det) * p.j * 3;
}

// The block of (frame b, camera c2) for block index `blk`: the largest c2
// first.
E_FN void block_of(const Costs& p, int blk, int* b, int* c2) {
  *c2 = p.c - 1 - blk / p.b;
  *b = blk % p.b;
}

// Thread `tid` of the block: camera c2's points and masks into shared
// memory, and -1 in the rows c1 >= c2.
E_FN void block_setup(const Costs& p, int b, int c2, int tid, int nthreads, const Smem& s) {
  const int dp = padded(p.d);
  for (int t = tid; t < p.d * p.j; t += nthreads) {
    const int dd = t / p.j, jj = t % p.j;
    const float* q = kp_row(p, b, c2, dd) + jj * 3;
    s.x2[jj * dp + dd] = q[0];
    s.y2[jj * dp + dd] = q[1];
  }
  for (int dd = tid; dd < dp; dd += nthreads) {
    unsigned mask = 0;
    if (dd < p.d) {
      const float* q = kp_row(p, b, c2, dd);
      for (int jj = 0; jj < p.j; ++jj) {
        mask |= static_cast<unsigned>(q[jj * 3 + 2] > p.min_score) << jj;
      }
    }
    s.ok2[dd] = mask;
  }
  const size_t dd2 = static_cast<size_t>(p.d) * p.d;
  float* rows = p.ctab + ((static_cast<size_t>(b) * p.c + c2) * p.c + c2) * dd2;
  const size_t n = (p.c - c2) * dd2;
#ifndef SES3D_HOST
  if (dd2 % 4 == 0) {
    float4* rows4 = reinterpret_cast<float4*>(rows);
    const float4 minus = make_float4(-1.0f, -1.0f, -1.0f, -1.0f);
    for (size_t t = tid; t < n / 4; t += nthreads) rows4[t] = minus;
    return;
  }
#endif
  for (size_t t = tid; t < n; t += nthreads) rows[t] = -1.0f;
}

// Round `round`, thread (g, dd), first phase: the lines of (c2, d2 = dd,
// every joint) in camera c1 = round * groups + g, F[c1, c2]^T [x2, y2, 1].
E_FN void round_lines(const Costs& p, int c2, int round, int tid, const Smem& s) {
  const int g = tid / p.d, dd = tid % p.d;
  const int c1 = round * p.groups + g;
  if (g >= p.groups || c1 >= c2) return;
  const int dp = padded(p.d);
  const float* f = p.F + (static_cast<size_t>(c1) * p.c + c2) * 9;
  const float f0 = f[0], f1 = f[1], f2 = f[2], f3 = f[3], f4 = f[4], f5 = f[5], f6 = f[6],
              f7 = f[7], f8 = f[8];
  float* out = s.lines + static_cast<size_t>(g) * p.j * 3 * dp + dd;
#ifndef SES3D_HOST
#pragma unroll 4
#endif
  for (int jj = 0; jj < p.j; ++jj) {
    const float x = s.x2[jj * dp + dd], y = s.y2[jj * dp + dd];
    const float b0 = (f0 * x + f3 * y) + f6;
    const float b1 = (f1 * x + f4 * y) + f7;
    const float b2 = (f2 * x + f5 * y) + f8;
    const float inv = inv_norm(b0 * b0 + b1 * b1);
    out[(jj * 3 + 0) * dp] = b0 * inv;
    out[(jj * 3 + 1) * dp] = b1 * inv;
    out[(jj * 3 + 2) * dp] = b2 * inv;
  }
}

// What a thread's terms read: its detection's row, F[c1, c2], and the
// points and lines of its slots d2 = d0 .. d0 + kSlots - 1 (each array at
// d0, 16-byte aligned), and each slot's joints confident in both.
struct Task {
  const float* row;    // kp of (b, c1, d1)
  float f[9];          // F[c1, c2]
  const float* lines;  // [J][3][Dp]
  const float* x2;     // [J][Dp]
  const float* y2;
  unsigned both[kSlots];
  int dp;
};

// kSlots consecutive floats of shared memory (16-byte aligned) into registers.
E_FN void load_slots(const float* src, float (&v)[kSlots]) {
#ifdef SES3D_HOST
  for (int k = 0; k < kSlots; ++k) v[k] = src[k];
#else
  E_UNROLL
  for (int k = 0; k < kSlots; k += 4) {
    const float4 q = *reinterpret_cast<const float4*>(src + k);
    v[k] = q.x;
    v[k + 1] = q.y;
    v[k + 2] = q.z;
    v[k + 3] = q.w;
  }
#endif
}

// The terms of joint jj for the thread's slots (0 where not both
// confident), as pair_terms_plain rounds them.
template <int DP, int jj>
E_FN void leaf_terms(const Task& t, float (&term)[kSlots]) {
  const int dp = DP > 0 ? DP : t.dp;
  const float x1 = t.row[jj * 3], y1 = t.row[jj * 3 + 1];
  const float a0 = (t.f[0] * x1 + t.f[1] * y1) + t.f[2];
  const float a1 = (t.f[3] * x1 + t.f[4] * y1) + t.f[5];
  const float a2 = (t.f[6] * x1 + t.f[7] * y1) + t.f[8];
  const float inv = inv_norm(a0 * a0 + a1 * a1);
  const float l10 = a0 * inv, l11 = a1 * inv, l12 = a2 * inv;
  float x2[kSlots], y2[kSlots], m0[kSlots], m1[kSlots], m2[kSlots];
  load_slots(t.x2 + jj * dp, x2);
  load_slots(t.y2 + jj * dp, y2);
  load_slots(t.lines + (jj * 3 + 0) * dp, m0);
  load_slots(t.lines + (jj * 3 + 1) * dp, m1);
  load_slots(t.lines + (jj * 3 + 2) * dp, m2);
  E_UNROLL
  for (int k = 0; k < kSlots; ++k) {
    const float num1 = (x2[k] * l10 + y2[k] * l11) + l12;
    const float num2 = (x1 * m0[k] + y1 * m1[k]) + m2[k];
    const float dist = fabsf(num1) + fabsf(num2);
    term[k] = (t.both[k] >> jj) & 1u ? dist : 0.0f;
  }
}

// The reduction's lane r of W: t_r + t_{r+W} where joint r + W exists.
// J > 0 and DP > 0: the joints and padded detections known at compile time
// (no branch between the leaves, addresses folded); 0: at run time.
template <int W, int J, int DP, int r>
E_FN void lane_value(const Task& t, int joints, float (&v)[kSlots]) {
  leaf_terms<DP, r>(t, v);
  if constexpr (r + W < kMaxJoints && (J == 0 || r + W < J)) {
    if (J > 0 || r + W < joints) {
      float u[kSlots];
      leaf_terms<DP, r + W>(t, u);
      E_UNROLL
      for (int k = 0; k < kSlots; ++k) v[k] = v[k] + u[k];
    }
  }
}

// The sum of the lanes r, r + m, r + 2m, ... of W as the warp shuffles at
// offsets W/2, ..., m combine them: S(r, m) = S(r, 2m) + S(r + m, 2m).
template <int W, int J, int DP, int r, int m>
E_FN void tree_sum(const Task& t, int joints, float (&s)[kSlots]) {
  if constexpr (m == W) {
    lane_value<W, J, DP, r>(t, joints, s);
  } else {
    float u[kSlots];
    tree_sum<W, J, DP, r, 2 * m>(t, joints, s);
    tree_sum<W, J, DP, r + m, 2 * m>(t, joints, u);
    E_UNROLL
    for (int k = 0; k < kSlots; ++k) s[k] = s[k] + u[k];
  }
}

// Round `round`, thread (g, d1), second phase: the costs of (c1, d1)
// against every detection of c2, kSlots at a time, into ctab.
template <int W, int J, int DP>
E_FN void round_costs(const Costs& p, int b, int c2, int round, int tid, const Smem& s) {
  const int g = tid / p.d, d1 = tid % p.d;
  const int c1 = round * p.groups + g;
  if (g >= p.groups || c1 >= c2) return;
  const int dp = DP > 0 ? DP : padded(p.d);
  const int joints = J > 0 ? J : p.j;
  const float* f = p.F + (static_cast<size_t>(c1) * p.c + c2) * 9;
  float* out = p.ctab + (((static_cast<size_t>(b) * p.c + c2) * p.c + c1) * p.d + d1) * p.d;
  const float* row = kp_row(p, b, c1, d1);
  unsigned ok1 = 0;
  for (int jj = 0; jj < joints; ++jj) {
    ok1 |= static_cast<unsigned>(row[jj * 3 + 2] > p.min_score) << jj;
  }
  for (int d0 = 0; d0 < p.d; d0 += kSlots) {
    Task t;
    t.row = row;
    E_UNROLL
    for (int i = 0; i < 9; ++i) t.f[i] = f[i];
    t.lines = s.lines + static_cast<size_t>(g) * joints * 3 * dp + d0;
    t.x2 = s.x2 + d0;
    t.y2 = s.y2 + d0;
    E_UNROLL
    for (int k = 0; k < kSlots; ++k) t.both[k] = ok1 & s.ok2[d0 + k];
    t.dp = dp;
    float sum[kSlots];
    tree_sum<W, J, DP, 0, 1>(t, joints, sum);
    float cost[kSlots];
    E_UNROLL
    for (int k = 0; k < kSlots; ++k) {
#ifdef SES3D_HOST
      const int n = __builtin_popcount(t.both[k]);
#else
      const int n = __popc(t.both[k]);
#endif
      cost[k] = n > 0 ? sum[k] / static_cast<float>(n) : -1.0f;
    }
#ifndef SES3D_HOST
    if (d0 + kSlots <= p.d && p.d % 4 == 0) {
      float4* o = reinterpret_cast<float4*>(out + d0);
      E_UNROLL
      for (int k = 0; k < kSlots / 4; ++k) {
        o[k] = make_float4(cost[4 * k], cost[4 * k + 1], cost[4 * k + 2], cost[4 * k + 3]);
      }
      continue;
    }
#endif
    for (int k = 0; k < kSlots && d0 + k < p.d; ++k) out[d0 + k] = cost[k];
  }
}

// The reduction's width for J joints: the largest power of two <= J.
int lane_width(int joints) {
  int w = 1;
  while (2 * w <= joints) w *= 2;
  return w;
}

bool valid(const Costs* p) {
  return p != nullptr && p->b >= 0 && p->c >= 0 && p->d >= 1 && p->d <= kMaxDets &&
         p->j >= 1 && p->j <= kMaxJoints && p->groups >= 1 && p->groups * p->d <= kThreads;
}

}  // namespace

#ifndef SES3D_HOST

namespace {

template <int W, int J, int DP>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) pair_costs_kernel(Costs p) {
  extern __shared__ float4 smem4[];
  const Smem s = smem_at(reinterpret_cast<float*>(smem4), p);
  int b, c2;
  block_of(p, blockIdx.x, &b, &c2);
  block_setup(p, b, c2, threadIdx.x, blockDim.x, s);
  __syncthreads();
  const int rounds = (c2 + p.groups - 1) / p.groups;
  for (int round = 0; round < rounds; ++round) {
    round_lines(p, c2, round, threadIdx.x, s);
    __syncthreads();
    round_costs<W, J, DP>(p, b, c2, round, threadIdx.x, s);
    __syncthreads();
  }
}

template <int W, int J, int DP>
cudaError_t launch(const Costs& p, cudaStream_t stream) {
  const size_t bytes = smem_floats(p.d, p.j, p.groups) * sizeof(float);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (bytes > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(pair_costs_kernel<W, J, DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  pair_costs_kernel<W, J, DP><<<p.b * p.c, p.groups * p.d, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// `costs` points to a Costs (a void pointer: a C entry's signature names
// no type of this file's unnamed namespace). One launch on `stream`; returns
// the CUDA error, or cudaErrorInvalidValue for shapes it does not take
// (J > 32, D > 256, a block's shared memory).
extern "C" int ses3d_pair_costs(const void* costs, void* stream) {
  const Costs* p = static_cast<const Costs*>(costs);
  if (!valid(p)) return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(p->b) * p->c == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p->j == kSkeletonJoints && padded(p->d) == kSlots) {
    return static_cast<int>(launch<16, kSkeletonJoints, kSlots>(*p, st));
  }
  switch (lane_width(p->j)) {
    case 1: return static_cast<int>(launch<1, 0, 0>(*p, st));
    case 2: return static_cast<int>(launch<2, 0, 0>(*p, st));
    case 4: return static_cast<int>(launch<4, 0, 0>(*p, st));
    case 8: return static_cast<int>(launch<8, 0, 0>(*p, st));
    case 16: return static_cast<int>(launch<16, 0, 0>(*p, st));
    default: return static_cast<int>(launch<32, 0, 0>(*p, st));
  }
}

#else  // SES3D_HOST

namespace {

template <int W, int J, int DP>
void run_host(const Costs& p) {
  std::vector<float> smem(smem_floats(p.d, p.j, p.groups));
  const Smem s = smem_at(smem.data(), p);
  const int nthreads = p.groups * p.d;
  for (int blk = 0; blk < p.b * p.c; ++blk) {
    int b, c2;
    block_of(p, blk, &b, &c2);
    for (int tid = 0; tid < nthreads; ++tid) block_setup(p, b, c2, tid, nthreads, s);
    const int rounds = (c2 + p.groups - 1) / p.groups;
    for (int round = 0; round < rounds; ++round) {
      for (int tid = 0; tid < nthreads; ++tid) round_lines(p, c2, round, tid, s);
      for (int tid = 0; tid < nthreads; ++tid) round_costs<W, J, DP>(p, b, c2, round, tid, s);
    }
  }
}

}  // namespace

// The kernel's phases on the host (file comment): the same arithmetic.
extern "C" int ses3d_pair_costs_host(const void* costs) {
  const Costs* p = static_cast<const Costs*>(costs);
  if (!valid(p)) return 1;
  if (p->j == kSkeletonJoints && padded(p->d) == kSlots) {
    run_host<16, kSkeletonJoints, kSlots>(*p);
    return 0;
  }
  switch (lane_width(p->j)) {
    case 1: run_host<1, 0, 0>(*p); break;
    case 2: run_host<2, 0, 0>(*p); break;
    case 4: run_host<4, 0, 0>(*p); break;
    case 8: run_host<8, 0, 0>(*p); break;
    case 16: run_host<16, 0, 0>(*p); break;
    default: run_host<32, 0, 0>(*p); break;
  }
  return 0;
}

#endif  // SES3D_HOST
