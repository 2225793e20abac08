// Kernel F1 (triangulation_kernel): the fusion's triangulation of every
// person hypothesis in one launch, for sm_90a.
//
// It ports no pallas_call. The JAX package triangulates the hypotheses
// (smartedgesensor3dhumanpose_tpu/fusion.py triangulate_hypotheses, the
// reference's skeleton_3d_triang_mult_node.cpp:676-982) as one XLA program
// of batched 4x4 algebra; the port's plain version (fusion.py
// `_triangulate_plain`) runs it as ~1,900 small PyTorch kernels a call,
// each far shorter than its launch. F1 computes the same function from the
// hypotheses' keypoints, covariances and camera masks and the rig's P and
// F, and writes the 21-joint persons once:
//   view masks and k, the coefficient-form normal matrix and its base
//   solve, the base reprojection error, every leave-one-out solve and its
//   error, the three-view drop scores, the drop selection, the published
//   xyz, error and score, the unscented covariance (a base solve and four
//   sigma points per valid view, unweighted), the scatter to the fusion
//   layout, the limb and shoulder inflation, the root gate and the
//   feet / valid-count person gate.
// The arithmetic is the plain version's, operation for operation, in
// float32 (build flag --fmad=false: no multiply-add is fused but those
// written as such): the coefficient form, adjugate power iteration with 3
// iterations from the dominant column and its guards, the 1e-20 / 1e-30
// clamps, the 0.9 err0 leave-one-out rule and the err0^2 three-view rule.
// Its sums and products over views take the order the plain version's
// reductions and einsums take on the CPU (`row_sum`, `inner_sum`, the
// multiply-add chains): the host build equals the plain version there but
// for the last bit of some square roots.
//
// One block per hypothesis. A hypothesis' working set (the rig's per-camera
// constants, its keypoints, every view's normal-matrix contribution, the
// leave-one-out and sigma-point results) lives in shared memory (`Smem`,
// ~2.5 KB a camera) and never goes to device memory: C <= 91 on an H100.
// A wider rig takes the wide variant (triangulation_wide_kernel, C <= 742):
// the same phases, with the arrays written or read once a view (the
// coefficient constants, the covariances, T_c, the leave-one-out and the
// sigma-point results: 2.2 KB a camera) in a slice of device memory of its
// own per hypothesis, which stays in L2 between the phases, and those the
// reprojection sums read C times a task (P, its norms, the keypoints, the
// view masks: 0.3 KB a camera) still in shared memory. The block runs phases
// separated by __syncthreads; a phase's tasks are independent and its
// threads take them in turn:
//   load        the cameras' constants, the hypothesis' keypoints;
//   contribs    (joint, view): view mask, weighted coefficients, T_c;
//   base sum    (joint, entry): k, M0 = sum_c T_c;
//   solves      (joint, slot): slot < C the leave-one-out solve without
//               view slot and its error, slot C the base solve and err0,
//               slot C + 1 the three-view drop scores;
//   select      joint: the drop, final mask, published xyz, err, score;
//   ut contribs (joint, view): unweighted coefficients under the final
//               mask;
//   ut sum      (joint, entry): M0u;
//   sigma       (joint, slot): slot < C view slot's four sigma points and
//               their offsets from the mean, slot C the UT's base solve;
//   cov sum     (joint, entry): the sigma points' weighted scatter;
//   covariance  joint: the covariance, the scatter to the fusion layout;
//   gates       fusion joint: limb inflation, the root gate; then one
//               thread the person gate; then the outputs.
// What bounds it: latency. The work is ~10^7 float operations a frame
// (16 hypotheses x 17 joints x (1 + C + 1 + 4 C) 4x4 solves), no product
// worth a tensor core; the launch reads its inputs once and writes the
// persons once (~0.2 MB a frame). A phase's critical path is one 4x4 solve
// (~300 operations) plus, for the leave-one-out slots, C reprojections.
//
// Built with -DSES3D_HOST by a C++ compiler (no CUDA), this file gives
// the same block's phases run one task after another on the host
// (`ses3d_triangulation_host`): the tests hold F1's arithmetic to the plain
// version on the CPU through it, and the card's kernel to it bit for bit.

#include <cstddef>
#include <cstdint>

#ifdef SES3D_HOST
#include <cmath>
#include <vector>
#define F1_FN static inline
#define F1_HD static inline
#define F1_UNROLL
#define F1_SQRT std::sqrt
#define F1_ABS std::fabs
#define F1_FMA std::fma
#else
#include <cuda_runtime.h>
#define F1_FN __device__ __forceinline__
#define F1_HD __host__ __device__ inline
#define F1_UNROLL _Pragma("unroll")
#define F1_SQRT sqrtf
#define F1_ABS fabsf
#define F1_FMA __fmaf_rn
#endif

namespace {

constexpr int kJ = 17;            // input joints
constexpr int kK = 21;            // fusion joints
constexpr int kMaxThreads = 512;  // threads a block, at most
// Fusion joints the gates read (skeleton.py).
constexpr int kMidHip = 8, kRHip = 9, kRAnkle = 11, kLHip = 12, kLAnkle = 14;
// Unique entries of a symmetric 4x4 (row-major upper triangle): entry e
// is (sym_i(e), sym_j(e)).
constexpr int kSym = 10;
F1_HD constexpr int sym_i(int e) { return e < 4 ? 0 : e < 7 ? 1 : e < 9 ? 2 : 3; }
F1_HD constexpr int sym_j(int e) { return e < 4 ? e : e < 7 ? e - 3 : e < 9 ? e - 5 : 3; }
// The covariance's six sums (xx, xy, xz, yy, yz, zz): sum q is the
// product of components cov_i(q) and cov_j(q).
F1_HD constexpr int cov_i(int q) { return q < 3 ? 0 : q < 5 ? 1 : 2; }
F1_HD constexpr int cov_j(int q) { return q < 3 ? q : q < 5 ? q - 2 : 2; }

// The launch's settings, by value (ops/triangulation_kernel.py `Params`
// mirrors it field by field).
struct Params {
  int n;                   // hypotheses
  int c;                   // cameras
  float min_kp_score;      // view gate
  float reproj_max;        // reproj_error_max_acceptable
  float kappa;             // ut_kappa
  float two_kappa;         // 2 kappa, as the plain version forms it in double
  float limb_offset;       // limb_cov_offset_sigma
  float max_root_dist;     // max_joint_dist_to_root
  float max_feet_height;
  int min_valid;           // min_num_valid_keypoints
  int to_fusion[kJ];       // input joint -> fusion joint
  int from_fusion[kK];     // fusion joint -> input joint, -1 where none
  int limb_parent[kJ];     // the limb's parent input joint, -1 where no limb
  float limb_len[kJ];
  float limb_sigma[kJ];
  int shoulder_r;          // fusion joints of the shoulder pair, -1 where none
  int shoulder_l;
  float shoulder_dist;
  float shoulder_sigma;
};

struct Tensors {
  const float* kp;              // [N, C, 17, 3] normalized (x, y, conf)
  const float* cov;             // [N, C, 17, 3] packed (xx, xy, yy)
  const unsigned char* cam_mask;  // [N, C]
  const float* P;               // [C, 3, 4]
  const float* F;               // [C, C, 3, 3]
  float* xyz;                   // [N, 21, 3]
  float* score;                 // [N, 21]
  float* cov3;                  // [N, 21, 3, 3]
  unsigned char* valid;         // [N]
  int* person_id;               // [N]
  int* drops;                   // [N, 17]: the view each joint dropped, -1
                                // none; not written where null
};

// A block's shared memory, carved for C cameras.
struct Smem {
  float* P;        // [C][12]
  float* nrm;      // [C][5]: |p2|^2, |p0|^2, |p1|^2, p0.p2, p1.p2
  float* K;        // [C][5][10]: the coefficient form's constant products
  float* kp;       // [C][17][3]
  float* cv;       // [C][17][3]
  float* T;        // [17][C][10]: T_c, then the UT's unweighted coefficients [5]
  float* loo;      // [17][C][4]: leave-one-out xyz and error
  float* sd;       // [17][C][4][3]: each sigma point's offset from the mean
  float* M0;       // [17][10]
  float* M0u;      // [17][10]
  float* xyz0;     // [17][3]
  float* err0;     // [17]
  float* best3v;   // [17]
  float* xyz;      // [17][3]: the published position, the UT's mean
  float* score;    // [17]
  float* b;        // [17]: sqrt(2 k + kappa)
  float* denom;    // [17]: 2 (2 k + kappa)
  float* t0;       // [17][3]
  float* scatter;  // [17][6]: the sigma points' weighted scatter
  float* xyzf;     // [21][3]
  float* scoref;   // [21]
  float* covf;     // [21][9]
  int* k;          // [17]
  int* kf;         // [17]
  int* best3;      // [17]
  int* dropf;      // [21]
  unsigned char* vm;  // [17][C]
  unsigned char* fm;  // [17][C]
};

constexpr size_t kFixedFloats = 2 * kJ * kSym + 3 * kJ * 3 + 5 * kJ + kJ * 6 + kK * (3 + 1 + 9);
constexpr size_t kFixedInts = 3 * kJ + kK;
constexpr size_t kFloatsPerCam = 12 + 5 + 5 * kSym + 2 * kJ * 3 + kJ * kSym + kJ * 4 + kJ * 12;
// The wide variant's split of kFloatsPerCam: P, nrm and kp in shared
// memory; K, cv, T, loo and sd in device memory.
constexpr size_t kSharedFloatsPerCam = 12 + 5 + kJ * 3;
constexpr size_t kDeviceFloatsPerCam = kFloatsPerCam - kSharedFloatsPerCam;

F1_HD size_t smem_bytes_for(int c, bool wide) {
  const size_t per_cam = wide ? kSharedFloatsPerCam : kFloatsPerCam;
  const size_t words = kFixedFloats + kFixedInts + per_cam * static_cast<size_t>(c);
  return words * 4 + 2 * static_cast<size_t>(kJ) * static_cast<size_t>(c);
}

// The wide variant's device memory for one hypothesis, in floats.
F1_HD size_t device_floats_for(int c) { return kDeviceFloatsPerCam * static_cast<size_t>(c); }

// `dev`: the hypothesis' slice of device memory (the wide variant), else
// null and every array in shared memory.
F1_FN Smem carve(void* base, int c, float* dev) {
  Smem s;
  float* f = static_cast<float*>(base);
  auto take = [&f](size_t n) {
    float* p = f;
    f += n;
    return p;
  };
  auto take_dev = [&f, &dev](size_t n) {
    float*& from = dev != nullptr ? dev : f;
    float* p = from;
    from += n;
    return p;
  };
  s.P = take(12 * c);
  s.nrm = take(5 * c);
  s.K = take_dev(5 * kSym * c);
  s.kp = take(kJ * 3 * c);
  s.cv = take_dev(kJ * 3 * c);
  s.T = take_dev(kJ * kSym * c);
  s.loo = take_dev(kJ * 4 * c);
  s.sd = take_dev(kJ * 12 * c);
  s.M0 = take(kJ * kSym);
  s.M0u = take(kJ * kSym);
  s.xyz0 = take(kJ * 3);
  s.err0 = take(kJ);
  s.best3v = take(kJ);
  s.xyz = take(kJ * 3);
  s.score = take(kJ);
  s.b = take(kJ);
  s.denom = take(kJ);
  s.t0 = take(kJ * 3);
  s.scatter = take(kJ * 6);
  s.xyzf = take(kK * 3);
  s.scoref = take(kK);
  s.covf = take(kK * 9);
  int* i = reinterpret_cast<int*>(f);
  s.k = i;
  s.kf = i + kJ;
  s.best3 = i + 2 * kJ;
  s.dropf = i + 3 * kJ;
  s.vm = reinterpret_cast<unsigned char*>(i + kFixedInts);
  s.fm = s.vm + kJ * c;
  return s;
}

F1_HD int threads_for(int c) {
  const int want = (kJ * (c + 2) + 31) / 32 * 32;
  return want < kMaxThreads ? want : kMaxThreads;
}

// ------------------------------------------------------------ algebra --

// ops/linalg.py adjugate4's det3, term for term.
F1_FN float det3(const float m[4][4], int r0, int r1, int r2, int c0, int c1, int c2) {
  return m[r0][c0] * (m[r1][c1] * m[r2][c2] - m[r1][c2] * m[r2][c1]) -
         m[r0][c1] * (m[r1][c0] * m[r2][c2] - m[r1][c2] * m[r2][c0]) +
         m[r0][c2] * (m[r1][c0] * m[r2][c1] - m[r1][c1] * m[r2][c0]);
}

// ops/triangulation.py solve_normal: the smallest eigenvector of the
// symmetric normal matrix `sym` (kSym entries) by adjugate power iteration
// (linalg.smallest_eigvec4_psd, iters = 3), de-homogenized; fewer than 2
// views bias it by the identity and give 0.
F1_FN void solve_normal(const float sym[kSym], int n_views, float out[3]) {
  const bool deficient = n_views < 2;
  float m[4][4];
F1_UNROLL
  for (int e = 0; e < kSym; ++e) {
    m[sym_i(e)][sym_j(e)] = sym[e];
    m[sym_j(e)][sym_i(e)] = sym[e];
  }
F1_UNROLL
  for (int d = 0; d < 4; ++d) m[d][d] = m[d][d] + (deficient ? 1.0f : 0.0f);
  // adj[j][i] = (-1)^(i + j) det3(rows != i, cols != j).
  float adj[4][4];
F1_UNROLL
  for (int i = 0; i < 4; ++i) {
    const int r0 = i == 0 ? 1 : 0;
    const int r1 = i <= 1 ? 2 : 1;
    const int r2 = i <= 2 ? 3 : 2;
F1_UNROLL
    for (int j = 0; j < 4; ++j) {
      const int c0 = j == 0 ? 1 : 0;
      const int c1 = j <= 1 ? 2 : 1;
      const int c2 = j <= 2 ? 3 : 2;
      const float cof = det3(m, r0, r1, r2, c0, c1, c2);
      adj[j][i] = ((i + j) & 1) ? -cof : cof;
    }
  }
  // The dominant column (the first of equal norms) starts the iteration.
  int idx = 0;
  float best = 0.0f;
F1_UNROLL
  for (int col = 0; col < 4; ++col) {
    const float nrm = ((adj[0][col] * adj[0][col] + adj[1][col] * adj[1][col]) +
                       adj[2][col] * adj[2][col]) +
                      adj[3][col] * adj[3][col];
    if (col == 0 || nrm > best) {
      best = nrm;
      idx = col;
    }
  }
  float v[4];
F1_UNROLL
  for (int a = 0; a < 4; ++a) {
    v[a] = idx == 0 ? adj[a][0] : idx == 1 ? adj[a][1] : idx == 2 ? adj[a][2] : adj[a][3];
  }
F1_UNROLL
  for (int it = 0; it < 2; ++it) {
    float w[4];
F1_UNROLL
    for (int a = 0; a < 4; ++a) {
      w[a] = ((adj[a][0] * v[0] + adj[a][1] * v[1]) + adj[a][2] * v[2]) + adj[a][3] * v[3];
    }
    const float nrm = F1_SQRT(((w[0] * w[0] + w[1] * w[1]) + w[2] * w[2]) + w[3] * w[3]);
    const float den = nrm > 0.0f ? nrm : 1.0f;
F1_UNROLL
    for (int a = 0; a < 4; ++a) v[a] = w[a] / den;
  }
  const float nrm = F1_SQRT(((v[0] * v[0] + v[1] * v[1]) + v[2] * v[2]) + v[3] * v[3]);
  const bool ok = nrm > 1e-30f;
  const float den = nrm > 0.0f ? nrm : 1.0f;
  float hv[4];
F1_UNROLL
  for (int a = 0; a < 4; ++a) hv[a] = ok ? v[a] / den : (a == 3 ? 1.0f : 0.0f);
  float wh = hv[3];
  wh = F1_ABS(wh) > 1e-20f ? wh : 1e-20f;
F1_UNROLL
  for (int a = 0; a < 3; ++a) out[a] = deficient ? 0.0f : hv[a] / wh;
}

// ops/triangulation.py view_coeffs for one view: w2 masks the view (the
// squared confidence, 1 unweighted, 0 where masked).
F1_FN void view_coeffs(const float* nrm, float x, float y, float w2, float coeff[5]) {
  const float n22 = nrm[0], n00 = nrm[1], n11 = nrm[2], n02 = nrm[3], n12 = nrm[4];
  const float nx = (x * x * n22 - 2.0f * x * n02) + n00;
  const float ny = (y * y * n22 - 2.0f * y * n12) + n11;
  const float inv_nx = w2 / (nx < 1e-30f ? 1e-30f : nx);
  const float inv_ny = w2 / (ny < 1e-30f ? 1e-30f : ny);
  coeff[0] = x * x * inv_nx + y * y * inv_ny;
  coeff[1] = -x * inv_nx;
  coeff[2] = inv_nx;
  coeff[3] = -y * inv_ny;
  coeff[4] = inv_ny;
}

// sum_k coeff_k K_k, the five products added in order (ops/covariance.py's
// sum over the sigma points' coefficient changes).
F1_FN void contrib(const float coeff[5], const float* K, float out[kSym]) {
F1_UNROLL
  for (int e = 0; e < kSym; ++e) {
    out[e] = (((coeff[0] * K[e] + coeff[1] * K[kSym + e]) + coeff[2] * K[2 * kSym + e]) +
              coeff[3] * K[3 * kSym + e]) +
             coeff[4] * K[4 * kSym + e];
  }
}

// ops/triangulation.py view_contribs' einsum: the five products as a chain
// of multiply-adds in order, as the plain version's matrix product runs.
F1_FN void contrib_fma(const float coeff[5], const float* K, float out[kSym]) {
F1_UNROLL
  for (int e = 0; e < kSym; ++e) {
    float acc = 0.0f;
F1_UNROLL
    for (int q = 0; q < 5; ++q) acc = F1_FMA(coeff[q], K[q * kSym + e], acc);
    out[e] = acc;
  }
}

// Sums over the views (or sigma points) in the order of PyTorch's CPU
// reductions (cascade_sum, vectors of kVec floats), which the plain
// version runs there. `cascade` is one output's sum across vectors of
// outputs (the sum along an axis that is not the innermost, as M0's):
// multi_row_sum's kLevels running sums, level 0 over blocks of kLevelStep
// elements, each level added into the next when a block of the level
// below completes a multiple of kLevelStep of them, the part block after
// the last whole block, then levels 1, 2, 3 added to level 0 in turn
// (its level step is 16 below 2^20 elements; F1 sums at most 4 x 742).
// `row_sum` is kRows interleaved cascades added in turn. `inner_sum` sums
// along the contiguous last axis: the scalars past the last whole vector,
// then each of the kVec lanes' `row_sum` over the vectors.
constexpr int kRows = 4;
constexpr int kLevels = 4;
constexpr int kLevelPower = 4;
constexpr int kLevelStep = 1 << kLevelPower;
constexpr int kVec = 8;

template <typename Term>
F1_FN float cascade(int n, const Term& term) {
  float acc[kLevels] = {0.0f, 0.0f, 0.0f, 0.0f};
  int i = 0;
  while (i + kLevelStep <= n) {
    for (int b = 0; b < kLevelStep; ++b, ++i) acc[0] = acc[0] + term(i);
F1_UNROLL
    for (int level = 1; level < kLevels; ++level) {
      acc[level] = acc[level] + acc[level - 1];
      acc[level - 1] = 0.0f;
      if ((i & ((kLevelStep - 1) << (level * kLevelPower))) != 0) break;
    }
  }
  for (; i < n; ++i) acc[0] = acc[0] + term(i);
F1_UNROLL
  for (int level = 1; level < kLevels; ++level) acc[0] = acc[0] + acc[level];
  return acc[0];
}

template <typename Term>
F1_FN float row_sum(int n, const Term& term) {
  const int size = n / kRows;
  float acc[kRows];
F1_UNROLL
  for (int r = 0; r < kRows; ++r) {
    acc[r] = cascade(size, [&](int i) { return term(i * kRows + r); });
  }
  for (int t = size * kRows; t < n; ++t) acc[0] = acc[0] + term(t);
  return ((acc[0] + acc[1]) + acc[2]) + acc[3];
}

template <typename Term>
F1_FN float inner_sum(int n, const Term& term) {
  if (n < kVec) return row_sum(n, term);
  const int vecs = n / kVec;
  float total = 0.0f;
  for (int t = vecs * kVec; t < n; ++t) total = total + term(t);
  for (int lane = 0; lane < kVec; ++lane) {
    total = total + row_sum(vecs, [&](int v) { return term(v * kVec + lane); });
  }
  return total;
}

// ops/triangulation.py reprojection_error over the joint's views but `skip`.
// Its sums run across vectors of outputs: of the joints (`row_sum`) for the
// base solve, of every (dropped view, joint) pair (`cascade`) for the
// leave-one-out solves, whose error tensors hold the views outermost.
template <typename Term>
F1_FN float view_sum(int c_cams, bool loo, const Term& term) {
  return loo ? cascade(c_cams, term) : row_sum(c_cams, term);
}

F1_FN float reproj_error(const Smem& s, int c_cams, int j, int skip, const float xyz[3]) {
  const auto on = [&](int c) { return s.vm[j * c_cams + c] && c != skip; };
  const bool loo = skip >= 0;
  const float norm = view_sum(c_cams, loo, [&](int c) {
    return on(c) ? s.kp[(c * kJ + j) * 3 + 2] : 0.0f;
  });
  const float total = view_sum(c_cams, loo, [&](int c) {
    if (!on(c)) return 0.0f;
    const float* P = s.P + 12 * c;
    const float* kp = s.kp + (c * kJ + j) * 3;
    float z = ((P[8] * xyz[0] + P[9] * xyz[1]) + P[10] * xyz[2]) + P[11];
    z = F1_ABS(z) > 1e-20f ? z : 1e-20f;
    const float ex = (((P[0] * xyz[0] + P[1] * xyz[1]) + P[2] * xyz[2]) + P[3]) / z - kp[0];
    const float ey = (((P[4] * xyz[0] + P[5] * xyz[1]) + P[6] * xyz[2]) + P[7]) / z - kp[1];
    return kp[2] * F1_SQRT(ex * ex + ey * ey);
  });
  return total / (norm > 0.0f ? norm : 1.0f);
}

// ops/epipolar.py three_view_drop_scores' pair_d2 for views a < b.
F1_FN float pair_d2(const float* F, int c_cams, int a, int b, const float* pa, const float* pb) {
  const float* f = F + (static_cast<size_t>(a) * c_cams + b) * 9;
  float l1[3], l2[3];
F1_UNROLL
  for (int i = 0; i < 3; ++i) {
    l1[i] = (f[3 * i] * pa[0] + f[3 * i + 1] * pa[1]) + f[3 * i + 2] * 1.0f;
    l2[i] = (f[i] * pb[0] + f[3 + i] * pb[1]) + f[6 + i] * 1.0f;
  }
  const float num1 = (pb[0] * l1[0] + pb[1] * l1[1]) + 1.0f * l1[2];
  const float num2 = (pa[0] * l2[0] + pa[1] * l2[1]) + 1.0f * l2[2];
  const float den1 = l1[0] * l1[0] + l1[1] * l1[1];
  const float den2 = l2[0] * l2[0] + l2[1] * l2[1];
  return num1 * num1 / (den1 > 0.0f ? den1 : 1.0f) + num2 * num2 / (den2 > 0.0f ? den2 : 1.0f);
}

// torch.linalg.vector_norm of a 3-vector: a multiply-add chain, as its
// scalar loop runs on the CPU.
F1_FN float norm3(float dx, float dy, float dz) {
  return F1_SQRT(F1_FMA(dz, dz, F1_FMA(dy, dy, dx * dx)));
}

// ------------------------------------------------------------- phases --
// Each phase is `tasks(...)` independent tasks; `h` is the hypothesis.

F1_FN int load_tasks(int c) { return kJ * 3 * c > kK * 13 ? kJ * 3 * c : kK * 13; }

F1_FN void load(const Params& p, const Tensors& g, const Smem& s, int h, int t) {
  const int c_cams = p.c;
  if (t < c_cams) {
    const float* P = g.P + 12 * t;
    float* sp = s.P + 12 * t;
    F1_UNROLL
    for (int e = 0; e < 12; ++e) sp[e] = P[e];
    const float* p0 = P;
    const float* p1 = P + 4;
    const float* p2 = P + 8;
    float* nrm = s.nrm + 5 * t;
    nrm[0] = ((p2[0] * p2[0] + p2[1] * p2[1]) + p2[2] * p2[2]) + p2[3] * p2[3];
    nrm[1] = ((p0[0] * p0[0] + p0[1] * p0[1]) + p0[2] * p0[2]) + p0[3] * p0[3];
    nrm[2] = ((p1[0] * p1[0] + p1[1] * p1[1]) + p1[2] * p1[2]) + p1[3] * p1[3];
    nrm[3] = ((p0[0] * p2[0] + p0[1] * p2[1]) + p0[2] * p2[2]) + p0[3] * p2[3];
    nrm[4] = ((p1[0] * p2[0] + p1[1] * p2[1]) + p1[2] * p2[2]) + p1[3] * p2[3];
    // ops/triangulation.py coeff_constants: p2 p2^T, p0 p2^T + p2 p0^T,
    // p0 p0^T, p1 p2^T + p2 p1^T, p1 p1^T.
    float* K = s.K + 5 * kSym * t;
    F1_UNROLL
    for (int e = 0; e < kSym; ++e) {
      const int i = sym_i(e), j = sym_j(e);
      K[e] = p2[i] * p2[j];
      K[kSym + e] = p0[i] * p2[j] + p0[j] * p2[i];
      K[2 * kSym + e] = p0[i] * p0[j];
      K[3 * kSym + e] = p1[i] * p2[j] + p1[j] * p2[i];
      K[4 * kSym + e] = p1[i] * p1[j];
    }
  }
  const size_t per = static_cast<size_t>(c_cams) * kJ * 3;
  if (t < static_cast<int>(per)) {
    s.kp[t] = g.kp[h * per + t];
    s.cv[t] = g.cov[h * per + t];
  }
  if (t < kK * 13) {
    // The fusion layout starts empty: xyz, score and covariance 0.
    if (t < kK * 3) s.xyzf[t] = 0.0f;
    else if (t < kK * 4) s.scoref[t - kK * 3] = 0.0f;
    else s.covf[t - kK * 4] = 0.0f;
  }
}

// (joint, view): the view mask and the view's weighted contribution T_c.
F1_FN void contribs(const Params& p, const Tensors& g, const Smem& s, int h, int t) {
  const int c_cams = p.c;
  const int j = t / c_cams, c = t % c_cams;
  const float* kp = s.kp + (c * kJ + j) * 3;
  const bool on = g.cam_mask[static_cast<size_t>(h) * c_cams + c] && kp[2] >= p.min_kp_score;
  s.vm[j * c_cams + c] = on;
  float coeff[5];
  view_coeffs(s.nrm + 5 * c, kp[0], kp[1], on ? kp[2] * kp[2] : 0.0f, coeff);
  contrib_fma(coeff, s.K + 5 * kSym * c, s.T + (j * c_cams + c) * kSym);
}

// (joint, entry): entry e of M0 = sum_c T_c; entry 0 also the view count.
F1_FN void base_sum(const Params& p, const Smem& s, int t) {
  const int c_cams = p.c;
  const int j = t / kSym, e = t % kSym;
  const float* T = s.T + j * c_cams * kSym + e;
  s.M0[t] = cascade(c_cams, [&](int c) { return T[c * kSym]; });
  if (e == 0) {
    int k = 0;
    for (int c = 0; c < c_cams; ++c) k += s.vm[j * c_cams + c];
    s.k[j] = k;
  }
}

// (joint, slot): slot < C the leave-one-out solve without view `slot` and
// its error (only for a valid view: the others are never read), slot C the
// base solve and err0, slot C + 1 the three-view drop scores (only where
// the joint has exactly three views).
F1_FN void solves(const Params& p, const Tensors& g, const Smem& s, int t) {
  const int c_cams = p.c;
  const int j = t / (c_cams + 2), slot = t % (c_cams + 2);
  const int k = s.k[j];
  if (slot < c_cams) {
    if (!s.vm[j * c_cams + slot]) return;
    float m[kSym];
    const float* T = s.T + (j * c_cams + slot) * kSym;
    F1_UNROLL
    for (int e = 0; e < kSym; ++e) m[e] = s.M0[j * kSym + e] - T[e];
    float xyz[3];
    solve_normal(m, k - 1, xyz);
    float* out = s.loo + (j * c_cams + slot) * 4;
    out[0] = xyz[0];
    out[1] = xyz[1];
    out[2] = xyz[2];
    out[3] = reproj_error(s, c_cams, j, slot, xyz);
  } else if (slot == c_cams) {
    float xyz[3];
    solve_normal(s.M0 + j * kSym, k, xyz);
    F1_UNROLL
    for (int a = 0; a < 3; ++a) s.xyz0[j * 3 + a] = xyz[a];
    s.err0[j] = reproj_error(s, c_cams, j, -1, xyz);
  } else if (k == 3) {
    // The first three valid views, ascending; rem[v] is the pair left
    // after dropping the v-th.
    int i0 = 0, i1 = 0, i2 = 0;
    int n = 0;
    for (int c = 0; c < c_cams && n < 3; ++c) {
      if (!s.vm[j * c_cams + c]) continue;
      if (n == 0) i0 = c;
      else if (n == 1) i1 = c;
      else i2 = c;
      ++n;
    }
    const float* k0 = s.kp + (i0 * kJ + j) * 3;
    const float* k1 = s.kp + (i1 * kJ + j) * 3;
    const float* k2 = s.kp + (i2 * kJ + j) * 3;
    const float rem0 = pair_d2(g.F, c_cams, i1, i2, k1, k2);
    const float rem1 = pair_d2(g.F, c_cams, i0, i2, k0, k2);
    const float rem2 = pair_d2(g.F, c_cams, i0, i1, k0, k1);
    // The first smallest.
    int best = i0;
    float best_v = rem0;
    if (rem1 < best_v) {
      best = i1;
      best_v = rem1;
    }
    if (rem2 < best_v) {
      best = i2;
      best_v = rem2;
    }
    s.best3[j] = best;
    s.best3v[j] = best_v;
  }
}

// joint: fusion.py _select_outlier_drops and what follows it: the final
// mask, the published position and error, the down-weighted score, and
// the UT's scale for the final views.
F1_FN void select(const Params& p, const Tensors& g, const Smem& s, int h, int j) {
  const int c_cams = p.c;
  const int k = s.k[j];
  const float err0 = s.err0[j];
  int drop = -1;
  if (err0 > p.reproj_max) {
    if (k == 3) {
      drop = s.best3v[j] < err0 * err0 ? s.best3[j] : -1;
    } else if (k >= 4) {
      // The smallest leave-one-out error (the first of equals) among the
      // valid views at least 10% better than err0.
      const float limit = 0.9f * err0;
      float best = 3.0e38f;
      for (int c = 0; c < c_cams; ++c) {
        if (!s.vm[j * c_cams + c]) continue;
        const float e = s.loo[(j * c_cams + c) * 4 + 3];
        if (e < limit && (drop < 0 || e < best)) {
          best = e;
          drop = c;
        }
      }
    }
  }
  int kf = 0;
  for (int c = 0; c < c_cams; ++c) {
    const bool on = s.vm[j * c_cams + c] && c != drop;
    s.fm[j * c_cams + c] = on;
    kf += on;
  }
  const float conf_sum = row_sum(c_cams, [&](int c) {
    return s.fm[j * c_cams + c] ? s.kp[(c * kJ + j) * 3 + 2] : 0.0f;
  });
  const float* src = drop >= 0 ? s.loo + (j * c_cams + drop) * 4 : s.xyz0 + j * 3;
  F1_UNROLL
  for (int a = 0; a < 3; ++a) s.xyz[j * 3 + a] = src[a];
  const float err = drop >= 0 ? src[3] : err0;
  if (g.drops != nullptr) g.drops[static_cast<size_t>(h) * kJ + j] = drop;
  float score = conf_sum / static_cast<float>(kf > 1 ? kf : 1);
  const float scale =
      err > p.reproj_max ? 1.0f / (err < 1e-20f ? 1e-20f : err) * p.reproj_max : 1.0f;
  s.score[j] = score * scale;
  s.kf[j] = kf;
  const float dim = 2.0f * static_cast<float>(kf);
  s.b[j] = F1_SQRT(dim + p.kappa);
  s.denom[j] = 2.0f * (dim + p.kappa);
}

// (joint, view): the view's unweighted coefficients under the final mask.
F1_FN void ut_contribs(const Params& p, const Smem& s, int t) {
  const int c_cams = p.c;
  const int j = t / c_cams, c = t % c_cams;
  const float* kp = s.kp + (c * kJ + j) * 3;
  view_coeffs(s.nrm + 5 * c, kp[0], kp[1], s.fm[j * c_cams + c] ? 1.0f : 0.0f,
              s.T + (j * c_cams + c) * kSym);
}

// (joint, entry): entry e of M0u, ops/covariance.py's einsums over (view,
// coefficient): a multiply-add chain, view by view, over each chunk of
// kProductViews views, the chunks' sums added in turn.
constexpr int kProductViews = 64;

F1_FN void ut_sum(const Params& p, const Smem& s, int t) {
  const int c_cams = p.c;
  const int j = t / kSym, e = t % kSym;
  float total = 0.0f;
  for (int lo = 0; lo < c_cams; lo += kProductViews) {
    const int hi = lo + kProductViews < c_cams ? lo + kProductViews : c_cams;
    float acc = 0.0f;
    for (int c = lo; c < hi; ++c) {
      const float* coeff = s.T + (j * c_cams + c) * kSym;
      const float* K = s.K + 5 * kSym * c + e;
F1_UNROLL
      for (int q = 0; q < 5; ++q) acc = F1_FMA(coeff[q], K[q * kSym], acc);
    }
    total = lo == 0 ? acc : total + acc;
  }
  s.M0u[t] = total;
}

// (joint, slot): slot < C the four sigma points of view `slot` (a final
// view) and their offsets from the published position, slot C the UT's
// base solve. ops/covariance.py triangulation_covariance.
F1_FN void sigma(const Params& p, const Smem& s, int t) {
  const int c_cams = p.c;
  const int j = t / (c_cams + 1), slot = t % (c_cams + 1);
  const int kf = s.kf[j];
  const float* mean = s.xyz + j * 3;
  if (slot == c_cams) {
    solve_normal(s.M0u + j * kSym, kf, s.t0 + j * 3);
    return;
  }
  if (!s.fm[j * c_cams + slot]) return;
  const int c = slot;
  const float* kp = s.kp + (c * kJ + j) * 3;
  const float* cv = s.cv + (c * kJ + j) * 3;
  const float* nrm = s.nrm + 5 * c;
  const float* K = s.K + 5 * kSym * c;
  // linalg.chol2x2_packed.
  const float l11 = F1_SQRT(cv[0] < 0.0f ? 0.0f : cv[0]);
  const float l21 = l11 > 0.0f ? cv[1] / l11 : 0.0f;
  const float rest = cv[2] - l21 * l21;
  const float l22 = F1_SQRT(rest < 0.0f ? 0.0f : rest);
  const float b = s.b[j];
  // The four sigma points' offsets of (x, y): -L[:, 0], -L[:, 1], L[:, 0],
  // L[:, 1], times b.
  float coeff0[5];
  view_coeffs(nrm, kp[0], kp[1], 1.0f, coeff0);
  for (int v = 0; v < 4; ++v) {
    float coeff[5];
    const float sx = v == 0 ? -l11 : v == 2 ? l11 : 0.0f;
    const float sy = v == 0 ? -l21 : v == 1 ? -l22 : v == 2 ? l21 : l22;
    view_coeffs(nrm, kp[0] + sx * b, kp[1] + sy * b, 1.0f, coeff);
    float dc[5];
    F1_UNROLL
    for (int q = 0; q < 5; ++q) dc[q] = coeff[q] - coeff0[q];
    float m[kSym];
    contrib(dc, K, m);
    F1_UNROLL
    for (int e = 0; e < kSym; ++e) m[e] = s.M0u[j * kSym + e] + m[e];
    float ts[3];
    solve_normal(m, kf, ts);
    float* d = s.sd + ((j * c_cams + c) * 4 + v) * 3;
    F1_UNROLL
    for (int a = 0; a < 3; ++a) d[a] = ts[a] - mean[a];
  }
}

// (joint, entry): entry q of the joint's sigma points' weighted scatter,
// sigma point 4 c + v in order, a masked view's with weight 0.
F1_FN void cov_sum(const Params& p, const Smem& s, int t) {
  const int c_cams = p.c;
  const int j = t / 6, q = t % 6;
  const float* mean = s.xyz + j * 3;
  const float w = 1.0f / s.denom[j];
  // A masked view's sigma points solve to the base point, weight 0.
  const float masked =
      0.0f * (s.t0[j * 3 + cov_i(q)] - mean[cov_i(q)]) * (s.t0[j * 3 + cov_j(q)] - mean[cov_j(q)]);
  s.scatter[t] = inner_sum(4 * c_cams, [&](int sp) {
    if (!s.fm[j * c_cams + sp / 4]) return masked;
    const float* d = s.sd + (j * c_cams * 4 + sp) * 3;
    return w * d[cov_i(q)] * d[cov_j(q)];
  });
}

// joint: the covariance (the scatter and the base point's term), then the
// joint into the fusion layout where it has at least two views.
F1_FN void covariance(const Params& p, const Smem& s, int j) {
  const float* mean = s.xyz + j * 3;
  float d0[3];
  F1_UNROLL
  for (int a = 0; a < 3; ++a) d0[a] = s.t0[j * 3 + a] - mean[a];
  const float w0 = 1.0f / s.denom[j] * p.two_kappa;
  const int fj = p.to_fusion[j];
  const bool valid = s.k[j] >= 2;
  F1_UNROLL
  for (int a = 0; a < 3; ++a) {
    F1_UNROLL
    for (int bq = 0; bq < 3; ++bq) {
      const int q = a <= bq ? (a == 0 ? bq : a == 1 ? 2 + bq : 5) : (bq == 0 ? a : 4);
      const float v = s.scatter[j * 6 + q] + w0 * d0[a] * d0[bq];
      s.covf[fj * 9 + a * 3 + bq] = valid ? v : 0.0f;
    }
    s.xyzf[fj * 3 + a] = valid ? mean[a] : 0.0f;
  }
  s.scoref[fj] = valid ? s.score[j] : 0.0f;
}

// The root: MidHip if present, else the mean of both hips.
F1_FN float root_of(const Smem& s, float root[3]) {
  const bool have_mid = s.scoref[kMidHip] > 0.0f;
  const bool have_hips = s.scoref[kLHip] > 0.0f && s.scoref[kRHip] > 0.0f;
  F1_UNROLL
  for (int a = 0; a < 3; ++a) {
    const float hip = 0.5f * (s.xyzf[kLHip * 3 + a] + s.xyzf[kRHip * 3 + a]);
    root[a] = have_mid ? s.xyzf[kMidHip * 3 + a] : have_hips ? hip : 0.0f;
  }
  const float hip_score = 0.5f * (s.scoref[kLHip] + s.scoref[kRHip]);
  return have_mid ? s.scoref[kMidHip] : have_hips ? hip_score : 0.0f;
}

// fusion joint: the limb and shoulder inflation of its covariance
// (fusion.py _apply_limb_inflation_and_gates) and whether the root gate
// drops it.
F1_FN void inflate(const Params& p, const Smem& s, int fj) {
  float add = 0.0f;
  const int j = p.from_fusion[fj];
  if (j >= 0 && p.limb_parent[j] >= 0) {
    const int pf = p.to_fusion[p.limb_parent[j]];
    const float dist = norm3(s.xyzf[fj * 3] - s.xyzf[pf * 3], s.xyzf[fj * 3 + 1] - s.xyzf[pf * 3 + 1],
                             s.xyzf[fj * 3 + 2] - s.xyzf[pf * 3 + 2]);
    const float sig = p.limb_offset * (dist - p.limb_len[j]) / p.limb_sigma[j];
    const bool active = s.scoref[fj] > 0.0f && s.scoref[pf] > 0.0f;
    add = add + (active ? sig : 0.0f);
  }
  const int rf = p.shoulder_r, lf = p.shoulder_l;
  if (rf >= 0 && (fj == rf || fj == lf)) {
    const float dist = norm3(s.xyzf[rf * 3] - s.xyzf[lf * 3], s.xyzf[rf * 3 + 1] - s.xyzf[lf * 3 + 1],
                             s.xyzf[rf * 3 + 2] - s.xyzf[lf * 3 + 2]);
    const float sig = p.limb_offset * (dist - p.shoulder_dist) / p.shoulder_sigma;
    const bool active = s.scoref[rf] > 0.0f && s.scoref[lf] > 0.0f;
    add = add + (active ? sig : 0.0f);
  }
  const float add2 = add * add;
  F1_UNROLL
  for (int a = 0; a < 3; ++a) {
    F1_UNROLL
    for (int bq = 0; bq < 3; ++bq) {
      s.covf[fj * 9 + a * 3 + bq] = s.covf[fj * 9 + a * 3 + bq] + add2 * (a == bq ? 1.0f : 0.0f);
    }
  }
  float root[3];
  const float root_score = root_of(s, root);
  const float dist = norm3(s.xyzf[fj * 3] - root[0], s.xyzf[fj * 3 + 1] - root[1],
                           s.xyzf[fj * 3 + 2] - root[2]);
  s.dropf[fj] = root_score > 0.0f && s.scoref[fj] > 0.0f && dist > p.max_root_dist;
}

// One thread: fusion.py _person_gate on the gated joints.
F1_FN void person_gate(const Params& p, const Tensors& g, const Smem& s, int h) {
  int n_pre = 0, n_dropped = 0;
  for (int fj = 0; fj < kK; ++fj) {
    n_pre += s.scoref[fj] > 0.0f;
    n_dropped += s.dropf[fj];
  }
  float root[3];
  const bool has_root = root_of(s, root) > 0.0f;
  const bool have_l = s.scoref[kLAnkle] > 0.0f && !s.dropf[kLAnkle];
  const bool have_r = s.scoref[kRAnkle] > 0.0f && !s.dropf[kRAnkle];
  const float zl = s.xyzf[kLAnkle * 3 + 2], zr = s.xyzf[kRAnkle * 3 + 2];
  const float feet = have_l && have_r ? 0.5f * (zl + zr) : have_l ? zl : have_r ? zr : 0.0f;
  const int num_valid = has_root ? n_pre - n_dropped - (kK - n_pre) : n_pre;
  g.valid[h] = F1_ABS(feet) <= p.max_feet_height && num_valid > p.min_valid;
  g.person_id[h] = -1;
}

// (fusion joint, element): the gated outputs.
F1_FN void store(const Smem& s, const Tensors& g, int h, int t) {
  const int fj = t / 13, e = t % 13;
  const bool drop = s.dropf[fj];
  if (e < 3) {
    g.xyz[(static_cast<size_t>(h) * kK + fj) * 3 + e] = drop ? 0.0f : s.xyzf[fj * 3 + e];
  } else if (e == 3) {
    g.score[static_cast<size_t>(h) * kK + fj] = drop ? 0.0f : s.scoref[fj];
  } else {
    g.cov3[(static_cast<size_t>(h) * kK + fj) * 9 + e - 4] = drop ? 0.0f : s.covf[fj * 9 + e - 4];
  }
}

}  // namespace

#ifndef SES3D_HOST

namespace {

#define F1_PHASE(n, body)                                           \
  do {                                                              \
    for (int t = threadIdx.x; t < (n); t += blockDim.x) { body; }   \
    __syncthreads();                                                \
  } while (0)

// One hypothesis (this block's): `dev` is the launch's device memory of
// the wide variant (`device_floats_for` a hypothesis), else null.
template <bool kWide>
__device__ __forceinline__ void triangulate_block(const Params& p, const Tensors& g, float* dev) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int h = blockIdx.x;
  const int c = p.c;
  const Smem s = carve(smem_raw, c, kWide ? dev + static_cast<size_t>(h) * device_floats_for(c)
                                          : nullptr);
  F1_PHASE(load_tasks(c), load(p, g, s, h, t));
  F1_PHASE(kJ * c, contribs(p, g, s, h, t));
  F1_PHASE(kJ * kSym, base_sum(p, s, t));
  F1_PHASE(kJ * (c + 2), solves(p, g, s, t));
  F1_PHASE(kJ, select(p, g, s, h, t));
  F1_PHASE(kJ * c, ut_contribs(p, s, t));
  F1_PHASE(kJ * kSym, ut_sum(p, s, t));
  F1_PHASE(kJ * (c + 1), sigma(p, s, t));
  F1_PHASE(kJ * 6, cov_sum(p, s, t));
  F1_PHASE(kJ, covariance(p, s, t));
  F1_PHASE(kK, inflate(p, s, t));
  F1_PHASE(1, person_gate(p, g, s, h));
  for (int t = threadIdx.x; t < kK * 13; t += blockDim.x) store(s, g, h, t);
}

__global__ void __launch_bounds__(kMaxThreads)
triangulation_kernel(Params p, Tensors g) {
  triangulate_block<false>(p, g, nullptr);
}

__global__ void __launch_bounds__(kMaxThreads)
triangulation_wide_kernel(Params p, Tensors g, float* dev) {
  triangulate_block<true>(p, g, dev);
}

}  // namespace

// The dynamic shared memory one block takes at `cams` cameras (`wide`:
// the wide variant's).
extern "C" int ses3d_triangulate_smem_bytes(int cams, int wide) {
  return static_cast<int>(smem_bytes_for(cams, wide != 0));
}

// The wide variant's device memory per hypothesis at `cams` cameras, bytes.
extern "C" int ses3d_triangulate_wide_bytes(int cams) {
  return static_cast<int>(device_floats_for(cams) * 4);
}

// F1 over `params`' hypotheses on `stream`; `params` points to a Params
// (a void pointer: a C entry's signature names no type of this file's
// unnamed namespace). `dev`, where not null, is the wide variant's device
// memory (ses3d_triangulate_wide_bytes per hypothesis) and launches it.
// Returns the CUDA error (or cudaErrorInvalidValue for settings it does
// not take).
extern "C" int ses3d_triangulate(const void* params, const void* kp, const void* cov,
                                 const void* cam_mask, const void* P, const void* F, void* xyz,
                                 void* score, void* cov3, void* valid, void* person_id,
                                 void* drops, void* dev, int smem_bytes, void* stream) {
  const Params* p = static_cast<const Params*>(params);
  const bool wide = dev != nullptr;
  if (p == nullptr || p->n < 0 || p->c < 1 ||
      static_cast<size_t>(smem_bytes) != smem_bytes_for(p->c, wide)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* kernel = wide ? reinterpret_cast<const void*>(triangulation_wide_kernel)
                            : reinterpret_cast<const void*>(triangulation_kernel);
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
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p->n > 0) {
    const Tensors g{static_cast<const float*>(kp),
                    static_cast<const float*>(cov),
                    static_cast<const unsigned char*>(cam_mask),
                    static_cast<const float*>(P),
                    static_cast<const float*>(F),
                    static_cast<float*>(xyz),
                    static_cast<float*>(score),
                    static_cast<float*>(cov3),
                    static_cast<unsigned char*>(valid),
                    static_cast<int*>(person_id),
                    static_cast<int*>(drops)};
    const auto s = static_cast<cudaStream_t>(stream);
    if (wide) {
      triangulation_wide_kernel<<<p->n, threads_for(p->c), smem_bytes, s>>>(
          *p, g, static_cast<float*>(dev));
    } else {
      triangulation_kernel<<<p->n, threads_for(p->c), smem_bytes, s>>>(*p, g);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

#else  // SES3D_HOST

// The kernel's phases on the host, one hypothesis (block) after another and
// within a phase one task (thread) after another: the same arithmetic, for
// the tests; `wide` lays the working set out as the wide variant does.
// Returns 0.
extern "C" int ses3d_triangulation_host(const void* params, const void* kp, const void* cov,
                                      const void* cam_mask, const void* P, const void* F,
                                      void* xyz, void* score, void* cov3, void* valid,
                                      void* person_id, void* drops, int wide) {
  const Params* p = static_cast<const Params*>(params);
  if (p == nullptr || p->n < 0 || p->c < 1) return 1;
  std::vector<float> raw((smem_bytes_for(p->c, wide != 0) + 3) / 4);
  std::vector<float> dev(wide != 0 ? device_floats_for(p->c) : 0);
  const Smem s = carve(raw.data(), p->c, wide != 0 ? dev.data() : nullptr);
  const Tensors g{static_cast<const float*>(kp),
                  static_cast<const float*>(cov),
                  static_cast<const unsigned char*>(cam_mask),
                  static_cast<const float*>(P),
                  static_cast<const float*>(F),
                  static_cast<float*>(xyz),
                  static_cast<float*>(score),
                  static_cast<float*>(cov3),
                  static_cast<unsigned char*>(valid),
                  static_cast<int*>(person_id),
                  static_cast<int*>(drops)};
  const int c = p->c;
  for (int h = 0; h < p->n; ++h) {
    for (int t = 0; t < load_tasks(c); ++t) load(*p, g, s, h, t);
    for (int t = 0; t < kJ * c; ++t) contribs(*p, g, s, h, t);
    for (int t = 0; t < kJ * kSym; ++t) base_sum(*p, s, t);
    for (int t = 0; t < kJ * (c + 2); ++t) solves(*p, g, s, t);
    for (int t = 0; t < kJ; ++t) select(*p, g, s, h, t);
    for (int t = 0; t < kJ * c; ++t) ut_contribs(*p, s, t);
    for (int t = 0; t < kJ * kSym; ++t) ut_sum(*p, s, t);
    for (int t = 0; t < kJ * (c + 1); ++t) sigma(*p, s, t);
    for (int t = 0; t < kJ * 6; ++t) cov_sum(*p, s, t);
    for (int t = 0; t < kJ; ++t) covariance(*p, s, t);
    for (int t = 0; t < kK; ++t) inflate(*p, s, t);
    person_gate(*p, g, s, h);
    for (int t = 0; t < kK * 13; ++t) store(s, g, h, t);
  }
  return 0;
}

extern "C" int ses3d_triangulation_host_smem_bytes(int cams, int wide) {
  return static_cast<int>(smem_bytes_for(cams, wide != 0));
}

extern "C" int ses3d_triangulation_host_wide_bytes(int cams) {
  return static_cast<int>(device_floats_for(cams) * 4);
}

#endif  // SES3D_HOST
