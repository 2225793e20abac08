// Kernels L1 (lm_trip_kernel) and L2 (lm_marginals_kernel): the skeleton
// prior's Levenberg-Marquardt loop and its tree marginals, for sm_90a.
//
// They port no pallas_call. The JAX package runs each LM iteration
// (smartedgesensor3dhumanpose_tpu/prior.py:438-461) as the body of one
// lax.while_loop (:467), which XLA fuses into a handful of kernels, and the
// marginals after it (:476-495) as a second linearisation and a
// sparse-inverse sweep. One launch of L1 runs that whole loop for every
// person, L2 the marginals; ops/lm_prior.py wraps both and holds their
// plain PyTorch twins, which follow this file's order of every sum, so the
// card holds each kernel to its twin bit for bit (build flag --fmad=false:
// no multiply-add is fused).
//
// One warp per person, kPersonsPerBlock persons per block. Lane k < 21 is
// joint k and bone k (the fusion skeleton has 21 of each). Before its first
// trip each lane reads its rows of the topology into registers (Topo: its
// bone's joints, its joint's bones and signs, its slot's bone in each level
// and which slots of the level share its parent or child), and its
// person's inputs and carry; a trip reads no table at a lane-dependent
// address. L2 runs one linearisation, elimination and sweep the same way.
// A person's blocks live in shared memory (struct Person), and the warp
// runs trips until the person is done or the launch's cap, each trip a
// chain of phases with __syncwarp between them:
//   linearise   lanes over bones (direction, residual, gradient, the 3x3
//               block wb u u^T), then over joints (the joint's bones added
//               in ascending bone order; damping on the diagonal);
//   eliminate   the bone tree's levels deepest first, a level's bones on
//               groups of six lanes (slot i = lane / 6 takes the level's
//               bone i): the group computes its child's inverse (at most
//               two IEEE divisions a lane, gathered by shuffles, kept for
//               the solve), lane q < 3 row q of the child's elimination,
//               and the first slot of each parent adds its own update,
//               then its siblings', shuffled to it in the level's order;
//   solve       the roots' inverses (a lane per element), every joint's own
//               solve, then the levels shallow to deep (lane q < 3 of the
//               child's first slot writes component q, from the level's
//               last active bone with that child);
//   step        non-finite components 0, x + delta, the new error (every
//               lane sums the 21 joint terms and the 21 bone terms in
//               order, shuffled from their lanes), and prior._lm_trip's
//               accept, convergence, lambda and freeze rules.
// The carry (x, err, lam, done) stays on chip between trips and is written
// once at the end. A person done at the start runs no trip: its carry stays
// as it is, as the plain trip's freeze rules leave it.
//
// The loop's count. Persons are independent; the only quantity they share
// is the count `iters`, the trips that started with some person running,
// capped at max_iters. A person that finishes after n_p trips runs
// min(n_p, cap) of them here, cap = min(max_trips, max_iters - iters_in),
// and ends where a loop of single trips leaves it; that loop runs max_p
// min(n_p, cap) trips. Each block folds its warps' (2 trips + still
// running) into scratch[0] by atomicMax (a person still running ran the
// most trips, cap) and takes a ticket from scratch[1]; the last block adds
// the trips to `iters`, sets `running` (some person not done), zeroes both
// counters and, where the caller passes a log, writes the trips run and
// the device clock at the end (block 0 writes it at its start).
//
// What bounds it: latency. A person's trip is ~9,300 float operations in a
// chain of five tree levels each way; the launch reads each input once and
// writes the carry once (~0.7 MB at P = 512, bound ~2e-4 ms), where a trip
// costs microseconds on one warp.

#include <cuda_runtime.h>

namespace {

constexpr int kJ = 21;  // joints
constexpr int kB = 21;  // bones
constexpr int kLevels = 5;
constexpr int kMaxLevel = 5;   // bones in the widest level
constexpr int kMaxDegree = 5;  // bones at one joint
// Four persons a block; one block an SM is all a warp that waits on its
// own chain needs, and the bound lets ptxas keep every value in registers
// (without it L2 spilled a flag around the divisions' slow-path calls).
constexpr int kPersonsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

// The topology (ops/lm_prior.py `cuda_tables`, pinned there by a test):
// bone b joins parent joint c_bone_i[b] to child joint c_bone_j[b]; level l
// holds bones c_level_bone[c_level_start[l] .. c_level_start[l + 1]),
// deepest child first; joint k's bones are c_inc_bone[c_inc_start[k] ..
// c_inc_start[k + 1]) with the joint's sign in each. Read once per launch
// (load_topo), never inside a trip.
__constant__ int c_bone_i[kB] = {8, 8, 9, 10, 12, 13, 1, 1, 1, 2, 3, 5, 6, 8, 20, 0, 0, 0, 15, 16, 8};
__constant__ int c_bone_j[kB] = {9, 12, 10, 11, 13, 14, 0, 2, 5, 3, 4, 6, 7, 20, 1, 19, 15, 16, 17, 18, 1};
__constant__ int c_level_start[kLevels + 1] = {0, 4, 9, 14, 18, 21};
__constant__ int c_level_bone[kB] = {10, 12, 18, 19, 9, 11, 15, 16, 17, 3, 5, 6, 7, 8, 2, 4, 14, 20, 0, 1, 13};
__constant__ int c_inc_start[kJ + 1] = {0, 4, 9, 11, 13, 14, 16, 18, 19, 23, 25, 27, 28, 30, 32, 33, 35, 37, 38, 39, 40, 42};
__constant__ int c_inc_bone[2 * kB] = {6, 15, 16, 17, 6, 7, 8, 14, 20, 7, 9, 9, 10, 10, 8, 11, 11, 12, 12, 0, 1, 13, 20, 0, 2, 2, 3, 3, 1, 4, 4, 5, 5, 16, 18, 17, 19, 18, 19, 15, 13, 14};
__constant__ float c_inc_sign[2 * kB] = {-1.f, 1.f, 1.f, 1.f, 1.f, 1.f, 1.f, -1.f, -1.f, -1.f, 1.f, -1.f, 1.f, -1.f, -1.f, 1.f, -1.f, 1.f, -1.f, 1.f, 1.f, 1.f, 1.f, -1.f, 1.f, -1.f, 1.f, -1.f, -1.f, 1.f, -1.f, 1.f, -1.f, -1.f, 1.f, -1.f, 1.f, -1.f, -1.f, -1.f, -1.f, 1.f};

// One person's working set.
struct Person {
  float x[kJ][3];        // the joints the trip linearises at
  float xs[kJ][3];       // the solution, then x + delta
  float gb[kB][3];       // wb r_b u
  float uu[kB][9];       // wb u u^T (the coupling is its negative)
  float d[kJ][9];        // damped diagonal blocks, eliminated; L2: sigma
  float dinv[kJ][9];     // their inverses
  float r[kJ][3];        // -g, eliminated
};

// The tree levels spread over lane groups: slot i = lane / kGroup of a
// level handles the level's bone i, and its kGroup lanes share that bone's
// 3x3 work by element (lane q of the group owns elements q and q + kGroup
// of a block, and component q of a vector).
constexpr int kGroup = 6;
static_assert(kMaxLevel * kGroup <= 32 && 2 * kGroup >= 9, "a level's groups fit a warp");

// Lane `lane`'s rows of the topology, in registers (the level arrays are
// indexed by unrolled loops only). Slot masks have bit j for slot j.
struct Topo {
  int bi, bj;                      // bone role: its parent and child joint
  int deg;                         // joint role: its bones, ascending,
  int inc_b[kMaxDegree];           //   and its sign in each
  float inc_s[kMaxDegree];
  unsigned roots;                  // uniform: joints no bone ends at
  int lb[kLevels];                 // level role: the bone of this lane's
  int lc[kLevels], lp[kLevels];    //   slot (-1 past the level), its joints
  unsigned sib[kLevels];           // the parent's first slot: the level's
                                   //   slots with its parent, else 0
  unsigned kin[kLevels];           // the child's first slot: the level's
                                   //   slots with its child, else 0
  unsigned later[kLevels];         // uniform: slots not first of their parent
  unsigned later_c[kLevels];       // uniform: slots not first of their child
};

// The slots whose first lane (lane kGroup * j) is set in `lanes`.
__device__ __forceinline__ unsigned slot_mask(unsigned lanes) {
  unsigned out = 0u;
#pragma unroll
  for (int j = 0; j < kMaxLevel; ++j) out |= ((lanes >> (kGroup * j)) & 1u) << j;
  return out;
}

__device__ __forceinline__ Topo load_topo(int lane) {
  Topo t;
  const int b = lane < kB ? lane : 0;
  t.bi = c_bone_i[b];
  t.bj = c_bone_j[b];
  const int k = lane < kJ ? lane : 0;
  const int i0 = c_inc_start[k];
  t.deg = lane < kJ ? c_inc_start[k + 1] - i0 : 0;
#pragma unroll
  for (int i = 0; i < kMaxDegree; ++i) {
    const int at = i < t.deg ? i0 + i : 0;
    t.inc_b[i] = c_inc_bone[at];
    t.inc_s[i] = c_inc_sign[at];
  }
  unsigned children = 0u;
  for (int j = 0; j < kB; ++j) children |= 1u << c_bone_j[j];  // j uniform
  t.roots = ~children & ((1u << kJ) - 1u);
  const int slot = lane / kGroup, q = lane - kGroup * slot;
#pragma unroll
  for (int l = 0; l < kLevels; ++l) {
    const int b0 = c_level_start[l], nb = c_level_start[l + 1] - b0;
    const bool in = slot < nb;
    const int lb = c_level_bone[b0 + (in ? slot : 0)];
    const int c = c_bone_j[lb], pj = c_bone_i[lb];
    t.lb[l] = in ? lb : -1;
    t.lc[l] = c;
    t.lp[l] = pj;
    unsigned sib = 0u, kin = 0u;
    bool first_p = in, first_c = in;
    for (int j = 0; j < nb; ++j) {  // j uniform: broadcast reads
      const int bj = c_level_bone[b0 + j];
      const bool same_p = c_bone_i[bj] == pj, same_c = c_bone_j[bj] == c;
      if (j < slot) {
        first_p = first_p && !same_p;
        first_c = first_c && !same_c;
      }
      sib |= same_p ? 1u << j : 0u;
      kin |= same_c ? 1u << j : 0u;
    }
    t.sib[l] = first_p ? sib : 0u;
    t.kin[l] = first_c ? kin : 0u;
    t.later[l] = slot_mask(__ballot_sync(kFull, q == 0 && in && !first_p));
    t.later_c[l] = slot_mask(__ballot_sync(kFull, q == 0 && in && !first_c));
  }
  return t;
}

// Per person: whether the bone of lane's slot in level l is active (bit l
// of `on`; masks, not bools, keep them out of predicate registers), and
// for the child's first slot the level's slots with its child whose bone
// is active.
struct Active {
  unsigned on;
  unsigned kin_on[kLevels];
  __device__ __forceinline__ bool at(int l) const { return ((on >> l) & 1u) != 0u; }
};

__device__ __forceinline__ Active load_active(const Topo& t, int lane, bool bone_on) {
  Active a;
  a.on = 0u;
  const int q = lane % kGroup;
#pragma unroll
  for (int l = 0; l < kLevels; ++l) {
    const int src = t.lb[l] < 0 ? 0 : t.lb[l];
    const bool on = __shfl_sync(kFull, bone_on ? 1 : 0, src) != 0 && t.lb[l] >= 0;
    a.on |= on ? 1u << l : 0u;
    a.kin_on[l] = t.kin[l] & slot_mask(__ballot_sync(kFull, q == 0 && on));
  }
  return a;
}

// v[e] for a lane-dependent e in [0, 9), by selects (no local memory).
__device__ __forceinline__ float pick9(const float* v, int e) {
  float out = v[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) out = e == i ? v[i] : out;
  return out;
}

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2];
}

// m @ v, m row-major 3x3.
__device__ __forceinline__ void mv3(const float* m, const float* v, float* out) {
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = dot3(m + 3 * i, v);
}

// a @ b.
__device__ __forceinline__ void mm3(const float* a, const float* b, float* out) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      out[3 * i + j] = (a[3 * i] * b[j] + a[3 * i + 1] * b[3 + j]) + a[3 * i + 2] * b[6 + j];
    }
  }
}

// The adjugate of m (row-major) and the divisor of its inverse: the
// determinant, 1 where |det| <= 1e-30 (ops/linalg.py adjugate3,
// tree_solve._inv3). The inverse's element e is adj[e] / den.
__device__ __forceinline__ float adjugate3(const float* m, float* adj) {
  const float c00 = m[4] * m[8] - m[5] * m[7];
  const float c01 = m[5] * m[6] - m[3] * m[8];
  const float c02 = m[3] * m[7] - m[4] * m[6];
  const float det = (m[0] * c00 + m[1] * c01) + m[2] * c02;
  adj[0] = c00; adj[3] = c01; adj[6] = c02;
  adj[1] = m[2] * m[7] - m[1] * m[8];
  adj[4] = m[0] * m[8] - m[2] * m[6];
  adj[7] = m[1] * m[6] - m[0] * m[7];
  adj[2] = m[1] * m[5] - m[2] * m[4];
  adj[5] = m[2] * m[3] - m[0] * m[5];
  adj[8] = m[0] * m[4] - m[1] * m[3];
  return fabsf(det) > 1e-30f ? det : 1.f;
}

// Bone (bi, bj) at the joints x: its unit direction u, residual rb and
// weight wb.
__device__ __forceinline__ void bone_terms(const float (*x)[3], int bi, int bj, float blen,
                                           float bw, bool on, float* u, float& rb, float& wb) {
  float dv[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) dv[c] = x[bi][c] - x[bj][c];
  const float n = sqrtf(dot3(dv, dv));
  const bool safe = n > 1e-12f;
  const float den = safe ? n : 1.f;
#pragma unroll
  for (int c = 0; c < 3; ++c) u[c] = dv[c] / den;
  rb = (safe ? n : 0.f) - blen;
  wb = (on ? 1.f : 0.f) * bw;
}

// Lane k's joint and lane b's bone of a person.
struct Inputs {
  float C[9], m[3], xk[3], act, blen, bw;
  bool on;
};

// The tree-factored normal equations at s.x (lane k's joint at xk): s.uu,
// and s.d = inv_cov + the joint's bone blocks (+ lam on the diagonal); with
// kTrip also s.gb and s.r = -g.
template <bool kTrip>
__device__ __forceinline__ void linearize(Person& s, int lane, const Topo& t, const Inputs& in,
                                          const float* xk, float lam) {
  if (lane < kB) {
    float u[3], rb, wb;
    bone_terms(s.x, t.bi, t.bj, in.blen, in.bw, in.on, u, rb, wb);
    if constexpr (kTrip) {
      const float wr = wb * rb;
#pragma unroll
      for (int c = 0; c < 3; ++c) s.gb[lane][c] = wr * u[c];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float wu = wb * u[i];
#pragma unroll
      for (int j = 0; j < 3; ++j) s.uu[lane][3 * i + j] = wu * u[j];
    }
  }
  float gu[3] = {0.f, 0.f, 0.f};
  if (kTrip && lane < kJ) {
    float ru[3], w[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) ru[c] = xk[c] - in.m[c];
    mv3(in.C, ru, w);
#pragma unroll
    for (int c = 0; c < 3; ++c) gu[c] = in.act * w[c];
  }
  __syncwarp();
  if (lane < kJ) {
    float ag[3] = {0.f, 0.f, 0.f};
    float ah[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kMaxDegree; ++i) {
      if (i < t.deg) {
        const int b = t.inc_b[i];
        if constexpr (kTrip) {
#pragma unroll
          for (int c = 0; c < 3; ++c) ag[c] = ag[c] + t.inc_s[i] * s.gb[b][c];
        }
#pragma unroll
        for (int e = 0; e < 9; ++e) ah[e] = ah[e] + s.uu[b][e];
      }
    }
#pragma unroll
    for (int e = 0; e < 9; ++e) {
      const float h = in.C[e] + ah[e];
      s.d[lane][e] = kTrip ? h + lam * (e % 4 == 0 ? 1.f : 0.f) : h;
    }
    if constexpr (kTrip) {
#pragma unroll
      for (int c = 0; c < 3; ++c) s.r[lane][c] = -(gu[c] + ag[c]);
    }
  }
  __syncwarp();
}

// The coupling of bone b as the solve uses it: -uu where the bone is
// active, else 0.
__device__ __forceinline__ void coupling(const Person& s, int b, bool on, float* cm) {
#pragma unroll
  for (int e = 0; e < 9; ++e) cm[e] = on ? -s.uu[b][e] : 0.f;
}

// The coupling's row r (cm[3r .. 3r + 2] of `coupling`), read at a
// lane-dependent row.
__device__ __forceinline__ void coupling_row(const Person& s, int b, bool on, int r, float* row) {
#pragma unroll
  for (int k = 0; k < 3; ++k) row[k] = on ? -s.uu[b][3 * r + k] : 0.f;
}

// Row r of a @ b (mm3's elements 3r .. 3r + 2), given a's row r.
__device__ __forceinline__ void row_mm3(const float* a_row, const float* b, float* out) {
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    out[j] = (a_row[0] * b[j] + a_row[1] * b[3 + j]) + a_row[2] * b[6 + j];
  }
}

// Forward elimination over the levels, deepest first, on s.d (and s.r);
// s.dinv of every child joint on the way. A slot's six lanes compute the
// child's inverse (elements q and q + kGroup of lane q: two divisions at
// most) and gather it; lane q < 3 computes row q of the update and its
// right-hand side component q; the parent's first slot adds its own
// update, then its siblings' in the level's order, row by row.
template <bool kRhs>
__device__ __forceinline__ void eliminate(Person& s, int lane, const Topo& t, const Active& a) {
  const int q = lane % kGroup, base = lane - q;
  const int q2 = q + kGroup < 9 ? q + kGroup : q;  // lane's second element
  const bool two = q + kGroup < 9, owner = q < 3;
  const int r = owner ? q : 0;                      // lane's row
#pragma unroll
  for (int l = 0; l < kLevels; ++l) {
    const int b = t.lb[l];
    float v0 = 0.f, v1 = 0.f;  // the inverse's elements q and q2
    if (b >= 0) {
      float adj[9];
      const float den = adjugate3(s.d[t.lc[l]], adj);
      v0 = pick9(adj, q) / den;
      if (two) v1 = pick9(adj, q2) / den;
    }
    float inv[9];
#pragma unroll
    for (int e = 0; e < 9; ++e) inv[e] = __shfl_sync(kFull, e < kGroup ? v0 : v1, base + e % kGroup);
    float u[3] = {0.f, 0.f, 0.f}, ur = 0.f;  // -(cdinv cm) row r, -(cdinv r_c)[r]
    if (b >= 0) {
      const int c = t.lc[l];
      if (t.kin[l] != 0u) {
        s.dinv[c][q] = v0;
        if (two) s.dinv[c][q2] = v1;
      }
      float cm[9], cmr[3], cd[3], tt[3];
      coupling(s, b, a.at(l), cm);
      coupling_row(s, b, a.at(l), r, cmr);
      row_mm3(cmr, inv, cd);  // row r of cdinv = cm inv
      row_mm3(cd, cm, tt);
#pragma unroll
      for (int k = 0; k < 3; ++k) u[k] = -tt[k];
      if constexpr (kRhs) ur = -dot3(cd, s.r[c]);
    }
    const bool first = owner && t.sib[l] != 0u;
    const int pj = t.lp[l];
    float acc[3] = {0.f, 0.f, 0.f}, accr = 0.f;
    if (first) {
#pragma unroll
      for (int k = 0; k < 3; ++k) acc[k] = s.d[pj][3 * r + k] + u[k];
      if constexpr (kRhs) accr = s.r[pj][r] + ur;
    }
    for (unsigned m = t.later[l]; m != 0u; m &= m - 1u) {
      const int j = __ffs(m) - 1, src = kGroup * j + q;
      const bool mine = first && ((t.sib[l] >> j) & 1u) != 0u;
      float w[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) w[k] = __shfl_sync(kFull, u[k], src);
      const float wr = kRhs ? __shfl_sync(kFull, ur, src) : 0.f;
      if (mine) {
#pragma unroll
        for (int k = 0; k < 3; ++k) acc[k] = acc[k] + w[k];
        accr = accr + wr;
      }
    }
    if (first) {
#pragma unroll
      for (int k = 0; k < 3; ++k) s.d[pj][3 * r + k] = acc[k];
      if constexpr (kRhs) s.r[pj][r] = accr;
    }
    __syncwarp();
  }
}

// Writes the child joints of level l: lane q < 3 of the child's first slot
// writes the joint's row q (n = 9) or component q (n = 3) from the last of
// the level's slots with that child whose bone is active, in the level's
// order; v: this lane's n / 3 values.
template <int n>
__device__ __forceinline__ void put_children(float (*dst)[n], int l, int lane, const Topo& t,
                                             const Active& a, const float* v) {
  constexpr int w = n / 3;
  const int slot = lane / kGroup, q = lane - kGroup * slot;
  float o[w];
#pragma unroll
  for (int k = 0; k < w; ++k) o[k] = v[k];
  bool has = ((a.kin_on[l] >> slot) & 1u) != 0u;
  for (unsigned m = t.later_c[l]; m != 0u; m &= m - 1u) {
    const int j = __ffs(m) - 1;
    const bool take = ((a.kin_on[l] >> j) & 1u) != 0u;
#pragma unroll
    for (int k = 0; k < w; ++k) {
      const float x = __shfl_sync(kFull, v[k], kGroup * j + q);
      if (take) o[k] = x;
    }
    has = has || take;
  }
  if (has && q < 3) {
#pragma unroll
    for (int k = 0; k < w; ++k) dst[t.lc[l]][w * q + k] = o[k];
  }
  __syncwarp();
}

// The roots' inverses into s.dinv (every other joint's came from the
// elimination, of the same block): lane e < 9 computes element e.
__device__ __forceinline__ void root_inverse(Person& s, int lane, const Topo& t) {
  for (unsigned m = t.roots; m != 0u; m &= m - 1u) {
    const int r = __ffs(m) - 1;
    if (lane < 9) {
      float adj[9];
      const float den = adjugate3(s.d[r], adj);
      s.dinv[r][lane] = pick9(adj, lane) / den;
    }
  }
  __syncwarp();
}

// The solution s.xs: every joint's own solve, then the levels shallow to
// deep (lane q < 3 of a slot computes its child's component q).
__device__ __forceinline__ void back_substitute(Person& s, int lane, const Topo& t,
                                                const Active& a) {
  root_inverse(s, lane, t);
  if (lane < kJ) mv3(s.dinv[lane], s.r[lane], s.xs[lane]);
  __syncwarp();
  const int q = lane % kGroup, row = 3 * (q < 3 ? q : 0);
#pragma unroll
  for (int l = kLevels - 1; l >= 0; --l) {
    const int b = t.lb[l];
    float xq[1] = {0.f};
    if (b >= 0) {
      const int c = t.lc[l];
      float cm[9], tv[3], v[3];
      coupling(s, b, a.at(l), cm);
      mv3(cm, s.xs[t.lp[l]], tv);
#pragma unroll
      for (int k = 0; k < 3; ++k) v[k] = s.r[c][k] - tv[k];
      xq[0] = dot3(s.dinv[c] + row, v);
    }
    put_children<3>(s.xs, l, lane, t, a, xq);
  }
}

// The diagonal blocks of H^-1 into s.d from the eliminated s.d: every
// joint's inverse, then the levels shallow to deep (lane q < 3 of a slot
// computes row q of its child's block).
__device__ __forceinline__ void sigma_sweep(Person& s, int lane, const Topo& t, const Active& a) {
  root_inverse(s, lane, t);
  if (lane < kJ) {
#pragma unroll
    for (int e = 0; e < 9; ++e) s.d[lane][e] = s.dinv[lane][e];
  }
  __syncwarp();
  const int q = lane % kGroup, r = q < 3 ? q : 0;
#pragma unroll
  for (int l = kLevels - 1; l >= 0; --l) {
    const int b = t.lb[l];
    float sc[3] = {0.f, 0.f, 0.f};  // row r of the child's block
    if (b >= 0) {
      const int c = t.lc[l];
      float cm[9], km[9], kmr[3], tt[3];
      coupling(s, b, a.at(l), cm);
      mm3(s.dinv[c], cm, km);
      row_mm3(s.dinv[c] + 3 * r, cm, kmr);  // km's row r
      row_mm3(kmr, s.d[t.lp[l]], tt);
#pragma unroll
      for (int k = 0; k < 3; ++k) sc[k] = s.dinv[c][3 * r + k] + dot3(tt, km + 3 * k);
    }
    put_children<9>(s.d, l, lane, t, a, sc);
  }
}

// The total error at x (lane k's joint at xk), on every lane: 0.5 (joint
// terms summed in order) + 0.5 (bone terms summed in order).
__device__ __forceinline__ float total_error(int lane, const float (*x)[3], const float* xk,
                                             const Topo& t, const Inputs& in) {
  float ej = 0.f, eb = 0.f;
  if (lane < kJ) {
    float ru[3], w[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) ru[c] = xk[c] - in.m[c];
    mv3(in.C, ru, w);
    ej = in.act * dot3(ru, w);
  }
  if (lane < kB) {
    float u[3], rb, wb;
    bone_terms(x, t.bi, t.bj, in.blen, in.bw, in.on, u, rb, wb);
    eb = (wb * rb) * rb;
  }
  float su = __shfl_sync(kFull, ej, 0), sb = __shfl_sync(kFull, eb, 0);
#pragma unroll
  for (int k = 1; k < kJ; ++k) su = su + __shfl_sync(kFull, ej, k);
#pragma unroll
  for (int b = 1; b < kB; ++b) sb = sb + __shfl_sync(kFull, eb, b);
  return 0.5f * su + 0.5f * sb;
}

__device__ __forceinline__ Inputs load(int p, int lane, const float* x, const float* meas,
                                       const unsigned char* active, const float* inv_cov,
                                       const unsigned char* bone_active, const float* bone_len,
                                       const float* bone_w) {
  Inputs in{};
  if (lane < kJ) {
    const int k = p * kJ + lane;
#pragma unroll
    for (int e = 0; e < 9; ++e) in.C[e] = inv_cov[9 * k + e];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      in.m[c] = meas[3 * k + c];
      in.xk[c] = x[3 * k + c];
    }
    in.act = (active != nullptr && active[k]) ? 1.f : 0.f;
  }
  if (lane < kB) {
    in.on = bone_active[p * kB + lane] != 0;
    in.blen = bone_len[lane];
    in.bw = bone_w[lane];
  }
  return in;
}

__device__ __forceinline__ long long global_ns() {
  long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  return ns;
}

struct Rules {
  float lam_factor, lam_upper, abs_tol, rel_tol;
};

__global__ void __launch_bounds__(32 * kPersonsPerBlock, 1)
lm_trip_kernel(float* __restrict__ x_g, float* __restrict__ err_g, float* __restrict__ lam_g,
               unsigned char* __restrict__ done_g, int* iters, unsigned char* running,
               int* scratch, const float* __restrict__ meas,
               const unsigned char* __restrict__ active, const float* __restrict__ inv_cov,
               const unsigned char* __restrict__ bone_active,
               const float* __restrict__ bone_len, const float* __restrict__ bone_w,
               int persons, int max_trips, int max_iters, Rules rules, int* log_trips,
               long long* log_stamps) {
  __shared__ Person s_all[kPersonsPerBlock];
  __shared__ int s_count[kPersonsPerBlock];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p = blockIdx.x * kPersonsPerBlock + warp;
  if (log_stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0) log_stamps[0] = global_ns();
  const int iters_in = *iters;
  const int cap = min(max_trips, max_iters - iters_in);
  int trips = 0;
  bool done = true;
  if (p < persons && done_g[p] == 0) {
    done = false;
    Person& s = s_all[warp];
    const Topo t = load_topo(lane);
    const Inputs in = load(p, lane, x_g, meas, active, inv_cov, bone_active, bone_len, bone_w);
    const Active a = load_active(t, lane, in.on);
    float xk[3] = {in.xk[0], in.xk[1], in.xk[2]};
    if (lane < kJ) {
#pragma unroll
      for (int c = 0; c < 3; ++c) s.x[lane][c] = xk[c];
    }
    float lam = lam_g[p], err = err_g[p];
    while (!done && trips < cap) {
      linearize<true>(s, lane, t, in, xk, lam);
      eliminate<true>(s, lane, t, a);
      back_substitute(s, lane, t, a);
      float xn[3] = {0.f, 0.f, 0.f};
      if (lane < kJ) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float dl = s.xs[lane][c];
          xn[c] = xk[c] + (isfinite(dl) ? dl : 0.f);
          s.xs[lane][c] = xn[c];
        }
      }
      __syncwarp();
      const float err_new = total_error(lane, s.xs, xn, t, in);
      // prior._lm_trip's rules, on every lane (err_new is the same on all).
      const bool finite = isfinite(err_new);
      const bool accept = (err_new < err) && finite;
      const float dec = err - err_new;
      const bool conv = finite && ((fabsf(dec) <= rules.abs_tol) ||
                                   (fabsf(dec) <= rules.rel_tol * err));
      const float lam_next = accept ? lam / rules.lam_factor : lam * rules.lam_factor;
      done = conv || (lam_next > rules.lam_upper);
      lam = lam_next;
      if (accept) {
        err = err_new;
        if (lane < kJ) {
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            xk[c] = xn[c];
            s.x[lane][c] = xn[c];
          }
        }
      }
      ++trips;
      __syncwarp();
    }
    if (trips > 0) {
      if (lane < kJ) {
#pragma unroll
        for (int c = 0; c < 3; ++c) x_g[3 * (p * kJ + lane) + c] = xk[c];
      }
      if (lane == 0) {
        err_g[p] = err;
        lam_g[p] = lam;
        done_g[p] = done;
      }
    }
  }
  if (lane == 0) s_count[warp] = 2 * trips + (done ? 0 : 1);
  __syncthreads();
  if (threadIdx.x == 0) {
    int v = 0;
#pragma unroll
    for (int w = 0; w < kPersonsPerBlock; ++w) v = max(v, s_count[w]);
    if (v != 0) atomicMax(&scratch[0], v);
    __threadfence();
    if (atomicAdd(&scratch[1], 1) == static_cast<int>(gridDim.x) - 1) {
      __threadfence();
      const int total = atomicExch(&scratch[0], 0);
      atomicExch(&scratch[1], 0);
      *iters = iters_in + (total >> 1);
      *running = static_cast<unsigned char>(total & 1);
      if (log_trips != nullptr) {
        *log_trips = total >> 1;
        log_stamps[total >> 1] = global_ns();
      }
    }
  }
}

__global__ void __launch_bounds__(32 * kPersonsPerBlock, 1)
lm_marginals_kernel(const float* __restrict__ x_in, const float* __restrict__ meas,
                    const float* __restrict__ inv_cov,
                    const unsigned char* __restrict__ bone_active,
                    const float* __restrict__ bone_len, const float* __restrict__ bone_w,
                    float* __restrict__ x_out, float* __restrict__ marg,
                    unsigned char* __restrict__ marg_ok, int persons) {
  __shared__ Person s_all[kPersonsPerBlock];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p = blockIdx.x * kPersonsPerBlock + warp;
  if (p >= persons) return;  // the whole warp
  Person& s = s_all[warp];
  const Topo t = load_topo(lane);
  const Inputs in = load(p, lane, x_in, meas, nullptr, inv_cov, bone_active, bone_len, bone_w);
  const Active a = load_active(t, lane, in.on);
  // Some joint of the person not finite (taken again at the end: a flag
  // kept across the solve ends up spilled).
  const auto any_bad = [&]() {
    return __any_sync(kFull, lane < kJ && !(isfinite(in.xk[0]) && isfinite(in.xk[1]) &&
                                            isfinite(in.xk[2])));
  };
  const bool bad = any_bad();
  float xk[3] = {0.f, 0.f, 0.f};
  if (lane < kJ) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      xk[c] = bad ? in.m[c] : in.xk[c];
      s.x[lane][c] = xk[c];
      x_out[3 * (p * kJ + lane) + c] = xk[c];
    }
  }
  __syncwarp();
  linearize<false>(s, lane, t, in, xk, 0.f);
  eliminate<false>(s, lane, t, a);
  sigma_sweep(s, lane, t, a);
  bool finite = true;
  if (lane < kJ) {
#pragma unroll
    for (int e = 0; e < 9; ++e) finite = finite && isfinite(s.d[lane][e]);
  }
  const bool ok = __all_sync(kFull, finite) && !any_bad();
  if (lane < kJ) {
#pragma unroll
    for (int e = 0; e < 9; ++e) {
      marg[9 * (p * kJ + lane) + e] = ok ? s.d[lane][e] : (e % 4 == 0 ? 1.f : 0.f);
    }
  }
  if (lane == 0) marg_ok[p] = ok ? 1 : 0;
}

int blocks_for(int persons) { return (persons + kPersonsPerBlock - 1) / kPersonsPerBlock; }

}  // namespace

// The LM for `persons` persons, in place on (x, err, lam, done, iters,
// running): every person runs trips until it is done, until max_trips trips
// have run or until iters would pass max_iters (the loop's cap); iters
// gains the trips the loop ran. scratch: int32 [2], zero before and after.
// log_trips (int32) and log_stamps (int64, one more than the trips that
// can run), both or neither: the trips run and the device clock (ns) at
// the start and after the last trip. Returns the launch's CUDA error.
extern "C" int ses3d_lm_trip(void* x, void* err, void* lam, void* done, void* iters,
                             void* running, void* scratch, const void* meas, const void* active,
                             const void* inv_cov, const void* bone_active, const void* bone_len,
                             const void* bone_w, int persons, int max_trips, int max_iters,
                             float lam_factor, float lam_upper, float abs_tol, float rel_tol,
                             void* log_trips, void* log_stamps, void* stream) {
  if (persons <= 0 || max_trips < 0 || (log_trips == nullptr) != (log_stamps == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  lm_trip_kernel<<<blocks_for(persons), 32 * kPersonsPerBlock, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(x), static_cast<float*>(err), static_cast<float*>(lam),
      static_cast<unsigned char*>(done), static_cast<int*>(iters),
      static_cast<unsigned char*>(running), static_cast<int*>(scratch),
      static_cast<const float*>(meas), static_cast<const unsigned char*>(active),
      static_cast<const float*>(inv_cov), static_cast<const unsigned char*>(bone_active),
      static_cast<const float*>(bone_len), static_cast<const float*>(bone_w), persons,
      max_trips, max_iters, Rules{lam_factor, lam_upper, abs_tol, rel_tol},
      static_cast<int*>(log_trips), static_cast<long long*>(log_stamps));
  return static_cast<int>(cudaGetLastError());
}

// The marginals at the final x: x_out (x, or the measurements where x is
// not finite), marg [P, 21, 3, 3], marg_ok [P].
extern "C" int ses3d_lm_marginals(const void* x, const void* meas, const void* inv_cov,
                                  const void* bone_active, const void* bone_len,
                                  const void* bone_w, void* x_out, void* marg, void* marg_ok,
                                  int persons, void* stream) {
  if (persons <= 0) return static_cast<int>(cudaErrorInvalidValue);
  lm_marginals_kernel<<<blocks_for(persons), 32 * kPersonsPerBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(meas),
      static_cast<const float*>(inv_cov), static_cast<const unsigned char*>(bone_active),
      static_cast<const float*>(bone_len), static_cast<const float*>(bone_w),
      static_cast<float*>(x_out), static_cast<float*>(marg),
      static_cast<unsigned char*>(marg_ok), persons);
  return static_cast<int>(cudaGetLastError());
}
