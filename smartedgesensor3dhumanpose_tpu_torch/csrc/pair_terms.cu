// Kernel E1 (pair_terms_kernel): the per-joint terms of the association's
// epipolar costs for every detection pair of every camera pair, for sm_90a.
//
// It ports no pallas_call. ops/epipolar.py pairwise_association_costs_packed
// (the reference's calcCost, skeleton_3d_triang_mult_node.cpp:335-390,
// evaluated once per frame for every unordered camera pair) forms, per
// frame, camera pair p, joint j and detections (d1, d2),
//   num1 = x2 l10 + y2 l11 + l12   (the point of d2 against the line of d1)
//   num2 = x1 l20 + y1 l21 + l22   (the point of d1 against the line of d2)
//   term = |num1| + |num2| where both joints are confident, else 0,
// and sums the terms and the confident pairs over the joints. In plain
// PyTorch each of those ten operations is a pass over [frames, C(C-1)/2,
// J, D, D] values: half a gigabyte a frame for each at the Panoptic
// dome's 480 cameras. This kernel computes the terms and the confident
// flags in one pass from the per-detection lines and coordinates
// ([frames, C(C-1)/2, J, D] each), operation for operation as the plain
// version rounds them (built with --fmad=false), and leaves the sums over
// the joints to PyTorch's reductions, as before: the results are the plain
// version's bit for bit.
//
// The terms are written in the layout the plain version's CUDA kernels
// give their result, the joints innermost ([frames, pairs, D1, D2, J] in
// memory), so that PyTorch's sum over the joints takes the same order.
// One thread per term, in that order; what bounds it: the bytes it writes
// (5 per term).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

struct Side {
  const float* x;
  const float* y;
  const float* l0;
  const float* l1;
  const float* l2;
  const unsigned char* ok;
};

__global__ void pair_terms_kernel(Side a, Side b, float* term, unsigned char* both,
                                  long long pairs, int joints, int d1, int d2) {
  const long long n = pairs * joints * d1 * d2;
  for (long long t = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; t < n;
       t += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int j = static_cast<int>(t % joints);
    const int k = static_cast<int>(t / joints % d2);
    const int i = static_cast<int>(t / (static_cast<long long>(joints) * d2) % d1);
    const long long row = t / (static_cast<long long>(joints) * d2 * d1) * joints + j;
    const long long ia = row * d1 + i;
    const long long ib = row * d2 + k;
    const float num1 = (b.x[ib] * a.l0[ia] + b.y[ib] * a.l1[ia]) + a.l2[ia];
    const float num2 = (a.x[ia] * b.l0[ib] + a.y[ia] * b.l1[ib]) + b.l2[ib];
    const float d = fabsf(num1) + fabsf(num2);
    const bool on = a.ok[ia] && b.ok[ib];
    term[t] = on ? d : 0.0f;
    both[t] = on;
  }
}

}  // namespace

// The terms of `pairs` (frame, camera pair) rows of `joints` joints of
// d1 x d2 detection pairs on `stream`: side 1's x, y, line (l0, l1, l2)
// and confident flag [pairs, joints, d1] each, side 2's [pairs, joints,
// d2]; out `term` float32 and `both` bytes, [pairs, d1, d2, joints] in
// memory. Returns the CUDA error.
extern "C" int ses3d_pair_terms(const void* x1, const void* y1, const void* l10, const void* l11,
                                const void* l12, const void* ok1, const void* x2, const void* y2,
                                const void* l20, const void* l21, const void* l22,
                                const void* ok2, void* term, void* both, long long pairs,
                                int joints, int d1, int d2, void* stream) {
  if (pairs < 0 || joints < 1 || d1 < 1 || d2 < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n = pairs * joints * d1 * d2;
  if (n > 0) {
    const Side a{static_cast<const float*>(x1), static_cast<const float*>(y1),
                 static_cast<const float*>(l10), static_cast<const float*>(l11),
                 static_cast<const float*>(l12), static_cast<const unsigned char*>(ok1)};
    const Side b{static_cast<const float*>(x2), static_cast<const float*>(y2),
                 static_cast<const float*>(l20), static_cast<const float*>(l21),
                 static_cast<const float*>(l22), static_cast<const unsigned char*>(ok2)};
    const int threads = 256;
    const long long want = (n + threads - 1) / threads;
    const int blocks = static_cast<int>(want < 132LL * 64 ? want : 132LL * 64);
    pair_terms_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        a, b, static_cast<float*>(term), static_cast<unsigned char*>(both), pairs, joints, d1,
        d2);
  }
  return static_cast<int>(cudaGetLastError());
}
