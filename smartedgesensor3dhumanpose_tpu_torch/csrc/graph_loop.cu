// A loop that stops on the device inside a captured CUDA graph: one WHILE
// conditional node (CUDA 12.4 or later) around a captured loop body.
//
// This is the port's counterpart of jax.lax.while_loop in the two loops the
// JAX package runs on the device: the LM iteration
// (smartedgesensor3dhumanpose_tpu/prior.py:463-469) and the track-merge
// fixpoint (smartedgesensor3dhumanpose_tpu/tracking.py:398-413). It is not
// a port of a TPU kernel: it is how a CUDA graph expresses such a loop.
// ops/loops.py drives it.
//
// While a stream captures a graph, ses3d_loop_begin
//  1. creates a conditional handle in the graph being captured,
//  2. captures a one-thread kernel that zeroes the trip count and sets the
//     handle to the loop's first test (pred && max_trips > 0),
//  3. adds a WHILE node after it, makes the node the stream's capture
//     dependency, and
//  4. starts capturing `body_stream` into the node's body graph.
// The caller then records one trip on `body_stream`, its test last, and
// ses3d_loop_next captures a one-thread kernel that counts the trip and sets
// the handle to (pred && trips < max_trips). ses3d_loop_end ends the body's
// capture. On a replay the device runs the body while the handle is set,
// and the stream's later work waits for the node: no host reads a value.
//
// Where the caller passes `stamps` (int64 [max_trips + 1], or null), the
// two kernels also write the device clock (%globaltimer, ns) there: at the
// loop's start and at the end of each trip that ran, so a replay leaves a
// trace of its trips on the device (ops/loops.py `trip_log`).
//
// What bounds it: nothing of note; the two kernels are a thread each, one
// per loop and one per trip that runs. A trip that does not run costs
// nothing: no node of the body runs.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void loop_begin_kernel(cudaGraphConditionalHandle handle,
                                  const bool* pred, int* trips, int max_trips,
                                  long long* stamps) {
  *trips = 0;
  if (stamps != nullptr) stamps[0] = global_ns();
  cudaGraphSetConditional(handle, (max_trips > 0 && *pred) ? 1u : 0u);
}

__global__ void loop_next_kernel(cudaGraphConditionalHandle handle,
                                 const bool* pred, int* trips, int max_trips,
                                 long long* stamps) {
  const int t = *trips + 1;
  *trips = t;
  if (stamps != nullptr) stamps[t] = global_ns();
  cudaGraphSetConditional(handle, (t < max_trips && *pred) ? 1u : 0u);
}

}  // namespace

// Returns cudaErrorIllegalState, and records nothing, where `stream` is not
// capturing; else the first CUDA error of the steps above.
extern "C" int ses3d_loop_begin(void* stream, const void* pred, void* trips,
                                int max_trips, void* stamps, void* body_stream,
                                unsigned long long* handle_out) {
  const auto s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  cudaError_t err =
      cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (status != cudaStreamCaptureStatusActive) {
    return static_cast<int>(cudaErrorIllegalState);
  }
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  loop_begin_kernel<<<1, 1, 0, s>>>(handle, static_cast<const bool*>(pred),
                                    static_cast<int*>(trips), max_trips,
                                    static_cast<long long*>(stamps));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return static_cast<int>(err);

  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeWhile;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1,
                                            cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(body_stream), params.conditional.phGraph_out[0],
      nullptr, nullptr, 0, cudaStreamCaptureModeThreadLocal);
  if (err != cudaSuccess) return static_cast<int>(err);
  *handle_out = handle;
  return 0;
}

extern "C" int ses3d_loop_next(void* body_stream, unsigned long long handle,
                               const void* pred, void* trips, int max_trips,
                               void* stamps) {
  loop_next_kernel<<<1, 1, 0, static_cast<cudaStream_t>(body_stream)>>>(
      handle, static_cast<const bool*>(pred), static_cast<int*>(trips),
      max_trips, static_cast<long long*>(stamps));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ses3d_loop_end(void* body_stream) {
  cudaGraph_t body;
  return static_cast<int>(
      cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream), &body));
}
