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
// trace of its trips on the device (the trip log of tracing.py).
//
// What bounds it: nothing of note; the two kernels are a thread each, one
// per loop and one per trip that runs. A trip that does not run costs
// nothing: no node of the body runs.
//
// The same clock serves the tracer (tracing.py): ses3d_stage_mark launches
// a one-thread kernel that writes %globaltimer into a column of a ring of
// rows, the call's first mark advancing the row, so a replayed graph marks
// its stages with no host sync; while a stream captures, it also counts
// the kernel nodes the graph holds before the mark. ses3d_clock_probe
// answers a flag that the host sets in pinned memory with %globaltimer, so
// the host can relate the device clock to its own.

#include <cuda_runtime.h>

#include <vector>

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

// Ends the body's capture; where `nodes_out` is not null, writes there the
// number of nodes the body holds (the kernels and copies of one trip,
// ses3d_loop_next's kernel included).
extern "C" int ses3d_loop_end(void* body_stream, unsigned long long* nodes_out) {
  cudaGraph_t body;
  cudaError_t err = cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream), &body);
  if (err != cudaSuccess || nodes_out == nullptr) return static_cast<int>(err);
  size_t n = 0;
  err = cudaGraphGetNodes(body, nullptr, &n);
  *nodes_out = n;
  return static_cast<int>(err);
}

// ------------------------------------------------------------ the tracer --

namespace {

__global__ void stage_mark_kernel(long long* ring, unsigned long long* count,
                                  int col, int cols, int rows, int first) {
  const long long t = global_ns();
  unsigned long long n = *count;
  if (first) {
    n += 1;
    *count = n;
  }
  ring[((n - 1) % rows) * cols + col] = t;
}

__global__ void clock_probe_kernel(volatile int* flag, volatile long long* reply,
                                   long long timeout_ns) {
  const long long t0 = global_ns();
  reply[3] = t0;  // the clock at the kernel's start
  reply[2] = 1;   // started
  __threadfence_system();
  long long t = t0;
  while (*flag == 0 && t - t0 < timeout_ns) t = global_ns();
  reply[0] = global_ns();
  __threadfence_system();
  reply[1] = (*flag != 0) ? 1 : -1;
}

}  // namespace

// Kernel nodes of the graph `stream` is capturing into, or -1 where it is
// not capturing. A node whose type the runtime does not report (a WHILE
// node's, on the card's driver) is no kernel node; its error is cleared, as
// portbench's count of a finished graph skips such a node.
static cudaError_t captured_kernels(cudaStream_t stream, long long* out) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  *out = -1;
  cudaError_t err =
      cudaStreamGetCaptureInfo(stream, &status, nullptr, &graph, &deps, &n_deps);
  if (err != cudaSuccess || status != cudaStreamCaptureStatusActive) return err;
  size_t n = 0;
  err = cudaGraphGetNodes(graph, nullptr, &n);
  if (err != cudaSuccess) return err;
  std::vector<cudaGraphNode_t> nodes(n);
  err = cudaGraphGetNodes(graph, nodes.data(), &n);
  if (err != cudaSuccess) return err;
  long long kernels = 0;
  for (size_t i = 0; i < n; ++i) {
    cudaGraphNodeType type;
    if (cudaGraphNodeGetType(nodes[i], &type) == cudaSuccess) {
      kernels += type == cudaGraphNodeTypeKernel;
    } else {
      cudaGetLastError();
    }
  }
  *out = kernels;
  return cudaSuccess;
}

// One stage mark: ring[(row - 1) % rows][col] = %globaltimer, where the
// first mark of a call first advances *count (the rows written). Where
// `kernels_out` is not null it receives the kernel nodes of the graph being
// captured before this mark (-1 when `stream` is not capturing).
extern "C" int ses3d_stage_mark(void* stream, void* ring, void* count, int col,
                                int cols, int rows, int first,
                                long long* kernels_out) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (col < 0 || col >= cols || rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (kernels_out != nullptr) {
    const cudaError_t err = captured_kernels(s, kernels_out);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  stage_mark_kernel<<<1, 1, 0, s>>>(static_cast<long long*>(ring),
                                    static_cast<unsigned long long*>(count), col,
                                    cols, rows, first);
  return static_cast<int>(cudaGetLastError());
}

// Launches the probe on `stream` (reply: int64 [4] in host pinned memory):
// it writes %globaltimer at its start to reply[3] and sets reply[2], waits
// for *flag (host pinned memory) to turn non-zero, at most `timeout_ns` on
// the device clock, then writes %globaltimer to reply[0] and 1 (answered)
// or -1 (timed out) to reply[1].
extern "C" int ses3d_clock_probe(void* stream, void* flag, void* reply,
                                 long long timeout_ns) {
  clock_probe_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<volatile int*>(flag), static_cast<volatile long long*>(reply),
      timeout_ns);
  return static_cast<int>(cudaGetLastError());
}
