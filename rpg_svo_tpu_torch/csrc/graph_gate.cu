// Conditional (IF) nodes for a CUDA graph that PyTorch is capturing: the
// branch of core/graphed.gate.
//
// Port-only: the JAX step picks its mapping branches with lax.cond inside
// one XLA program; the port's step is one CUDA graph, and a graph branches
// on the device through a conditional node (CUDA 12.4+).  PyTorch builds
// without begin_capture_to_if_node open the node here, with the runtime's
// conditional-handle API, as torch/csrc/cuda/Graph.cpp does where it has it:
//
// 1. gate_open, on the capturing stream: a conditional handle in the graph
//    being captured, a one-thread kernel that sets it from the 0-d bool
//    predicate at every launch (captured, so it runs on each replay before
//    the node), an IF node after it, the stream's capture moved past the
//    node, and the body stream's capture begun into the node's body graph;
// 2. the body's work, captured on the body stream;
// 3. gate_close, ending the body stream's capture.
//
// The handle has no default: the kernel sets it on every launch.  Nothing
// here reads the predicate on the host.

#include <cuda_runtime.h>

namespace {

__global__ void set_condition(cudaGraphConditionalHandle handle,
                              const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

cudaError_t capture_info(cudaStream_t stream, cudaGraph_t* graph,
                         const cudaGraphNode_t** deps, size_t* n_deps) {
  cudaStreamCaptureStatus status;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, graph,
                                             deps, nullptr, n_deps);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, graph,
                                             deps, n_deps);
#endif
  if (err == cudaSuccess && status != cudaStreamCaptureStatusActive)
    return cudaErrorStreamCaptureUnmatched;
  return err;
}

}  // namespace

// A stream of the caller's own for the bodies (never one PyTorch captures).
extern "C" int gate_stream(void** out) {
  cudaStream_t s = nullptr;
  cudaError_t err = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  *out = s;
  return err;
}

extern "C" int gate_open(cudaStream_t stream, const bool* pred,
                         cudaStream_t body_stream) {
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  cudaError_t err = capture_info(stream, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return err;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  set_condition<<<1, 1, 0, stream>>>(handle, pred);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = capture_info(stream, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return err;

  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, n_deps, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(stream, &node, nullptr, 1,
                                            cudaStreamSetCaptureDependencies);
#else
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(stream, &node, 1,
                                            cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return err;
  return cudaStreamBeginCaptureToGraph(body_stream,
                                       params.conditional.phGraph_out[0],
                                       nullptr, nullptr, 0,
                                       cudaStreamCaptureModeThreadLocal);
}

extern "C" int gate_close(cudaStream_t body_stream) {
  cudaGraph_t body;
  return cudaStreamEndCapture(body_stream, &body);
}
