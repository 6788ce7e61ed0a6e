// A conditional (IF) node inside a CUDA graph capture: the work captured
// between tdt_if_begin and tdt_if_end runs on a replay only where a bool
// on the device is true, with no host read.
//
// This is how the captured tick takes the triangle fallback only on the
// ticks where some env needs it: the JAX package decides the same thing
// with `lax.cond(jnp.any(fall), ...)` inside its one program
// (tpu_doom/render/portal.py, render_frames_portal). PyTorch of this
// version has no API for conditional nodes, so the port adds one from the
// CUDA runtime (12.4 or later): a one-thread kernel on the capturing
// stream sets the node's condition from the flag at replay time, the IF
// node is added after it, the capturing stream's later work is made to
// depend on the node, and a second stream captures the node's body graph.
// The caller (tpu_doom_torch/graphs.py:device_if) makes the body stream
// current and routes its allocations to the graph's memory pool.

#include <cuda_runtime.h>

namespace {

__global__ void set_if_kernel(cudaGraphConditionalHandle handle, const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

}  // namespace

// `stream` is capturing; `body` is not. After this call, work launched on
// `body` is captured into the IF node's body, and `stream`'s next work
// follows the node.
extern "C" int tdt_if_begin(void* stream, void* body, const void* pred) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaStreamCaptureStatus status;
  unsigned long long id = 0;
  cudaGraph_t graph = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, &id, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return (int)err;
  if (status != cudaStreamCaptureStatusActive) return (int)cudaErrorStreamCaptureInvalidated;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return (int)err;
  set_if_kernel<<<1, 1, 0, s>>>(handle, (const bool*)pred);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamGetCaptureInfo(s, &status, &id, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return (int)err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaStreamBeginCaptureToGraph((cudaStream_t)body,
                                            params.conditional.phGraph_out[0], nullptr,
                                            nullptr, 0, cudaStreamCaptureModeRelaxed);
}

// Ends the body's capture begun by tdt_if_begin (the IF node owns the
// body graph).
extern "C" int tdt_if_end(void* body) {
  cudaGraph_t graph = nullptr;
  return (int)cudaStreamEndCapture((cudaStream_t)body, &graph);
}
