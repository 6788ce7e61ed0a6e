// A conditional (WHILE) node inside a CUDA graph capture: the work captured
// between tdt_while_begin and tdt_while_end runs on a replay again and
// again while a bool on the device is true, with no host read.
//
// This is how the captured tick takes the triangle fallback only on the
// ticks where some env needs it, one block of envs per run: the JAX
// package decides the same thing with `lax.cond(jnp.any(fall), ...)`
// inside its one program (tpu_doom/render/portal.py, render_frames_portal).
// PyTorch of this version has no API for conditional nodes, so the port
// adds one from the CUDA runtime (12.4 or later): a one-thread kernel on
// the capturing stream sets the node's condition from the flag before the
// first run, the WHILE node is added after it, the capturing stream's
// later work is made to depend on the node, and a second stream captures
// the node's body graph, which ends with the same one-thread kernel
// setting the condition for the next run. The caller
// (tpu_doom_torch/graphs.py:device_while) makes the body stream current and
// routes its allocations to the graph's memory pool.

#include <cuda_runtime.h>

namespace {

__global__ void set_condition_kernel(cudaGraphConditionalHandle handle, const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

}  // namespace

// `stream` is capturing; `body` is not. After this call, work launched on
// `body` is captured into the WHILE node's body, and `stream`'s next work
// follows the node. The node's handle goes to *handle_out, for
// tdt_while_end.
extern "C" int tdt_while_begin(void* stream, void* body, const void* pred,
                               void* handle_out) {
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
  set_condition_kernel<<<1, 1, 0, s>>>(handle, (const bool*)pred);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamGetCaptureInfo(s, &status, &id, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return (int)err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeWhile;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return (int)err;
  *(cudaGraphConditionalHandle*)handle_out = handle;
  return (int)cudaStreamBeginCaptureToGraph((cudaStream_t)body,
                                            params.conditional.phGraph_out[0], nullptr,
                                            nullptr, 0, cudaStreamCaptureModeRelaxed);
}

// Ends the body's capture begun by tdt_while_begin (the WHILE node owns
// the body graph), after a launch that sets the node's condition for the
// next run from `pred`, a bool the body computed. A null `pred` (a body
// that failed to capture) ends the capture alone.
extern "C" int tdt_while_end(void* body, const void* handle, const void* pred) {
  cudaStream_t b = (cudaStream_t)body;
  if (pred != nullptr) {
    set_condition_kernel<<<1, 1, 0, b>>>(*(const cudaGraphConditionalHandle*)handle,
                                         (const bool*)pred);
  }
  cudaError_t launched = cudaGetLastError();
  cudaGraph_t graph = nullptr;
  cudaError_t err = cudaStreamEndCapture(b, &graph);
  return (int)(launched != cudaSuccess ? launched : err);
}
