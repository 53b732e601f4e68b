// Conditional (IF) nodes in a CUDA graph under stream capture.
//
// The JAX package keeps the reduced solve's data-dependent control flow
// on the device: `lax.cond` skips a polish round, a seed rebuild or the
// hybrid fallback, and `lax.while_loop` ends a gathered loop, inside one
// compiled program (fcc_qp_tpu/core/ds_engine.py, fcc_qp_tpu/ops/polish.py).
// The port captures its solve as a CUDA graph; CUDA 12.4+ conditional
// nodes let such a graph skip a body on the device. PyTorch 2.11 does not
// expose them, so this file adds the one form the port needs, called
// through ctypes from `ops/device_branch.py`:
//
//   if_node_begin(parent, pred, body, mode, body_graph)
//     On `parent`, a stream capturing a graph: create a conditional handle
//     in the graph being captured, capture a one-thread kernel that sets
//     it from the device flag `*pred` at every replay, add an IF node
//     after the stream's current dependencies, make that node the
//     stream's only dependency, and start capturing `body` into the IF
//     node's body graph (returned in `*body_graph`, owned by the graph).
//   if_node_end(body)
//     End the body's capture.
//
// No TPU kernel is replaced here: `set_if_condition` is the device half of
// a `lax.cond`. It reads one byte and is bound by the launch latency.
#include <cuda_runtime.h>

__global__ void set_if_condition(cudaGraphConditionalHandle handle,
                                 const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

extern "C" int if_node_begin(cudaStream_t parent, const bool* pred,
                             cudaStream_t body, int mode,
                             cudaGraph_t* body_graph) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t err = cudaStreamGetCaptureInfo(parent, &status, nullptr,
                                             &graph, &deps, &n_deps);
  if (err != cudaSuccess) return (int)err;
  if (status != cudaStreamCaptureStatusActive)
    return (int)cudaErrorStreamCaptureInvalidated;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return (int)err;
  set_if_condition<<<1, 1, 0, parent>>>(handle, pred);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamGetCaptureInfo(parent, &status, nullptr, &graph, &deps,
                                 &n_deps);
  if (err != cudaSuccess) return (int)err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamUpdateCaptureDependencies(
      parent, &node, 1, cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return (int)err;
  *body_graph = params.conditional.phGraph_out[0];
  return (int)cudaStreamBeginCaptureToGraph(
      body, *body_graph, nullptr, nullptr, 0, (cudaStreamCaptureMode)mode);
}

extern "C" int if_node_end(cudaStream_t body) {
  cudaGraph_t graph;
  return (int)cudaStreamEndCapture(body, &graph);
}

extern "C" int make_stream(cudaStream_t* out) {
  return (int)cudaStreamCreateWithFlags(out, cudaStreamNonBlocking);
}
