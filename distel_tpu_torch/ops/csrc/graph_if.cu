// Conditional (IF) nodes for CUDA graphs captured by PyTorch, with a
// plain C interface for ctypes (no PyTorch headers).
//
// The row-packed engine's fused K-round window (core/rowpacked_engine.py)
// is one CUDA graph a window: K round bodies, each run only while the
// window is still going, and inside a round the dense or the sparse
// tier, picked on the card.  CUDA 12.3 and later give graphs IF nodes
// (a child graph run when a handle, set on the card, is nonzero), but
// PyTorch's CUDAGraph does not expose them in every release, so this
// file adds them to a capture in progress:
//
//   graph_if_begin  on the stream capturing the parent graph: a one-thread
//                   kernel node that copies a bool from card memory into
//                   a new conditional handle, then an IF node after it;
//                   the parent capture continues after the IF node, and
//                   `child` (a stream not capturing) starts capturing the
//                   IF node's body graph
//   graph_if_end    ends the body's capture on `child`
//
// The kernel replaces no TPU kernel: it is the card-side half of a
// branch the reference takes inside its lax.while_loop.  It moves one
// byte; a replay pays a kernel node and a conditional node per branch.

#include <cuda_runtime.h>

namespace {

__global__ void graph_if_set_kernel(cudaGraphConditionalHandle handle,
                                    const bool* __restrict__ pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

}  // namespace

extern "C" {

// Returns 0 or the cudaError_t of the first call that failed.  `mode` is
// the child capture's cudaStreamCaptureMode (0 global, 1 thread-local,
// 2 relaxed).
int graph_if_begin(void* parent, void* child, const void* pred, int mode) {
  cudaStream_t ps = (cudaStream_t)parent, cs = (cudaStream_t)child;
  cudaStreamCaptureStatus status;
  unsigned long long id = 0;
  cudaGraph_t graph = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t err = cudaStreamGetCaptureInfo(ps, &status, &id, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return (int)err;
  if (status != cudaStreamCaptureStatusActive) return (int)cudaErrorStreamCaptureInvalidated;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, cudaGraphCondAssignDefault);
  if (err != cudaSuccess) return (int)err;
  graph_if_set_kernel<<<1, 1, 0, ps>>>(handle, (const bool*)pred);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamGetCaptureInfo(ps, &status, &id, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return (int)err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return (int)err;
  cudaGraph_t body = params.conditional.phGraph_out[0];
  err = cudaStreamUpdateCaptureDependencies(ps, &node, 1, cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaStreamBeginCaptureToGraph(cs, body, nullptr, nullptr, 0,
                                            (cudaStreamCaptureMode)mode);
}

int graph_if_end(void* child) {
  cudaGraph_t body = nullptr;
  return (int)cudaStreamEndCapture((cudaStream_t)child, &body);
}

const char* graph_if_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
