// Node counts of the CUDA graph a stream is capturing, for the layer spans of
// utils/profiling.py: a span reads the count at its entry and exit, and the
// nodes added in between are the span's. A host function, no kernel.
//
// cudaGraphGetNodes counts a graph's nodes in time linear in their number, so
// a count at every span would take time quadratic in the graph's size. A
// stream captured on its own adds its nodes as one chain: each node depends
// on the one before it, and the stream's capture dependency is the newest.
// The nodes added since a node `since` are then the steps from the newest
// back to `since`, walked by cudaGraphNodeGetDependencies: each node is
// walked once over a whole capture.

#include <cuda_runtime.h>

// *id: the capture's id (0 when the stream captures nothing); *last: the
// stream's newest node (null before the first); *count: the nodes added after
// `since` up to *last (since null: from the graph's first node), or -1 when
// they are not one chain from `since` (another stream joined the capture, or
// `since` is not on the chain), or the stream captures nothing. With `count`
// null only *id and *last are read, and nothing is walked.
extern "C" int f4b_capture_nodes_since(void* stream, void* since, unsigned long long* id,
                                       void** last, long long* count) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  unsigned long long capture_id = 0;
  cudaGraph_t graph = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t num_deps = 0;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(static_cast<cudaStream_t>(stream), &status,
                                             &capture_id, &graph, &deps, nullptr, &num_deps);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(static_cast<cudaStream_t>(stream), &status,
                                             &capture_id, &graph, &deps, &num_deps);
#endif
  *id = 0;
  *last = nullptr;
  if (count != nullptr) *count = -1;
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive) return cudaSuccess;
  *id = capture_id;
  if (num_deps > 1) return cudaSuccess;
  cudaGraphNode_t node = num_deps ? deps[0] : nullptr;
  *last = node;
  if (count == nullptr) return cudaSuccess;
  long long n = 0;
  while (node != nullptr && node != static_cast<cudaGraphNode_t>(since)) {
    ++n;
    cudaGraphNode_t up[2] = {nullptr, nullptr};
    size_t num_up = 2;
#if CUDART_VERSION >= 13000
    err = cudaGraphNodeGetDependencies(node, up, nullptr, &num_up);
#else
    err = cudaGraphNodeGetDependencies(node, up, &num_up);
#endif
    if (err != cudaSuccess) return err;
    if (num_up > 1) return cudaSuccess;
    node = num_up ? up[0] : nullptr;
  }
  if (node != static_cast<cudaGraphNode_t>(since)) return cudaSuccess;   // since: not on the chain
  *count = n;
  return cudaSuccess;
}
