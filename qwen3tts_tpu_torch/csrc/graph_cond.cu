// CUDA graph conditional (IF) nodes for stream capture, through the CUDA
// runtime (CUDA 12.4 or later), for a torch without
// CUDAGraph.begin_capture_to_if_node.
//
// qwen3tts_cond_begin, called while `parent` captures a graph:
//   1. creates a conditional handle in the graph being captured;
//   2. captures onto `parent` a one-thread kernel that sets the handle from
//      the device bool `pred` when the graph runs;
//   3. adds an IF node after it, makes the node the only dependency of what
//      `parent` captures next, and
//   4. starts capturing `body` into the node's body graph.
// Everything issued to `body` until qwen3tts_cond_end(body) runs only when
// `pred` held at the node.  `body` must not be capturing already.  The node
// and its body graph are returned through `node_out` and `body_out`.
//
// qwen3tts_graph_kernels counts the kernel nodes of a graph by the name of
// their kernel (what a replay of the graph launches), so that a caller can
// walk a captured graph and the bodies of its conditional nodes.  It skips
// the stamp kernel, so that a graph counts the same with stamps or without.
//
// qwen3tts_stamp launches one thread that writes the device's global
// nanosecond timer (%globaltimer) into *slot, on `stream` (captured into a
// graph when the stream captures); qwen3tts_stamp_clear zeroes `bytes` of a
// stamp buffer with a memset (a memset node, not a kernel, in a graph).
//
// Returns 0 or a cudaError_t; -1 when `parent` is not capturing; 10000 plus
// a CUresult when the driver fails on a graph; 20000 plus the number of a
// driver call that libcuda lacks.
#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <cstring>
#include <vector>

namespace {

__global__ void set_condition(cudaGraphConditionalHandle handle, const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

// its name is what the graph walk skips (kStampKernel)
__global__ void qwen3tts_stamp_kernel(unsigned long long* slot) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  *slot = t;
}

constexpr const char* kStampKernel = "qwen3tts_stamp_kernel";

}  // namespace

extern "C" int qwen3tts_stamp(void* stream, void* slot) {
  qwen3tts_stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(slot));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int qwen3tts_stamp_clear(void* stream, void* buf, size_t bytes) {
  return static_cast<int>(cudaMemsetAsync(buf, 0, bytes, static_cast<cudaStream_t>(stream)));
}

extern "C" int qwen3tts_cond_stream(void** out) {
  cudaStream_t s = nullptr;
  cudaError_t err = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  *out = s;
  return static_cast<int>(err);
}

extern "C" int qwen3tts_cond_begin(void* parent_ptr, const void* pred, void* body_ptr,
                                   void** node_out, void** body_out) {
  auto parent = static_cast<cudaStream_t>(parent_ptr);
  auto body = static_cast<cudaStream_t>(body_ptr);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t ndeps = 0;
  cudaError_t err = cudaStreamGetCaptureInfo(parent, &status, nullptr, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (status != cudaStreamCaptureStatusActive) return -1;

  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  set_condition<<<1, 1, 0, parent>>>(handle, static_cast<const bool*>(pred));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // the set kernel is now the capture's dependency: the node follows it
  err = cudaStreamGetCaptureInfo(parent, &status, nullptr, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaStreamUpdateCaptureDependencies(parent, &node, 1,
                                            cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return static_cast<int>(err);
  *node_out = node;
  *body_out = params.conditional.phGraph_out[0];
  return static_cast<int>(cudaStreamBeginCaptureToGraph(
      body, params.conditional.phGraph_out[0], nullptr, nullptr, 0,
      cudaStreamCaptureModeThreadLocal));
}

extern "C" int qwen3tts_cond_end(void* body_ptr) {
  cudaGraph_t graph;
  return static_cast<int>(cudaStreamEndCapture(static_cast<cudaStream_t>(body_ptr), &graph));
}

namespace {

// the driver's graph calls, looked up in libcuda (no -lcuda, and no
// runtime of another version between the walk and the driver)
struct Driver {
  CUresult (*get_nodes)(CUgraph, CUgraphNode*, size_t*) = nullptr;
  CUresult (*node_type)(CUgraphNode, CUgraphNodeType*) = nullptr;
  CUresult (*child_graph)(CUgraphNode, CUgraph*) = nullptr;
  CUresult (*kernel_params)(CUgraphNode, CUDA_KERNEL_NODE_PARAMS_v2*) = nullptr;
  CUresult (*func_name)(const char**, CUfunction) = nullptr;
  CUresult (*kernel_name)(const char**, CUkernel) = nullptr;
  int missing = 0;  // 1 + the index of the first symbol not found, or 0
};

const Driver& driver() {
  static const Driver d = [] {
    Driver d;
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    const char* names[] = {"cuGraphGetNodes", "cuGraphNodeGetType", "cuGraphChildGraphNodeGetGraph",
                           "cuGraphKernelNodeGetParams_v2", "cuFuncGetName", "cuKernelGetName"};
    void** slots[] = {reinterpret_cast<void**>(&d.get_nodes),
                      reinterpret_cast<void**>(&d.node_type),
                      reinterpret_cast<void**>(&d.child_graph),
                      reinterpret_cast<void**>(&d.kernel_params),
                      reinterpret_cast<void**>(&d.func_name),
                      reinterpret_cast<void**>(&d.kernel_name)};
    for (int i = 0; i < 6; ++i) {
      *slots[i] = lib ? dlsym(lib, names[i]) : nullptr;
      if (*slots[i] == nullptr && d.missing == 0) d.missing = i + 1;
    }
    return d;
  }();
  return d;
}

int walk(CUgraph graph, const char* const* needles, int n_needles, long long* counts,
         void** conds, size_t cap, size_t* n_conds) {
  const Driver& d = driver();
  if (d.missing) return 20000 + d.missing;
  size_t count = 0;
  CUresult r = d.get_nodes(graph, nullptr, &count);
  if (r != CUDA_SUCCESS) return 10000 + static_cast<int>(r);
  std::vector<CUgraphNode> nodes(count);
  if (count) {
    r = d.get_nodes(graph, nodes.data(), &count);
    if (r != CUDA_SUCCESS) return 10000 + static_cast<int>(r);
  }
  for (CUgraphNode node : nodes) {
    CUgraphNodeType type;
    r = d.node_type(node, &type);
    if (r != CUDA_SUCCESS) return 10000 + static_cast<int>(r);
    if (type == CU_GRAPH_NODE_TYPE_GRAPH) {
      CUgraph child;
      r = d.child_graph(node, &child);
      if (r != CUDA_SUCCESS) return 10000 + static_cast<int>(r);
      const int rc = walk(child, needles, n_needles, counts, conds, cap, n_conds);
      if (rc != 0) return rc;
    } else if (type == CU_GRAPH_NODE_TYPE_CONDITIONAL) {
      if (*n_conds < cap) conds[*n_conds] = node;
      ++*n_conds;
    } else if (type == CU_GRAPH_NODE_TYPE_KERNEL) {
      CUDA_KERNEL_NODE_PARAMS_v2 p = {};
      r = d.kernel_params(node, &p);
      const char* name = nullptr;
      if (r == CUDA_SUCCESS) r = p.func ? d.func_name(&name, p.func) : d.kernel_name(&name, p.kern);
      if (r != CUDA_SUCCESS) return 10000 + static_cast<int>(r);
      if (std::strstr(name, kStampKernel) != nullptr) continue;
      ++counts[n_needles];
      for (int i = 0; i < n_needles; ++i) {
        if (std::strstr(name, needles[i]) != nullptr) {
          ++counts[i];
          break;
        }
      }
    }
  }
  return 0;
}

}  // namespace

// Counts the kernel nodes of `graph`, its child graphs' included, but the
// stamp kernel's: counts[i]
// those whose kernel's (mangled) name contains needles[i], the first that
// matches; counts[n_needles] all of them.  The graph's conditional nodes,
// whose bodies are not walked, go to `conds` (at most *n_conds of them);
// *n_conds is set to their number.  `counts` is added to, not cleared.
extern "C" int qwen3tts_graph_kernels(void* graph, const char* const* needles, int n_needles,
                                      long long* counts, void** conds, size_t* n_conds) {
  const size_t cap = *n_conds;
  *n_conds = 0;
  return walk(static_cast<CUgraph>(graph), needles, n_needles, counts, conds, cap, n_conds);
}
