// K7w and the WHILE graph: a solve's outers after the first as one launch.
//
// Replaces the lax.while_loop node of the JAX solvers
// (ics_tpu/models/rl_mm.py:627; rl_pam.py:171, rl_pd.py:292; the fori_loop of
// tv_denoise.py:60), which the TPU runs as one program with no host
// round-trip.  Here the caller captures one outer body with PyTorch's CUDA
// graph capture (models/rl_mm.py::_while_loop); K7 (outer_loop.cu), at the
// end of that body, leaves the state's `go` in device memory.  This file
// builds the outer graph around that capture:
//
//   K7w(go) -> WHILE(handle) { body (a child graph node of the capture) -> K7w(go) }
//
// K7w is one thread that reads `go`, sets the node's condition with
// cudaGraphSetConditional and adds one to `runs`, its own count of its runs
// on the card, so the card runs body after body until K7 says stop, and the
// host launches once and reads the state (and `runs`) once.  A launch runs
// K7w once before the node and once after each body: `runs` - 1 bodies.
// Given a `stamps` buffer (a tracer's, utils/trace.py), K7w also writes the
// card's %globaltimer into stamps[runs] before it counts itself, so stamp
// j + 1 minus stamp j is body j's time on the card; without one (null, when
// no tracer is active) it writes nothing, and the graph is the same.
//
// What bounds K7w on the card: one launch's latency.  It reads the byte of
// `go` and reads and writes the four of `runs` (and writes a stamp's eight
// when tracing); at 3.35 TB/s that is 0.003 ns.
//
// The body's tensors stay where the capture put them: the caller keeps
// PyTorch's graph and its private memory pool alive until this graph has run
// (the child node is a copy of the capture's nodes, not of its memory).

#include <cuda_runtime.h>

namespace {

__global__ void while_go_kernel(cudaGraphConditionalHandle handle, const bool* go, int* runs,
                                long long* stamps) {
  if (stamps != nullptr) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    stamps[*runs] = static_cast<long long>(t);
  }
  *runs += 1;
  cudaGraphSetConditional(handle, *go ? 1u : 0u);
}

cudaError_t add_go_node(cudaGraphNode_t* node, cudaGraph_t graph, const cudaGraphNode_t* deps,
                        size_t n_deps, cudaGraphConditionalHandle handle, const bool* go,
                        int* runs, long long* stamps) {
  void* args[] = {&handle, &go, &runs, &stamps};
  cudaKernelNodeParams p = {};
  p.func = reinterpret_cast<void*>(while_go_kernel);
  p.gridDim = dim3(1);
  p.blockDim = dim3(1);
  p.sharedMemBytes = 0;
  p.kernelParams = args;
  p.extra = nullptr;
  return cudaGraphAddKernelNode(node, graph, deps, n_deps, &p);
}

cudaError_t add_while_node(cudaGraphNode_t* node, cudaGraph_t graph, cudaGraphNode_t dep,
                           cudaGraphConditionalHandle handle, cudaGraph_t* body) {
  cudaGraphNodeParams p = {};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = handle;
  p.conditional.type = cudaGraphCondTypeWhile;
  p.conditional.size = 1;
#if CUDART_VERSION >= 13000
  const cudaError_t rc = cudaGraphAddNode(node, graph, &dep, nullptr, 1, &p);
#else
  const cudaError_t rc = cudaGraphAddNode(node, graph, &dep, 1, &p);
#endif
  if (rc == cudaSuccess) *body = p.conditional.phGraph_out[0];
  return rc;
}

// Build the outer graph around `body`; on failure destroy what was made.
cudaError_t build(cudaGraph_t body, const bool* go, int* runs, long long* stamps,
                  cudaGraph_t* graph_out, cudaGraphExec_t* exec_out) {
  cudaGraph_t graph = nullptr;
  cudaError_t rc = cudaGraphCreate(&graph, 0);
  if (rc != cudaSuccess) return rc;
  cudaGraphConditionalHandle handle;
  cudaGraphNode_t first, loop, child, last;
  cudaGraph_t inner = nullptr;
  rc = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (rc == cudaSuccess) rc = add_go_node(&first, graph, nullptr, 0, handle, go, runs, stamps);
  if (rc == cudaSuccess) rc = add_while_node(&loop, graph, first, handle, &inner);
  if (rc == cudaSuccess) rc = cudaGraphAddChildGraphNode(&child, inner, nullptr, 0, body);
  if (rc == cudaSuccess) rc = add_go_node(&last, inner, &child, 1, handle, go, runs, stamps);
  if (rc == cudaSuccess) rc = cudaGraphInstantiate(exec_out, graph, 0);
  if (rc != cudaSuccess) {
    cudaGraphDestroy(graph);
    return rc;
  }
  *graph_out = graph;
  return cudaSuccess;
}

}  // namespace

// body: a cudaGraph_t (PyTorch's CUDAGraph(keep_graph=True).raw_cuda_graph())
// whose last work is K7 on the state that `go` belongs to; runs: one int32
// on the card that every run of K7w adds one to; stamps: null, or int64 on
// the card with room for every run of K7w (one more than the bodies), where
// each run writes its %globaltimer.  graph_out and exec_out receive the
// outer graph and its executable; free them with ics_while_free.  Returns 0
// or the CUDA error of the step that failed.
extern "C" int ics_while_build(void* body, const bool* go, int* runs, long long* stamps,
                               void** graph_out, void** exec_out) {
  cudaGraph_t graph = nullptr;
  cudaGraphExec_t exec = nullptr;
  const cudaError_t rc =
      build(static_cast<cudaGraph_t>(body), go, runs, stamps, &graph, &exec);
  if (rc != cudaSuccess) {
    cudaGetLastError();  // clear a sticky launch-configuration error, if any
    return static_cast<int>(rc);
  }
  *graph_out = graph;
  *exec_out = exec;
  return 0;
}

// One launch of the outer graph on `stream` (asynchronous, as a kernel).
extern "C" int ics_while_launch(void* exec, void* stream) {
  const cudaError_t rc =
      cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec), static_cast<cudaStream_t>(stream));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

// Destroy the executable and the graph.  An executable still running on the
// card is freed when it completes (cudaGraphExecDestroy).
extern "C" int ics_while_free(void* graph, void* exec) {
  cudaError_t rc = cudaSuccess;
  if (exec != nullptr) rc = cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
  if (graph != nullptr) {
    const cudaError_t rc2 = cudaGraphDestroy(static_cast<cudaGraph_t>(graph));
    if (rc == cudaSuccess) rc = rc2;
  }
  return static_cast<int>(rc);
}

// The nodes of `graph` (a captured body) by type: counts[0] kernels, [1]
// copies, [2] sets, [3] every other node (events, waits, host calls, child
// graphs, conditionals).  Host metadata: no work on the card.
extern "C" int ics_graph_nodes(void* graph, int* counts) {
  const cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  size_t n = 0;
  cudaError_t rc = cudaGraphGetNodes(g, nullptr, &n);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  counts[0] = counts[1] = counts[2] = counts[3] = 0;
  if (n == 0) return 0;
  cudaGraphNode_t* nodes = new cudaGraphNode_t[n];
  rc = cudaGraphGetNodes(g, nodes, &n);
  for (size_t i = 0; rc == cudaSuccess && i < n; ++i) {
    cudaGraphNodeType type;
    rc = cudaGraphNodeGetType(nodes[i], &type);
    if (rc == cudaSuccess) {
      counts[type == cudaGraphNodeTypeKernel   ? 0
             : type == cudaGraphNodeTypeMemcpy ? 1
             : type == cudaGraphNodeTypeMemset ? 2
                                               : 3] += 1;
    }
  }
  delete[] nodes;
  return static_cast<int>(rc);
}

// The CUDA driver's and this library's runtime versions (1000 * major +
// 10 * minor); WHILE nodes need 12.3 or later of both.
extern "C" int ics_cuda_versions(int* driver, int* runtime) {
  cudaError_t rc = cudaDriverGetVersion(driver);
  if (rc == cudaSuccess) rc = cudaRuntimeGetVersion(runtime);
  return static_cast<int>(rc);
}
