// The device-decided LM loop: a CUDA graph with a WHILE conditional node,
// plain C interface.
//
// Replaces no TPU kernel.  It is the port's counterpart of the JAX
// package's lax.while_loop (collocfem_tpu/solve/lm_core.py, cond ~done &
// (it < maxiter)): the device, not the host, decides when an LM solve
// stops.  solve/graph.py captures one LM iteration (lm_core.lm_step,
// written in place into the state buffers) as a PyTorch CUDA graph kept
// uninstantiated (torch.cuda.CUDAGraph(keep_graph=True)), and optionally a
// graph to run before the loop and one after it.  graph_loop_build makes
//
//   [before] -> set_condition -> WHILE { step -> set_condition } -> [after]
//
// from them (each captured graph cloned in as a child graph node), where
// set_condition is a one-thread kernel that sets the WHILE node's handle to
// !*done && *it < maxiter from the state buffers.  One launch of the result
// runs the whole loop with no read of done on the host.
//
// What bounds it: nothing of its own.  Each WHILE iteration adds the
// one-thread condition kernel to the step's kernels, which are the
// solver's.  A conditional body refuses memory-allocation, host and event
// nodes: graph_loop_build then fails at its stage 6 and
// graph_loop_describe lists the step graph's nodes that are not kernels.
//
// The same library holds trace_mark, the device half of utils/profiling.py's
// spans: a one-thread kernel that appends (code, solve, cause, %globaltimer)
// to a device log at a device-side cursor, launched on the current stream
// like any other kernel, so a capture (and a WHILE body) holds it.  A mark
// passed solve >= 0 (one launched outside a capture) sets the log's current
// solve and cause first; a captured mark passes -1 and reads them.  A full
// log counts the mark as dropped instead of writing it.
//
// Needs CUDA 12.4 or later (WHILE conditional nodes).
// Build (ops/_build.py does this at first use):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o graph_loop.so graph_loop.cu

#include <cuda_runtime.h>

#include <cstdio>
#include <cstring>

#if CUDART_VERSION < 12040
#error "graph_loop.cu needs CUDA 12.4 or later (WHILE conditional nodes)"
#endif

namespace {

__global__ void set_condition(cudaGraphConditionalHandle handle,
                              const bool* done, const long long* it,
                              long long maxiter) {
  cudaGraphSetConditional(handle, (!*done && *it < maxiter) ? 1u : 0u);
}

cudaError_t add_condition(cudaGraphNode_t* node, cudaGraph_t graph,
                          const cudaGraphNode_t* deps, size_t n_deps,
                          cudaGraphConditionalHandle handle, const bool* done,
                          const long long* it, long long maxiter) {
  void* args[] = {&handle, &done, &it, &maxiter};
  cudaKernelNodeParams p = {};
  p.func = reinterpret_cast<void*>(set_condition);
  p.gridDim = dim3(1);
  p.blockDim = dim3(1);
  p.sharedMemBytes = 0;
  p.kernelParams = args;
  p.extra = nullptr;
  return cudaGraphAddKernelNode(node, graph, deps, n_deps, &p);
}

cudaError_t add_node(cudaGraphNode_t* node, cudaGraph_t graph,
                     const cudaGraphNode_t* deps, size_t n_deps,
                     cudaGraphNodeParams* params) {
#if CUDART_VERSION >= 13000
  return cudaGraphAddNode(node, graph, deps, nullptr, n_deps, params);
#else
  return cudaGraphAddNode(node, graph, deps, n_deps, params);
#endif
}

// The nodes of ``graph`` and, recursively, of its child graphs.
cudaError_t count_nodes(cudaGraph_t graph, long long* total) {
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(graph, nullptr, &n);
  if (err != cudaSuccess || n == 0) return err;
  cudaGraphNode_t* nodes = new cudaGraphNode_t[n];
  err = cudaGraphGetNodes(graph, nodes, &n);
  for (size_t i = 0; err == cudaSuccess && i < n; ++i) {
    *total += 1;
    cudaGraphNodeType type;
    err = cudaGraphNodeGetType(nodes[i], &type);
    if (err == cudaSuccess && type == cudaGraphNodeTypeGraph) {
      cudaGraph_t child;
      err = cudaGraphChildGraphNodeGetGraph(nodes[i], &child);
      if (err == cudaSuccess) err = count_nodes(child, total);
    }
  }
  delete[] nodes;
  return err;
}

// Append to buf a line per node of ``graph`` that is not a kernel (its
// type, and a memcpy's kind, extent and pointers' memory types or a
// memset's element size, width and height), recursing into child graphs.
void describe(cudaGraph_t graph, char* buf, size_t len, size_t* used,
              int depth) {
  size_t n = 0;
  if (cudaGraphGetNodes(graph, nullptr, &n) != cudaSuccess || n == 0) return;
  cudaGraphNode_t* nodes = new cudaGraphNode_t[n];
  if (cudaGraphGetNodes(graph, nodes, &n) == cudaSuccess) {
    for (size_t i = 0; i < n; ++i) {
      cudaGraphNodeType type;
      if (cudaGraphNodeGetType(nodes[i], &type) != cudaSuccess ||
          type == cudaGraphNodeTypeKernel)
        continue;
      char line[256];
      int k = snprintf(line, sizeof line, "%*snode %zu: type %d", depth * 2,
                       "", i, static_cast<int>(type));
      if (type == cudaGraphNodeTypeMemcpy) {
        cudaMemcpy3DParms p = {};
        if (cudaGraphMemcpyNodeGetParams(nodes[i], &p) == cudaSuccess) {
          cudaPointerAttributes src = {}, dst = {};
          cudaPointerGetAttributes(&src, p.srcPtr.ptr);
          cudaPointerGetAttributes(&dst, p.dstPtr.ptr);
          k += snprintf(line + k, sizeof line - k,
                        " memcpy kind %d extent %zu x %zu x %zu, src "
                        "memory %d, dst memory %d", static_cast<int>(p.kind),
                        p.extent.width, p.extent.height, p.extent.depth,
                        static_cast<int>(src.type),
                        static_cast<int>(dst.type));
        }
      } else if (type == cudaGraphNodeTypeMemset) {
        cudaMemsetParams p = {};
        if (cudaGraphMemsetNodeGetParams(nodes[i], &p) == cudaSuccess)
          k += snprintf(line + k, sizeof line - k,
                        " memset element %u width %zu height %zu",
                        p.elementSize, p.width, p.height);
      }
      k += snprintf(line + k, sizeof line - k, "\n");
      if (*used + k < len) {
        memcpy(buf + *used, line, k);
        *used += k;
        buf[*used] = 0;
      }
      if (type == cudaGraphNodeTypeGraph) {
        cudaGraph_t child;
        if (cudaGraphChildGraphNodeGetGraph(nodes[i], &child) == cudaSuccess)
          describe(child, buf, len, used, depth + 1);
      }
    }
  }
  delete[] nodes;
}

// state: {cursor, dropped, solve, cause}; log: capacity rows of {code,
// solve, cause, time in ns}.
__global__ void trace_mark(long long* state, long long* log,
                           long long capacity, long long code,
                           long long solve, long long cause) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  if (solve >= 0) {
    state[2] = solve;
    state[3] = cause;
  }
  const long long i = state[0];
  if (i < capacity) {
    long long* row = log + 4 * i;
    row[0] = code;
    row[1] = state[2];
    row[2] = state[3];
    row[3] = static_cast<long long>(now);
    state[0] = i + 1;
  } else {
    state[1] += 1;
  }
}

}  // namespace

extern "C" {

// One trace_mark on ``stream``; returns the launch's cudaError_t.
int trace_mark_launch(void* state, void* log, long long capacity,
                      long long code, long long solve, long long cause,
                      void* stream) {
  trace_mark<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(state), static_cast<long long*>(log), capacity,
      code, solve, cause);
  return cudaGetLastError();
}

// cudaStreamSynchronize, for the round trips that calibrate the timer.
int trace_sync(void* stream) {
  return cudaStreamSynchronize(static_cast<cudaStream_t>(stream));
}

// Build and instantiate the loop graph.  before and after may be null.
// *stage names the call that failed (1 create, 2 handle, 3 before, 4 the
// first condition, 5 the WHILE node, 6 the step, 7 the condition in the
// body, 8 after, 9 instantiate); the return value is its cudaError_t.
int graph_loop_build(void* before, void* step, void* after, const bool* done,
                     const long long* it, long long maxiter, void** graph_out,
                     void** exec_out, int* stage) {
  cudaGraph_t graph = nullptr;
  cudaGraphExec_t exec = nullptr;
  cudaGraphNode_t last = nullptr, node = nullptr;
  cudaGraphConditionalHandle handle;
  cudaError_t err;

  *stage = 1;
  if ((err = cudaGraphCreate(&graph, 0)) != cudaSuccess) return err;
  *stage = 2;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err == cudaSuccess && before != nullptr) {
    *stage = 3;
    err = cudaGraphAddChildGraphNode(&last, graph, nullptr, 0,
                                     static_cast<cudaGraph_t>(before));
  }
  if (err == cudaSuccess) {
    *stage = 4;
    err = add_condition(&node, graph, last ? &last : nullptr, last ? 1 : 0,
                        handle, done, it, maxiter);
    last = node;
  }
  cudaGraph_t body = nullptr;
  if (err == cudaSuccess) {
    *stage = 5;
    cudaGraphNodeParams params = {};
    params.type = cudaGraphNodeTypeConditional;
    params.conditional.handle = handle;
    params.conditional.type = cudaGraphCondTypeWhile;
    params.conditional.size = 1;
    err = add_node(&node, graph, &last, 1, &params);
    if (err == cudaSuccess) body = params.conditional.phGraph_out[0];
    last = node;
  }
  cudaGraphNode_t in_body = nullptr;
  if (err == cudaSuccess) {
    *stage = 6;
    err = cudaGraphAddChildGraphNode(&in_body, body, nullptr, 0,
                                     static_cast<cudaGraph_t>(step));
  }
  if (err == cudaSuccess) {
    *stage = 7;
    err = add_condition(&node, body, &in_body, 1, handle, done, it, maxiter);
  }
  if (err == cudaSuccess && after != nullptr) {
    *stage = 8;
    err = cudaGraphAddChildGraphNode(&node, graph, &last, 1,
                                     static_cast<cudaGraph_t>(after));
  }
  if (err == cudaSuccess) {
    *stage = 9;
    err = cudaGraphInstantiate(&exec, graph, 0);
  }
  if (err != cudaSuccess) {
    cudaGraphDestroy(graph);
    return err;
  }
  *stage = 0;
  *graph_out = graph;
  *exec_out = exec;
  return cudaSuccess;
}

int graph_loop_launch(void* exec, void* stream) {
  return cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                         static_cast<cudaStream_t>(stream));
}

void graph_loop_destroy(void* graph, void* exec) {
  if (exec != nullptr) cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
  if (graph != nullptr) cudaGraphDestroy(static_cast<cudaGraph_t>(graph));
}

// The nodes of a graph, child graphs' counted in; conditional bodies count
// as their conditional node.  Minus the cudaError_t on an error.
long long graph_loop_node_count(void* graph) {
  long long total = 0;
  cudaError_t err = count_nodes(static_cast<cudaGraph_t>(graph), &total);
  return err == cudaSuccess ? total : -static_cast<long long>(err);
}

// Every node of a graph that is not a kernel, one line each, into buf (at
// most len bytes with the terminating 0): what a conditional body may
// refuse.
void graph_loop_describe(void* graph, char* buf, int len) {
  size_t used = 0;
  if (len > 0) buf[0] = 0;
  describe(static_cast<cudaGraph_t>(graph), buf, static_cast<size_t>(len),
           &used, 0);
}

const char* graph_loop_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
