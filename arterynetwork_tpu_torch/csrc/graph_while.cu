// The region growers' device loop as one CUDA graph with a conditional
// WHILE node, for Hopper (sm_90a).
//
// Replaces no Pallas kernel.  It is the counterpart of the condition of
// the JAX growers' lax.while_loop (arterynetwork_tpu/ops/
// region_grow_fused.py:297, region_grow.py:250 and
// region_grow_frontier.py:564): there `cond` is evaluated on the device,
// and a grow does not return to the host until it ends.  Here a grower's
// steps (one, or two that alternate: A -> B and B -> A), each captured by
// torch as a CUDA graph, become the body of a WHILE node:
//
//   set_while -> WHILE [ step 0 -> count_step
//                        (-> IF [ step 1 -> count_step ]  two steps)
//                        -> set_while ]
//
// set_while sets the WHILE node's handle to (*stop < 0), so the body is
// skipped when stop is already >= 0 and left once a step sets it, and
// adds one to a device count of its own launches.  count_step adds one
// to a device count of the steps run and, after step 0 of a two-step
// loop, sets the IF node's handle to (*stop < 0), so a grow that stops
// after step 0 does not run step 1.  The host launches the graph once and
// then reads stop and the two counts together: each kernel's launches are
// counted where it runs, by itself.
//
// What bounds it on this card: nothing that scales with the volume.  Per
// step run it adds one 1-thread kernel (count_step; 8 bytes read, 4
// written), per iteration of the WHILE node one more (set_while; 8 bytes
// read, 4 written) and one conditional relaunch of the body by the
// device, each a few microseconds of launch latency, in place of the host
// round trip (a stream synchronise and a replay launch) that each step
// took before.
//
// Needs CUDA 12.4 or later, in the toolkit and in libcuda: conditional
// graph nodes (cudaGraphConditionalHandleCreate, cudaGraphAddNode with
// cudaGraphNodeTypeConditional, the device-side cudaGraphSetConditional)
// came in 12.3, and the card's torch captures with 12.4+ runtimes.
//
// Entry points (plain C, loaded with ctypes; each returns a CUDA error
// code, 0 = done, and writes a message into `err` when it fails):
//   graph_while_build    the parent graph around 1 or 2 step graphs,
//                        instantiated;
//   graph_while_launch   one launch of it on a stream;
//   graph_while_destroy  the instantiated graph and the parent graph;
//   graph_while_describe the node types of a graph, counted (child graphs
//                        walked), as text.

#include <cstdio>
#include <vector>

#include <cuda_runtime.h>

namespace {

__global__ void set_while(cudaGraphConditionalHandle handle,
                          const int* stop, int* launches) {
  *launches += 1;
  cudaGraphSetConditional(handle, *stop < 0 ? 1u : 0u);
}

__global__ void count_step(int* count, cudaGraphConditionalHandle if_handle,
                           const int* stop, int set_if) {
  *count += 1;
  if (set_if) cudaGraphSetConditional(if_handle, *stop < 0 ? 1u : 0u);
}

const char* type_name(cudaGraphNodeType t) {
  switch (t) {
    case cudaGraphNodeTypeKernel: return "kernel";
    case cudaGraphNodeTypeMemcpy: return "memcpy";
    case cudaGraphNodeTypeMemset: return "memset";
    case cudaGraphNodeTypeHost: return "host";
    case cudaGraphNodeTypeGraph: return "child graph";
    case cudaGraphNodeTypeEmpty: return "empty";
    case cudaGraphNodeTypeWaitEvent: return "event wait";
    case cudaGraphNodeTypeEventRecord: return "event record";
    case cudaGraphNodeTypeExtSemaphoreSignal: return "semaphore signal";
    case cudaGraphNodeTypeExtSemaphoreWait: return "semaphore wait";
    case cudaGraphNodeTypeMemAlloc: return "memory allocation";
    case cudaGraphNodeTypeMemFree: return "memory free";
    case cudaGraphNodeTypeConditional: return "conditional";
    default: return "unknown";
  }
}

// The node types a conditional node's body may hold (CUDA programming
// guide, "Conditional Graph Nodes"): memcpy and memset nodes only on
// device memory, which instantiation checks.
bool body_may_hold(cudaGraphNodeType t) {
  switch (t) {
    case cudaGraphNodeTypeKernel:
    case cudaGraphNodeTypeMemcpy:
    case cudaGraphNodeTypeMemset:
    case cudaGraphNodeTypeEmpty:
    case cudaGraphNodeTypeGraph:
    case cudaGraphNodeTypeConditional:
      return true;
    default:
      return false;
  }
}

constexpr int kTypes = 32;

void say(char* err, int len, const char* what, cudaError_t e) {
  if (err && len > 0)
    snprintf(err, len, "%s: %s (CUDA error %d)", what, cudaGetErrorString(e),
             (int)e);
}

// Counts the node types of `g` and of its child graphs into `counts`;
// with `step` >= 0, fails on the first node a body may not hold.
cudaError_t walk(cudaGraph_t g, int step, int* counts, char* err, int len) {
  size_t n = 0;
  cudaError_t e = cudaGraphGetNodes(g, nullptr, &n);
  if (e != cudaSuccess) return say(err, len, "cudaGraphGetNodes", e), e;
  std::vector<cudaGraphNode_t> nodes(n);
  if (n) e = cudaGraphGetNodes(g, nodes.data(), &n);
  if (e != cudaSuccess) return say(err, len, "cudaGraphGetNodes", e), e;
  for (cudaGraphNode_t node : nodes) {
    cudaGraphNodeType t;
    e = cudaGraphNodeGetType(node, &t);
    if (e != cudaSuccess) return say(err, len, "cudaGraphNodeGetType", e), e;
    counts[(int)t >= 0 && (int)t < kTypes ? (int)t : kTypes - 1] += 1;
    if (step >= 0 && !body_may_hold(t)) {
      if (err && len > 0)
        snprintf(err, len,
                 "step %d holds a node of type '%s' (%d), which the body of "
                 "a conditional node may not hold", step, type_name(t),
                 (int)t);
      return cudaErrorNotSupported;
    }
    if (t == cudaGraphNodeTypeGraph) {
      cudaGraph_t child;
      e = cudaGraphChildGraphNodeGetGraph(node, &child);
      if (e != cudaSuccess)
        return say(err, len, "cudaGraphChildGraphNodeGetGraph", e), e;
      e = walk(child, step, counts, err, len);
      if (e != cudaSuccess) return e;
    }
  }
  return cudaSuccess;
}

cudaError_t add_kernel(cudaGraphNode_t* node, cudaGraph_t g,
                       const cudaGraphNode_t* dep, void* fn, void** args) {
  cudaKernelNodeParams p = {};
  p.func = fn;
  p.gridDim = dim3(1);
  p.blockDim = dim3(1);
  p.sharedMemBytes = 0;
  p.kernelParams = args;
  p.extra = nullptr;
  return cudaGraphAddKernelNode(node, g, dep, dep ? 1 : 0, &p);
}

// The body of a WHILE (or IF) node: `cond` with its handle, the body
// graph it owns in *body.
cudaError_t add_conditional(cudaGraphNode_t* node, cudaGraph_t g,
                            const cudaGraphNode_t* dep,
                            cudaGraphConditionalHandle handle,
                            cudaGraphConditionalNodeType type,
                            cudaGraph_t* body) {
  cudaGraphNodeParams p = {};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = handle;
  p.conditional.type = type;
  p.conditional.size = 1;
#if CUDART_VERSION >= 13000
  cudaError_t e = cudaGraphAddNode(node, g, dep, nullptr, dep ? 1 : 0, &p);
#else
  cudaError_t e = cudaGraphAddNode(node, g, dep, dep ? 1 : 0, &p);
#endif
  if (e == cudaSuccess) *body = p.conditional.phGraph_out[0];
  return e;
}

#define TRY(call, what)                 \
  do {                                  \
    cudaError_t e_ = (call);            \
    if (e_ != cudaSuccess) {            \
      say(err, err_len, what, e_);      \
      cudaGetLastError();               \
      if (graph) cudaGraphDestroy(graph); \
      return (int)e_;                   \
    }                                   \
  } while (0)

}  // namespace

// steps: n_steps (1 or 2) cudaGraph_t, each cloned into the body as a
// child graph node (the caller keeps its own); stop: the device int32
// stop code (< 0: go on); counts: two device int32 that the caller
// zeroes before a launch: counts[0] counts the steps run (count_step's
// launches), counts[1] set_while's launches.  out[0] <- the
// cudaGraphExec_t, out[1] <- the parent cudaGraph_t.
extern "C" int graph_while_build(void* const* steps, int n_steps,
                                 const int* stop, int* counts, void** out,
                                 char* err, int err_len) {
  cudaGraph_t graph = nullptr;
  if (n_steps < 1 || n_steps > 2) {
    if (err && err_len > 0)
      snprintf(err, err_len, "graph_while_build takes 1 or 2 steps, got %d",
               n_steps);
    return (int)cudaErrorInvalidValue;
  }
  for (int i = 0; i < n_steps; ++i) {
    int types[kTypes] = {};
    cudaError_t e = walk(static_cast<cudaGraph_t>(steps[i]), i, types, err,
                         err_len);
    if (e != cudaSuccess) return cudaGetLastError(), (int)e;
  }
  TRY(cudaGraphCreate(&graph, 0), "cudaGraphCreate");
  cudaGraphConditionalHandle while_h, if_h = 0;
  TRY(cudaGraphConditionalHandleCreate(&while_h, graph, 0,
                                       cudaGraphCondAssignDefault),
      "cudaGraphConditionalHandleCreate (while)");
  int* count = counts;
  int* set_count = counts + 1;
  void* set_args[] = {&while_h, &stop, &set_count};
  cudaGraphNode_t head, loop;
  TRY(add_kernel(&head, graph, nullptr, (void*)set_while, set_args),
      "cudaGraphAddKernelNode (set_while)");
  cudaGraph_t body;
  TRY(add_conditional(&loop, graph, &head, while_h, cudaGraphCondTypeWhile,
                      &body),
      "cudaGraphAddNode (while)");
  if (n_steps == 2)
    TRY(cudaGraphConditionalHandleCreate(&if_h, body, 0,
                                         cudaGraphCondAssignDefault),
        "cudaGraphConditionalHandleCreate (if)");

  cudaGraphNode_t step0, counted0, last;
  TRY(cudaGraphAddChildGraphNode(&step0, body, nullptr, 0,
                                 static_cast<cudaGraph_t>(steps[0])),
      "cudaGraphAddChildGraphNode (step 0)");
  int set_if = n_steps == 2;
  void* count0_args[] = {&count, &if_h, &stop, &set_if};
  TRY(add_kernel(&counted0, body, &step0, (void*)count_step, count0_args),
      "cudaGraphAddKernelNode (count_step)");
  last = counted0;
  if (n_steps == 2) {
    cudaGraphNode_t branch, step1, counted1;
    cudaGraph_t if_body;
    TRY(add_conditional(&branch, body, &counted0, if_h, cudaGraphCondTypeIf,
                        &if_body),
        "cudaGraphAddNode (if)");
    TRY(cudaGraphAddChildGraphNode(&step1, if_body, nullptr, 0,
                                   static_cast<cudaGraph_t>(steps[1])),
        "cudaGraphAddChildGraphNode (step 1)");
    int no_if = 0;
    void* count1_args[] = {&count, &if_h, &stop, &no_if};
    TRY(add_kernel(&counted1, if_body, &step1, (void*)count_step,
                   count1_args),
        "cudaGraphAddKernelNode (count_step)");
    last = branch;
  }
  cudaGraphNode_t tail;
  TRY(add_kernel(&tail, body, &last, (void*)set_while, set_args),
      "cudaGraphAddKernelNode (set_while)");

  cudaGraphExec_t exec;
  TRY(cudaGraphInstantiate(&exec, graph, 0), "cudaGraphInstantiate");
  out[0] = exec;
  out[1] = graph;
  return 0;
}

#undef TRY

extern "C" int graph_while_launch(void* exec, void* stream, char* err,
                                  int err_len) {
  cudaError_t e = cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) {
    say(err, err_len, "cudaGraphLaunch", e);
    cudaGetLastError();
  }
  return (int)e;
}

extern "C" int graph_while_destroy(void* exec, void* graph, char* err,
                                   int err_len) {
  cudaError_t e = cudaSuccess;
  if (exec) e = cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
  if (e == cudaSuccess && graph)
    e = cudaGraphDestroy(static_cast<cudaGraph_t>(graph));
  if (e != cudaSuccess) {
    say(err, err_len, "cudaGraph(Exec)Destroy", e);
    cudaGetLastError();
  }
  return (int)e;
}

// text <- "kernel 87, memset 1, ..." for `graph` and its child graphs
// (or the error).
extern "C" int graph_while_describe(void* graph, char* text, int text_len) {
  int counts[kTypes] = {};
  cudaError_t e = walk(static_cast<cudaGraph_t>(graph), -1, counts, text,
                       text_len);
  if (e != cudaSuccess) return cudaGetLastError(), (int)e;
  int at = 0;
  if (text && text_len > 0) text[0] = '\0';
  for (int t = 0; t < kTypes && text && at < text_len; ++t)
    if (counts[t])
      at += snprintf(text + at, text_len - at, "%s%s %d", at ? ", " : "",
                     type_name((cudaGraphNodeType)t), counts[t]);
  return 0;
}
