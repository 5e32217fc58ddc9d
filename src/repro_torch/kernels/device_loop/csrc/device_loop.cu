// The device do-while loop of the engine's stretches: a CUDA graph whose
// WHILE node replays one captured round until a device flag drops.
//
// Built by build.py into a shared library with a plain C interface and
// called through ctypes from device_loop.py.
//
// ---------------------------------------------------------------------------
// Replaces the jax.lax.while_loop of the reference's stretches
//   (src/repro/core/engine.py: run_dense, _staged_stretch, _sparse_stretch,
//   _dense_stretch).  It is no TPU kernel: on the TPU, XLA keeps the loop on
//   the device; here a host loop would fetch the band predicate after every
//   round, one blocking device-to-host read a round.
//
//   The graph (device_loop_build):
//
//     loop_enter ──> WHILE(handle) { body (a child graph) ──> loop_next }
//
//   * body: one round as PyTorch captured it (torch.cuda.CUDAGraph,
//     keep_graph=True): the step, copies of its results into the loop's
//     static state buffers, and the flag `go` (the stretch's band
//     predicate, or cond).  The body is cloned into the WHILE node as a
//     child graph, so torch's private memory pool of the capture must
//     outlive the executable.
//   * loop_enter: one thread sets the handle to (*k < *limit && *go), so the
//     caller decides whether the first iteration runs: a do-while puts the
//     flag of a round it already ran there, a while loop its entry cond.
//   * loop_next: one thread counts the round (*k += 1) and sets the handle
//     to (*k < *limit && *go) for the next iteration.
//
//   k, limit and go are device words that the caller fills before each
//   launch (the executable is replayed for every stretch of one rung), and
//   k holds the rounds run when the launch ends.  Nothing is read on the
//   host until the caller fetches k with the next round's scalars.
//
//   Bound: none worth naming.  The two kernels read 9 bytes and write 4 a
//   round, one thread each; a round's time is its body's.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>

namespace {

__global__ void loop_enter(cudaGraphConditionalHandle handle, const int* k, const int* limit,
                           const unsigned char* go) {
  cudaGraphSetConditional(handle, (*k < *limit && *go) ? 1u : 0u);
}

__global__ void loop_next(cudaGraphConditionalHandle handle, int* k, const int* limit,
                          const unsigned char* go) {
  const int rounds = *k + 1;
  *k = rounds;
  cudaGraphSetConditional(handle, (rounds < *limit && *go) ? 1u : 0u);
}

// one single-thread kernel node; `args` are copied into the node
cudaError_t add_kernel_node(cudaGraphNode_t* node, cudaGraph_t graph, const cudaGraphNode_t* dep,
                            size_t ndep, void* fn, void** args) {
  cudaKernelNodeParams p = {};
  p.func = fn;
  p.gridDim = dim3(1, 1, 1);
  p.blockDim = dim3(1, 1, 1);
  p.sharedMemBytes = 0;
  p.kernelParams = args;
  p.extra = nullptr;
  return cudaGraphAddKernelNode(node, graph, dep, ndep, &p);
}

cudaError_t build(cudaGraph_t body, int* k, const int* limit, const unsigned char* go,
                  cudaGraph_t outer, cudaGraphExec_t* exec) {
  cudaGraphConditionalHandle handle;
  cudaError_t err = cudaGraphConditionalHandleCreate(&handle, outer, 0, 0);
  if (err != cudaSuccess) return err;
  cudaGraphNode_t enter;
  void* enter_args[] = {&handle, &k, &limit, &go};
  err = add_kernel_node(&enter, outer, nullptr, 0, reinterpret_cast<void*>(loop_enter),
                        enter_args);
  if (err != cudaSuccess) return err;

  cudaGraphNodeParams cp = {};
  cp.type = cudaGraphNodeTypeConditional;
  cp.conditional.handle = handle;
  cp.conditional.type = cudaGraphCondTypeWhile;
  cp.conditional.size = 1;
  cudaGraphNode_t cond;
  err = cudaGraphAddNode(&cond, outer, &enter, 1, &cp);
  if (err != cudaSuccess) return err;
  cudaGraph_t inner = cp.conditional.phGraph_out[0];

  cudaGraphNode_t child;
  err = cudaGraphAddChildGraphNode(&child, inner, nullptr, 0, body);
  if (err != cudaSuccess) return err;
  cudaGraphNode_t next;
  void* next_args[] = {&handle, &k, &limit, &go};
  err = add_kernel_node(&next, inner, &child, 1, reinterpret_cast<void*>(loop_next), next_args);
  if (err != cudaSuccess) return err;
  return cudaGraphInstantiate(exec, outer, 0);
}

}  // namespace

extern "C" {

const char* device_loop_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Build the loop's executable around `body` (a cudaGraph_t); `*exec_out`
// receives the cudaGraphExec_t.  The outer graph is destroyed here; the
// executable keeps what it needs.
int device_loop_build(void* body, int* k, const int* limit, const unsigned char* go,
                      void** exec_out) {
  *exec_out = nullptr;
  cudaGraph_t outer = nullptr;
  cudaError_t err = cudaGraphCreate(&outer, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphExec_t exec = nullptr;
  err = build(static_cast<cudaGraph_t>(body), k, limit, go, outer, &exec);
  cudaGraphDestroy(outer);
  if (err != cudaSuccess) {
    if (exec != nullptr) cudaGraphExecDestroy(exec);
    return static_cast<int>(err);
  }
  *exec_out = exec;
  return 0;
}

// Enqueue one run of the loop on `stream`; it does not wait.
int device_loop_launch(void* exec, void* stream) {
  cudaError_t err = cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Destroy an executable; one still running is freed when it completes.
int device_loop_destroy(void* exec) {
  return static_cast<int>(cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec)));
}

}  // extern "C"
