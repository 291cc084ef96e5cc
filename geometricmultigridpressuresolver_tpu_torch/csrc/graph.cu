// The CG loop's exit test on the device: a conditional IF node around one
// captured CG iteration (solver/graph.py).
//
// Replaces the loop test of the JAX package's `lax.while_loop`
// (solver/cg.py:238-276: `cond` on (rr > threshold) & (it < max) &
// ~interrupted, evaluated on the device before every body).  PyTorch
// captures the iteration into a plain CUDA graph; this file wraps it:
//
//   [set_condition_kernel: handle = *running] -> [IF handle: iteration]
//
// and instantiates that as one executable graph.  The iteration is added
// as a child graph node of the IF node's body, so the body runs exactly
// the captured kernels, copies and fills.  `running` is a device bool that
// the iteration itself rewrites, so a launch after the loop's exit sets the
// handle to 0 and runs nothing: the graph can be launched K times back to
// back and the host reads the loop's status once.  Needs CUDA 12.4 or later
// (conditional nodes built with cudaGraphAddNode); the GPU runner has 12.8.
#include <cuda_runtime.h>

namespace gmg {

__global__ void set_condition_kernel(cudaGraphConditionalHandle handle, const bool* running) {
  cudaGraphSetConditional(handle, *running ? 1u : 0u);
}

}  // namespace gmg

#define GMG_TRY(call)               \
  do {                              \
    cudaError_t err_ = (call);      \
    if (err_ != cudaSuccess) {      \
      code = err_;                  \
      goto done;                    \
    }                               \
  } while (0)

// Instantiate [set handle from *running] -> [IF handle: child graph `body`]
// into *exec_out.  `body` is a cudaGraph_t (PyTorch's captured iteration,
// kept by `torch.cuda.CUDAGraph(keep_graph=True)`); the child node holds
// its own copy, so `body` may be destroyed afterwards.  Returns the first
// CUDA error, or 0.
extern "C" int gmg_graph_if(void* body, const void* running, void** exec_out) {
  cudaError_t code = cudaSuccess;
  cudaGraph_t outer = nullptr;
  cudaGraphConditionalHandle handle;
  cudaGraphNode_t set_node, if_node, child_node;
  cudaKernelNodeParams kp = {};
  cudaGraphNodeParams cp = {};
  cudaGraphExec_t exec = nullptr;
  void* args[2] = {&handle, &running};
  *exec_out = nullptr;
  GMG_TRY(cudaGraphCreate(&outer, 0));
  GMG_TRY(cudaGraphConditionalHandleCreate(&handle, outer, 0, 0));
  kp.func = (void*)gmg::set_condition_kernel;
  kp.gridDim = dim3(1);
  kp.blockDim = dim3(1);
  kp.kernelParams = args;
  GMG_TRY(cudaGraphAddKernelNode(&set_node, outer, nullptr, 0, &kp));
  cp.type = cudaGraphNodeTypeConditional;
  cp.conditional.handle = handle;
  cp.conditional.type = cudaGraphCondTypeIf;
  cp.conditional.size = 1;
  GMG_TRY(cudaGraphAddNode(&if_node, outer, &set_node, 1, &cp));
  GMG_TRY(cudaGraphAddChildGraphNode(&child_node, cp.conditional.phGraph_out[0], nullptr, 0,
                                     (cudaGraph_t)body));
  GMG_TRY(cudaGraphInstantiate(&exec, outer, 0));
  *exec_out = exec;
done:
  if (outer != nullptr) cudaGraphDestroy(outer);
  return code;
}

extern "C" int gmg_graph_launch(void* exec, void* stream) {
  return cudaGraphLaunch((cudaGraphExec_t)exec, (cudaStream_t)stream);
}

extern "C" int gmg_graph_destroy(void* exec) {
  return cudaGraphExecDestroy((cudaGraphExec_t)exec);
}
