// The CG loop's exit test on the device: a conditional IF node around one
// captured CG iteration (solver/graph.py), and a whole frame of the fused
// frame loop with its CG loop as a WHILE node (`gmg_graph_frame`).
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

// Instantiate one frame of the fused frame loop (solver/graph.py
// `FrameGraph`, the JAX package's `lax.scan` body with its CG
// `while_loop`) into *exec_out:
//
//   [child: pre] -> [set W from *running] -> [WHILE W: body] -> [child: post]
//   body: [child: it0] -> [set I from *running] -> [IF I: child it1]
//         -> [set W from *running]
//
// `pre` is the frame up to the CG loop's first iteration, `it0` / `it1`
// the two parities of one iteration (p read from one buffer, p' written to
// the other), `post` the rest of the frame; all four are cudaGraph_t
// captured by PyTorch (the child nodes hold copies).  `running` is the
// loop's device predicate, rewritten by every iteration, so the WHILE
// node runs iterations in pairs until it drops, the second of a pair only
// where the first left it set -- the iterations, in order, that an eager
// loop runs.  Returns the first CUDA error, or 0.
extern "C" int gmg_graph_frame(void* pre, void* it0, void* it1, void* post, const void* running,
                               void** exec_out) {
  cudaError_t code = cudaSuccess;
  cudaGraph_t outer = nullptr, body = nullptr;
  cudaGraphConditionalHandle loop_h, if_h;
  cudaGraphNode_t pre_node, set_loop, while_node, post_node, it0_node, set_if, if_node, again, it1_node;
  cudaKernelNodeParams kp = {};
  cudaGraphNodeParams wp = {}, ip = {};
  cudaGraphExec_t exec = nullptr;
  void* loop_args[2] = {&loop_h, &running};
  void* if_args[2] = {&if_h, &running};
  *exec_out = nullptr;
  kp.func = (void*)gmg::set_condition_kernel;
  kp.gridDim = dim3(1);
  kp.blockDim = dim3(1);
  GMG_TRY(cudaGraphCreate(&outer, 0));
  GMG_TRY(cudaGraphConditionalHandleCreate(&loop_h, outer, 0, 0));
  GMG_TRY(cudaGraphAddChildGraphNode(&pre_node, outer, nullptr, 0, (cudaGraph_t)pre));
  kp.kernelParams = loop_args;
  GMG_TRY(cudaGraphAddKernelNode(&set_loop, outer, &pre_node, 1, &kp));
  wp.type = cudaGraphNodeTypeConditional;
  wp.conditional.handle = loop_h;
  wp.conditional.type = cudaGraphCondTypeWhile;
  wp.conditional.size = 1;
  GMG_TRY(cudaGraphAddNode(&while_node, outer, &set_loop, 1, &wp));
  GMG_TRY(cudaGraphAddChildGraphNode(&post_node, outer, &while_node, 1, (cudaGraph_t)post));
  body = wp.conditional.phGraph_out[0];
  GMG_TRY(cudaGraphConditionalHandleCreate(&if_h, body, 0, 0));
  GMG_TRY(cudaGraphAddChildGraphNode(&it0_node, body, nullptr, 0, (cudaGraph_t)it0));
  kp.kernelParams = if_args;
  GMG_TRY(cudaGraphAddKernelNode(&set_if, body, &it0_node, 1, &kp));
  ip.type = cudaGraphNodeTypeConditional;
  ip.conditional.handle = if_h;
  ip.conditional.type = cudaGraphCondTypeIf;
  ip.conditional.size = 1;
  GMG_TRY(cudaGraphAddNode(&if_node, body, &set_if, 1, &ip));
  GMG_TRY(cudaGraphAddChildGraphNode(&it1_node, ip.conditional.phGraph_out[0], nullptr, 0, (cudaGraph_t)it1));
  kp.kernelParams = loop_args;
  GMG_TRY(cudaGraphAddKernelNode(&again, body, &if_node, 1, &kp));
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
