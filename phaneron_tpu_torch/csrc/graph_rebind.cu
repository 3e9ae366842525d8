// graph_rebind: the entries graph/replay.py drives a captured channel tick
// with.  No kernel of its own: driver calls on a CUDA graph that PyTorch
// captured (torch.cuda.CUDAGraph(keep_graph=True)) and on its executable
// graph.
//
// phn_graph_nodes and phn_graph_node list the graph's nodes and what each
// holds: a kernel node its function's name and its parameters laid out as
// the kernel receives them (cuFuncGetParamInfo gives each parameter's offset
// and size), a memcpy or memset node the addresses it touches.  Python finds
// there every node that holds the address of a tick's source or output
// plane, pointers inside by-value structs included.
//
// phn_graph_rebind puts a tick's addresses in place and launches: for each
// given kernel node, cuGraphExecKernelNodeSetParams on the executable graph
// with the node's new parameter bytes, then cuGraphLaunch.  The function,
// grid, block and shared memory stay the captured ones.  CUDA applies an
// update to later launches only, so a launch still in flight keeps the
// addresses it was launched with (and the update does not wait for it).
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr size_t kMaxParams = 256;

CUresult kernel_params(CUgraphNode node, CUDA_KERNEL_NODE_PARAMS* p) {
  memset(p, 0, sizeof(*p));
  return cuGraphKernelNodeGetParams(node, p);
}

// parameter i of the node's function: its offset and size
CUresult param_info(const CUDA_KERNEL_NODE_PARAMS& p, size_t i, size_t* offset, size_t* size) {
  return p.func != nullptr ? cuFuncGetParamInfo(p.func, i, offset, size)
                           : cuKernelGetParamInfo(p.kern, i, offset, size);
}

bool reads_host(CUmemorytype type, CUdeviceptr ptr) {
  if (type == CU_MEMORYTYPE_HOST) return true;
  if (type != CU_MEMORYTYPE_UNIFIED || ptr == 0) return false;
  unsigned int kind = 0;
  return cuPointerGetAttribute(&kind, CU_POINTER_ATTRIBUTE_MEMORY_TYPE, ptr) != CUDA_SUCCESS ||
         kind == CU_MEMORYTYPE_HOST;
}

}  // namespace

// nodes null: *count becomes the number of nodes of the graph; else the
// first *count nodes are written to nodes.  Returns a CUresult.
extern "C" int phn_graph_nodes(void* graph, void** nodes, size_t* count) {
  return static_cast<int>(
      cuGraphGetNodes(static_cast<CUgraph>(graph), reinterpret_cast<CUgraphNode*>(nodes), count));
}

// One node: *type its CUgraphNodeType.  A kernel node: *name its function's
// name, params[0, *size) its parameters as the kernel receives them,
// offsets[0, *n_params) where each begins (at most max_params; the bytes
// between parameters are left as they were).  A memcpy node: params holds
// its source's and destination's device and host addresses as four 8-byte
// values and *from_host is 1 when it reads host memory.  A memset node: its
// destination.  Other nodes: *size 0.  Returns a CUresult, or
// CUDA_ERROR_NOT_SUPPORTED for a kernel node whose parameters do not fit or
// were given as one buffer.
extern "C" int phn_graph_node(void* node, int* type, const char** name, unsigned char* params,
                              size_t cap, size_t* size, unsigned long long* offsets, size_t max_params,
                              size_t* n_params, int* from_host) {
  CUgraphNode n = static_cast<CUgraphNode>(node);
  CUgraphNodeType t;
  CUresult r = cuGraphNodeGetType(n, &t);
  if (r != CUDA_SUCCESS) return static_cast<int>(r);
  *type = static_cast<int>(t);
  *name = "";
  *size = 0;
  *n_params = 0;
  *from_host = 0;
  if (t == CU_GRAPH_NODE_TYPE_KERNEL) {
    CUDA_KERNEL_NODE_PARAMS p;
    if ((r = kernel_params(n, &p)) != CUDA_SUCCESS) return static_cast<int>(r);
    r = p.func != nullptr ? cuFuncGetName(name, p.func) : cuKernelGetName(name, p.kern);
    if (r != CUDA_SUCCESS) return static_cast<int>(r);
    size_t end = 0, i = 0;
    for (;; ++i) {
      size_t off = 0, sz = 0;
      r = param_info(p, i, &off, &sz);
      if (r == CUDA_ERROR_INVALID_VALUE) break;  // past the last parameter
      if (r != CUDA_SUCCESS) return static_cast<int>(r);
      if (i >= max_params || off + sz > cap || p.kernelParams == nullptr)
        return static_cast<int>(CUDA_ERROR_NOT_SUPPORTED);
      memcpy(params + off, p.kernelParams[i], sz);
      offsets[i] = off;
      if (off + sz > end) end = off + sz;
    }
    *size = end;
    *n_params = i;
  } else if (t == CU_GRAPH_NODE_TYPE_MEMCPY) {
    CUDA_MEMCPY3D m;
    if ((r = cuGraphMemcpyNodeGetParams(n, &m)) != CUDA_SUCCESS) return static_cast<int>(r);
    const unsigned long long v[4] = {static_cast<unsigned long long>(m.srcDevice),
                                     static_cast<unsigned long long>(m.dstDevice),
                                     reinterpret_cast<uintptr_t>(m.srcHost),
                                     reinterpret_cast<uintptr_t>(m.dstHost)};
    if (cap < sizeof(v)) return static_cast<int>(CUDA_ERROR_NOT_SUPPORTED);
    memcpy(params, v, sizeof(v));
    *size = sizeof(v);
    *from_host = reads_host(m.srcMemoryType, m.srcDevice) ? 1 : 0;
  } else if (t == CU_GRAPH_NODE_TYPE_MEMSET) {
    CUDA_MEMSET_NODE_PARAMS m;
    if ((r = cuGraphMemsetNodeGetParams(n, &m)) != CUDA_SUCCESS) return static_cast<int>(r);
    const unsigned long long v = static_cast<unsigned long long>(m.dst);
    if (cap < sizeof(v)) return static_cast<int>(CUDA_ERROR_NOT_SUPPORTED);
    memcpy(params, &v, sizeof(v));
    *size = sizeof(v);
  }
  return static_cast<int>(CUDA_SUCCESS);
}

// n kernel nodes of the graph exec was instantiated from: nodes[k] takes
// the parameter bytes params[k], parameter i at offsets[k][i], n_params[k]
// of them (as phn_graph_node gave them, with new addresses written in);
// then exec is launched on stream.  Returns the first CUresult that is not
// CUDA_SUCCESS.
extern "C" int phn_graph_rebind(void* exec, void* const* nodes, const unsigned char* const* params,
                                const unsigned long long* const* offsets, const unsigned long long* n_params,
                                int n, void* stream) {
  void* args[kMaxParams];
  for (int k = 0; k < n; ++k) {
    CUgraphNode node = static_cast<CUgraphNode>(nodes[k]);
    CUDA_KERNEL_NODE_PARAMS p;
    CUresult r = kernel_params(node, &p);
    if (r != CUDA_SUCCESS) return static_cast<int>(r);
    if (n_params[k] > kMaxParams) return static_cast<int>(CUDA_ERROR_NOT_SUPPORTED);
    for (unsigned long long i = 0; i < n_params[k]; ++i)
      args[i] = const_cast<unsigned char*>(params[k] + offsets[k][i]);
    p.kernelParams = args;
    p.extra = nullptr;
    r = cuGraphExecKernelNodeSetParams(static_cast<CUgraphExec>(exec), node, &p);
    if (r != CUDA_SUCCESS) return static_cast<int>(r);
  }
  return static_cast<int>(cuGraphLaunch(static_cast<CUgraphExec>(exec), static_cast<CUstream>(stream)));
}
