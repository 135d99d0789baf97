"""The kernel nodes of a captured CUDA graph, read through the CUDA driver:
what every replay of it launches, whatever a profiler's trace records. A
copy of hnumo_tpu_torch/tools/_measure.graph_kernels."""
from __future__ import annotations

from .bounds import KERNEL_SYMBOLS


def graph_kernels(graph) -> dict:
    """{kernel symbol (mangled): nodes} of a graph captured with its nodes
    kept (torch.cuda.CUDAGraph(keep_graph=True)), child graphs included."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    ptr, out = ctypes.c_void_p, ctypes.byref

    class KernelNodeParams(ctypes.Structure):   # cuda.h: CUDA_KERNEL_NODE_PARAMS_v2
        _fields_ = [("func", ptr), ("dims", ctypes.c_uint * 6),
                    ("shared_bytes", ctypes.c_uint), ("params", ptr), ("extra", ptr),
                    ("kern", ptr), ("ctx", ptr)]

    def call(fn, *args):
        rc = getattr(cu, fn)(*args)
        if rc:
            raise RuntimeError(f"{fn} returned CUresult {rc}")

    counts = {}

    def walk(g):
        n = ctypes.c_size_t(0)
        call("cuGraphGetNodes", g, None, out(n))
        nodes = (ptr * n.value)()
        call("cuGraphGetNodes", g, nodes, out(n))
        for node in map(ptr, nodes):
            kind = ctypes.c_int()
            call("cuGraphNodeGetType", node, out(kind))
            if kind.value == 4:                   # CU_GRAPH_NODE_TYPE_GRAPH
                child = ptr()
                call("cuGraphChildGraphNodeGetGraph", node, out(child))
                walk(child)
            elif kind.value == 0:                 # CU_GRAPH_NODE_TYPE_KERNEL
                params, name = KernelNodeParams(), ctypes.c_char_p()
                call("cuGraphKernelNodeGetParams_v2", node, out(params))
                if params.func:
                    call("cuFuncGetName", out(name), ptr(params.func))
                else:
                    call("cuKernelGetName", out(name), ptr(params.kern))
                key = name.value.decode()
                counts[key] = counts.get(key, 0) + 1

    walk(ptr(graph.raw_cuda_graph()))
    return counts


def path_counts(nodes: dict) -> dict:
    """The five kernels' nodes among `graph_kernels` (mangled symbols)."""
    return {name: sum(n for k, n in nodes.items() if sym in k)
            for name, sym in KERNEL_SYMBOLS.items()}


def expected_from_static(static) -> dict:
    """{kernel: launches a step} of the five kernels on the path that the
    model says it takes (its StaticConfig: `mega`, `fused_tail`,
    `uni_volume`, `n_btp`, `kstages`): 2 megakernel launches, or every
    stage (2 solves of n_btp * kstages) one launch of each kernel of the
    fused path, of the uniform-geometry or of the general volume kernel."""
    stages = 2 * static.n_btp * static.kstages
    if static.mega:
        want = {"btp_mega": 2}
    elif static.fused_tail:
        want = dict.fromkeys(("btp_volume_uni", "btp_faces", "btp_update"), stages)
    elif static.uni_volume:
        want = {"btp_volume_uni": stages}
    else:
        want = {"btp_volume": stages}
    return {name: want.get(name, 0) for name in KERNEL_SYMBOLS}
