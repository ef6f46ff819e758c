"""The CUDA kernels one call launches, read from the kernel nodes of a CUDA
graph that captures it: a copy of `chip_smoke.py` `kernels_of_graph`, which
the benchmark holds the profiler's names to (the profiler can lose events)."""

from __future__ import annotations

import sys


def kernels_of_graph(fn):
    """The names of the CUDA kernels one call of fn launches, read from the
    kernel nodes of a CUDA graph that captures the call: libcuda's
    cuGraphKernelNodeGetParams_v2 and cuFuncGetName (cuKernelGetName where
    the node holds a library kernel), demangled by libstdc++'s
    __cxa_demangle. None where any step fails. Unlike the profiler it needs
    no tracer, so it gives the same answer every time."""
    import ctypes

    import torch

    vp = ctypes.c_void_p
    try:
        cu = ctypes.CDLL("libcuda.so.1")
        cxx = ctypes.CDLL("libstdc++.so.6")
        cxx.__cxa_demangle.restype = vp
        cxx.__cxa_demangle.argtypes = [ctypes.c_char_p, vp, vp, ctypes.POINTER(ctypes.c_int)]
        libc = ctypes.CDLL(None)
        libc.free.argtypes = [vp]
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph):
            fn()
        torch.cuda.synchronize()
        raw = vp(graph.raw_cuda_graph())
        count = ctypes.c_size_t(0)
        if cu.cuGraphGetNodes(raw, None, ctypes.byref(count)) != 0:
            return None
        nodes = (vp * count.value)()
        if cu.cuGraphGetNodes(raw, nodes, ctypes.byref(count)) != 0:
            return None
        names = []
        for node in nodes[: count.value]:
            kind = ctypes.c_int(-1)
            if cu.cuGraphNodeGetType(vp(node), ctypes.byref(kind)) != 0:
                return None
            if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
                continue
            # CUDA_KERNEL_NODE_PARAMS_v2: func, 7 unsigned ints and padding,
            # kernelParams, extra, kern, ctx
            params = (vp * 9)()
            if cu.cuGraphKernelNodeGetParams_v2(vp(node), params) != 0:
                return None
            name = ctypes.c_char_p()
            rc = (cu.cuFuncGetName(ctypes.byref(name), vp(params[0])) if params[0]
                  else cu.cuKernelGetName(ctypes.byref(name), vp(params[7])))
            if rc != 0 or not name.value:
                return None
            status = ctypes.c_int(-1)
            out = cxx.__cxa_demangle(name.value, None, None, ctypes.byref(status))
            if status.value == 0 and out:
                names.append(ctypes.string_at(out).decode())
                libc.free(out)
            else:
                names.append(name.value.decode())
        graph.reset()
        return names or None
    except (AttributeError, OSError, RuntimeError) as exc:
        print(f"portbench: kernels of a CUDA graph of a call: not measured ({exc})",
              file=sys.stderr)
        return None
