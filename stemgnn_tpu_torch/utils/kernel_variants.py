"""Where a kernel's time goes: builds copies of a CUDA source with one piece
taken out or changed, and times each beside the source as it is.

    python -m stemgnn_tpu_torch.utils.kernel_variants [gru] [graph]

A variant is a list of (text, replacement) pairs applied to the source; a
pair whose text is no longer in the source stops the run, so an edit to a
kernel shows up here. Most variants compute WRONG results by design (an
exchange or a load left out): only their times mean anything, and the difference to
`base` is what the piece costs. Shapes are the ECG flagship's (B = 32,
H = N = 140, W = 12, K = 4). Times are device milliseconds of one call,
replays of a CUDA graph of 20 calls, with the card's name and power limit on
the first line. Needs a card and nvcc; nothing in the package calls this.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from stemgnn_tpu_torch.device import card_info
from stemgnn_tpu_torch.ops import _build, cuda_graph, cuda_gru

_GRU_SEND = ("    if (unit_live)\n      cluster_send_all(shared_addr(h_next + j * R + p), "
             "row_live ? h : 0.f, bar, blocks);\n")
_GRU_ARM = "    if (threadIdx.x == 0) mbarrier_expect(bar, (unsigned)(H * R) * 4u);\n"
_GRU_WAIT = "    mbarrier_wait(bar, (unsigned)(t >> 1) & 1u);\n"
GRU_VARIANTS = {
    "base": [],
    # no exchange at all, a block barrier a step: what the exchange costs
    "local stores, block barrier": [
        (_GRU_SEND, "    if (unit_live) h_next[j * R + p] = row_live ? h : 0.f;\n"),
        (_GRU_ARM, ""), (_GRU_WAIT, "    __syncthreads();\n")],
    # plain remote stores and the hardware cluster barrier, split around the
    # stores of out and sv, in place of st.async and the mbarrier
    "cluster barrier": [
        (_GRU_SEND,
         "    if (unit_live)\n      for (unsigned rank = 0; rank < blocks; ++rank)\n"
         "        cluster.map_shared_rank(h_next, rank)[j * R + p] = row_live ? h : 0.f;\n"
         "    __syncwarp();\n"
         '    asm volatile("barrier.cluster.arrive.release;" ::: "memory");\n'),
        (_GRU_ARM, ""),
        (_GRU_WAIT, '    __syncwarp();\n'
                    '    asm volatile("barrier.cluster.wait.acquire;" ::: "memory");\n')],
    "no sigmoid or tanh": [
        ("const float c = tanhf(x_cur[2] + r * hpn);",
         "const float c = x_cur[2] + r * hpn;"),
        ("sigmoidf(x_cur[0] + (acc[0][0] + br))", "(x_cur[0] + (acc[0][0] + br)) * 0.01f"),
        ("sigmoidf(x_cur[1] + (acc[1][0] + bz))", "(x_cur[1] + (acc[1][0] + bz)) * 0.01f")],
    "k loop not unrolled": [("#pragma unroll 5\n", "#pragma unroll 1\n")],
}

_G_LOOP = "      for (int m = p; m < mp; m += kParts) {"
_G_ONE_ROUND = "      for (int m = p; m < min(mp, kParts); m += kParts) {"
_G_LOADS = [
    ("        copy_panel_async(As, RSA, Lk + m0, N, rows, mr);\n", ""),
    ("          copy_panel_async(Xs + i * XBS, 0, x + ((long)(b0 + i) * N + m0) * W, "
     "0, 1,\n                           mr * W);\n", "          ;\n")]
GRAPH_VARIANTS = {
    "base": [],
    "one round of the sum": [(_G_LOOP, _G_ONE_ROUND)],
    "no loads": _G_LOADS,
    "no loads, one round of the sum": [(_G_LOOP, _G_ONE_ROUND), *_G_LOADS],
    "every block returns at once": [("  float* As = smem;\n",
                                     "  if (n0 >= 0) return;\n  float* As = smem;\n")],
}


def _cuda_ms(fn, calls: int = 20, replays: int = 10) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def _build_variants(source: str, variants: dict, tmp: Path) -> dict:
    """{variant: loaded library}, every nvcc started together."""
    text = (_build.CSRC / source).read_text()
    procs = {}
    for n, (name, pairs) in enumerate(variants.items()):
        changed = text
        for old, new in pairs:
            if old not in changed:
                raise SystemExit(f"{source}, variant {name!r}: the source no longer "
                                 f"holds {old!r}")
            changed = changed.replace(old, new)
        src = tmp / f"{Path(source).stem}_{n}.cu"
        src.write_text(changed)
        lib = src.with_suffix(".so")
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(lib),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{source}, variant {name!r}: nvcc failed:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def _gru_inputs(b: int, h: int, dev):
    rng = np.random.default_rng(0)
    bound = 1.0 / np.sqrt(h)
    return [torch.from_numpy(a.astype(np.float32)).to(dev)
            for a in (rng.standard_normal((h, b, 3 * h)),
                      rng.uniform(-bound, bound, (h, 3 * h)),
                      rng.uniform(-bound, bound, 3 * h))]


def gru(dev, tmp: Path) -> None:
    b, h = 32, 140
    x_proj, a_all, b_hh = _gru_inputs(b, h, dev)
    out = torch.empty((b, h, h), device=dev)
    sv = torch.empty((h, 5, b, h), device=dev)
    plans = {f"cluster of {c}": cuda_gru._cluster_plan(b, h, c) for c in (5, 7, 4)}
    for name, lib in _build_variants("gru.cu", GRU_VARIANTS, tmp).items():
        fn = lib.gru_fwd_cluster
        fn.argtypes = cuda_gru._ARGTYPES["gru_fwd_cluster"]
        fn.restype = ctypes.c_int
        for label, plan in plans.items():
            if name != "base" and plan != cuda_gru.launch_plan(b, h):
                continue  # the other cluster sizes: the source as it is only

            def call(save, plan=plan):
                _build.check(fn(
                    x_proj.data_ptr(), a_all.data_ptr(), b_hh.data_ptr(), out.data_ptr(),
                    sv.data_ptr() if save else None, h, b, h, plan.rows, plan.groups,
                    plan.cluster, plan.slice, plan.row_stride, plan.threads, plan.smem,
                    _build.stream_ptr(out)), name)

            serve, save = (_cuda_ms(lambda s=s: call(s)) for s in (False, True))
            print(f"gru_fwd_cluster B={b} H={h}, {label} ({plan.threads} threads), "
                  f"{name}: serving {serve:.5f} ms ({serve / h * 1e3:.3f} us a step), "
                  f"saving {save:.5f} ms")

    # the widest model (H = 512): the one-block route it takes against a cluster
    # of 16 blocks, above the portable limit of 8, which the kernel asks for
    # with cudaFuncAttributeNonPortableClusterSizeAllowed
    b, h = 32, 512
    args = _gru_inputs(b, h, dev)
    with torch.no_grad():
        one_block, _ = cuda_gru.gru_fwd_one_block(*args)
        ms = _cuda_ms(lambda: cuda_gru.gru_fwd_one_block(*args), calls=2, replays=3)
        print(f"gru forward B={b} H={h}, one block: serving {ms:.5f} ms")
        plan = cuda_gru.launch_plan(b, h, max_cluster=16)
        try:
            wide, _ = cuda_gru._launch_fwd(*args, False, plan)
            torch.cuda.synchronize()
        except RuntimeError as exc:
            print(f"gru forward B={b} H={h}, cluster of {plan.cluster}: refused ({exc})")
            return
        err = (wide - one_block).abs().max().item()
        ms = _cuda_ms(lambda: cuda_gru._launch_fwd(*args, False, plan))
        print(f"gru forward B={b} H={h}, cluster of {plan.cluster} (slice {plan.slice}, "
              f"{plan.smem} B): serving {ms:.5f} ms ({ms / h * 1e3:.3f} us a step), "
              f"max_abs_err against the one block {err:.3e}")


def graph(dev, tmp: Path) -> None:
    k, n, b, w = 4, 140, 32, 12
    rng = np.random.default_rng(0)
    mul_l = torch.from_numpy((rng.standard_normal((k, n, n)) * 0.1).astype(np.float32))
    mul_l, x = mul_l.to(dev), torch.from_numpy(
        rng.standard_normal((b, n, w)).astype(np.float32)).to(dev)
    out = torch.empty((b, k, n, w), device=dev)
    plan = cuda_graph.launch_plan(k, n, b, w)
    for name, lib in _build_variants("graph.cu", GRAPH_VARIANTS, tmp).items():
        fn = lib.cheb_graph_conv_fwd
        fn.argtypes = cuda_graph._ARGTYPES
        fn.restype = ctypes.c_int

        def call():
            _build.check(fn(mul_l.data_ptr(), x.data_ptr(), out.data_ptr(), k, n, b, w,
                            plan.panel, plan.row_stride, plan.batch_stride, plan.threads,
                            plan.smem, 1, _build.stream_ptr(out)), name)

        print(f"cheb_graph_conv_fwd K={k} N={n} B={b} W={w}, {name}: "
              f"{_cuda_ms(call) * 1e3:.3f} us")
    x_t = x.permute(1, 0, 2).reshape(n, b * w).contiguous()
    orders = mul_l[1:].contiguous()
    print(f"torch.matmul of the three orders: "
          f"{_cuda_ms(lambda: torch.matmul(orders, x_t)) * 1e3:.3f} us")


def main(argv=None) -> int:
    which = (argv if argv is not None else sys.argv[1:]) or ["gru", "graph"]
    if not torch.cuda.is_available():
        print("kernel_variants: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_info()
    print(f"{card['device']}, {card['power_limit']}")
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        for name in which:
            {"gru": gru, "graph": graph}[name](dev, Path(tmp))
    return 0


if __name__ == "__main__":
    sys.exit(main())
