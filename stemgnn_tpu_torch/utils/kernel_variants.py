"""Where a kernel's time goes: builds copies of a CUDA source with one piece
taken out or changed, and times each beside the source as it is.

    python -m stemgnn_tpu_torch.utils.kernel_variants [gru] [gru_bwd] [gru_grid]
        [spectral] [spectral_fwd] [spectral_mma] [spectral_fwd_mma] [spectral_acts]
        [graph] [against=CHECKOUT] [ptxas] [ptxas=CHECKOUT]

A variant is a list of (text, replacement) pairs applied to the source; a
pair whose text is no longer in the source stops the run, so an edit to a
kernel shows up here. Most variants compute WRONG results by design (an
exchange or a load left out): only their times mean anything, and the difference to
`base` is what the piece costs. Shapes are the ECG flagship's (B = 32,
H = N = 140, W = 12, K = 4); `gru_grid` times the grid GRU kernels at
B = 32, H = N = 512 and B = 8, H = N = 1024; `spectral_fwd` also times the COVID-19 shape
(B = 32, N = 25, W = 28, multi 5); `spectral_mma` the bf16 reread backward
on tensor cores, its epilogue or one kernel left out; `spectral_fwd_mma` the
bf16 forwards' chain on tensor cores at both shapes, its a, s stores, join,
inverse DFT, weight staging or products left out, and other plans;
`spectral_acts` the bf16 saving forward and reread backward with each storage
of the saved arrays (f32, bf16) at both shapes, and the bf16 stores by variant.
`against=CHECKOUT`
builds the spectral and graph sources of another checkout (a `git archive` of
an earlier commit) and holds this tree's f32 spectral entries (forwards and
backwards) and both arms of the graph conv (this tree's bf16 arm fed the f32
operands, the other's the casts its wrapper made) bitwise against it, at the
flagship and COVID-19 shapes, and times both trees' bf16 reread backwards and
bf16 forwards. Times are
device milliseconds of one call, replays of a CUDA graph of 20 calls, with the
card's name and power limit on the first line. `ptxas` (or `ptxas=CHECKOUT`
for another checkout's sources) compiles each kernel source with
`-Xptxas -v` and prints every kernel's registers, stack and spills. Needs a
card and nvcc; nothing in the package calls this.
"""

from __future__ import annotations

import ctypes
import functools
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

_BWD_SEND = ("        cluster_send_all(shared_addr(d_cur + (gate * H + j) * R + p),\n"
             "                         row_live ? v[gate] : 0.f, bar, blocks);\n")
_BWD_ARM = "    if (threadIdx.x == 0) mbarrier_expect(bar, (unsigned)(H3 * R) * 4u);\n"
_BWD_WAIT = "    mbarrier_wait(bar, (unsigned)(u >> 1) & 1u);\n"
GRU_BWD_VARIANTS = {
    "base": [],
    # no exchange at all, a block barrier a step: what the exchange costs
    "local stores, block barrier": [
        (_BWD_SEND, "        d_cur[(gate * H + j) * R + p] = row_live ? v[gate] : 0.f;\n"),
        (_BWD_ARM, ""), (_BWD_WAIT, "    __syncthreads();\n")],
    # plain remote stores and the hardware cluster barrier in place of
    # st.async and the mbarrier
    "cluster barrier": [
        (_BWD_SEND,
         "        for (unsigned rank = 0; rank < blocks; ++rank)\n"
         "          cluster.map_shared_rank(d_cur, rank)[(gate * H + j) * R + p] =\n"
         "              row_live ? v[gate] : 0.f;\n"),
        (_BWD_ARM, ""),
        (_BWD_WAIT, '    __syncwarp();\n'
                    '    asm volatile("barrier.cluster.arrive.release;" ::: "memory");\n'
                    '    asm volatile("barrier.cluster.wait.acquire;" ::: "memory");\n')],
    # the product's loop not unrolled
    "k loop not unrolled": [("#pragma unroll 7\n", "#pragma unroll 1\n")],
}

_SPE_IN = "      const bool in = row < rows_pad;\n"
SPECTRAL_VARIANTS = {
    "base": [],
    # the kernels of the reread backward, each left out in turn
    "rows kernel returns at once": [
        ("  float* da = smem;              // [d1][S]\n",
         "  if (row0 >= 0) return;\n  float* da = smem;\n")],
    "wgrad kernel returns at once": [
        ("  if (k0 >= din) return;  // the whole block: layer 0 has fewer k tiles\n",
         "  if (k0 >= 0) return;\n")],
    "dx, bias and reduce kernels return at once": [
        ("  if (e >= total) return;\n  const int w = e % W;\n",
         "  if (e >= 0) return;\n  const int w = e % W;\n"),
        ("  __shared__ float lane_sum[kBiasLanes][33];\n",
         "  __shared__ float lane_sum[kBiasLanes][33];\n  if (blockIdx.x >= 0) return;\n"),
        ("  if (i >= total || is_bias_slot(i, d0, d1)) return;\n",
         "  if (i >= 0) return;\n")],
    # the rows kernel's row tile: 32 or 40 rows (4 or 5 row groups)
    "rows tile of 32": [
        ("constexpr int kBR = 24; ", "constexpr int kBR = 32; "),
        ("constexpr int kBRS = 28; ", "constexpr int kBRS = 36; "),
        ("constexpr int kBMaxThreads = 96; ", "constexpr int kBMaxThreads = 128; ")],
    "rows tile of 40, 2 blocks an SM": [
        ("constexpr int kBR = 24; ", "constexpr int kBR = 40; "),
        ("constexpr int kBRS = 28; ", "constexpr int kBRS = 44; "),
        ("constexpr int kBMaxThreads = 96; ", "constexpr int kBMaxThreads = 160; "),
        ("kMaxThreads == kBMaxThreads ? 3 : 1", "kMaxThreads == kBMaxThreads ? 2 : 1")],
    # the rows kernel's pieces
    "rows: no weight loads": [
        ("      l[j4] = ldg_vec4(wl + (long)cc * dout + c4[j4]);\n"
         "      r[j4] = ldg_vec4(wr + (long)cc * dout + c4[j4]);\n",
         "      const float4 fl = make_float4(cc, j4, 1.f, 2.f), fr = make_float4(j4, cc, 2.f, 1.f);\n"
         "      l[j4] = *reinterpret_cast<const V*>(&fl);\n"
         "      r[j4] = *reinterpret_cast<const V*>(&fr);\n")],
    "rows: no activation reads": [
        ("      load8(da + c * S + r0, a);\n      load8(ds + c * S + r0, s);\n",
         "      for (int i = 0; i < 8; ++i) {\n        a[i] = 1e-3f * (c + i);\n"
         "        s[i] = 2e-3f * (c - i);\n      }\n")],
    # the elementwise pass keeps only its shared-memory stores
    "rows: elementwise without its loads and stores": [
        (_SPE_IN, "      const bool in = false;\n")],
    # the instantiation for ragged shapes (masked runs, a column at a time
    # where a run straddles two windows) at the flagship's, which needs neither
    "rows: the ragged instantiation": [
        ("  const bool ragged = WM % 4 != 0 || d1 / 4 % 2 != 0;\n",
         "  const bool ragged = true;\n")],
    # the weight-gradient kernel's pieces
    "wgrad: no stage loads": [
        ("  if (ch0 < ch1) issue(ch0, 0);\n", ""),
        ("  if (ch0 + 1 < ch1) issue(ch0 + 1, 1);\n", ""),
        ("    if (ch + 2 < ch1) issue(ch + 2, (ch - ch0 + 2) % 3);\n", "")],
    "wgrad: no u = a * s product": [
        ("        if (gi >= 2) {  // u = a * s of the GLU before\n",
         "        if (gi < 0) {  // u = a * s of the GLU before\n")],
}

_FWD_TILE = "  const int tile = chain_tile(rows_pad, sms, d1);\n"
SPECTRAL_FWD_VARIANTS = {
    "base": [],
    # the chain forward's pieces, each left out in turn
    "fwd: no weight loads": [
        ("    l = ldg_vec4(pl + kk * dout);\n    r = ldg_vec4(pr + kk * dout);\n",
         "    const float4 fl = make_float4(kk, c, 1.f, 2.f), fr = make_float4(c, kk, 2.f, 1.f);\n"
         "    l = *reinterpret_cast<const V*>(&fl);\n    r = *reinterpret_cast<const V*>(&fr);\n")],
    "fwd: no activation reads": [
        ("      load8(in + k * S + r0, x);\n",
         "      for (int i = 0; i < 8; ++i) x[i] = 1e-3f * (k + i);\n")],
    "fwd: no saved writes": [
        ("      if (row < rows_pad) {\n        *reinterpret_cast<float4*>(ga + row * d1",
         "      if (row < 0) {\n        *reinterpret_cast<float4*>(ga + row * d1")],
    "fwd: no inverse DFT sums": [
        ("      idft_fwd_run<T, kRagged>(re, im, S, ci, si, WM, q0, cc, acc);\n",
         "      for (int i = 0; i < 8; ++i)\n        for (int q = 0; q < 4; ++q) "
         "acc[i][q] = re[q] + im[i];\n")],
    "fwd: no join (cluster barriers, copy, inverse DFT)": [
        ("  if constexpr (kOut) {\n    cg::cluster_group",
         "  if constexpr (kOut && !kOut) {\n    cg::cluster_group")],
    # blocks of up to 192 threads bounded for two an SM in place of three
    # (more registers a thread)
    "fwd: two blocks an SM": [
        ("__launch_bounds__(kMaxThreads, kMaxThreads == kFMaxThreads ? 3 : 1)\n"
         "spectral_chain_kernel",
         "__launch_bounds__(kMaxThreads, kMaxThreads == kFMaxThreads ? 2 : 1)\n"
         "spectral_chain_kernel")],
    # the weight loads one step of k ahead in place of two (fewer registers)
    "fwd: weights one step ahead": [
        ("constexpr int kFAhead = 2; ", "constexpr int kFAhead = 1; ")],
    # blocks of 193 to 320 threads in the 512-thread instantiation (128
    # registers a thread in place of 168)
    "fwd: no 320-thread instantiation": [
        ("      : threads <= kFMidThreads\n", "      : threads <= 0\n")],
    # the row tile the rule chooses against the others
    "fwd: row tile 24": [(_FWD_TILE, "  const int tile = 24;\n")],
    "fwd: row tile 16": [(_FWD_TILE, "  const int tile = 16;\n")],
    "fwd: row tile 8": [(_FWD_TILE, "  const int tile = 8;\n")],
}

_G_LOOP = "      for (int m = p; m < mp; m += kParts) {"
_G_ONE_ROUND = "      for (int m = p; m < min(mp, kParts); m += kParts) {"
_G_LOADS = [  # the f32 arm's
    ("          copy_panel_async(As, RSA, Lk + m0, N, rows, mr);\n", ""),
    ("            copy_panel_async(Xs + i * XBS, 0, x + ((long)(b0 + i) * N + m0) * W, 0, 1,\n"
     "                             mr * W);\n", "            ;\n")]
GRAPH_VARIANTS = {
    "base": [],
    "one round of the sum": [(_G_LOOP, _G_ONE_ROUND)],
    "no loads": _G_LOADS,
    "no loads, one round of the sum": [(_G_LOOP, _G_ONE_ROUND), *_G_LOADS],
    "every block returns at once": [("  T* As = smem;\n",
                                     "  if (n0 >= 0) return;\n  T* As = smem;\n")],
}


_MMA_EPILOGUE = "    rows_mma_epilogue<MT, NT>(acc, n0, d1, S, row0, rows_pad, ld, acts + (2 * gi) * plane,\n"
SPECTRAL_MMA_VARIANTS = {
    "base": [],
    # the products alone: the epilogue (a, s read; da, ds, u and the bias
    # partials written) left out, the products run on the shared buffers as
    # they stand
    "mma rows: no epilogue": [(_MMA_EPILOGUE, (
        "    {  // the products' sums kept alive\n      float t = 0.f;\n#pragma unroll\n"
        "      for (int i = 0; i < MT; ++i)\n#pragma unroll\n        for (int j = 0; j < NT; ++j)\n"
        "          t += acc[i][j][0] + acc[i][j][1] + acc[i][j][2] + acc[i][j][3];\n"
        "      if (t == 1.2345f) da[threadIdx.x] = zero;\n    }\n"
        "    if (gi < 0) " + _MMA_EPILOGUE.lstrip()))],
    # the products' B fragments made in registers in place of their L2 loads
    "mma rows: no weight loads": [(
        "      b[nt] = n < nn && k < kin ? __ldg(reinterpret_cast<const uint2*>(w + (long)n * kin + k))\n",
        "      b[nt] = n < nn && k < kin ? make_uint2(n, k)\n")],
    "mma rows kernel returns at once": [
        ("  bf16* da = reinterpret_cast<bf16*>(smem);  // [TM][S]: the cotangent tile, then da\n",
         "  if (blockIdx.x >= 0) return;\n  bf16* da = reinterpret_cast<bf16*>(smem);\n")],
    "mma wgrad kernel returns at once": [
        ("  if (k0 >= din) return;  // the whole block: layer 0 has fewer k tiles\n"
         "  const long rows = (long)B * N;\n  const bf16* u_src",
         "  if (k0 >= 0) return;\n  const long rows = (long)B * N;\n  const bf16* u_src")],
}


_FMMA_SAVE = ("              if (row < rows_pad) {\n"
              "                __stcs(reinterpret_cast<float2*>(ga + row * d1 + col)")
SPECTRAL_FWD_MMA_VARIANTS = {
    "base": [],
    # the saving forward's a, s stores (51.6 MB at the flagship)
    "mma fwd: no a, s stores": [(_FMMA_SAVE, _FMMA_SAVE.replace("row < rows_pad", "row < 0"))],
    # the join: cluster barriers, the copy of the other chain's buffer and the
    # inverse DFT (the serving output is then not written)
    "mma fwd: no join": [
        ("  if constexpr (kOut) {\n    // GLU 2's output is in buf1 of both blocks",
         "  if constexpr (kOut && !kOut) {\n    // GLU 2's output is in buf1 of both blocks")],
    # the inverse DFT's products (the join's copy and the output stores kept)
    "mma fwd: no inverse DFT products": [
        ("      idft_fwd_mma<MT, kFIdftNT>(re, im, S, ci, si, WM, d1, 8 * tt, acc);\n",
         "      for (int i = 0; i < MT; ++i)\n        for (int j = 0; j < kFIdftNT; ++j)\n"
         "          for (int e = 0; e < 4; ++e) acc[i][j][e] = __bfloat162float(re[16 * i + j + e]);\n")],
    # the inverse DFT's B fragments made in registers, not loaded
    "mma fwd: inverse DFT B without loads": [
        ("            v[q] = j >= 0 && j < WM ? __bfloat16_as_ushort(blk[off[nt] + j]) : 0u;\n",
         "            v[q] = j >= 0 && j < WM ? (unsigned)(off[nt] + j) & 0x3f00u : 0u;\n")],
    # the a, s stores as plain stores (not streaming, evict-first ones)
    "mma fwd: a, s stores st.global": [
        ("                __stcs(reinterpret_cast<float2*>(ga + row * d1 + col), make_float2(a0, a1));\n"
         "                __stcs(reinterpret_cast<float2*>(gs + row * d1 + col), make_float2(s0, s1));\n",
         "                *reinterpret_cast<float2*>(ga + row * d1 + col) = make_float2(a0, a1);\n"
         "                *reinterpret_cast<float2*>(gs + row * d1 + col) = make_float2(s0, s1);\n")],
    # the weight panels' copies (the products read the stages as they stand)
    "mma fwd: no weight staging": [
        ("          if (vec16) cp_async16(d, src);\n          else cp_async8(d, src);\n",
         "          (void)src;\n")],
    # the GLUs' fragment loads and mma.sync (the panel stream, its barriers
    # and the epilogues kept)
    "mma fwd: no products": [
        ("        if (busy) {\n          const bf16* pl = panels",
         "        if (busy && !busy) {\n          const bf16* pl = panels")],
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
    """{variant: loaded library}, every nvcc started together, in a directory
    of its own: a library path loaded once in the process is not loaded again."""
    text = (_build.CSRC / source).read_text()
    tmp = Path(tempfile.mkdtemp(dir=tmp))
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
    card = cuda_gru.card_limits(dev)
    for name, lib in _build_variants("gru.cu", GRU_VARIANTS, tmp).items():
        fn = lib.gru_fwd_cluster
        fn.argtypes = cuda_gru._ARGTYPES["gru_fwd_cluster"]
        fn.restype = ctypes.c_int
        for label, plan in plans.items():
            if name != "base" and plan != cuda_gru.launch_plan(b, h, *card):
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

    # the widest model (H = 512): the grid route it takes against a cluster
    # of 16 blocks, above the portable limit of 8, which the kernel asks for
    # with cudaFuncAttributeNonPortableClusterSizeAllowed
    b, h = 32, 512
    args = _gru_inputs(b, h, dev)
    with torch.no_grad():
        grid, _ = cuda_gru._launch_fwd(*args, False)
        ms = _cuda_ms(lambda: cuda_gru._launch_fwd(*args, False), calls=2, replays=3)
        print(f"gru forward B={b} H={h}, grid: serving {ms:.5f} ms")
        plan = cuda_gru.launch_plan(b, h, *card, max_cluster=16)
        try:
            wide, _ = cuda_gru._launch_fwd(*args, False, plan)
            torch.cuda.synchronize()
        except RuntimeError as exc:
            print(f"gru forward B={b} H={h}, cluster of {plan.cluster}: refused ({exc})")
            return
        err = (wide - grid).abs().max().item()
        ms = _cuda_ms(lambda: cuda_gru._launch_fwd(*args, False, plan))
        print(f"gru forward B={b} H={h}, cluster of {plan.cluster} (slice {plan.slice}, "
              f"{plan.smem} B): serving {ms:.5f} ms ({ms / h * 1e3:.3f} us a step), "
              f"max_abs_err against the grid {err:.3e}")


def gru_bwd(dev, tmp: Path) -> None:
    """The cluster backward at the flagship shape, by variant and by cluster
    size."""
    from stemgnn_tpu_torch.ops import torch_impl

    b, h = 32, 140
    rng = np.random.default_rng(1)
    x_proj, a_all, b_hh = _gru_inputs(b, h, dev)
    g = torch.from_numpy(rng.standard_normal((b, h, h)).astype(np.float32)).to(dev)
    with torch.no_grad():
        _, saved = torch_impl.gru_scan(x_proj, a_all, b_hh, save=True)
    dxp = torch.empty((h, b, 3 * h), device=dev)
    plans = {f"cluster of {c}": cuda_gru._bwd_cluster_plan(b, h, c) for c in (5, 7, 8)}
    card = cuda_gru.card_limits(dev)
    for name, lib in _build_variants("gru.cu", GRU_BWD_VARIANTS, tmp).items():
        fn = lib.gru_bwd_cluster
        fn.argtypes = cuda_gru._ARGTYPES["gru_bwd_cluster"]
        fn.restype = ctypes.c_int
        for label, plan in plans.items():
            if name != "base" and plan != cuda_gru.bwd_plan(b, h, *card):
                continue  # the other cluster sizes: the source as it is only

            def call(plan=plan):
                _build.check(fn(
                    saved.data_ptr(), g.data_ptr(), a_all.data_ptr(), dxp.data_ptr(), h,
                    b, h, plan.rows, plan.groups, plan.cluster, plan.slice,
                    plan.row_stride, plan.threads, plan.smem, _build.stream_ptr(dxp)),
                    name)

            ms = _cuda_ms(call)
            print(f"gru_bwd_cluster B={b} H={h}, {label} ({plan.threads} threads, "
                  f"{plan.smem} B), {name}: {ms:.5f} ms ({ms / h * 1e3:.3f} us a step)")


# the grid GRU kernels (both directions), each with one piece left out
GRU_GRID_VARIANTS = {
    "base": [],
    # the flag round trip: no block waits for the others' arrivals
    "no wait for the step": [
        ("    if (t > 0) grid_wait(counter, P * t); else __syncthreads();\n",
         "    __syncthreads();\n"),
        ("    grid_wait(counter, P * (u + 1));\n", "    __syncthreads();\n")],
    # a fence before the release add (the add is a release already)
    "a fence before the arrival": [("  if (threadIdx.x == 0)\n    asm volatile(\"red.release",
                                    "  if (threadIdx.x == 0) __threadfence();\n"
                                    "  if (threadIdx.x == 0)\n    asm volatile(\"red.release")],
    # the copy of a step's exchanged values into shared memory
    "no staging": [("      stage_rows(hs, hcur + c0 * Bp, c1 - c0, Bp);\n", ""),
                   ("      stage_rows(dsb, dcur + c0 * Bp, c1 - c0, Bp);\n", "")],
    # the product over the staged values
    "no product": [("      for (int task = warp; task < tasks; task += warps) {\n",
                    "      for (int task = warp; task < 0; task += warps) {\n")],
}


def gru_grid(dev, tmp: Path) -> None:
    """The grid GRU forward (saving) and backward by variant at B = 32,
    H = N = 512 and B = 8, H = N = 1024."""
    from stemgnn_tpu_torch.ops import torch_impl

    shapes = []
    for b, h in ((32, 512), (8, 1024)):
        x_proj, a_all, b_hh = _gru_inputs(b, h, dev)
        g = torch.from_numpy(np.random.default_rng(2).standard_normal((b, h, h)).astype(
            np.float32)).to(dev)
        with torch.no_grad():
            _, saved = torch_impl.gru_scan(x_proj, a_all, b_hh, save=True)
        card = cuda_gru.card_limits(dev)
        shapes.append((b, h, x_proj, a_all, b_hh, saved, g, cuda_gru.grid_plan(b, h, *card),
                       cuda_gru.grid_plan(b, h, *card, backward=True)))
    for name, lib in _build_variants("gru.cu", GRU_GRID_VARIANTS, tmp).items():
        fwd, bwd = lib.gru_fwd_grid, lib.gru_bwd_grid
        fwd.argtypes, bwd.argtypes = (cuda_gru._ARGTYPES["gru_fwd_grid"],
                                      cuda_gru._ARGTYPES["gru_bwd_grid"])
        fwd.restype = bwd.restype = ctypes.c_int
        for b, h, x_proj, a_all, b_hh, saved, g, pf, pb in shapes:
            out = torch.empty((b, h, h), device=dev)
            sv = torch.empty_like(saved)
            dxp = torch.empty_like(x_proj)
            wsf = torch.empty(pf.workspace // 4, device=dev)
            wsb = torch.empty(pb.workspace // 4, device=dev)

            def call_fwd():
                _build.check(fwd(x_proj.data_ptr(), a_all.data_ptr(), b_hh.data_ptr(),
                                 out.data_ptr(), sv.data_ptr(), wsf.data_ptr(), h, b, h,
                                 pf.cluster, pf.slice, pf.ksplit, pf.row_stride, pf.threads,
                                 pf.smem, pf.resident, pf.chunk, _build.stream_ptr(out)), name)

            def call_bwd():
                _build.check(bwd(saved.data_ptr(), g.data_ptr(), a_all.data_ptr(),
                                 dxp.data_ptr(), wsb.data_ptr(), h, b, h, pb.cluster, pb.slice,
                                 pb.ksplit, pb.row_stride, pb.threads, pb.smem, pb.resident,
                                 pb.chunk, _build.stream_ptr(dxp)), name)

            f = _cuda_ms(call_fwd, calls=2, replays=3)
            bw = _cuda_ms(call_bwd, calls=2, replays=3)
            print(f"gru grid B={b} H=N={h} ({pf.cluster} blocks of {pf.slice} units, "
                  f"chunks {-(-h // pf.chunk)} / {-(-3 * h // pb.chunk)}), {name}: saving "
                  f"forward {f:.5f} ms ({f / h * 1e3:.3f} us a step), backward {bw:.5f} ms "
                  f"({bw / h * 1e3:.3f} us a step)")


def spectral(dev, tmp: Path) -> None:
    """The spectral reread backward (one C entry, all its kernels) by variant,
    at the flagship shapes, on the first stack's GLU weights of init_params(0)
    and the saved activations of the saving forward."""
    from stemgnn_tpu_torch.config import TrainConfig
    from stemgnn_tpu_torch.models import init_params
    from stemgnn_tpu_torch.ops import cuda_spectral

    b, k, n, w, multi = 32, 4, 140, 12, 5
    wm = w * multi
    mcfg = TrainConfig(dataset="ECG_data").model_config(n)
    glu = init_params(0, mcfg, device=dev)["blocks"][0]["glu"]
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((b, k, n, w)).astype(np.float32)).to(dev)
    g = torch.from_numpy(
        (1e-3 * rng.standard_normal((b, k, n, wm))).astype(np.float32)).to(dev)
    cf, sf, ci, si = cuda_spectral._dft_on(w, k, wm, dev)
    weights = cuda_spectral.folded_weights(glu, cf, sf)
    with torch.no_grad():
        _, acts = cuda_spectral._launch_fwd(x, weights, ci, si, multi, save=True)
    ptrs = (ctypes.c_void_p * 24)(*[t.data_ptr() for t in weights])
    dx = torch.empty_like(x)
    grads = torch.empty(cuda_spectral._fn("spectral_bwd_grad_floats")(k, w, wm),
                        device=dev)
    ws = torch.empty(cuda_spectral._fn("spectral_bwd_reread_workspace_floats")(
        b, k, n, w, wm, cuda_spectral.N_SPLIT), device=dev)
    for name, lib in _build_variants("spectral.cu", SPECTRAL_VARIANTS, tmp).items():
        fn = lib.spectral_bwd_reread
        fn.argtypes, fn.restype = cuda_spectral._SIGNATURES["spectral_bwd_reread"]

        def call():
            _build.check(fn(x.data_ptr(), g.data_ptr(), ptrs, ci.data_ptr(), si.data_ptr(),
                            acts.data_ptr(), dx.data_ptr(), grads.data_ptr(),
                            ws.data_ptr(), b, k, n, w, wm, cuda_spectral.N_SPLIT,
                            _build.stream_ptr(x)), name)

        print(f"spectral_bwd_reread B={b} K={k} N={n} W={w} multi={multi}, {name}: "
              f"{_cuda_ms(call):.5f} ms")


def _spectral_inputs(b, n, w, multi, dev, seed):
    """x [B, 4, N, W], the 24 folded GLU tensors of init_params(0) at that
    window and multiplier, and one block of the inverse DFT, on the card."""
    from stemgnn_tpu_torch.config import StemGNNConfig
    from stemgnn_tpu_torch.models import init_params
    from stemgnn_tpu_torch.ops import cuda_spectral

    k, wm = 4, w * multi
    cfg = StemGNNConfig(units=n, window_size=w, horizon=3, multi_layer=multi)
    glu = init_params(0, cfg, device=dev)["blocks"][0]["glu"]
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, k, n, w)).astype(np.float32)).to(dev)
    cf, sf, ci, si = cuda_spectral._dft_on(w, k, wm, dev)
    return x, cuda_spectral.folded_weights(glu, cf, sf), ci, si


def _spectral_fwd_calls(lib, x, weights, ci, si, multi):
    """(serving call, saving call) of a library's two forward entries, each
    into buffers made here; the calls return (out, acts or None)."""
    from stemgnn_tpu_torch.ops import cuda_spectral

    b, k, n, w = x.shape
    wm = w * multi
    ptrs = (ctypes.c_void_p * 24)(*[t.data_ptr() for t in weights])
    out = torch.empty((b, k, n, wm), device=x.device)
    acts = torch.empty(lib.spectral_act_floats(b, k, n, wm), device=x.device)
    fwd, save = lib.spectral_fwd, lib.spectral_fwd_save
    fwd.argtypes, fwd.restype = cuda_spectral._SIGNATURES["spectral_fwd"]
    save.argtypes, save.restype = cuda_spectral._SIGNATURES["spectral_fwd_save"]
    # the forwards take a workspace pointer since the wide chain kernel (at
    # these shapes null); a library from before it takes none
    ws = (None,) if hasattr(lib, "spectral_fwd_workspace_floats") else ()
    if not ws:
        fwd.argtypes = fwd.argtypes[:5] + fwd.argtypes[6:]
        save.argtypes = save.argtypes[:6] + save.argtypes[7:]

    def serve():
        _build.check(fwd(x.data_ptr(), ptrs, ci.data_ptr(), si.data_ptr(), out.data_ptr(),
                         *ws, b, k, n, w, wm, _build.stream_ptr(x)), "spectral_fwd")
        return out, None

    def saving():
        _build.check(save(x.data_ptr(), ptrs, ci.data_ptr(), si.data_ptr(), out.data_ptr(),
                          acts.data_ptr(), *ws, b, k, n, w, wm, _build.stream_ptr(x)),
                     "spectral_fwd_save")
        return out, acts.view(12, -1, k * wm)

    return serve, saving


SPECTRAL_FWD_SHAPES = {"flagship": (32, 140, 12, 5), "COVID-19": (32, 25, 28, 5)}


def spectral_fwd(dev, tmp: Path) -> None:
    """The spectral serving and saving forwards by variant, at the flagship
    and COVID-19 shapes."""
    shapes = {name: _spectral_inputs(b, n, w, m, dev, 5) + (m,)
              for name, (b, n, w, m) in SPECTRAL_FWD_SHAPES.items()}
    for name, lib in _build_variants("spectral.cu", SPECTRAL_FWD_VARIANTS, tmp).items():
        lib.spectral_act_floats.argtypes = [ctypes.c_int] * 4
        lib.spectral_act_floats.restype = ctypes.c_longlong
        for shape, (x, weights, ci, si, m) in shapes.items():
            serve, saving = _spectral_fwd_calls(lib, x, weights, ci, si, m)
            print(f"spectral forward {shape} {tuple(x.shape)} multi={m}, {name}: serving "
                  f"{_cuda_ms(serve):.5f} ms, saving {_cuda_ms(saving):.5f} ms")


def _spectral_bwd_calls(lib, x, g, weights, ci, si, multi, acts):
    """(reread call, recompute call) of a library's two f32 backward entries,
    each into buffers made here; the calls return (dx, the flat gradients)."""
    from stemgnn_tpu_torch.ops import cuda_spectral

    b, k, n, w = x.shape
    wm = w * multi
    ptrs = (ctypes.c_void_p * 24)(*[t.data_ptr() for t in weights])
    dx = torch.empty_like(x)
    grads = torch.empty(cuda_spectral._fn("spectral_bwd_grad_floats")(k, w, wm), device=x.device)
    ws = torch.empty(cuda_spectral._fn("spectral_bwd_workspace_floats")(
        b, k, n, w, wm, cuda_spectral.N_SPLIT), device=x.device)
    head = (x.data_ptr(), g.data_ptr(), ptrs, ci.data_ptr(), si.data_ptr())
    tail = (dx.data_ptr(), grads.data_ptr(), ws.data_ptr(), b, k, n, w, wm,
            cuda_spectral.N_SPLIT)
    calls = []
    for name in ("spectral_bwd_reread", "spectral_bwd"):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = cuda_spectral._SIGNATURES[name]
        extra = (acts.data_ptr(),) if name == "spectral_bwd_reread" else ()

        # the buffers are held by the call, the stream is the one current at it
        def call(fn=fn, extra=extra, name=name, held=(ws, acts)):
            _build.check(fn(*head, *extra, *tail, _build.stream_ptr(x)), name)
            return dx, grads

        calls.append(call)
    return calls


def _bf16_operands(x, weights, ci, si):
    """The bf16 arm's operands from the f32 ones: x, the 2-D weights, ci, si."""
    from stemgnn_tpu_torch.ops import cuda_spectral

    bf = torch.bfloat16
    return (x.to(bf), [cuda_spectral._aligned(t.to(bf)) if i % 2 == 0 else t
                       for i, t in enumerate(weights)], ci.to(bf), si.to(bf))


def _bf16_reread_call(lib, x, g, weights, ci, si, multi, acts, plan=None):
    """The bf16 reread C entry of a library, into buffers made here: this
    tree's (g f32, the tile plan `plan`, by default `bwd_mma_plan`'s), or an
    earlier tree's (g bf16, no plan: found by its workspace function)."""
    from stemgnn_tpu_torch.ops import cuda_spectral

    b, k, n, w = x.shape
    wm = w * multi
    fn = lib.spectral_bwd_reread_bf16
    ptrs = (ctypes.c_void_p * 24)(*[t.data_ptr() for t in weights])
    dx = torch.empty(x.shape, device=x.device)
    grads = torch.empty(cuda_spectral._fn("spectral_bwd_grad_floats")(k, w, wm), device=x.device)
    if hasattr(lib, "spectral_bwd_reread_bf16_workspace_floats"):
        plan = plan or cuda_spectral.bwd_mma_plan(b, k, n, w, wm, cuda_spectral._sms(x.device))
        size = lib.spectral_bwd_reread_bf16_workspace_floats
        size.argtypes, size.restype = [ctypes.c_int] * 7, ctypes.c_longlong
        ws = torch.empty(size(b, k, n, w, wm, plan.nsplit, plan.tile_rows), device=x.device)
        fn.argtypes, fn.restype = cuda_spectral._SIGNATURES["spectral_bwd_reread_bf16"]
        gk, tail = g, (plan.nsplit, plan.tile_rows, plan.n_tiles)
    else:
        size = lib.spectral_bwd_reread_workspace_floats
        size.argtypes, size.restype = [ctypes.c_int] * 6, ctypes.c_longlong
        ws = torch.empty(size(b, k, n, w, wm, cuda_spectral.N_SPLIT), device=x.device)
        fn.argtypes = cuda_spectral._SIGNATURES["spectral_bwd_reread_bf16"][0][:15] + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        gk, tail = g.to(torch.bfloat16), (cuda_spectral.N_SPLIT,)

    def call(held=(ws, gk)):
        _build.check(fn(x.data_ptr(), gk.data_ptr(), ptrs, ci.data_ptr(), si.data_ptr(),
                        acts.data_ptr(), dx.data_ptr(), grads.data_ptr(), ws.data_ptr(), b, k,
                        n, w, wm, *tail, _build.stream_ptr(x)), "spectral_bwd_reread_bf16")
        return dx, grads

    return call


def spectral_mma(dev, tmp: Path) -> None:
    """The bf16 spectral reread backward (its C entry: the mma rows and
    weight-gradient kernels, dx, reduce and bias) by variant at the flagship
    shapes, on the saving forward's arrays: what the products cost without
    their epilogue, and each mma kernel's share; then the source as it is at
    other row tiles and row segments than the plan's."""
    from stemgnn_tpu_torch.ops import cuda_spectral

    b, n, w, m = 32, 140, 12, 5
    x, weights, ci, si = _bf16_operands(*_spectral_inputs(b, n, w, m, dev, 2))
    g = 1e-3 * torch.from_numpy(np.random.default_rng(3).standard_normal(
        (b, 4, n, w * m)).astype(np.float32)).to(dev)
    with torch.no_grad():
        _, acts = cuda_spectral._launch_fwd(x, weights, ci, si, m, save=True)
    libs = _build_variants("spectral.cu", SPECTRAL_MMA_VARIANTS, tmp)
    for name, lib in libs.items():
        call = _bf16_reread_call(lib, x, g, weights, ci, si, m, acts)
        print(f"spectral_bwd_reread_bf16 B={b} N={n} W={w} multi={m}, {name}: "
              f"{_cuda_ms(call):.5f} ms")
    plan = cuda_spectral.bwd_mma_plan(b, 4, n, w, w * m, cuda_spectral._sms(dev))
    for tile_rows, nsplit in ((plan.tile_rows, plan.nsplit), (80, 6), (80, 18), (32, 12),
                              (16, 12), (plan.tile_rows, plan.nsplit)):
        other = plan._replace(tile_rows=tile_rows, nsplit=nsplit)
        call = _bf16_reread_call(libs["base"], x, g, weights, ci, si, m, acts, other)
        print(f"spectral_bwd_reread_bf16 B={b} N={n} W={w} multi={m}, base, row tile "
              f"{tile_rows}, {nsplit} row segments (the plan's: {plan.tile_rows}, "
              f"{plan.nsplit}): {_cuda_ms(call):.5f} ms")


def _bf16_fwd_calls(lib, x, weights, ci, si, multi, plan=None):
    """(serving call, saving call) of a library's two bf16 forward entries,
    each into buffers made here: this tree's (the tile plan `plan`, by
    default `fwd_mma_plan`'s), or an earlier tree's (no plan: found by the
    absence of `spectral_fwd_bf16_smem`). The calls return (out, acts or
    None)."""
    from stemgnn_tpu_torch.ops import cuda_spectral

    b, k, n, w = x.shape
    wm = w * multi
    ptrs = (ctypes.c_void_p * 24)(*[t.data_ptr() for t in weights])
    out = torch.empty((b, k, n, wm), device=x.device)
    acts = torch.empty(cuda_spectral._fn("spectral_act_floats")(b, k, n, wm), device=x.device)
    fwd, save = lib.spectral_fwd_bf16, lib.spectral_fwd_save_bf16
    fwd.argtypes, fwd.restype = cuda_spectral._SIGNATURES["spectral_fwd_bf16"]
    save.argtypes, save.restype = cuda_spectral._SIGNATURES["spectral_fwd_save_bf16"]
    if hasattr(lib, "spectral_fwd_bf16_smem"):
        plan = plan or cuda_spectral.fwd_mma_plan(b, k, n, w, wm, cuda_spectral._sms(x.device))
        args = plan.args
    else:
        fwd.argtypes = fwd.argtypes[:11] + fwd.argtypes[16:]
        save.argtypes = save.argtypes[:12] + save.argtypes[17:]
        args = ()

    def serve():
        _build.check(fwd(x.data_ptr(), ptrs, ci.data_ptr(), si.data_ptr(), out.data_ptr(),
                         None, b, k, n, w, wm, *args, _build.stream_ptr(x)),
                     "spectral_fwd_bf16")
        return out, None

    def saving():
        _build.check(save(x.data_ptr(), ptrs, ci.data_ptr(), si.data_ptr(), out.data_ptr(),
                          acts.data_ptr(), None, b, k, n, w, wm, *args, _build.stream_ptr(x)),
                     "spectral_fwd_save_bf16")
        return out, acts.view(12, -1, k * wm)

    return serve, saving


def spectral_fwd_mma(dev, tmp: Path) -> None:
    """The bf16 serving and saving forwards' C entries (the chain on tensor
    cores) by variant at the flagship and COVID-19 shapes: what the a, s
    stores, the join, the inverse DFT, the weight staging and the products
    cost; then the source as it is on other plans than `fwd_mma_plan`'s
    (row tiles, panel rows, stages, threads)."""
    from stemgnn_tpu_torch.ops import cuda_spectral

    shapes = {name: _bf16_operands(*_spectral_inputs(b, n, w, m, dev, 5)) + (m,)
              for name, (b, n, w, m) in SPECTRAL_FWD_SHAPES.items()}
    libs = _build_variants("spectral.cu", SPECTRAL_FWD_MMA_VARIANTS, tmp)
    for name, lib in libs.items():
        for shape, (x, weights, ci, si, m) in shapes.items():
            serve, saving = _bf16_fwd_calls(lib, x, weights, ci, si, m)
            print(f"spectral bf16 forward {shape} {tuple(x.shape)} multi={m}, {name}: serving "
                  f"{_cuda_ms(serve):.5f} ms, saving {_cuda_ms(saving):.5f} ms")
    for shape, (x, weights, ci, si, m) in shapes.items():
        b, k, n, w = x.shape
        plan = cuda_spectral.fwd_mma_plan(b, k, n, w, w * m, cuda_spectral._sms(dev))
        if shape == "flagship":
            others = [plan._replace(panel_k=48), plan._replace(panel_k=32, stages=4),
                      plan._replace(panel_k=32, stages=2), plan._replace(panel_k=16, stages=4),
                      plan._replace(tile_rows=32, n_tiles=4, threads=256, panel_k=32),
                      plan._replace(tile_rows=16, n_tiles=4, threads=256, panel_k=32)]
        else:
            others = [plan._replace(panel_k=16, stages=4),
                      plan._replace(tile_rows=32, panel_k=32),
                      plan._replace(tile_rows=32, threads=512, panel_k=32)]
        for other in [plan, *others, plan]:
            serve, saving = _bf16_fwd_calls(libs["base"], x, weights, ci, si, m, other)
            print(f"spectral bf16 forward {shape}, base, row tile {other.tile_rows}, "
                  f"{other.n_tiles} n8 tiles a warp, {other.threads} threads, "
                  f"{other.stages} stages of {other.panel_k}-row panels (the plan's: "
                  f"{plan.tile_rows}, {plan.n_tiles}, {plan.threads}, {plan.stages} of "
                  f"{plan.panel_k}): serving {_cuda_ms(serve):.5f} ms, saving "
                  f"{_cuda_ms(saving):.5f} ms")


# The bf16-storage arm's a, s stores in the chain kernel on tensor cores: as
# they are (a bf16 pair a word, cached in L2 only), streaming (evict-first),
# and none (what they cost).
_ACTS_STORE = "__stcg(reinterpret_cast<unsigned int*>(ga + row * d1 + col), pack_bf16x2(a0, a1));"
_ACTS_STORE_S = "__stcg(reinterpret_cast<unsigned int*>(gs + row * d1 + col), pack_bf16x2(s0, s1));"
SPECTRAL_ACTS_VARIANTS = {
    "base": [],
    "streaming stores": [(_ACTS_STORE, _ACTS_STORE.replace("__stcg", "__stcs")),
                         (_ACTS_STORE_S, _ACTS_STORE_S.replace("__stcg", "__stcs"))],
    "no stores": [(_ACTS_STORE, ""), (_ACTS_STORE_S, "")],
}


def _bf16_storage_calls(lib, x, g, weights, ci, si, multi):
    """(saving call, reread call) of a library's bf16-storage entries
    (`spectral_fwd_save_bf16acts`, `spectral_bwd_reread_bf16acts`) on the
    plans of `fwd_mma_plan` and `bwd_mma_plan`, into buffers made here; the
    reread reads what one saving call wrote."""
    from stemgnn_tpu_torch.ops import cuda_spectral

    b, k, n, w = x.shape
    wm = w * multi
    fp = cuda_spectral.fwd_mma_plan(b, k, n, w, wm, cuda_spectral._sms(x.device))
    bp = cuda_spectral.bwd_mma_plan(b, k, n, w, wm, cuda_spectral._sms(x.device))
    ptrs = (ctypes.c_void_p * 24)(*[t.data_ptr() for t in weights])
    out = torch.empty((b, k, n, wm), device=x.device)
    acts = torch.empty(cuda_spectral._fn("spectral_act_floats")(b, k, n, wm),
                       dtype=torch.bfloat16, device=x.device)
    dx = torch.empty(x.shape, device=x.device)
    grads = torch.empty(cuda_spectral._fn("spectral_bwd_grad_floats")(k, w, wm), device=x.device)
    ws = torch.empty(cuda_spectral._fn("spectral_bwd_reread_bf16_workspace_floats")(
        b, k, n, w, wm, bp.nsplit, bp.tile_rows), device=x.device)
    save, reread = lib.spectral_fwd_save_bf16acts, lib.spectral_bwd_reread_bf16acts
    save.argtypes, save.restype = cuda_spectral._SIGNATURES["spectral_fwd_save_bf16acts"]
    reread.argtypes, reread.restype = cuda_spectral._SIGNATURES["spectral_bwd_reread_bf16acts"]

    def saving():
        _build.check(save(x.data_ptr(), ptrs, ci.data_ptr(), si.data_ptr(), out.data_ptr(),
                          acts.data_ptr(), None, b, k, n, w, wm, *fp.args,
                          _build.stream_ptr(x)), "spectral_fwd_save_bf16acts")
        return out, acts

    def rereading():
        _build.check(reread(x.data_ptr(), g.data_ptr(), ptrs, ci.data_ptr(), si.data_ptr(),
                            acts.data_ptr(), dx.data_ptr(), grads.data_ptr(), ws.data_ptr(),
                            b, k, n, w, wm, bp.nsplit, bp.tile_rows, bp.n_tiles,
                            _build.stream_ptr(x)), "spectral_bwd_reread_bf16acts")
        return dx, grads

    saving()
    return saving, rereading


def spectral_acts(dev, tmp: Path) -> None:
    """The bf16 saving forward and reread backward (their C entries) with each
    storage of the 12 saved arrays, f32 and bf16, in turns (f32, bf16, bf16,
    f32) at the flagship and COVID-19 shapes; then the bf16 stores of the
    saving forward by variant (SPECTRAL_ACTS_VARIANTS)."""
    shapes = {}
    for name, (b, n, w, m) in SPECTRAL_FWD_SHAPES.items():
        x, weights, ci, si = _bf16_operands(*_spectral_inputs(b, n, w, m, dev, 5))
        g = 1e-3 * torch.from_numpy(np.random.default_rng(6).standard_normal(
            (b, 4, n, w * m)).astype(np.float32)).to(dev)
        shapes[name] = (x, g, weights, ci, si, m)
    libs = _build_variants("spectral.cu", SPECTRAL_ACTS_VARIANTS, tmp)
    for shape, (x, g, weights, ci, si, m) in shapes.items():
        _, save32 = _bf16_fwd_calls(libs["base"], x, weights, ci, si, m)
        acts32 = save32()[1]
        reread32 = _bf16_reread_call(libs["base"], x, g, weights, ci, si, m, acts32)
        save16, reread16 = _bf16_storage_calls(libs["base"], x, g, weights, ci, si, m)
        for label, saving, rereading in (("f32", save32, reread32), ("bf16", save16, reread16),
                                         ("bf16", save16, reread16), ("f32", save32, reread32)):
            print(f"spectral bf16 {shape} {tuple(x.shape)} multi={m}, {label} saved arrays: "
                  f"saving forward {_cuda_ms(saving):.5f} ms, reread backward "
                  f"{_cuda_ms(rereading):.5f} ms")
        for name, lib in libs.items():
            saving, _ = _bf16_storage_calls(lib, x, g, weights, ci, si, m)
            print(f"spectral bf16 {shape}, bf16 saved arrays, {name}: saving forward "
                  f"{_cuda_ms(saving):.5f} ms")


def _build_other(src: Path, tmp: Path) -> ctypes.CDLL:
    so = Path(tempfile.mkdtemp(dir=tmp)) / f"lib{src.stem}_other.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(src.parent), "-o",
                           str(so), str(src)], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"{src}: nvcc failed:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(so))


def spectral_against(dev, tmp: Path, other: Path) -> None:
    """This tree's f32 kernels against another checkout's (its csrc/spectral.cu
    and csrc/graph.cu built on their own): the spectral serving and saving
    forwards (the output and the 12 saved arrays' real rows) and the reread
    and recompute backwards (dx and the flat gradients) at the flagship shape,
    at W = 25 and at the COVID-19 shape, and both arms of the graph conv at
    the flagship's and the COVID-19 shape, every output bitwise equal; and
    both trees' times, in the order other, this, this, other, the bf16
    reread backward's and bf16 forwards' too, their outputs compared (equal
    where both trees run the same bf16 design, else their sums differ)."""
    from stemgnn_tpu_torch.ops import cuda_spectral

    csrc = other / "stemgnn_tpu_torch" / "csrc"
    libs = {"other": _build_other(csrc / "spectral.cu", tmp), "this": _build.library("spectral")}
    for lib in libs.values():
        lib.spectral_act_floats.argtypes = [ctypes.c_int] * 4
        lib.spectral_act_floats.restype = ctypes.c_longlong
    for shape, (b, n, w, m) in {"flagship": (32, 140, 12, 5), "W=25": (5, 37, 25, 5),
                                "COVID-19": (32, 25, 28, 5)}.items():
        x, weights, ci, si = _spectral_inputs(b, n, w, m, dev, 6)
        g = 1e-3 * torch.from_numpy(np.random.default_rng(7).standard_normal(
            (b, 4, n, w * m)).astype(np.float32)).to(dev)
        rows = b * n
        calls = {tree: _spectral_fwd_calls(lib, x, weights, ci, si, m)
                 for tree, lib in libs.items()}
        got = {}
        for tree, (serve, saving) in calls.items():
            out, _ = serve()
            out = out.clone()
            out_s, acts = saving()
            acts = acts.clone()
            reread, recompute = _spectral_bwd_calls(libs[tree], x, g, weights, ci, si, m, acts)
            calls[tree] = (serve, saving, reread, recompute)
            got[tree] = [out, out_s.clone(), acts[:, :rows]]
            got[tree] += [t.clone() for t in reread()] + [t.clone() for t in recompute()]
        torch.cuda.synchronize()
        same = [torch.equal(a, b_) for a, b_ in zip(got["this"], got["other"])]
        times = {tree: [] for tree in libs}
        for tree in ("other", "this", "this", "other"):
            times[tree].append([round(_cuda_ms(c), 5) for c in calls[tree]])
        word = ["bitwise equal" if ok else "DIFFER" for ok in same]
        print(f"spectral {shape} B={b} N={n} W={w} multi={m}: this tree against {other}: "
              f"serving output {word[0]}, saving output {word[1]}, 12 saved arrays "
              f"{word[2]}, reread dx and gradients {word[3]}, {word[4]}, recompute dx and "
              f"gradients {word[5]}, {word[6]}; ms (serving, saving, reread, recompute) in "
              f"the order other, this, this, other: {times['other'][0]}, "
              f"{times['this'][0]}, {times['this'][1]}, {times['other'][1]}")
    # the bf16 reread backward of both trees at the flagship: this tree's on
    # tensor cores, the other's as it was; times only (their sums differ)
    x, weights, ci, si = _bf16_operands(*_spectral_inputs(32, 140, 12, 5, dev, 6))
    g = 1e-3 * torch.from_numpy(np.random.default_rng(7).standard_normal(
        (32, 4, 140, 60)).astype(np.float32)).to(dev)
    with torch.no_grad():
        _, acts = cuda_spectral._launch_fwd(x, weights, ci, si, 5, save=True)
    calls = {tree: _bf16_reread_call(lib, x, g, weights, ci, si, 5, acts)
             for tree, lib in libs.items()}
    outs = {tree: [t.clone() for t in call()] for tree, call in calls.items()}
    same = all(torch.equal(a, b_) for a, b_ in zip(outs["this"], outs["other"]))
    ms = [round(_cuda_ms(calls[tree]), 5) for tree in ("other", "this", "this", "other")]
    print(f"spectral_bwd_reread_bf16 flagship: this tree against {other}: dx and gradients "
          f"{'bitwise equal' if same else 'DIFFER'}; ms in the order other, this, this, "
          f"other: {ms}")
    # and both trees' bf16 forwards' C entries (this tree's chain on tensor
    # cores): times only, as above
    calls = {tree: _bf16_fwd_calls(lib, x, weights, ci, si, 5) for tree, lib in libs.items()}
    for i, entry in enumerate(("spectral_fwd_bf16", "spectral_fwd_save_bf16")):
        outs = {tree: [t.clone() for t in calls[tree][i]() if t is not None] for tree in libs}
        same = all(torch.equal(a, b_) for a, b_ in zip(outs["this"], outs["other"]))
        ms = [round(_cuda_ms(calls[tree][i]), 5) for tree in ("other", "this", "this", "other")]
        print(f"{entry} flagship: this tree against {other}: output"
              f"{' and saved arrays' if i else ''} {'bitwise equal' if same else 'DIFFER'}; ms "
              f"in the order other, this, this, other: {ms}")
    graph_libs = {"other": _build_other(csrc / "graph.cu", tmp),
                  "this": _build.library("graph")}
    # an other tree with this tree's graph.cu takes its operands as this one
    same_graph = (csrc / "graph.cu").read_bytes() == (_build.CSRC / "graph.cu").read_bytes()
    rng = np.random.default_rng(8)
    for shape, (k, n, b, w) in {"flagship": (4, 140, 32, 12), "COVID-19": (4, 25, 32, 28)}.items():
        mul_l = torch.from_numpy((rng.standard_normal((k, n, n)) * 0.1).astype(np.float32)).to(dev)
        x = torch.from_numpy(rng.standard_normal((b, n, w)).astype(np.float32)).to(dev)
        # both arms; the bf16 one of this tree takes the f32 operands and
        # rounds them in its loads, an other's from before that bf16 casts
        for arm, esize in (("", 4), ("_bf16", 2)):
            plan = cuda_graph.launch_plan(k, n, b, w, esize)
            outs, calls = {}, {}
            for tree, lib in graph_libs.items():
                fn = getattr(lib, "cheb_graph_conv_fwd" + arm)
                fn.argtypes, fn.restype = cuda_graph._ARGTYPES, ctypes.c_int
                out = torch.empty((b, k, n, w), device=dev)
                cast = arm and tree == "other" and not same_graph
                a_in, x_in = ((mul_l.to(torch.bfloat16), x.to(torch.bfloat16)) if cast
                              else (mul_l, x))

                def call(fn=fn, out=out, a_in=a_in, x_in=x_in, cast=cast):
                    if cast:  # the other tree's wrapper cast before its launch
                        a_in.copy_(mul_l)
                        x_in.copy_(x)
                    _build.check(fn(a_in.data_ptr(), x_in.data_ptr(), out.data_ptr(), k, n, b,
                                    w, plan.panel, plan.row_stride, plan.batch_stride,
                                    plan.threads, plan.smem, int(plan.vec),
                                    _build.stream_ptr(out)), "cheb_graph_conv_fwd" + arm)
                    return out

                outs[tree], calls[tree] = call().clone(), call
            torch.cuda.synchronize()
            ms = [round(_cuda_ms(calls[tree]), 5) for tree in ("other", "this", "this", "other")]
            if arm and not same_graph:  # the other kernel alone, its operands cast beforehand
                alone = functools.partial(calls["other"], cast=False)
                ms.append(round(_cuda_ms(alone), 5))
            same = torch.equal(outs["this"], outs["other"])
            print(f"cheb_graph_conv_fwd{arm} {shape} K={k} N={n} B={b} W={w}: this tree "
                  f"against {other}: output {'bitwise equal' if same else 'DIFFERS'}; ms "
                  f"(with the other's casts) in the order other, this, this, other"
                  f"{', then the other kernel alone' if arm and not same_graph else ''}: {ms}")


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


def ptxas(csrc: Path, tmp: Path) -> None:
    """Registers, stack frame and spill bytes of every kernel of every source
    in `csrc`, as ptxas reports them (one nvcc a source, all started
    together; names demangled by cu++filt where the toolkit has it)."""
    procs = [(src, subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(csrc), "-o",
         str(Path(tempfile.mkdtemp(dir=tmp)) / f"lib{src.stem}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for src in sorted(csrc.glob("*.cu"))]
    filt = Path(_build._nvcc()).with_name("cu++filt")
    for src, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{src}: nvcc failed:\n{log}")
        kernels, name = {}, None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                name = line.split("'")[1]
                kernels[name] = {}
            elif name and "bytes stack frame" in line:
                kernels[name]["spills"] = line.strip()
            elif name and "Used" in line and "registers" in line:
                kernels[name]["registers"] = line.split("Used")[1].split(",")[0].strip()
        names = list(kernels)
        if filt.exists():
            names = subprocess.run([str(filt)], input="\n".join(names), capture_output=True,
                                   text=True).stdout.splitlines()
        for shown, info in zip(names, kernels.values()):
            print(f"ptxas {src.name}: {shown[:150]}: {info.get('registers', '?')}; "
                  f"{info.get('spills', 'no stack frame')}")


def main(argv=None) -> int:
    which = ((argv if argv is not None else sys.argv[1:])
             or ["gru", "gru_bwd", "spectral", "spectral_fwd", "graph"])
    if not torch.cuda.is_available():
        print("kernel_variants: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_info()
    print(f"{card['device']}, {card['power_limit']}")
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        for name in which:
            if name.startswith("against="):
                spectral_against(dev, Path(tmp), Path(name.split("=", 1)[1]).resolve())
                continue
            if name.startswith("ptxas"):
                other = name.partition("=")[2]
                ptxas(Path(other).resolve() / "stemgnn_tpu_torch" / "csrc" if other
                      else _build.CSRC, Path(tmp))
                continue
            {"gru": gru, "gru_bwd": gru_bwd, "gru_grid": gru_grid, "spectral": spectral,
             "spectral_fwd": spectral_fwd, "spectral_mma": spectral_mma,
             "spectral_fwd_mma": spectral_fwd_mma, "spectral_acts": spectral_acts,
             "graph": graph}[name](dev, Path(tmp))
    return 0


if __name__ == "__main__":
    sys.exit(main())
