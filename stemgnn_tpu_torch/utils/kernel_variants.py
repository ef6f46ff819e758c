"""Where a kernel's time goes: builds copies of a CUDA source with one piece
taken out or changed, and times each beside the source as it is.

    python -m stemgnn_tpu_torch.utils.kernel_variants [gru] [gru_bwd] [gru_grid]
        [spectral] [spectral_fwd] [spectral_mma] [spectral_fwd_mma] [spectral_acts]
        [graph] [attention] [against=CHECKOUT] [ptxas] [ptxas=CHECKOUT]

A variant is a list of (text, replacement) pairs applied to the source; a
pair whose text is no longer in the source stops the run, so an edit to a
kernel shows up here. Most variants compute WRONG results by design (an
exchange or a load left out): only their times mean anything, and the difference to
`base` is what the piece costs. Shapes are the ECG flagship's (B = 32,
H = N = 140, W = 12, K = 4); `gru_grid` times the grid GRU kernels at
B = 32, H = N = 512 and B = 8, H = N = 1024; `spectral_fwd` also times the COVID-19 shape
(B = 32, N = 25, W = 28, multi 5); `spectral_mma` the bf16 reread backward
on Hopper's route with one piece left out (products, weight items, saved
a, s loads, cotangent loads, transposed stores, dx sum, wgmma, cluster sums,
a kernel), its phases' timeline, each kernel's time and other plans;
`spectral_fwd_mma` the
bf16 forwards' chain on tensor cores at both shapes, its a, s stores, join,
inverse DFT, weight staging or products left out, and other plans;
`spectral_acts` the bf16 saving forward and reread backward with each storage
of the saved arrays (f32, bf16) at both shapes, and the bf16 stores by variant.
`attention` times the attention forward and backward at the flagship and at
B = 32, N = 512 with one piece left out (the query held in registers, the
16-byte accesses, the key loads, the cluster's sums and its start barrier)
and on other plans (rows a warp, warps a block, blocks a cluster). `graph`
times the f32 graph conv at the flagship with a piece left out, and the bf16
arm on the tensor cores (`cheb_graph_conv_mma_kernel`) at the flagship,
COVID-19 and synthetic-1k shapes (whole, and its row blocks on 'graph' 2
and 4) with a piece left out (loads of x, of L, all staging, products, the
split sum's exchange, the epilogue) and on other plans than `mma_plan`'s
(row tiles, segments), beside torch.mm on bf16 operands cast beforehand and
with its two casts in the call.
`against=CHECKOUT`
builds the spectral and graph sources of another checkout (a `git archive` of
an earlier commit) and holds this tree's f32 spectral entries (forwards and
backwards) and the f32 graph conv bitwise against it, at the flagship and
COVID-19 shapes (the graph conv at synthetic-1k's shapes too), and times
both trees' bf16 reread backwards (both storage arms), bf16 recompute, bf16
forwards (the bf16-storage saving forward too) and bf16 graph conv (each
tree's C entry on its own tree's plan, its ops/cuda_graph.py; an earlier
bf16 arm fed the casts its wrapper made where it took bf16 operands), their
outputs compared; it also builds the other checkout's csrc/attention.cu and
times both trees' attention forward and backward in turns at the flagship
and at B = 32, N = 512, their outputs compared. Times are
device milliseconds of one call, replays of a CUDA graph of 20 calls, with the
card's name and power limit on the first line. `ptxas` (or `ptxas=CHECKOUT`
for another checkout's sources) compiles each kernel source with
`-Xptxas -v` and prints every kernel's registers, stack and spills. Needs a
card and nvcc; nothing in the package calls this.
"""

from __future__ import annotations

import ctypes
import importlib.util
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from stemgnn_tpu_torch.device import card_info
from stemgnn_tpu_torch.ops import _build, cuda_attention, cuda_graph, cuda_gru

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
        ("      if (row < rows_pad) {\n        if constexpr (std::is_same<TA, float>::value) {\n"
         "          *reinterpret_cast<float4*>(ga + row * d1",
         "      if (row < 0) {\n        if constexpr (std::is_same<TA, float>::value) {\n"
         "          *reinterpret_cast<float4*>(ga + row * d1")],
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
    ("        copy_panel_async(As, RSA, Lk + m0, N, rows, mr);\n", ""),
    ("          copy_panel_async(Xs + i * XBS, 0, x + ((long)(b0 + i) * N + m0) * W, 0, 1,\n"
     "                           mr * W);\n", "          ;\n")]
GRAPH_VARIANTS = {
    "base": [],
    "one round of the sum": [(_G_LOOP, _G_ONE_ROUND)],
    "no loads": _G_LOADS,
    "no loads, one round of the sum": [(_G_LOOP, _G_ONE_ROUND), *_G_LOADS],
    "every block returns at once": [("  T* As = smem;\n",
                                     "  if (n0 >= 0) return;\n  T* As = smem;\n")],
}

# The bf16 arm on the tensor cores (csrc/graph.cu `cheb_graph_conv_mma_kernel`)
# with one piece left out at a time: its staging (the loads of L, of x, and
# their rounding into the bf16 stages), the products, the split sum's
# exchange (the bulk copies of the partials' slices between the cluster's
# blocks and the wait for them; the cluster barriers stay) and the
# epilogue's sums and stores.
_GM_LOADS = [("    load(c_lo);\n", "    for (int i = 0; i < 8; ++i) lreg[i] = 0.f;\n"
                                     "    for (int i = 0; i < 16; ++i) xreg[i] = 0.f;\n"),
             ("      if (c + 1 < c_hi) load(c + 1);  // in flight while this chunk is multiplied\n",
              "")]
GRAPH_MMA_VARIANTS = {
    "base": [],
    "no loads of x": [("            v = __ldg(reinterpret_cast<const float4*>(xc0 + xg[s]));\n",
                       "            v.x = (float)xg[s];\n")],
    "no loads of L": [("            v = __ldg(reinterpret_cast<const float4*>(Lk + (long)r * N + m0 + lc));\n",
                       "            v.x = (float)r;\n")],
    "no loads": _GM_LOADS,
    "no staging (loads, rounding)": [
        *_GM_LOADS, ("    store(0);\n", ""), ("      if (c + 1 < c_hi) store(st ^ 1);\n", "")],
    "no products": [("      products(st);\n", "")],
    "no exchange (bulk copies, their wait)": [
        ("      for (int q = 0; q < C; ++q)\n        bulk_to_cluster(", "      for (int q = 0; q < 0; ++q)\n        bulk_to_cluster("),
        ("    mbar_wait(bar, 0);  // every rank's slice has landed (traps if one never does)\n", "")],
    "no epilogue sums or stores": [("  if (ob < tb && ow < tw) {\n", "  if (ob < 0) {\n")],
    "every block returns at once": [
        ("  cg::cluster_group cluster = cg::this_cluster();\n",
         "  if (K > 0) return;\n  cg::cluster_group cluster = cg::this_cluster();\n")],
}
# (K, N, B, W, M) of the bf16 arm's shapes: the ECG flagship, COVID-19,
# synthetic-1k's row blocks on 'graph' 2 and 4, and synthetic-1k whole
GRAPH_SHAPES = {"flagship": (4, 140, 32, 12, 140), "COVID-19": (4, 25, 32, 28, 25),
                "synthetic-1k (1, 2) block": (4, 1024, 8, 12, 512),
                "synthetic-1k (1, 4) block": (4, 1024, 8, 12, 256),
                "synthetic-1k": (4, 1024, 8, 12, 1024)}


# The bf16 backward on Hopper (csrc/spectral.cu `bwd_tc_launch`: the pack,
# rows and weight-gradient kernels) with one piece left out at a time.
_TC_MMA = "              if (mt < nmt) mma_bf16(acc[mt][t], a[mt], b.x, b.y);\n"
_TC_ITEM = [("          mbar_expect(full + slot, item_bytes);\n",
             "          mbar_expect(full + slot, 16u);\n"),
            ("item_bytes,\n                    full + slot);", "16u,\n                    "
             "full + slot);")]
_TC_ACTS = "          if (r < rows_pad) {\n            const unsigned bytes = (unsigned)(tile_elems"
_TC_TSTORE = "                  *reinterpret_cast<uint4*>((pl == 0 ? tda : pl == 1 ? tds : tu) +"
_WG_MMA = ("        wgmma_m64n128(d[0], wg_desc(stg + 256 * k), db);\n"
           "        wgmma_m64n128(d[1], wg_desc(stg + 64 * kTR * 2 + 256 * k), db);\n")
_TC_TRANS = (
    "                const bf16* sc = reinterpret_cast<const bf16*>(scratch);\n"
    "                const int mrow8 = (lane / 8 % 2 * 8 + lane % 8) * 8;\n"
    "                uint32_t tv[4];\n"
    "                ldsm_x4_trans(tv, sc + lane / 16 * 128 + mrow8);\n"
    "#pragma unroll\n"
    "                for (int m = 0; m < 4; ++m)\n"
    "                  *reinterpret_cast<uint32_t*>((m < 2 ? tda : tds) +\n"
    "                                               toff(rc + 8 * (m % 2), n0 + 8 * nt + gq, d1) +\n"
    "                                               4 * tq) = tv[m];\n"
    "                if (planes == 3) {\n"
    "                  uint32_t tw[2];\n"
    "                  ldsm_x2_trans(tw, sc + 2 * 128 + mrow8);\n"
    "#pragma unroll\n"
    "                  for (int m = 0; m < 2; ++m)\n"
    "                    *reinterpret_cast<uint32_t*>(tu + toff(rc + 8 * m, n0 + 8 * nt + gq, d1) +\n"
    "                                                 4 * tq) = tw[m];\n"
    "                }\n"
)
_TC_GATHER = (
    "                for (int e = lane; e < 16 * planes; e += 32) {\n"
    "                  const int pl = e / 16, f = e % 8, kg = e / 8 % 2;\n"
    "                  const unsigned short* sc =\n"
    "                      reinterpret_cast<const unsigned short*>(scratch + 64 * pl) + kg * 64 + f;\n"
    "                  uint32_t wv[4];\n"
    "#pragma unroll\n"
    "                  for (int i = 0; i < 4; ++i) wv[i] = sc[16 * i] | (uint32_t)sc[16 * i + 8] << 16;\n"
    "                  *reinterpret_cast<uint4*>((pl == 0 ? tda : pl == 1 ? tds : tu) +\n"
    "                                            toff(rc + 8 * kg, n0 + 8 * nt + f, d1)) =\n"
    "                      make_uint4(wv[0], wv[1], wv[2], wv[3]);\n"
    "                }\n"
)
SPECTRAL_MMA_VARIANTS = {
    "base": [],
    # the rows kernel's products: their A and B loads kept, no tensor-core op
    "rows: no products": [(_TC_MMA, (
        "              if (mt < nmt) acc[mt][t][0] += __uint_as_float(\n"
        "                  (a[mt][0] ^ a[mt][3] ^ b.x ^ b.y) & 0x007fffffu);\n"))],
    # the weight items' bulk copies cut to 16 bytes each (the products run on
    # whatever the ring holds; the barriers keep their order)
    "rows: no weight items": _TC_ITEM,
    # the saved a, s tiles' bulk copies (the epilogue reads the stale slots)
    "rows: no a, s loads": [(_TC_ACTS, _TC_ACTS.replace("r < rows_pad", "r < 0"))],
    # the transposed planes' stores of da, ds and u (their gathers kept)
    "rows: no da, ds, u stores": [
        (_TC_TSTORE, _TC_TSTORE.replace("  *reinterpret_cast", "  if (wv[0] == 0x7f7f7f7fu) "
                                                              "*reinterpret_cast"))],
    # the transposed stores by ldmatrix.trans from the scratch, 4 bytes a lane
    # (a feature's 16-byte run from 4 lanes), in place of each lane's gather
    # of its 16-byte runs
    "rows: transposed stores by ldmatrix": [(_TC_GATHER, _TC_TRANS)],
    # the cotangent tile's loads (zeros staged in their place)
    "rows: no cotangent loads": [(
        "          if (vec == 4) v[j] = *reinterpret_cast<const float4*>(src);\n"
        "          else v[j].x = *src;\n",
        "          v[j].x = 0.f * (float)(row + kk + m) + (src == g ? 1.f : 0.f);\n")],
    # the sum of the chains' parts of dx in the cluster (dx not written)
    "rows: no dx sum": [("  if (chain == 0) {\n    const float* own = ",
                         "  if (chain < 0) {\n    const float* own = ")],
    # the weight gradients' tensor-core products (their stages still stream)
    "wgrad: no wgmma": [(_WG_MMA, "")],
    # the weight gradients' cluster sums (the gradients are not written)
    "wgrad: no cluster reduce": [(
        "  for (int h = 0; h < 2; ++h) {\n    if (warp < 8) {\n      const int side = warp / 4",
        "  for (int h = 0; h < 0; ++h) {\n    if (warp < 8) {\n      const int side = warp / 4")],
    # the rows kernel's phases by %globaltimer (ns), thread 0 of each block into
    # dx[16 block + k] (read by `spectral_mma`; the dx sum left out)
    "rows: timeline": [
        ("  if (threadIdx.x == 0) {\n    for (int i = 0; i < ring; ++i) {",
         "#define TL(k) do { if (threadIdx.x == 0) { unsigned long long t_; asm volatile("
         "\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)); dx[blockIdx.x * 16 + (k)] = "
         "(float)(t_ % 100000000ull); } } while (0)\n  TL(0);\n"
         "  if (threadIdx.x == 0) {\n    for (int i = 0; i < ring; ++i) {"),
        ("  cluster.sync();  // both blocks' barriers are initialised, the tiles staged\n",
         "  cluster.sync();\n  TL(1);\n"),
        ("        consumers_sync(warps);  // the tile's da, ds are in place\n",
         "        consumers_sync(warps);  // the tile's da, ds are in place\n"
         "        TL(1 + 2 * qp);\n"),
        ("      consumers_sync(warps);  // every read of the tile's buffers is done before they "
         "are rewritten\n",
         "      consumers_sync(warps);\n      TL(2 + 2 * qp);\n"),
        ("  cluster.sync();\n  if (chain == 0) {\n    const float* own = ",
         "  cluster.sync();\n  TL(9);\n  if (chain < 0) {\n    const float* own = "),
        ("  cluster.sync();  // the imaginary block's part is read before it goes\n}",
         "  cluster.sync();\n  TL(10);\n}")],
    "rows kernel returns at once": [(
        "  const TcStream st = tc_stream(d0, d1, NT, p);\n  const int warps = st.w, warp",
        "  if (blockIdx.x >= 0) return;\n  const TcStream st = tc_stream(d0, d1, NT, p);\n"
        "  const int warps = st.w, warp")],
    "wgrad kernel returns at once": [(
        "  const int unit = blockIdx.x / C, z = blockIdx.x % C;\n",
        "  if (blockIdx.x >= 0) return;\n  const int unit = blockIdx.x / C, z = blockIdx.x % C;\n")],
    "pack kernel returns at once": [(
        "  const TcStream s = tc_stream(d0, d1, nt, p);\n  const long per_item",
        "  if (blockIdx.x >= 0) return;\n  const TcStream s = tc_stream(d0, d1, nt, p);\n"
        "  const long per_item")],
}


_FMMA_SAVE = ("              if (row < rows_pad) {\n"
              "                if constexpr (std::is_same<TA, float>::value) {\n"
              "                  __stcs(reinterpret_cast<float2*>(ga + row * d1 + col)")
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
        ("                  __stcs(reinterpret_cast<float2*>(ga + row * d1 + col), "
         "make_float2(a0, a1));\n"
         "                  __stcs(reinterpret_cast<float2*>(gs + row * d1 + col), "
         "make_float2(s0, s1));\n",
         "                  *reinterpret_cast<float2*>(ga + row * d1 + col) = make_float2(a0, a1);\n"
         "                  *reinterpret_cast<float2*>(gs + row * d1 + col) = make_float2(s0, s1);\n")],
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
    card = _build.card_limits(dev)
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
    card = _build.card_limits(dev)
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
        card = _build.card_limits(dev)
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


def _parent_mma_plan(b: int, k: int, n: int, w: int, wm: int, sms: int) -> tuple:
    """(row segments, tile rows, n8 tiles a warp) of the mma.sync bf16
    backward that came before Hopper's route (its `bwd_mma_plan`), for a checkout that
    still has it: the fewest n8 tiles a warp (4, 8, 16) whose block holds
    D1, the row tile that puts the fewest rows on the busiest SM, enough row
    segments of the weight gradients for four blocks an SM."""
    d0, d1 = k * w, k * wm
    rows_pad = -(-(b * n) // 16) * 16
    tiles = {4: (5, 2, 1), 8: (2, 1), 16: (1,)}
    threads = {4: 256, 8: 512, 16: 512}
    col_tiles = -(-d1 // 8)
    nt = next(t for t in tiles if -(-col_tiles // t) * 32 <= threads[t])
    mt = min(tiles[nt], key=lambda m: (-(-2 * -(-rows_pad // (16 * m)) // sms) * m, -m))
    blocks = sum(-(-din // 48) for din in (d0, d0, d1, d1, d1, d1)) * -(-d1 // 128)
    chunks = -(-rows_pad // 32)
    return max(1, min(chunks, -(-4 * sms // blocks))), 16 * mt, nt


def _bf16_reread_call(lib, x, g, weights, ci, si, multi, acts, plan=None):
    """The bf16 reread C entry of a library (its bf16-storage entry on bf16
    acts), into buffers made here: this tree's (Hopper's route on the plan
    `plan`, by default `bwd_tc_plan`'s for the acts' storage), or an earlier
    tree's mma.sync route (g f32, the plan of `_parent_mma_plan`; found by
    its workspace function of 7 arguments)."""
    from stemgnn_tpu_torch.ops import cuda_spectral

    b, k, n, w = x.shape
    wm = w * multi
    bf16_acts = acts.dtype == torch.bfloat16
    name = "spectral_bwd_reread_bf16" + ("acts" if bf16_acts else "")
    fn = getattr(lib, name)
    ptrs = (ctypes.c_void_p * 24)(*[t.data_ptr() for t in weights])
    dx = torch.empty(x.shape, device=x.device)
    grads = torch.empty(cuda_spectral._fn("spectral_bwd_grad_floats")(k, w, wm), device=x.device)
    size = lib.spectral_bwd_reread_bf16_workspace_floats
    if hasattr(lib, "spectral_bwd_bf16_smem"):
        plan = plan or cuda_spectral.bwd_tc_plan(b, k, n, w, wm, cuda_spectral._sms(x.device),
                                                 2 if bf16_acts else 4)
        tail = (cuda_spectral.N_SPLIT,) + plan.args
        fn.argtypes, fn.restype = cuda_spectral._SIGNATURES[name]
    else:
        tail = _parent_mma_plan(b, k, n, w, wm, cuda_spectral._sms(x.device))
        fn.argtypes = cuda_spectral._SIGNATURES[name][0][:14] + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    size.argtypes, size.restype = [ctypes.c_int] * (5 + len(tail)), ctypes.c_longlong
    ws = torch.empty(size(b, k, n, w, wm, *tail), device=x.device)

    def call(held=(ws,)):
        _build.check(fn(x.data_ptr(), g.data_ptr(), ptrs, ci.data_ptr(), si.data_ptr(),
                        acts.data_ptr(), dx.data_ptr(), grads.data_ptr(), ws.data_ptr(), b, k,
                        n, w, wm, *tail, _build.stream_ptr(x)), name)
        return dx, grads

    return call


def _bf16_acts_save_call(lib, x, weights, ci, si, multi):
    """The bf16-storage saving forward's C entry of a library into buffers
    made here: this tree's (`fwd_mma_plan` with acts_bf16, stage_acts
    handed in), or an earlier tree's (the plain plan, no stage_acts: found
    by the absence of `spectral_fwd_save_bf16acts_smem`). The call returns
    (out, acts)."""
    from stemgnn_tpu_torch.ops import cuda_spectral

    b, k, n, w = x.shape
    wm = w * multi
    this = hasattr(lib, "spectral_fwd_save_bf16acts_smem")
    plan = cuda_spectral.fwd_mma_plan(b, k, n, w, wm, cuda_spectral._sms(x.device),
                                      acts_bf16=this)
    args = plan.args + ((plan.stage_acts,) if this else ())
    fn = lib.spectral_fwd_save_bf16acts
    fn.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)] + [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * (5 + len(args)) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ptrs = (ctypes.c_void_p * 24)(*[t.data_ptr() for t in weights])
    out = torch.empty((b, k, n, wm), device=x.device)
    acts = torch.empty(cuda_spectral._fn("spectral_act_floats")(b, k, n, wm),
                       dtype=torch.bfloat16, device=x.device)

    def call():
        _build.check(fn(x.data_ptr(), ptrs, ci.data_ptr(), si.data_ptr(), out.data_ptr(),
                        acts.data_ptr(), None, b, k, n, w, wm, *args, _build.stream_ptr(x)),
                     "spectral_fwd_save_bf16acts")
        return out, acts

    return call


def _bf16_recompute_call(lib, x, g, weights, ci, si, multi):
    """The bf16 recompute backward's C entry of a library into buffers made
    here, this tree's or an earlier one's as `_bf16_reread_call` tells them
    apart; the chain on `fwd_mma_plan`'s plan."""
    from stemgnn_tpu_torch.ops import cuda_spectral

    b, k, n, w = x.shape
    wm = w * multi
    sms = cuda_spectral._sms(x.device)
    fn = lib.spectral_bwd_bf16
    ptrs = (ctypes.c_void_p * 24)(*[t.data_ptr() for t in weights])
    dx = torch.empty(x.shape, device=x.device)
    grads = torch.empty(cuda_spectral._fn("spectral_bwd_grad_floats")(k, w, wm), device=x.device)
    size = lib.spectral_bwd_bf16_workspace_floats
    if hasattr(lib, "spectral_bwd_bf16_smem"):
        tail = (cuda_spectral.N_SPLIT,) + cuda_spectral.bwd_tc_plan(b, k, n, w, wm, sms).args
        fn.argtypes, fn.restype = cuda_spectral._SIGNATURES["spectral_bwd_bf16"]
    else:
        tail = _parent_mma_plan(b, k, n, w, wm, sms)
        fn.argtypes = cuda_spectral._SIGNATURES["spectral_bwd_bf16"][0][:13] + [
            ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    size.argtypes, size.restype = [ctypes.c_int] * (5 + len(tail)), ctypes.c_longlong
    ws = torch.empty(size(b, k, n, w, wm, *tail), device=x.device)
    fplan = cuda_spectral.fwd_mma_plan(b, k, n, w, wm, sms).args

    def call(held=(ws,)):
        _build.check(fn(x.data_ptr(), g.data_ptr(), ptrs, ci.data_ptr(), si.data_ptr(),
                        dx.data_ptr(), grads.data_ptr(), ws.data_ptr(), b, k, n, w, wm, *tail,
                        *fplan, _build.stream_ptr(x)), "spectral_bwd_bf16")
        return dx, grads

    return call


def _kernel_ms(call, reps: int = 20) -> dict:
    """{kernel name: device ms a call} of `call` by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    import re

    out = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            found = re.search(r"(\w+?)[<(]", ev.key.replace("void ", "").split("::")[-1])
            name = found.group(1) if found else ev.key
            out[name] = out.get(name, 0.0) + ev.device_time_total / 1e3 / reps
    return out


def spectral_mma(dev, tmp: Path) -> None:
    """The bf16 reread backward on Hopper (its C entry: the pack, rows and
    weight-gradient kernels) by variant at the flagship shapes, on the f32
    and the bf16 planes of the saving forwards: what the products, the
    weight items, the a, s loads, the transposed stores and the weight
    gradients' products and cluster sums cost, and each kernel's share (and
    the rows kernel's phases by %globaltimer); each kernel's time by the
    profiler; then the source as it is on other plans than `bwd_tc_plan`'s
    (a, s read from L2, items of other depths, other row segments of the
    weight gradients)."""
    from stemgnn_tpu_torch.ops import cuda_spectral

    b, n, w, m = 32, 140, 12, 5
    x, weights, ci, si = _bf16_operands(*_spectral_inputs(b, n, w, m, dev, 2))
    g = 1e-3 * torch.from_numpy(np.random.default_rng(3).standard_normal(
        (b, 4, n, w * m)).astype(np.float32)).to(dev)
    with torch.no_grad():
        _, acts = cuda_spectral._launch_fwd(x, weights, ci, si, m, save=True)
        _, acts16 = cuda_spectral._launch_fwd(x, weights, ci, si, m, save=True,
                                              act_dtype="bfloat16")
    planes = {"f32 planes": acts, "bf16 planes": acts16}
    libs = _build_variants("spectral.cu", SPECTRAL_MMA_VARIANTS, tmp)
    for name, lib in libs.items():
        for label, a in planes.items():
            call = _bf16_reread_call(lib, x, g, weights, ci, si, m, a)
            print(f"spectral bf16 reread B={b} N={n} W={w} multi={m}, {label}, {name}: "
                  f"{_cuda_ms(call):.5f} ms")
            if name == "rows: timeline":  # each phase's end after the block's start, us
                call()
                dx, _ = call()
                torch.cuda.synchronize()
                plan = cuda_spectral.bwd_tc_plan(b, 4, n, w, w * m, cuda_spectral._sms(dev),
                                                 2 if a is acts16 else 4)
                t = dx.flatten()[: 2 * plan.clusters * 16].view(-1, 16)[:, :11].double().cpu()
                rel = (t - t[:, :1]) / 1e3
                start = (t[:, 0] - t[:, 0].min()) / 1e3
                print(f"  timeline, {label}: block starts after the first, us (median, max): "
                      f"{start.median().item():.2f}, {start.max().item():.2f}; phase ends "
                      f"(staged, idft, epi 2, prod 2, epi 1, prod 1, epi 0, prod 0, cluster "
                      f"sync, end), us after the block's start (median / max): " + ", ".join(
                          f"{rel[:, k].median().item():.2f}/{rel[:, k].max().item():.2f}"
                          for k in range(1, 11)))
    for label, a in planes.items():
        ms = _kernel_ms(_bf16_reread_call(libs["base"], x, g, weights, ci, si, m, a))
        print(f"spectral bf16 reread B={b} N={n} W={w} multi={m}, {label}, base, by kernel "
              f"(profiler, ms a call): " + ", ".join(f"{k} {v:.5f}" for k, v in ms.items()))
    sms = cuda_spectral._sms(dev)
    for label, a in planes.items():
        plan = cuda_spectral.bwd_tc_plan(b, 4, n, w, w * m, sms, 2 if a is acts16 else 4)
        others = [plan, plan._replace(stage_acts=0),
                  plan._replace(item_steps=2),
                  plan._replace(item_steps=2, ring=min(2 * plan.ring, 4 * plan.warps)),
                  plan._replace(ring=plan.warps)]  # one slot a warp
        others += [plan._replace(nseg=c) for c in (1, 2, 3, 4, 5, 8) if c != plan.nseg]
        others.append(plan)
        for other in others:
            diff = {f: v for f, v in other._asdict().items() if v != getattr(plan, f)}
            try:
                call = _bf16_reread_call(libs["base"], x, g, weights, ci, si, m, a, other)
                t = f"{_cuda_ms(call):.5f} ms"
            except RuntimeError as exc:  # a plan the kernels refuse
                t = f"refused ({exc})"
            print(f"spectral bf16 reread B={b} N={n} W={w} multi={m}, {label}, base, plan "
                  f"{diff or 'bwd_tc_plan'}: {t}")


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
# they are (staged in shared memory, a bulk store a plane and GLU), without
# the bulk stores (the staging written, nothing sent), and none at all.
_ACTS_BULK = ("            bulk_store(acts + (2 * gi) * plane + row0 * d1, stg, bytes);\n"
              "            bulk_store(acts + (2 * gi + 1) * plane + row0 * d1, stg + TM * d1, "
              "bytes);\n")
_ACTS_STAGE = ("                  *reinterpret_cast<uint32_t*>(stg + r * d1 + col) = "
               "pack_bf16x2(a0, a1);\n"
               "                  *reinterpret_cast<uint32_t*>(stg + (TM + r) * d1 + col) = "
               "pack_bf16x2(s0, s1);\n")
SPECTRAL_ACTS_VARIANTS = {
    "base": [],
    "no bulk stores": [(_ACTS_BULK, "")],
    "no stores": [(_ACTS_BULK, ""), (_ACTS_STAGE, "")],
}


def _bf16_storage_calls(lib, x, g, weights, ci, si, multi, staged: bool = True):
    """(saving call, reread call) of a library's bf16-storage entries
    (`spectral_fwd_save_bf16acts`, `spectral_bwd_reread_bf16acts`) on the
    plans of `fwd_mma_plan` (acts_bf16; with `staged` False, the plain plan:
    the lanes store the planes) and `bwd_tc_plan` for 2-byte planes, into
    buffers made here; the reread reads what one saving call wrote."""
    from stemgnn_tpu_torch.ops import cuda_spectral

    b, k, n, w = x.shape
    wm = w * multi
    fp = cuda_spectral.fwd_mma_plan(b, k, n, w, wm, cuda_spectral._sms(x.device),
                                    acts_bf16=staged)
    stage = fp.stage_acts
    bp = cuda_spectral.bwd_tc_plan(b, k, n, w, wm, cuda_spectral._sms(x.device), act_bytes=2)
    ptrs = (ctypes.c_void_p * 24)(*[t.data_ptr() for t in weights])
    out = torch.empty((b, k, n, wm), device=x.device)
    acts = torch.empty(cuda_spectral._fn("spectral_act_floats")(b, k, n, wm),
                       dtype=torch.bfloat16, device=x.device)
    dx = torch.empty(x.shape, device=x.device)
    grads = torch.empty(cuda_spectral._fn("spectral_bwd_grad_floats")(k, w, wm), device=x.device)
    ws = torch.empty(cuda_spectral._fn("spectral_bwd_reread_bf16_workspace_floats")(
        b, k, n, w, wm, cuda_spectral.N_SPLIT, *bp.args), device=x.device)
    save, reread = lib.spectral_fwd_save_bf16acts, lib.spectral_bwd_reread_bf16acts
    save.argtypes, save.restype = cuda_spectral._SIGNATURES["spectral_fwd_save_bf16acts"]
    reread.argtypes, reread.restype = cuda_spectral._SIGNATURES["spectral_bwd_reread_bf16acts"]

    def saving():
        _build.check(save(x.data_ptr(), ptrs, ci.data_ptr(), si.data_ptr(), out.data_ptr(),
                          acts.data_ptr(), None, b, k, n, w, wm, *fp.args, stage,
                          _build.stream_ptr(x)), "spectral_fwd_save_bf16acts")
        return out, acts

    def rereading():
        _build.check(reread(x.data_ptr(), g.data_ptr(), ptrs, ci.data_ptr(), si.data_ptr(),
                            acts.data_ptr(), dx.data_ptr(), grads.data_ptr(), ws.data_ptr(),
                            b, k, n, w, wm, cuda_spectral.N_SPLIT, *bp.args,
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
        # the lanes' own stores (the plan without the staging), in turns
        for label, staged in (("staged, bulk stores", True), ("lane stores", False),
                              ("lane stores", False), ("staged, bulk stores", True)):
            saving, _ = _bf16_storage_calls(libs["base"], x, g, weights, ci, si, m, staged)
            print(f"spectral bf16 {shape}, bf16 saved arrays, base, {label}: saving forward "
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
    reread backwards' (both storage arms), the bf16 recompute's and the bf16
    forwards' too, their outputs compared (equal where both trees run the
    same bf16 design, else their sums differ)."""
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
    # the bf16-storage planes, as this tree's saving forward writes them (bitwise
    # the f32 planes rounded in either tree)
    with torch.no_grad():
        _, acts16 = cuda_spectral._launch_fwd(x, weights, ci, si, 5, save=True,
                                              act_dtype="bfloat16")
    for entry, make in (
            ("spectral_bwd_reread_bf16", lambda lib: _bf16_reread_call(
                lib, x, g, weights, ci, si, 5, acts)),
            ("spectral_bwd_reread_bf16acts", lambda lib: _bf16_reread_call(
                lib, x, g, weights, ci, si, 5, acts16)),
            ("spectral_bwd_bf16", lambda lib: _bf16_recompute_call(
                lib, x, g, weights, ci, si, 5)),
            ("spectral_fwd_save_bf16acts", lambda lib: _bf16_acts_save_call(
                lib, x, weights, ci, si, 5))):
        calls = {tree: make(lib) for tree, lib in libs.items()}
        outs = {tree: [t.clone() for t in call()] for tree, call in calls.items()}
        same = all(torch.equal(a, b_) for a, b_ in zip(outs["this"], outs["other"]))
        ms = [round(_cuda_ms(calls[tree]), 5) for tree in ("other", "this", "this", "other")]
        print(f"{entry} flagship: this tree against {other}: outputs "
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


def _graph_inputs(k: int, n: int, b: int, w: int, m: int, dev, seed: int = 0):
    """mul_L [k, m, n] (order 0 zeros) and x [b, n, w], seeded."""
    rng = np.random.default_rng(seed)
    mul_l = (rng.standard_normal((k, m, n)) / np.sqrt(n)).astype(np.float32)
    mul_l[0] = 0.0
    return (torch.from_numpy(mul_l).to(dev),
            torch.from_numpy(rng.standard_normal((b, n, w)).astype(np.float32)).to(dev))


def _graph_entry(fn, mul_l, x, out, dims: tuple, plan_args: tuple, name: str):
    """A call of a graph-conv C entry on dims (K, [M,] N, B, W) and its plan's
    arguments."""
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * (len(dims) + len(plan_args))
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def call():
        _build.check(fn(mul_l.data_ptr(), x.data_ptr(), out.data_ptr(), *dims, *plan_args,
                        _build.stream_ptr(out)), name)
        return out

    return call


def _f32_args(plan, x, out) -> tuple:
    vec = plan.vec and x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    return (plan.panel, plan.row_stride, plan.batch_stride, plan.threads, plan.smem, int(vec))


def _mma_plan_as(plan, tm: int, cluster: int):
    """`plan` with other row tiles or segments (the C entry derives its grid
    from these), or None where the kernel would refuse it."""
    if cluster > plan.chunks or (plan.orders <= 1 and cluster > 1):
        return None
    return plan._replace(tm=tm, cluster=cluster, smem=cuda_graph._mma_smem(tm, plan.tn))


def library_bf16(mul_l, x):
    """(pre-cast, with casts) calls of torch.mm on bf16 operands with an f32
    result, the orders 1..K-1 of mul_l [K, M, N] against x [B, N, W] as
    [N, B * W]: the bf16 graph conv's library yardsticks (here and in
    `chip_smoke.py` phase 3). The first takes operands cast beforehand, the
    second holds its two casts."""
    k, m, n = mul_l.shape
    b, _, w = x.shape
    lk = mul_l[1:].reshape((k - 1) * m, n)
    xt = x.permute(1, 0, 2).reshape(n, b * w)
    lk16, xt16 = lk.to(torch.bfloat16), xt.to(torch.bfloat16).contiguous()
    return (lambda: torch.mm(lk16, xt16, out_dtype=torch.float32),
            lambda: torch.mm(lk.to(torch.bfloat16), xt.to(torch.bfloat16),
                             out_dtype=torch.float32))


def graph(dev, tmp: Path) -> None:
    """The f32 arm with a piece left out (GRAPH_VARIANTS) at the flagship; the
    bf16 arm on the tensor cores with a piece left out (GRAPH_MMA_VARIANTS)
    and on other plans than `mma_plan`'s at GRAPH_SHAPES, beside torch.mm on
    bf16 operands, pre-cast and with its casts."""
    k, n, b, w = 4, 140, 32, 12
    mul_l, x = _graph_inputs(k, n, b, w, n, dev)
    out = torch.empty((b, k, n, w), device=dev)
    plan = cuda_graph.launch_plan(k, n, b, w)
    for name, lib in _build_variants("graph.cu", GRAPH_VARIANTS, tmp).items():
        call = _graph_entry(lib.cheb_graph_conv_fwd, mul_l, x, out, (k, n, n, b, w),
                            _f32_args(plan, x, out), name)
        print(f"cheb_graph_conv_fwd K={k} N={n} B={b} W={w}, {name}: "
              f"{_cuda_ms(call) * 1e3:.3f} us")
    x_t = x.permute(1, 0, 2).reshape(n, b * w).contiguous()
    orders = mul_l[1:].contiguous()
    print(f"torch.matmul of the three orders: "
          f"{_cuda_ms(lambda: torch.matmul(orders, x_t)) * 1e3:.3f} us")
    sms = _build.card_limits(dev)[0]
    libs = _build_variants("graph.cu", GRAPH_MMA_VARIANTS, tmp)
    for shape, (k, n, b, w, m) in GRAPH_SHAPES.items():
        mul_l, x = _graph_inputs(k, n, b, w, m, dev)
        out = torch.empty((b, k, m, w), device=dev)
        plan = cuda_graph.mma_plan(k, n, b, w, sms, m=m)
        tag = f"cheb_graph_conv_fwd_bf16 {shape} K={k} M={m} N={n} B={b} W={w}"
        print(f"{tag}: plan {plan}")
        for name, lib in libs.items():
            call = _graph_entry(lib.cheb_graph_conv_fwd_bf16, mul_l, x, out, (k, m, n, b, w),
                                plan.c_args(), name)
            print(f"{tag}, {name}: {_cuda_ms(call) * 1e3:.3f} us")
        base = libs["base"].cheb_graph_conv_fwd_bf16
        for tm in cuda_graph.MMA_ROW_TILES:
            for c in (1, 2, 4, 8):
                other = _mma_plan_as(plan, tm, c)
                if other is None or other == plan:
                    continue
                call = _graph_entry(base, mul_l, x, out, (k, m, n, b, w), other.c_args(),
                                    "plan")
                blocks = c * plan.grid[0] // plan.cluster * -(-m // tm) * plan.grid[2]
                print(f"{tag}, plan TM={tm} C={c} ({blocks} blocks): "
                      f"{_cuda_ms(call) * 1e3:.3f} us")
        pre, cast = library_bf16(mul_l, x)
        print(f"{tag}: torch.mm on bf16 operands {_cuda_ms(pre) * 1e3:.3f} us, with its "
              f"casts {_cuda_ms(cast) * 1e3:.3f} us")


def _other_module(other: Path, rel: str):
    """Another checkout's module of the port (a plan, pure Python), loaded from
    its file; what it imports of the package comes from this tree."""
    path = other / "stemgnn_tpu_torch" / rel
    spec = importlib.util.spec_from_file_location(f"other_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def graph_against(dev, tmp: Path, other: Path) -> None:
    """Both trees' graph conv (this tree's csrc/graph.cu and the other
    checkout's), each arm as its own tree's C entry takes it and on its own
    tree's plan (its ops/cuda_graph.py: an earlier bf16 arm's `launch_plan`
    with 2-byte operands, fed bf16 casts where it took them): the f32 arm
    bitwise, the bf16 arm compared (bitwise where both trees run one design),
    times in the order other, this, this, other, at GRAPH_SHAPES."""
    src = other / "stemgnn_tpu_torch" / "csrc" / "graph.cu"
    libs = {"other": _build_other(src, tmp), "this": _build.library("graph")}
    plans = {"other": _other_module(other, "ops/cuda_graph.py"), "this": cuda_graph}
    takes_m = {"other": _takes_m(src, "graph"), "this": True}
    f32_in = {"other": _bf16_graph_takes_f32(src), "this": True}
    sms = _build.card_limits(dev)[0]
    for shape, (k, n, b, w, m) in GRAPH_SHAPES.items():
        if m != n and not takes_m["other"]:
            continue
        mul_l, x = _graph_inputs(k, n, b, w, m, dev, seed=8)
        for arm in ("", "_bf16"):
            calls, outs = {}, {}
            for tree, lib in libs.items():
                cg_ = plans[tree]
                out = torch.empty((b, k, m, w), device=dev)
                dims = (k, m, n, b, w) if takes_m[tree] else (k, n, b, w)
                a_in, x_in = mul_l, x
                if not arm:
                    args = _f32_args(cg_.launch_plan(k, n, b, w, m=m), x, out)
                elif hasattr(cg_, "mma_plan"):
                    args = cg_.mma_plan(k, n, b, w, sms, m=m).c_args()
                else:  # an earlier bf16 arm: the f32 kernel's tiling of 2-byte operands
                    args = _f32_args(cg_.launch_plan(k, n, b, w, 2, m=m), x, out)
                    if not f32_in[tree]:
                        a_in, x_in = mul_l.to(torch.bfloat16), x.to(torch.bfloat16)
                entry = _graph_entry(getattr(lib, "cheb_graph_conv_fwd" + arm), a_in, x_in,
                                     out, dims, args, tree + arm)
                if a_in is not mul_l:  # that tree's wrapper cast before its launch

                    def entry(entry=entry, a_in=a_in, x_in=x_in):
                        a_in.copy_(mul_l)
                        x_in.copy_(x)
                        return entry()

                calls[tree], outs[tree] = entry, entry().clone()
            torch.cuda.synchronize()
            diff = (outs["this"] - outs["other"]).abs().max() / outs["other"].abs().max()
            same = ("bitwise equal" if torch.equal(outs["this"], outs["other"])
                    else f"max diff {diff.item():.3e} of the largest entry")
            ms = [round(_cuda_ms(calls[tree]), 5) for tree in ("other", "this", "this", "other")]
            print(f"cheb_graph_conv_fwd{arm} {shape} K={k} M={m} N={n} B={b} W={w}: this tree "
                  f"against {other}: output {same}; ms in the order other, this, this, "
                  f"other: {ms}")


_ATT_FWD_K = "      const float k = __shfl_sync(kFull, kl, (i - i0) % 32);\n"
_ATT_BWD_LOADS = ("      load_span<V, T>(pb + (long)i * N, N, lane, pv);\n"
                  "      load_span<V, T>(gb + (long)i * N, N, lane, gp);\n")
ATTENTION_VARIANTS = {
    "base": [],
    # the forward's query loaded again for every row in place of once a warp
    "fwd: query reloaded every row": [
        ("    load_span<V, T>(q, N, lane, qv);  // the query: once a warp, kept across its rows\n",
         ""),
        (_ATT_FWD_K, _ATT_FWD_K + "      load_span<V, T>(q, N, lane, qv);\n")],
    # each row's key by its own load in place of 32 rows' by one
    "fwd: key loaded every row": [(_ATT_FWD_K, "      const float k = __ldg(kb + i);\n")],
    # the arithmetic between the loads and the stores, each part left out
    "fwd: no expf": [("            e[t][v] = expf(e[t][v] - m);\n", "            e[t][v] = e[t][v] - m;\n")],
    "fwd: no row max": [("      m = warp_max(m);\n      float s = 0.f;\n#pragma unroll\n",
                         "      float s = 0.f;\n#pragma unroll\n")],
    "fwd: 4-byte stores": [
        ("          store_run<V>(o + run_col<V>(t, lane), e[t]);\n",
         "          for (int v = 0; v < V; ++v) o[run_col<V>(t, lane) + v] = e[t][v];\n")],
    "bwd: query reloaded every row": [
        ("    load_span<V, T>(qb, N, lane, qv);  // the query's columns: once a warp\n", ""),
        (_ATT_BWD_LOADS, _ATT_BWD_LOADS + "      load_span<V, T>(qb, N, lane, qv);\n")],
    "bwd: 4-byte loads of p and g": [
        (_ATT_BWD_LOADS,
         "#pragma unroll\n      for (int t = 0; t < T; ++t)\n#pragma unroll\n"
         "        for (int v = 0; v < V; ++v) {\n"
         "          const int cc = run_col<V>(t, lane) + v;\n"
         "          pv[t][v] = cc < N ? __ldg(pb + (long)i * N + cc) : 0.f;\n"
         "          gp[t][v] = cc < N ? __ldg(gb + (long)i * N + cc) : 0.f;\n"
         "        }\n")],
    # the block's column sums neither sent through distributed shared memory
    # nor waited for: each block reads its own unwritten slots
    "bwd: no cluster sums": [
        ("    send_to_owners(part, warps, kSpan, N, slice, recv, c, cluster);\n"
         "    cluster_arrive();\n    cluster_wait();\n", "")],
    # each kernel left at once: what a launch of its grid costs
    "fwd: returns at once": [
        ("  if (task >= (long)B * bands) return;", "  if (task >= 0) return;")],
    "bwd: returns at once (its cluster launch alone)": [
        ("  // every block of the cluster has started before anyone stores into it\n",
         "  if (N > 0) return;\n")],
    # a launch without clusters: no distributed shared memory, no barrier
    "bwd: no cluster (a plain launch, the block's own partials)": [
        ("  cluster_arrive_relaxed();\n\n  if constexpr (!kChunked) {", "\n  if constexpr (!kChunked) {"),
        ("    __syncthreads();\n    cluster_wait();\n    send_to_owners(part, warps, kSpan, N, slice, "
         "recv, c, cluster);\n    cluster_arrive();\n    cluster_wait();\n", "    __syncthreads();\n"),
        ("    cluster_wait();\n    int step = 0;\n", "    int step = 0;\n"),
        ("        send_to_owners(part, warps, kSpan, width, slice, buf, c, cluster);\n"
         "        cluster_arrive();\n        cluster_wait();\n", "        __syncthreads();\n"),
        ("  cfg.numAttrs = 1;\n  return (int)cudaLaunchKernelEx(&cfg, kernel, key",
         "  cfg.numAttrs = 0;\n  return (int)cudaLaunchKernelEx(&cfg, kernel, key")],
    # the chunked route (N > 1024) one row of a group at a time
    "bwd: chunked, a row at a time": [("constexpr int kChunkRows = 2;", "constexpr int kChunkRows = 1;")],
    "bwd: chunked, four rows at a time": [("constexpr int kChunkRows = 2;",
                                           "constexpr int kChunkRows = 4;")],
    "bwd: no start barrier": [
        ("  cluster_arrive_relaxed();\n\n  if constexpr (!kChunked) {", "\n  if constexpr (!kChunked) {"),
        ("    __syncthreads();\n    cluster_wait();\n    send_to_owners(part, warps, kSpan, N,",
         "    __syncthreads();\n    send_to_owners(part, warps, kSpan, N,"),
        ("    cluster_wait();\n    int step = 0;\n", "    int step = 0;\n")],
}

ATTENTION_SHAPES = {"flagship": (32, 140), "N=512": (32, 512)}
# the backward's chunked route (N past 1024): its variants only
CHUNKED_SHAPES = {"B=1 N=7300": (1, 7300), "B=8 N=2048": (8, 2048)}


def _takes_m(src: Path, which: str) -> bool:
    """Whether the C entries of a checkout's attention.cu or graph.cu take
    the row-block arms' M (this tree's do; a tree before them does not)."""
    text = src.read_text()
    return ("const float* kb = key + (long)b * M;" in text if which == "attention"
            else "int K, int M, int N" in text)


def _bf16_graph_takes_f32(src: Path) -> bool:
    """Whether a checkout's graph.cu bf16 entry takes f32 operands and rounds
    them in its loads (this tree's does; an earlier one took bf16 operands
    that its wrapper cast)."""
    return 'cheb_graph_conv_fwd_bf16(const float* L, const float* x' in src.read_text()


def _attention_inputs(b: int, n: int, dev):
    rng = np.random.default_rng(n)
    key, query = (torch.from_numpy(rng.standard_normal((b, n)).astype(np.float32)).to(dev)
                  for _ in range(2))
    g = torch.from_numpy((1e-3 * rng.standard_normal((b, n, n))).astype(np.float32)).to(dev)
    return key, query, cuda_attention.attention_kq_plain(key, query, 0.2), g


def _attention_calls(lib, key, query, p, g, fplan=None, bplan=None, alpha=0.2,
                     takes_m=True):
    """(forward, backward) calls of a built attention.cu's C entries: this
    tree's on the plans (default: the wrappers'; without `takes_m`, the
    entries of a tree before the row-block arms, which take no M), or, where
    the library has `attention_kq_bwd_tiles`, the earlier two-launch design
    with its scratch."""
    b, n = key.shape
    out = torch.empty((b, n, n), device=key.device)
    dk, dq = (torch.empty((b, n), device=key.device) for _ in range(2))
    fwd, bwd = lib.attention_kq_fwd, lib.attention_kq_bwd
    fwd.restype = bwd.restype = ctypes.c_int
    ptrs = [t.data_ptr() for t in (key, query)]
    if hasattr(lib, "attention_kq_bwd_tiles"):
        lib.attention_kq_bwd_tiles.argtypes = [ctypes.c_int]
        part = torch.empty((b, lib.attention_kq_bwd_tiles(n), n), device=key.device)
        fwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_float,
                                                                    ctypes.c_void_p]
        bwd.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + [ctypes.c_float,
                                                                    ctypes.c_void_p]
        fargs = (*ptrs, out.data_ptr(), b, n, alpha)
        bargs = (*ptrs, p.data_ptr(), g.data_ptr(), dk.data_ptr(), dq.data_ptr(),
                 part.data_ptr(), b, n, alpha)
    else:
        sms, smem = _build.card_limits(key.device)
        fp = fplan or cuda_attention.fwd_plan(b, n, sms)
        bp = bplan or cuda_attention.bwd_plan(b, n, sms, smem)
        fargtypes = list(cuda_attention._ARGTYPES["attention_kq_fwd"])
        bargtypes = list(cuda_attention._ARGTYPES["attention_kq_bwd"])
        dims = (b, n, n)
        if not takes_m:
            del fargtypes[4], bargtypes[7]
            dims = (b, n)
        fwd.argtypes, bwd.argtypes = fargtypes, bargtypes
        fargs = (*ptrs, out.data_ptr(), *dims, alpha, fp.vec, fp.runs, int(fp.wide),
                 fp.rows_per_warp, fp.bands, fp.blocks)
        bargs = (*ptrs, p.data_ptr(), g.data_ptr(), dk.data_ptr(), dq.data_ptr(), *dims,
                 alpha, bp.vec, bp.runs, int(bp.chunked), bp.cluster, bp.threads,
                 bp.rows_per_block, bp.slice, bp.smem)

    def fwd_call():
        _build.check(fwd(*fargs, _build.stream_ptr(key)), "attention_kq_fwd")
        return out

    def bwd_call():
        _build.check(bwd(*bargs, _build.stream_ptr(key)), "attention_kq_bwd")
        return dk, dq

    return fwd_call, bwd_call


def attention(dev, tmp: Path) -> None:
    """The attention kernels with one piece left out (ATTENTION_VARIANTS) and
    the source as it is on other plans, at the flagship and at N = 512."""
    libs = _build_variants("attention.cu", ATTENTION_VARIANTS, tmp)
    sms, smem = _build.card_limits(dev)
    for shape, (b, n) in ATTENTION_SHAPES.items():
        key, query, p, g = _attention_inputs(b, n, dev)
        fp, bp = cuda_attention.fwd_plan(b, n, sms), cuda_attention.bwd_plan(b, n, sms, smem)
        print(f"attention {shape} B={b} N={n}: {fp}; {bp}")
        for name, lib in libs.items():
            fwd, bwd = _attention_calls(lib, key, query, p, g)
            print(f"attention {shape}, {name}: forward {_cuda_ms(fwd):.5f} ms, backward "
                  f"{_cuda_ms(bwd):.5f} ms")
        fwd_plans = {f"{r} rows a warp": cuda_attention.fwd_plan(b, n, sms, rows_per_warp=r)
                     for r in (1, 2, 4, 8)}
        bwd_plans = {f"{w} warps a block, cluster of {c}": cuda_attention.bwd_plan(
            b, n, sms, smem, cluster=c, warps=w) for c in (4, 8) for w in (4, 8, 9, 16, 18)}
        for label, plan in fwd_plans.items():
            fwd, _ = _attention_calls(libs["base"], key, query, p, g, fplan=plan)
            print(f"attention {shape}, forward on {label} ({plan.blocks} blocks): "
                  f"{_cuda_ms(fwd):.5f} ms")
        for label, plan in bwd_plans.items():
            _, bwd = _attention_calls(libs["base"], key, query, p, g, bplan=plan)
            print(f"attention {shape}, backward on {label} ({plan.warps} warps, "
                  f"{plan.rows_per_block} rows a block): {_cuda_ms(bwd):.5f} ms")
    for shape, (b, n) in CHUNKED_SHAPES.items():
        key, query, p, g = _attention_inputs(b, n, dev)
        print(f"attention {shape}: {cuda_attention.bwd_plan(b, n, sms, smem)}")
        for name in ("base", "bwd: chunked, a row at a time", "bwd: chunked, four rows at a time"):
            _, bwd = _attention_calls(libs[name], key, query, p, g)
            print(f"attention {shape}, {name}: backward {_cuda_ms(bwd, 2, 3):.5f} ms")
        del p, g


def attention_against(dev, tmp: Path, other: Path) -> None:
    """Both trees' attention kernels (this tree's csrc/attention.cu and the
    other checkout's, each as its own C entries take them) at the flagship
    and at N = 512: outputs compared, times in the order other, this, this,
    other."""
    src = other / "stemgnn_tpu_torch" / "csrc" / "attention.cu"
    libs = {"other": _build_other(src, tmp), "this": _build.library("attention")}
    takes_m = {"other": _takes_m(src, "attention"), "this": True}
    for shape, (b, n) in ATTENTION_SHAPES.items():
        key, query, p, g = _attention_inputs(b, n, dev)
        calls = {tree: _attention_calls(lib, key, query, p, g, takes_m=takes_m[tree])
                 for tree, lib in libs.items()}
        outs = {tree: (fwd().clone(), [t.clone() for t in bwd()])
                for tree, (fwd, bwd) in calls.items()}
        torch.cuda.synchronize()
        (f_this, b_this), (f_other, b_other) = outs["this"], outs["other"]
        f_err = (f_this - f_other).abs().max().item()
        b_err = max(((a - o).abs().max() / o.abs().max()).item()
                    for a, o in zip(b_this, b_other))
        order = ("other", "this", "this", "other")
        fms = [round(_cuda_ms(calls[tree][0]), 5) for tree in order]
        bms = [round(_cuda_ms(calls[tree][1]), 5) for tree in order]
        print(f"attention {shape} B={b} N={n}: this tree against {other}: forward "
              f"{'bitwise equal' if torch.equal(f_this, f_other) else f'max abs diff {f_err:.3e}'}"
              f", backward {'bitwise equal' if all(map(torch.equal, b_this, b_other)) else f'max diff {b_err:.3e} of the largest entry'}; "
              f"ms in the order other, this, this, other: forward {fms}, backward {bms}")


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
                other = Path(name.split("=", 1)[1]).resolve()
                spectral_against(dev, Path(tmp), other)
                graph_against(dev, Path(tmp), other)
                attention_against(dev, Path(tmp), other)
                continue
            if name.startswith("ptxas"):
                other = name.partition("=")[2]
                ptxas(Path(other).resolve() / "stemgnn_tpu_torch" / "csrc" if other
                      else _build.CSRC, Path(tmp))
                continue
            {"gru": gru, "gru_bwd": gru_bwd, "gru_grid": gru_grid, "spectral": spectral,
             "spectral_fwd": spectral_fwd, "spectral_mma": spectral_mma,
             "spectral_fwd_mma": spectral_fwd_mma, "spectral_acts": spectral_acts,
             "graph": graph, "attention": attention}[name](dev, Path(tmp))
    return 0


if __name__ == "__main__":
    sys.exit(main())
