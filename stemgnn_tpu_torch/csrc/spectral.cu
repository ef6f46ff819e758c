// Spectral-sequential cell, forward and backward.
//
// Forward (`spectral_fwd`): replaces stemgnn_tpu/ops/pallas_spectral.py `_kernel` (reached from
// `_forward` / `spe_seq_cell_pallas`). A row map over the B*N rows of
// x [B,K,N,W] viewed as [rows, K*W]:
//   R = GLU0(x), I = GLU1(x)   (forward DFT folded into the layer-0
//                               weights by the caller: Cf@W, Sf@W)
//   2x: R = GLU_even(R); I = GLU_odd(I)
//   out = R @ Ci + I @ Si      (inverse DFT, real part), [rows, K*Wm]
// written straight into the [B,K,N,Wm] layout; GLU(u) = (u@Wl + bl) *
// sigmoid(u@Wr + br), all f32. The inverse DFT is block-diagonal over the
// K orders, so the kernel takes one [Wm, Wm] block of Ci and of Si and an
// output column of order kk sums only over that order's Wm inputs.
//
// Bound on the H100: f32 operations (about 2*rows*(4*D0*D1 + 8*D1*D1 +
// 2*K*Wm*Wm), D0 = K*W, D1 = K*Wm: 4.8 GFLOP at the flagship shapes,
// against a few MB of traffic). The design keeps every intermediate out of
// device memory, as the TPU kernel kept it out of HBM, and is built for the
// H100's SMs as the backward's rows kernel is (below):
//   * the two chains on separate blocks, a cluster of 2 per row tile (rank 0
//     the real chain, rank 1 the imaginary one): they are independent until
//     the inverse DFT, where each block copies the other's last tile through
//     distributed shared memory and computes half of the output columns;
//   * register tiles: a thread owns 8 rows by 4 columns of a GLU's output,
//     both the left and the right product (64 sums; 8 by 8 would be 128,
//     which spill at three blocks an SM), so a step of the sum brings 2
//     float4 of activations (shared memory, [k][row]) and 2 float4 of
//     weights (L2 through L1, loaded two steps ahead) for 64 FMAs: 1 byte
//     of shared memory or L1 an FMA;
//   * one buffer a block: a GLU's outputs stay in registers across the
//     barrier that ends the reads of its input, then overwrite the input;
//   * a row tile chosen from the row count (`chain_tile`: 24 rows, or 16 or
//     8 where that fills more SMs), so a few hundred rows still spread over
//     the card. Blocks of up to 192 threads (D1 up to 256 at 24 rows) three
//     an SM; wider ones, of up to 320 or 512 threads, one an SM.
// Every output element is one chain of fmaf in a fixed order (per GLU, k
// ascending, the left and right sums apart; the inverse DFT j ascending),
// whatever the tile, so all three instantiations write the same bits.
// Only the [rows, D1] result is written to device memory.
//
// Backward (`spectral_bwd`): replaces `_bwd_kernel` (reached from
// `_backward`): recompute (a, s) of the six GLUs from x, backpropagate the
// inverse DFT and the GLUs,
//   d = (g @ Ci^T, g @ Si^T);  per GLU, last to first, on its chain:
//   da = d * s;  ds = d * a * s * (1 - s)
//   dWl += u^T da;  dbl += colsum(da);  dWr += u^T ds;  dbr += colsum(ds)
//   d = da @ Wl^T + ds @ Wr^T;          dx = d_real + d_imag after layer 0
// with the layer-0 weight gradients in folded space (the caller unfolds
// them). Bound: f32 operations, about three times the forward's.
// Two TPU properties do not carry over. (1) The TPU kernel keeps (u, a, s) of
// all six GLUs for a row tile in VMEM: 18 [32, 240] f32 arrays are 552,960
// bytes, more than twice what a block here can have. (2) It adds the 24
// weight and bias gradients up across row tiles in one output block, which
// only a sequential grid allows. So the backward is a row of kernels behind
// one C entry, with (a, s) and (da, ds) staged through a workspace in device
// memory (103 MB at the flagship shapes, mostly L2 traffic next to 13 GFLOP):
//   1. transpose the 12 weight matrices, so that step 3 reads them with
//      neighbouring threads on neighbouring addresses;
//   2. the forward chain again, without the inverse DFT, writing a and s of
//      every GLU ([rows, D1] row-major each): the forward kernel itself,
//      compiled with kSave (and no cluster); a forward that must save is the
//      same kernel with kOut as well;
//   3. per tile of kBR rows and per chain (the two chains are independent
//      until dx), the chain backwards in shared memory with register tiles
//      of 8 rows by 8 columns, writing da and ds of the chain's GLUs and the
//      chain's part of dx and the column sums of da and ds over each 8 rows;
//      then dx = real part + imaginary part;
//   4. the weight gradients as products over the rows: a block owns a
//      [48, D1] tile of dWl and dWr of one GLU (u = x, or a * s of the GLU
//      before) for one of `nsplit` row segments and writes its partial
//      sums;
//   5. the segments' partials summed in order, and the bias gradients as the
//      sums of step 3's column sums.
// Every sum has one fixed order, so two runs give the same bits; no atomics.
// Rows past the end of a tile's data carry g = 0, hence da = ds = 0, and add
// nothing to any gradient. Ci and Si are symmetric, which step 3 uses to
// read them along rows. Steps 3 and 4 take D0 and D1 in runs of 4 columns
// (`shape_ok`, the forward's rule too: K = 4 in the model); every entry
// returns cudaErrorInvalidValue otherwise. They are
// built for the ECG flagship (W = 12, D0 = 48, D1 = 240); other shapes take
// masked runs, a column at a time where a run straddles two orders' windows,
// D1 past 256 takes wider blocks of the rows kernel and column tiles of
// the weight-gradient kernel, D1 past 680 a rows kernel of 8-row tiles
// (instantiated apart, so the flagship's code is as it was) and a chain
// forward of the row tile whose block and buffers fit (`chain_tile`), and D1
// past 2048 the wide chain and rows kernels (a column loop in the thread,
// their buffers in a device workspace past a block's shared memory).

// Saving forward and reread backward (`spectral_fwd_save`,
// `spectral_bwd_reread`): replace `_kernel_save` (reached from
// `_forward(save_acts=True)`) and `_bwd_kernel_reread` (reached from
// `_backward_reread`). The forward is the chain kernel with kSave and kOut:
// one launch writes the output and the 12 arrays (a, s) of the six GLUs into
// a buffer the caller keeps; the backward is steps 1, 3, 4 and 5 above on
// that buffer, without step 2. The saved values are the ones step 2 would
// compute, by the same code, so both backwards give the same bits. What the
// pair trades: 12 products and 6 sigmoid sweeps per call (4.5 GFLOP at the
// flagship shapes) against 12 * rows * D1 floats (51.6 MB) written by the
// forward and held until the backward, which is more than the 50 MB L2. Both
// entries pad the rows to the same multiple (`rows_padded`); rows of the
// saved arrays past the end hold the chain's values for an all-zero input
// row.

// The bf16 arms (`spectral_fwd_bf16`, `spectral_fwd_save_bf16`,
// `spectral_bwd_bf16`, `spectral_bwd_reread_bf16`): the same kernels
// instantiated for bf16 operands, the JAX package's compute_dtype=bfloat16
// arm of the same four TPU kernels. The caller folds the DFT in f32 and casts
// x, the twelve 2-D GLU weights and the inverse DFT's block to bf16 (g too,
// for a backward); biases, outputs, the 12 saved arrays and every sum stay
// f32. What the TPU kernels round to bf16 is rounded here at the same points
// (`round_to`): each GLU's input a * s (the next layer's operand, and the
// inverse DFT's), and in the backward da and ds before their products (the
// bias gradients sum them unrounded) and u = a * s of the weight gradients,
// rebuilt from the saved f32 a and s as the forward built it: so the reread
// backward stays bitwise the recompute backward. Up to D1 = 2048 every bf16
// kernel runs on tensor cores (bf16 x bf16 -> f32: the scalar products
// exactly, the f32 sums in steps of 16 k): the chain forward
// (`chain_mma_launch`, below: mma.sync, weight panels staged in shared memory
// for ldmatrix.trans, two bf16 buffers that the GLUs take in turn), behind both
// forwards and the recompute backward's step 2, and the backwards
// (`bwd_tc_launch`: the rows kernel on mma.sync fed by TMA bulk copies, the
// weight gradients on wgmma, three launches), which take g as f32 and round
// it as they stage it. Past D1 = 2048 both run the wide scalar kernels of the
// f32 arm's design, their bf16 operands converted to f32 (exact) and summed
// in the f32 arm's fmaf order.

// The bf16-storage arm of the bf16 saving pair (`spectral_fwd_save_bf16acts`,
// `spectral_bwd_reread_bf16acts`): the JAX package's `_kernel_save` with
// SAVE_ACTS_F32 off, whose 12 arrays take the compute dtype (act_dtype,
// pallas_spectral.py:213), and `_bwd_kernel_reread` on them. The same kernels,
// the storage type a template parameter TA (float by default, which leaves
// the f32-storage code as it was): the chain kernels round the f32 a and s
// they already hold to bf16 as they store them (so the planes are bitwise the
// f32-storage planes rounded, and the output does not change; up to D1 =
// 2048 through a shared staging and TMA bulk stores where it fits), and the
// rows kernels' epilogues (bulk copies of half the bytes on Hopper's route)
// and the scalar weight-gradient kernel read them back as bf16 and use the
// rounded values everywhere, u = round(a * s) too, as the TPU kernel upcasts
// what it reads. Bound: bytes, half the f32 arm's saved arrays (25.8 MB at
// the flagship shapes). The recompute backward keeps f32 planes: the JAX
// recompute stores nothing.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>
#include <climits>
#include <type_traits>

#include "device_utils.cuh"

namespace cg = cooperative_groups;

namespace {

// the six GLUs' tensors: 2-D weights of the operand type, biases f32
template <typename T>
struct GluWeights {
  const T* wl[6];
  const float* bl[6];
  const T* wr[6];
  const float* br[6];
};

__device__ __forceinline__ float sigmoidf(float v) { return 1.f / (1.f + expf(-v)); }

// two f32 values rounded to bf16 (to nearest, ties to even) as one 32-bit word,
// lo in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Four saved activations of the storage type TA (f32, or bf16 where the
// saving forward stores them rounded) as f32, where `in`, else zeros.
template <typename TA>
__device__ __forceinline__ void ldg_act4(const TA* p, bool in, float (&f)[4]) {
  if (in) {
    unpack4(ldg_vec4(p), f);
  } else {
    f[0] = f[1] = f[2] = f[3] = 0.f;
  }
}

// ---- forward: the chain kernel ----

constexpr int kFMaxThreads = 192;    // up to 192 threads: three blocks an SM
constexpr int kFMidThreads = 320;    // up to 320: one block an SM, 168 registers a thread
constexpr int kFWideThreads = 512;   // up to 512 (D1 up to 680 at 24 rows): 128 registers
constexpr int kFTiles[3] = {24, 16, 8};  // row tiles, in the order they are preferred
constexpr int kFAhead = 2;           // steps of k the weight loads run ahead

// al[i][q] = sum_k in[k][r0 + i] * wl[k][c + q], ar the same with wr, k < din,
// k ascending (in: [k][row], S floats between columns; wl, wr: [din][dout]
// row-major, of the operand type T). The weights come from L2: loaded
// kFAhead steps of k ahead, in a ring, and converted where they are used.
template <typename T>
__device__ __forceinline__ void glu_fwd_product(const float* in, int S, int din,
                                                const T* __restrict__ wl,
                                                const T* __restrict__ wr, int dout,
                                                int r0, int c, float (&al)[8][4],
                                                float (&ar)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) al[i][q] = ar[i][q] = 0.f;
  const T* pl = wl + c;
  const T* pr = wr + c;
  constexpr int kRing = kFAhead + 1;
  using V = typename Vec4<T>::type;
  V lw[kRing], rw[kRing];
  auto load_w = [&](int k, V& l, V& r) {
    const long kk = min(k, din - 1);  // past the end: a load nobody uses
    l = ldg_vec4(pl + kk * dout);
    r = ldg_vec4(pr + kk * dout);
  };
#pragma unroll
  for (int u = 0; u < kFAhead; ++u) load_w(u, lw[u], rw[u]);
  for (int k0 = 0; k0 < din; k0 += kRing) {
#pragma unroll
    for (int u = 0; u < kRing; ++u) {
      const int k = k0 + u;
      if (k >= din) break;
      load_w(k + kFAhead, lw[(u + kFAhead) % kRing], rw[(u + kFAhead) % kRing]);
      float x[8], l[4], r[4];
      load8(in + k * S + r0, x);
      unpack4(lw[u], l);
      unpack4(rw[u], r);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          al[i][q] = fmaf(x[i], l[q], al[i][q]);
          ar[i][q] = fmaf(x[i], r[q], ar[i][q]);
        }
    }
  }
}

// A GLU's outputs from the thread's sums: a = al + bl, s = sigmoid(ar + br),
// a * s rounded to the operand type T (the next product's operand) to the
// block's buffer (the 8 rows of a column as two float4); with kSave, a and s
// to ga, gs ([rows_pad][d1] row-major, rows past rows_pad dropped) in the
// storage type TA: f32, or bf16 (rounded to nearest, as the JAX package's
// `_kernel_save` stores them with SAVE_ACTS_F32 off).
template <typename T, bool kSave, typename TA = float>
__device__ __forceinline__ void glu_fwd_elementwise(
    const float (&al)[8][4], const float (&ar)[8][4], const float* __restrict__ bl,
    const float* __restrict__ br, int r0, int c, long row0, long rows_pad, int d1,
    TA* __restrict__ ga, TA* __restrict__ gs, float* buf, int S) {
  float bL[4], bR[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    bL[q] = __ldg(bl + c + q);
    bR[q] = __ldg(br + c + q);
  }
  float v[4][8];  // [column][row]
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float a[4], sg[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      a[q] = al[i][q] + bL[q];
      sg[q] = sigmoidf(ar[i][q] + bR[q]);
      v[q][i] = round_to<T>(a[q] * sg[q]);
    }
    if (kSave) {
      const long row = row0 + r0 + i;
      if (row < rows_pad) {
        if constexpr (std::is_same<TA, float>::value) {
          *reinterpret_cast<float4*>(ga + row * d1 + c) = make_float4(a[0], a[1], a[2], a[3]);
          *reinterpret_cast<float4*>(gs + row * d1 + c) = make_float4(sg[0], sg[1], sg[2], sg[3]);
        } else {
          *reinterpret_cast<uint2*>(ga + row * d1 + c) =
              make_uint2(pack_bf16x2(a[0], a[1]), pack_bf16x2(a[2], a[3]));
          *reinterpret_cast<uint2*>(gs + row * d1 + c) =
              make_uint2(pack_bf16x2(sg[0], sg[1]), pack_bf16x2(sg[2], sg[3]));
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) store8(buf + (c + q) * S + r0, v[q]);
}

// The inverse DFT of one run of 4 output columns c..c+3 for 8 rows:
//   acc[i][q] = sum_j I[kk * WM + j][r0 + i] * Si[j][m] + R[..] * Ci[j][m]
// (kk, m: the order and position of column c + q), j ascending, each step
// fmaf(imag, si, fmaf(real, ci, acc)). Where WM % 4 == 0 the run stays in
// one order and shares its loads; otherwise (only with kRagged) each column
// is summed on its own, in the same order. ci, si of the operand type T.
template <typename T, bool kRagged>
__device__ __forceinline__ void idft_fwd_run(const float* re, const float* im, int S,
                                             const T* __restrict__ ci,
                                             const T* __restrict__ si, int WM, int r0,
                                             int c, float (&acc)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
  if (kRagged) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int kk = (c + q) / WM, m = (c + q) % WM;
      const float* rk = re + kk * WM * S + r0;
      const float* ik = im + kk * WM * S + r0;
      for (int j = 0; j < WM; ++j) {
        const float wc = ldg1(ci + j * WM + m), ws = ldg1(si + j * WM + m);
        float u[8], v[8];
        load8(rk + j * S, u);
        load8(ik + j * S, v);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i][q] = fmaf(v[i], ws, fmaf(u[i], wc, acc[i][q]));
      }
    }
    return;
  }
  const int kk = c / WM, m0 = c % WM;
  const float* rk = re + kk * WM * S + r0;
  const float* ik = im + kk * WM * S + r0;
#pragma unroll 2
  for (int j = 0; j < WM; ++j) {
    float wc[4], ws[4], u[8], v[8];
    unpack4(ldg_vec4(ci + j * WM + m0), wc);
    unpack4(ldg_vec4(si + j * WM + m0), ws);
    load8(rk + j * S, u);
    load8(ik + j * S, v);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(v[i], ws[q], fmaf(u[i], wc[q], acc[i][q]));
  }
}

// One row tile (`tile` rows) of one chain (0 real, 1 imaginary): block x
// takes chain x % 2 of tile x / 2 (a grid's x takes 2^31 - 1 blocks, its y
// 65,535: `launch_chains`). acts: with kSave, 12 arrays [rows_pad, D1] (a0,
// s0, ..., a5, s5; GLU 2 * layer + chain), `plane` floats apart. out: with kOut, which
// needs the launch in clusters of 2 along x. kMaxThreads: kFMaxThreads,
// kFMidThreads or kFWideThreads, the least that holds the block; kRagged: for
// WM % 4 != 0. T: the operand type of x, the 2-D weights, ci and si.
template <typename T, int kMaxThreads, bool kSave, bool kOut, bool kRagged>
__global__ void __launch_bounds__(kMaxThreads, kMaxThreads == kFMaxThreads ? 3 : 1)
spectral_chain_kernel(const T* __restrict__ x, GluWeights<T> g,
                      const T* __restrict__ ci, const T* __restrict__ si,
                      float* __restrict__ out, float* __restrict__ acts, long plane,
                      long rows_pad, int tile, int B, int K, int N, int W, int WM) {
  extern __shared__ __align__(16) float smem[];
  const int d0 = K * W, d1 = K * WM, S = tile + 4;
  const long rows = (long)B * N;
  const int chain = blockIdx.x & 1;
  const long row0 = (long)(blockIdx.x >> 1) * tile;
  float* buf = smem;  // [d1][S]: x, then each GLU's output on this chain

  for (int e = threadIdx.x; e < tile * d0; e += blockDim.x) {
    const int r = e / d0, col = e % d0;
    const long row = row0 + r;
    float v = 0.f;
    if (row < rows) {
      const long b = row / N, n = row % N;
      v = to_f32(x[((b * K + col / W) * N + n) * W + col % W]);
    }
    buf[col * S + r] = v;
  }
  __syncthreads();

  // the tile of a d1-wide product: rows r0..r0+7, columns c..c+3
  const int runs = d1 / 4, groups = tile / 8;
  const bool live = (int)threadIdx.x < groups * runs;
  const int r0 = live ? (threadIdx.x / runs) * 8 : 0;
  const int c = 4 * (threadIdx.x % runs);
  float al[8][4], ar[8][4];
  for (int layer = 0; layer < 3; ++layer) {
    const int gi = 2 * layer + chain;
    if (live) glu_fwd_product(buf, S, layer == 0 ? d0 : d1, g.wl[gi], g.wr[gi], d1, r0, c, al, ar);
    __syncthreads();  // every read of this GLU's input is done
    if (live)
      glu_fwd_elementwise<T, kSave>(al, ar, g.bl[gi], g.br[gi], r0, c, row0, rows_pad, d1,
                                 kSave ? acts + (2 * gi) * plane : nullptr,
                                 kSave ? acts + (2 * gi + 1) * plane : nullptr, buf, S);
    __syncthreads();
  }

  if constexpr (kOut) {
    cg::cluster_group cluster = cg::this_cluster();
    float* other = buf + d1 * S;  // the other chain's last tile
    cluster.sync();               // both chains' last tiles are in place
    const float4* src = reinterpret_cast<const float4*>(cluster.map_shared_rank(buf, chain ^ 1));
    float4* dst = reinterpret_cast<float4*>(other);
    for (int e = threadIdx.x; e < d1 * S / 4; e += blockDim.x) dst[e] = src[e];
    cluster.sync();  // every copy is done: no block reads the other's buffer after this
    const float* re = chain == 0 ? buf : other;
    const float* im = chain == 0 ? other : buf;
    // this block's half of the output runs
    const int half = (runs + 1) / 2, first = chain * half;
    const int count = min(runs, first + half) - first;
    for (int t = threadIdx.x; t < groups * count; t += blockDim.x) {
      const int q0 = (t / count) * 8, cc = 4 * (first + t % count);
      float acc[8][4];
      idft_fwd_run<T, kRagged>(re, im, S, ci, si, WM, q0, cc, acc);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const long row = row0 + q0 + i;
        if (row >= rows) break;
        const long b = row / N, n = row % N;
        if (!kRagged) {
          *reinterpret_cast<float4*>(out + ((b * K + cc / WM) * N + n) * WM + cc % WM) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            out[((b * K + (cc + q) / WM) * N + n) * WM + (cc + q) % WM] = acc[i][q];
        }
      }
    }
  }
}

// ---- forward past D1 = 2048: the wide chain kernel ----
//
// Past D1 = 2048 an 8-row tile's chain block would need more than
// kFWideThreads threads (one a run of 4 columns). Here a thread takes the runs
// c, c + 4 * blockDim.x, ... of a GLU's output: a column loop. Its sums can
// then not wait in registers across the barrier that ends the reads of the
// GLU's input, so the block keeps two [D1][12] buffers and each GLU writes
// its output into the one it does not read. Every output element is the
// chain kernel's chain of fmaf in the same order, so both write the same
// bits. The two buffers sit in shared memory where they fit (96 D1 bytes: D1
// up to 2421) and else (kWs) in a device workspace, a part for each of
// wide_slots tile slots: a cluster of 2 (a block per chain) walks the row
// tiles blockIdx.y, blockIdx.y + gridDim.y, ... For the inverse DFT a block
// copies the other chain's last output into its free buffer, from the other
// block's shared memory or (kWs) from L2. The ragged inverse DFT (WM % 4 !=
// 0) is a branch, not an instantiation: it is a small part of the work here.
// TA: the storage type of acts (f32, or bf16 for the bf16-storage arm).
constexpr int kFWideTile = 8;

template <typename T, bool kSave, bool kOut, bool kWs, typename TA = float>
__global__ void __launch_bounds__(kFWideThreads, 1)
spectral_chain_wide_kernel(const T* __restrict__ x, GluWeights<T> g,
                           const T* __restrict__ ci, const T* __restrict__ si,
                           float* __restrict__ out, TA* __restrict__ acts, long plane,
                           long rows_pad, float* ws, int B, int K, int N, int W, int WM) {
  constexpr int tile = kFWideTile, S = tile + 4;
  extern __shared__ __align__(16) float smem[];
  const int d0 = K * W, d1 = K * WM, runs = d1 / 4;
  const long rows = (long)B * N, tiles = (rows_pad + tile - 1) / tile;
  const int chain = blockIdx.x;
  float* const buf = kWs ? ws + ((long)blockIdx.y * 2 + chain) * 2 * d1 * S : smem;
  float* const last = buf + d1 * S;  // the third GLU's output (layers alternate buffers)
  for (long ti = blockIdx.y; ti < tiles; ti += gridDim.y) {
    const long row0 = ti * tile;
    for (int e = threadIdx.x; e < tile * d0; e += blockDim.x) {
      const int r = e / d0, col = e % d0;
      const long row = row0 + r;
      float v = 0.f;
      if (row < rows) {
        const long b = row / N, n = row % N;
        v = to_f32(x[((b * K + col / W) * N + n) * W + col % W]);
      }
      buf[col * S + r] = v;
    }
    __syncthreads();
    for (int layer = 0; layer < 3; ++layer) {
      const int gi = 2 * layer + chain;
      const float* in = buf + (layer & 1) * d1 * S;
      float* next = buf + ((layer + 1) & 1) * d1 * S;
      for (int run = threadIdx.x; run < runs; run += blockDim.x) {
        float al[8][4], ar[8][4];
        glu_fwd_product(in, S, layer == 0 ? d0 : d1, g.wl[gi], g.wr[gi], d1, 0, 4 * run, al,
                        ar);
        glu_fwd_elementwise<T, kSave, TA>(al, ar, g.bl[gi], g.br[gi], 0, 4 * run, row0,
                                          rows_pad, d1, kSave ? acts + (2 * gi) * plane : nullptr,
                                          kSave ? acts + (2 * gi + 1) * plane : nullptr, next, S);
      }
      __syncthreads();
    }
    if constexpr (kOut) {
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();  // both chains' last outputs are in place
      float4* dst = reinterpret_cast<float4*>(buf);  // free since the third GLU's reads
      if (kWs) {
        const float4* src = reinterpret_cast<const float4*>(
            ws + ((long)blockIdx.y * 2 + (chain ^ 1)) * 2 * d1 * S + d1 * S);
        for (int e = threadIdx.x; e < d1 * S / 4; e += blockDim.x) dst[e] = __ldcg(src + e);
      } else {
        const float4* src = reinterpret_cast<const float4*>(cluster.map_shared_rank(last, chain ^ 1));
        for (int e = threadIdx.x; e < d1 * S / 4; e += blockDim.x) dst[e] = src[e];
      }
      cluster.sync();  // every copy is done: nobody reads the other block's buffers after this
      const float* re = chain == 0 ? last : buf;
      const float* im = chain == 0 ? buf : last;
      const bool ragged = WM % 4 != 0;
      const int half = (runs + 1) / 2, first = chain * half;
      const int count = min(runs, first + half) - first;
      for (int t = threadIdx.x; t < count; t += blockDim.x) {
        const int cc = 4 * (first + t);
        float acc[8][4];
        if (ragged) idft_fwd_run<T, true>(re, im, S, ci, si, WM, 0, cc, acc);
        else idft_fwd_run<T, false>(re, im, S, ci, si, WM, 0, cc, acc);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const long row = row0 + i;
          if (row >= rows) break;
          const long b = row / N, n = row % N;
          if (!ragged) {
            *reinterpret_cast<float4*>(out + ((b * K + cc / WM) * N + n) * WM + cc % WM) =
                make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q)
              out[((b * K + (cc + q) / WM) * N + n) * WM + (cc + q) % WM] = acc[i][q];
          }
        }
      }
      __syncthreads();  // the inverse DFT's reads are done before the next tile's x
    }
  }
}

// ---- backward ----

template <typename T>
struct TransposedWeights {
  const T* l[6];  // Wl^T of GLU i, [D1, Din] row-major
  const T* r[6];
};

// wT[c][k] = w[k][c] for the 12 weight matrices; blockIdx.y = 2 * GLU + side
template <typename T>
__global__ void spectral_transpose_kernel(GluWeights<T> g, T* __restrict__ wT, int d0,
                                          int d1) {
  const int m = blockIdx.y, gi = m / 2;
  const int din = gi < 2 ? d0 : d1;
  const T* w = (m % 2 == 0) ? g.wl[gi] : g.wr[gi];
  T* o = wT + (m < 4 ? (long)m * d0 * d1 : 4L * d0 * d1 + (long)(m - 4) * d1 * d1);
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= din * d1) return;
  const int k = e / d1, c = e % d1;
  o[(long)c * din + k] = w[e];
}

// ---- backward: the rows kernel ----
//
// One block per tile of kBR rows and one chain (blockIdx.y: 0 real, 1
// imaginary), so the 2 * ceil(rows / kBR) blocks fill the SMs three deep
// (374 at the flagship shapes, 53,760 bytes each). The tile's da and ds of
// the chain's current GLU live in shared memory, column-major [k][row]; a
// product's output stays in registers across the barrier that ends its reads,
// and the elementwise step writes the next da and ds from there. A thread
// owns a register tile of 8 rows by 8 columns (two runs of 4: the column
// group g and g + G), so a step of a product's sum brings 4 float4 of
// activations (broadcast) and 4 float4 of weights for 128 FMAs: 1 byte of
// shared memory or L1 an FMA (the one-column-a-thread kernel before it took
// 4). The weights come from L2 through L1, read by the tile's 3 row groups.
// Every output element is the same chain of fmaf as before, in the same order.
// Past D1 = 680 a 24-row tile's block would need more than kBWideThreads
// threads and its buffers more than a block's shared memory (2 * D1 * 28
// floats): there the kernel takes tiles of kBRN = 8 rows (one row group, D1 / 8
// threads, 2 * D1 * 12 floats: D1 up to 2048), instantiated apart. The
// column sums are per 8 rows whatever the tile, so the bias gradients'
// partials are the same.

constexpr int kBR = 24;           // rows of a block of the rows kernel
constexpr int kBRS = 28;          // floats between two columns of its [k][row] buffers
constexpr int kBMaxThreads = 96;  // 3 blocks an SM within the registers
constexpr int kBWideThreads = 256;  // D1 past 256: one block an SM
constexpr int kBRN = 8;           // rows of a tile past D1 = 680
constexpr int kBRNS = 12;         // floats between two columns of its buffers

// floats between two columns of the rows kernel's buffers for a tile of `rows`
__host__ __device__ constexpr int rows_stride(int rows) { return rows == kBR ? kBRS : kBRNS; }

// threads of a block of the rows kernel: rows / 8 row groups by (D1 / 4 + 1)
// / 2 column groups, in whole warps
__host__ __device__ inline int rows_threads(int d1, int rows) {
  return (rows / 8 * ((d1 / 4 + 1) / 2) + 31) / 32 * 32;
}

// the rows kernel's tile: 24 rows where its block fits kBWideThreads, else 8
inline int rows_tile(int d1) { return rows_threads(d1, kBR) <= kBWideThreads ? kBR : kBRN; }

// two float4 runs, `gap` floats apart
__device__ __forceinline__ void lds4x2(const float* p, int gap, float (&v)[8]) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + gap);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

// acc[i][4 * j4 + q] = sum_c da[c][r0 + i] * wl[c][c4[j4] + q]
//                          + ds[c][r0 + i] * wr[c][c4[j4] + q],  c < dmid
// (wl, wr: Wl^T, Wr^T [dmid][dout] row-major, of the operand type T; da, ds
// with S floats between columns).
template <typename T, int S, int TN>
__device__ __forceinline__ void glu_bwd_product(const float* da, const float* ds, int dmid,
                                                const T* __restrict__ wl,
                                                const T* __restrict__ wr, int dout,
                                                int r0, const int (&c4)[TN / 4],
                                                float (&acc)[8][TN]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  // the weights come from L2: loaded two steps of c ahead, in a ring of three
  constexpr int J4 = TN / 4;
  using V = typename Vec4<T>::type;
  V lw[3][J4], rw[3][J4];
  auto load_w = [&](int c, V (&l)[J4], V (&r)[J4]) {
    const int cc = min(c, dmid - 1);  // past the end: a load nobody uses
#pragma unroll
    for (int j4 = 0; j4 < J4; ++j4) {
      l[j4] = ldg_vec4(wl + (long)cc * dout + c4[j4]);
      r[j4] = ldg_vec4(wr + (long)cc * dout + c4[j4]);
    }
  };
  load_w(0, lw[0], rw[0]);
  load_w(1, lw[1], rw[1]);
  for (int c0 = 0; c0 < dmid; c0 += 3) {
#pragma unroll
    for (int u = 0; u < 3; ++u) {
      const int c = c0 + u;
      if (c >= dmid) break;
      load_w(c + 2, lw[(u + 2) % 3], rw[(u + 2) % 3]);
      float a[8], s[8], l[TN], r[TN];
      load8(da + c * S + r0, a);
      load8(ds + c * S + r0, s);
#pragma unroll
      for (int j4 = 0; j4 < J4; ++j4) {
        float lv[4], rv[4];
        unpack4(lw[u][j4], lv);
        unpack4(rw[u][j4], rv);
        l[4 * j4] = lv[0]; l[4 * j4 + 1] = lv[1]; l[4 * j4 + 2] = lv[2]; l[4 * j4 + 3] = lv[3];
        r[4 * j4] = rv[0]; r[4 * j4 + 1] = rv[1]; r[4 * j4 + 2] = rv[2]; r[4 * j4 + 3] = rv[3];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(s[i], r[j], fmaf(a[i], l[j], acc[i][j]));
    }
  }
}

// The inverse DFT backwards: acc[i][4 * j4 + q] = dR of column c4[j4] + q,
//   dR[r][c] = sum_m g[r][kk * WM + m] * Ci[m][c % WM], kk = c / WM
// (Ci symmetric; Si for the imaginary chain; of the operand type T). Where
// WM % 4 == 0 a run of 4 columns never leaves its order and shares its loads;
// otherwise (only with kRagged) each column is summed on its own, in the same
// order. gt: S floats between columns.
template <typename T, int S, bool kRagged>
__device__ __forceinline__ void idft_bwd_product(const float* gt, const T* __restrict__ idft,
                                                 int WM, int r0, const int (&c4)[2],
                                                 float (&acc)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  if (kRagged && WM % 4 != 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = c4[j / 4] + j % 4;
      const float* gj = gt + (c / WM) * WM * S + r0;
      const T* wj = idft + c % WM;
      for (int m = 0; m < WM; ++m) {
        float x[8];
        load8(gj + m * S, x);
        const float w = ldg1(wj + m * WM);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i][j] = fmaf(x[i], w, acc[i][j]);
      }
    }
    return;
  }
  const float* g0 = gt + (c4[0] / WM) * WM * S + r0;
  const float* g1 = gt + (c4[1] / WM) * WM * S + r0;
  const int j0 = c4[0] % WM, j1 = c4[1] % WM;
#pragma unroll 2
  for (int m = 0; m < WM; ++m) {
    float x0[8], x1[8], w0[4], w1[4];
    load8(g0 + m * S, x0);
    load8(g1 + m * S, x1);
    unpack4(ldg_vec4(idft + m * WM + j0), w0);
    unpack4(ldg_vec4(idft + m * WM + j1), w1);
    const float w[8] = {w0[0], w0[1], w0[2], w0[3], w1[0], w1[1], w1[2], w1[3]};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[i][q] = fmaf(x0[i], w[q], acc[i][q]);
        acc[i][4 + q] = fmaf(x1[i], w[4 + q], acc[i][4 + q]);
      }
    }
  }
}

// From the product dy of GLU gi's output in registers (the thread's tile):
//   da = dy * s, ds = dy * a * s * (1 - s)
// rounded to the operand type T (the operands of their products) to dacts
// (rows below rows_pad: the saved planes' rows) and to the shared da, ds (4
// rows of a column as one float4, S floats between columns), and the tile's
// column sums over its 8 rows of the unrounded values, in row order, to ba
// and bs (the bias gradients' partials). Without `two`, only the first run.
// a_g, s_g of the storage type TA (f32, or bf16: used as the rounded values).
template <typename T, int S, typename TA = float>
__device__ __forceinline__ void glu_bwd_elementwise(
    const float (&acc)[8][8], int r0, const int (&c4)[2], bool two, long row0, long rows_pad,
    int d1, const TA* __restrict__ a_g, const TA* __restrict__ s_g,
    float* __restrict__ da_g, float* __restrict__ ds_g, float* da, float* ds,
    float* __restrict__ ba, float* __restrict__ bs) {
#pragma unroll
  for (int j4 = 0; j4 < 2; ++j4) {
    if (j4 == 1 && !two) break;
    float sa[4] = {}, ss[4] = {};
#pragma unroll
    for (int h = 0; h < 8; h += 4) {  // 4 rows at a time
      float va[4][4], vs[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long row = row0 + r0 + h + i;
        const bool in = row < rows_pad;
        float a[4], s[4];
        if constexpr (std::is_same<TA, float>::value) {
          const float4 a4 = in ? ldg_vec4(a_g + row * d1 + c4[j4]) : make_float4(0.f, 0.f, 0.f, 0.f);
          const float4 s4 = in ? ldg_vec4(s_g + row * d1 + c4[j4]) : make_float4(0.f, 0.f, 0.f, 0.f);
          a[0] = a4.x; a[1] = a4.y; a[2] = a4.z; a[3] = a4.w;
          s[0] = s4.x; s[1] = s4.y; s[2] = s4.z; s[3] = s4.w;
        } else {
          ldg_act4(a_g + row * d1 + c4[j4], in, a);
          ldg_act4(s_g + row * d1 + c4[j4], in, s);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float v = acc[h + i][4 * j4 + q];
          va[i][q] = v * s[q];
          vs[i][q] = v * a[q] * (s[q] * (1.f - s[q]));
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          sa[q] += va[i][q];
          ss[q] += vs[i][q];
          va[i][q] = round_to<T>(va[i][q]);
          vs[i][q] = round_to<T>(vs[i][q]);
        }
        if (in) {
          *reinterpret_cast<float4*>(da_g + row * d1 + c4[j4]) =
              make_float4(va[i][0], va[i][1], va[i][2], va[i][3]);
          *reinterpret_cast<float4*>(ds_g + row * d1 + c4[j4]) =
              make_float4(vs[i][0], vs[i][1], vs[i][2], vs[i][3]);
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        *reinterpret_cast<float4*>(da + (c4[j4] + q) * S + r0 + h) =
            make_float4(va[0][q], va[1][q], va[2][q], va[3][q]);
        *reinterpret_cast<float4*>(ds + (c4[j4] + q) * S + r0 + h) =
            make_float4(vs[0][q], vs[1][q], vs[2][q], vs[3][q]);
      }
    }
    *reinterpret_cast<float4*>(ba + c4[j4]) = make_float4(sa[0], sa[1], sa[2], sa[3]);
    *reinterpret_cast<float4*>(bs + c4[j4]) = make_float4(ss[0], ss[1], ss[2], ss[3]);
  }
}

// One kRows-row tile of one chain: g -> dR (dI) -> the chain's three GLUs
// backwards -> the chain's part of dx, dxc [2][rows_pad][D0]; da, ds of the
// chain's GLUs to dacts (laid out like acts), and their column sums over
// each 8 rows to bpart [rows / 8][12][D1] (array 2 * GLU + side). Takes
// the shapes `shape_ok` passes; kRows: kBR, or kBRN past D1 = 680;
// kMaxThreads: kBMaxThreads, or kBWideThreads for the D1 that need more;
// kRagged: for D1 / 4 odd or WM % 4 != 0 (compiled into the flagship's
// instantiation, that code slowed the entry by 5% on an H100:
// `utils/kernel_variants.py`). T: the operand type of g, ci, si and the
// transposed weights.
template <typename T, int kRows, int kMaxThreads, bool kRagged>
__global__ void __launch_bounds__(kMaxThreads, kMaxThreads == kBMaxThreads ? 3 : 1)
spectral_bwd_rows_kernel(const T* __restrict__ g, const float* __restrict__ acts,
                         float* __restrict__ dacts, long plane, long rows_pad,
                         TransposedWeights<T> wt, const T* __restrict__ ci,
                         const T* __restrict__ si, float* __restrict__ dxc,
                         float* __restrict__ bpart, int B, int K, int N, int W, int WM) {
  constexpr int S = rows_stride(kRows), kG = kRows / 8;
  extern __shared__ __align__(16) float smem[];
  const int d0 = K * W, d1 = K * WM;
  const long rows = (long)B * N;
  const int chain = blockIdx.y;
  const long row0 = (long)blockIdx.x * kRows;
  float* da = smem;              // [d1][S]
  float* ds = da + d1 * S;       // [d1][S]

  for (int e = threadIdx.x; e < kRows * d1; e += blockDim.x) {
    const int r = e / d1, col = e % d1;
    const long row = row0 + r;
    float v = 0.f;
    if (row < rows) {
      const long b = row / N, n = row % N;
      v = to_f32(g[((b * K + col / WM) * N + n) * WM + col % WM]);
    }
    da[col * S + r] = v;  // the cotangent tile, until da is first written
  }
  __syncthreads();

  // the tile of a d1-wide product: rows r0..r0+7, the runs of 4 columns gc
  // and gc + G; where D1 / 4 is odd the last group has no second run, and
  // computes its first one twice and keeps one
  const int runs = d1 / 4, G = (runs + 1) / 2;
  const bool live = (int)threadIdx.x < kG * G;
  const int r0 = live ? (threadIdx.x / G) * 8 : 0;
  const int gc = threadIdx.x % G;
  const bool two = !kRagged || gc + G < runs;
  const int c4[2] = {4 * gc, 4 * (two ? gc + G : gc)};
  float acc[8][8];
  if (live) idft_bwd_product<T, S, kRagged>(da, chain == 0 ? ci : si, WM, r0, c4, acc);
  __syncthreads();  // every read of the cotangent tile is done

  for (int layer = 2; layer >= 0; --layer) {
    const int gi = 2 * layer + chain;
    if (live) {
      float* b = bpart + ((long)(blockIdx.x * kG + r0 / 8) * 12 + 2 * gi) * d1;
      glu_bwd_elementwise<T, S>(acc, r0, c4, two, row0, rows_pad, d1,
                                acts + (2 * gi) * plane, acts + (2 * gi + 1) * plane,
                                dacts + (2 * gi) * plane, dacts + (2 * gi + 1) * plane, da,
                                ds, b, b + d1);
    }
    __syncthreads();
    if (layer > 0) {
      if (live) glu_bwd_product<T, S, 8>(da, ds, d1, wt.l[gi], wt.r[gi], d1, r0, c4, acc);
      __syncthreads();  // every read of da, ds is done before they are rewritten
    } else {
      // into the input space: D0 columns, runs of 4
      const int G0 = d0 / 4;
      for (int t = threadIdx.x; t < kG * G0; t += blockDim.x) {
        const int q0 = (t / G0) * 8;
        const int cx[1] = {4 * (t % G0)};
        float out[8][4];
        glu_bwd_product<T, S, 4>(da, ds, d1, wt.l[gi], wt.r[gi], d0, q0, cx, out);
        float* dst = dxc + chain * rows_pad * d0;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const long row = row0 + q0 + i;
          if (row < rows_pad)
            *reinterpret_cast<float4*>(dst + row * d0 + cx[0]) =
                make_float4(out[i][0], out[i][1], out[i][2], out[i][3]);
        }
      }
    }
  }
}

// ---- backward past D1 = 2048: the wide rows kernel ----
//
// Past D1 = 2048 an 8-row tile's block would need more than kBWideThreads
// threads (one for two runs of 4 columns). Here a thread takes the column
// groups gc, gc + blockDim.x, ...: a column loop. Its sums can then not wait
// in registers across a barrier, so each product's output goes to a third
// [D1][12] buffer, dy, which the elementwise step reads after the barrier
// (the cotangent tile starts there). The three buffers (144 D1 bytes, more
// than a block's shared memory past D1 = 1614) sit in a device workspace, a
// part for each of wide_slots tile slots, walked as the wide chain kernel
// walks them. Every output element is the rows kernel's chain of fmaf in the
// same order, and the bias partials are per 8 rows as there. g of the type Tg
// (the bf16 arm: f32, rounded to bf16 as it is staged); acts of the storage
// type TA (f32, or bf16 for the bf16-storage arm).
template <typename T, typename Tg, bool kRagged, typename TA = float>
__global__ void __launch_bounds__(kBWideThreads, 1)
spectral_bwd_rows_wide_kernel(const Tg* __restrict__ g, const TA* __restrict__ acts,
                              float* __restrict__ dacts, long plane, long rows_pad,
                              TransposedWeights<T> wt, const T* __restrict__ ci,
                              const T* __restrict__ si, float* __restrict__ dxc,
                              float* __restrict__ bpart, float* ws, int B, int K, int N, int W,
                              int WM) {
  constexpr int kRows = kBRN, S = kBRNS;
  const int d0 = K * W, d1 = K * WM;
  const long rows = (long)B * N, tiles = (rows_pad + kRows - 1) / kRows;
  const int chain = blockIdx.y;
  float* const da = ws + ((long)blockIdx.x * 2 + chain) * 3 * d1 * S;  // [d1][S]
  float* const ds = da + d1 * S;                                        // [d1][S]
  float* const dy = ds + d1 * S;  // [d1][S]: the cotangent tile, then each product's output
  const int runs = d1 / 4, G = (runs + 1) / 2;
  for (long ti = blockIdx.x; ti < tiles; ti += gridDim.x) {
    const long row0 = ti * kRows;
    for (int e = threadIdx.x; e < kRows * d1; e += blockDim.x) {
      const int r = e / d1, col = e % d1;
      const long row = row0 + r;
      float v = 0.f;
      if (row < rows) {
        const long b = row / N, n = row % N;
        v = round_to<T>(to_f32(g[((b * K + col / WM) * N + n) * WM + col % WM]));
      }
      dy[col * S + r] = v;
    }
    __syncthreads();

    for (int layer = 2; layer >= 0; --layer) {
      const int gi = 2 * layer + chain;
      float* b = bpart + (ti * 12 + 2 * gi) * d1;
      for (int gc = threadIdx.x; gc < G; gc += blockDim.x) {
        const bool two = !kRagged || gc + G < runs;
        const int c4[2] = {4 * gc, 4 * (two ? gc + G : gc)};
        float acc[8][8];
        if (layer == 2) {
          idft_bwd_product<T, S, kRagged>(dy, chain == 0 ? ci : si, WM, 0, c4, acc);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            float v[8];
            load8(dy + (c4[j / 4] + j % 4) * S, v);
#pragma unroll
            for (int i = 0; i < 8; ++i) acc[i][j] = v[i];
          }
        }
        glu_bwd_elementwise<T, S, TA>(acc, 0, c4, two, row0, rows_pad, d1,
                                      acts + (2 * gi) * plane, acts + (2 * gi + 1) * plane,
                                      dacts + (2 * gi) * plane, dacts + (2 * gi + 1) * plane, da,
                                      ds, b, b + d1);
      }
      __syncthreads();  // da, ds of the GLU are complete; dy's reads are done
      if (layer > 0) {
        for (int gc = threadIdx.x; gc < G; gc += blockDim.x) {
          const bool two = !kRagged || gc + G < runs;
          const int c4[2] = {4 * gc, 4 * (two ? gc + G : gc)};
          float acc[8][8];
          glu_bwd_product<T, S, 8>(da, ds, d1, wt.l[gi], wt.r[gi], d1, 0, c4, acc);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (j >= 4 && !two) break;
            float v[8];
#pragma unroll
            for (int i = 0; i < 8; ++i) v[i] = acc[i][j];
            store8(dy + (c4[j / 4] + j % 4) * S, v);
          }
        }
      } else {
        // into the input space: D0 columns, runs of 4
        const int G0 = d0 / 4;
        for (int t = threadIdx.x; t < G0; t += blockDim.x) {
          const int cx[1] = {4 * t};
          float o[8][4];
          glu_bwd_product<T, S, 4>(da, ds, d1, wt.l[gi], wt.r[gi], d0, 0, cx, o);
          float* dst = dxc + chain * rows_pad * d0;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const long row = row0 + i;
            if (row < rows_pad)
              *reinterpret_cast<float4*>(dst + row * d0 + cx[0]) =
                  make_float4(o[i][0], o[i][1], o[i][2], o[i][3]);
          }
        }
      }
      __syncthreads();  // the products' reads of da, ds are done before they are rewritten
    }
  }
}

// dx [B,K,N,W] = real chain's part + imaginary chain's part
__global__ void spectral_dx_kernel(const float* __restrict__ dxc, float* __restrict__ dx,
                                   long rows_pad, int B, int K, int N, int W) {
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long total = (long)B * K * N * W;
  if (e >= total) return;
  const int w = e % W;
  const long n = (e / W) % N;
  const int kk = (e / ((long)W * N)) % K;
  const long b = e / ((long)W * N * K);
  const long i = (b * N + n) * (K * W) + kk * W + w;
  dx[e] = dxc[i] + dxc[rows_pad * K * W + i];
}

// ---- backward: the weight gradients ----
//
// A block owns a [48, D1] tile of dWl and dWr of one GLU (the k rows k0 to
// k0 + 47 of its input; D1 past kWC: a tile of kWC columns) for one of
// `nsplit` row segments, and writes its partial sums; a thread owns 8 k by 8
// columns of both (128 sums; the columns two runs of 4, g and g + CG of the
// tile's runs, so the float4 reads of a quarter warp cover 128 consecutive
// bytes), and a row brings 6 float4 for 128 FMAs (0.75 bytes an FMA). Rows
// come in stages of kWRC by cp.async, two stages in flight while one is
// summed; u is x (layer 0) or a * s of the GLU before, its product taken as a
// row is read (and rounded to the operand type T, as the forward rounded it
// for its product). The bias gradients, column sums of da and ds, are the rows
// kernel's partials added by `spectral_bias_kernel`.

// floats of GLU gi's block in the flat gradient buffer: wl, bl, wr, br
__host__ __device__ inline long glu_grad_offset(int gi, int d0, int d1) {
  const long s0 = 2L * ((long)d0 * d1 + d1), s1 = 2L * ((long)d1 * d1 + d1);
  return gi < 2 ? gi * s0 : 2 * s0 + (gi - 2) * s1;
}

constexpr int kWK = 48;      // k rows of a weight-gradient tile
constexpr int kWC = 256;     // columns of a weight-gradient tile, at most
constexpr int kWRC = 16;     // rows a stage
constexpr int kWMaxThreads = 192;

// blockIdx: x = k tile * column tiles + column tile, y = GLU, z = row
// segment. part: [gridDim.z][total] partial gradients in the flat layout. x
// of the operand type T (bf16: read through registers, not cp.async, into the
// f32 stage); acts of the storage type TA (bf16: the same, converted).
template <typename T, typename TA = float>
__global__ void __launch_bounds__(kWMaxThreads, 2)
spectral_wgrad_kernel(const T* __restrict__ x, const TA* __restrict__ acts,
                      const float* __restrict__ dacts, long plane,
                      float* __restrict__ part, long total, int chunks, int chunks_per_seg,
                      int B, int K, int N, int W, int WM) {
  extern __shared__ __align__(16) float smem[];
  const int d0 = K * W, d1 = K * WM;
  const int gi = blockIdx.y;
  const int din = gi < 2 ? d0 : d1;
  const int ctiles = (d1 + kWC - 1) / kWC, cw = min(d1, kWC);
  const int k0 = blockIdx.x / ctiles * kWK, c0 = blockIdx.x % ctiles * kWC;
  if (k0 >= din) return;  // the whole block: layer 0 has fewer k tiles
  const int kw = min(kWK, din - k0), cn = min(kWC, d1 - c0);
  const long rows = (long)B * N;
  const int stage = kWRC * (2 * kWK + 2 * cw);
  const TA* a_src = gi < 2 ? nullptr : acts + (2 * (gi - 2)) * plane;
  const TA* s_src = gi < 2 ? nullptr : acts + (2 * (gi - 2) + 1) * plane;
  const float* da_src = dacts + (2 * gi) * plane;
  const float* ds_src = dacts + (2 * gi + 1) * plane;

  // stage st: us [kWRC][kWK], ss [kWRC][kWK], das [kWRC][cw], dss [kWRC][cw]
  const int k4 = kw / 4, c4 = cn / 4;
  // this thread's first (row, run of 4 columns) of da and ds, and its step
  const int dr0 = threadIdx.x / c4, dc0 = threadIdx.x % c4;
  const int drs = blockDim.x / c4, dcs = blockDim.x % c4;
  auto issue = [&](int ch, int st) {
    float* us = smem + st * stage;
    float* ss = us + kWRC * kWK;
    float* das = ss + kWRC * kWK;
    float* dss = das + kWRC * cw;
    const long r0 = (long)ch * kWRC;
    for (int e = threadIdx.x; e < kWRC * k4; e += blockDim.x) {
      const int r = e / k4, k = k0 + 4 * (e % k4);
      const long row = r0 + r;
      float* du = us + r * kWK + k - k0;
      if (gi < 2) {
        if (row >= rows) {
          *reinterpret_cast<float4*>(du) = make_float4(0.f, 0.f, 0.f, 0.f);
        } else if constexpr (sizeof(T) == 2) {
          const long b = row / N, n = row % N;
          for (int q = 0; q < 4; ++q)
            du[q] = to_f32(x[((b * K + (k + q) / W) * N + n) * W + (k + q) % W]);
        } else if (W % 4 == 0) {  // the run stays in one order's window
          const long b = row / N, n = row % N;
          cp_async16(du, x + ((b * K + k / W) * N + n) * W + k % W);
        } else {
          const long b = row / N, n = row % N;
          for (int q = 0; q < 4; ++q)
            cp_async4(du + q, x + ((b * K + (k + q) / W) * N + n) * W + (k + q) % W);
        }
      } else if constexpr (std::is_same<TA, float>::value) {
        cp_async16(du, a_src + row * d1 + k);
        cp_async16(ss + r * kWK + k - k0, s_src + row * d1 + k);
      } else {
        float v[4];
        unpack4(ldg_vec4(a_src + row * d1 + k), v);
        *reinterpret_cast<float4*>(du) = make_float4(v[0], v[1], v[2], v[3]);
        unpack4(ldg_vec4(s_src + row * d1 + k), v);
        *reinterpret_cast<float4*>(ss + r * kWK + k - k0) = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
    for (int r = dr0, c = dc0; r < kWRC;) {
      const long src = (r0 + r) * d1 + c0 + 4 * c;
      cp_async16(das + r * cw + 4 * c, da_src + src);
      cp_async16(dss + r * cw + 4 * c, ds_src + src);
      r += drs;
      c += dcs;
      if (c >= c4) {
        c -= c4;
        ++r;
      }
    }
  };

  // a thread's runs of 4 columns: cg and cg + CG of the tile's, the second
  // only where the tile has 2 CG runs (else the first is read twice and kept
  // once); its k rows: 8 kg to 8 kg + 7 of the tile, those past kw unused
  const int runs = cn / 4, CG = (runs + 1) / 2;
  const bool live = (int)threadIdx.x < (kw + 7) / 8 * CG;
  const int kg = live ? threadIdx.x / CG : 0, cg = threadIdx.x % CG;
  const bool two = cg + CG < runs;
  const int gap = two ? 4 * CG : 0;
  float accl[8][8] = {}, accr[8][8] = {};
  const int ch0 = blockIdx.z * chunks_per_seg;
  const int ch1 = min(chunks, ch0 + chunks_per_seg);
  // a ring of three stages, two in flight: the stage a chunk's loads refill
  // was last read a chunk before, by threads that have all passed this
  // chunk's barrier since, so one barrier a chunk does
  if (ch0 < ch1) issue(ch0, 0);
  cp_async_commit();
  if (ch0 + 1 < ch1) issue(ch0 + 1, 1);
  cp_async_commit();
  for (int ch = ch0; ch < ch1; ++ch) {
    cp_async_wait_group<1>();
    __syncthreads();
    if (ch + 2 < ch1) issue(ch + 2, (ch - ch0 + 2) % 3);
    cp_async_commit();
    const float* us = smem + ((ch - ch0) % 3) * stage;
    const float* ss = us + kWRC * kWK;
    const float* das = ss + kWRC * kWK;
    const float* dss = das + kWRC * cw;
    if (live) {
#pragma unroll 2
      for (int r = 0; r < kWRC; ++r) {
        float u[8], a[8], s[8];
        load8(us + r * kWK + 8 * kg, u);
        if (gi >= 2) {  // u = a * s of the GLU before
          float sv[8];
          load8(ss + r * kWK + 8 * kg, sv);
#pragma unroll
          for (int i = 0; i < 8; ++i) u[i] = round_to<T>(u[i] * sv[i]);
        }
        lds4x2(das + r * cw + 4 * cg, gap, a);
        lds4x2(dss + r * cw + 4 * cg, gap, s);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            accl[i][j] = fmaf(u[i], a[j], accl[i][j]);
            accr[i][j] = fmaf(u[i], s[j], accr[i][j]);
          }
        }
      }
    }
  }
  if (!live) return;
  float* base = part + (long)blockIdx.z * total + glu_grad_offset(gi, d0, d1);
  float* pwl = base;
  float* pwr = pwl + (long)din * d1 + d1;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long k = k0 + 8 * kg + i;
    if (k >= din) break;
#pragma unroll
    for (int j4 = 0; j4 < 2; ++j4) {
      if (j4 == 1 && !two) break;
      const int c = c0 + 4 * (cg + j4 * CG);
      *reinterpret_cast<float4*>(pwl + k * d1 + c) = make_float4(
          accl[i][4 * j4], accl[i][4 * j4 + 1], accl[i][4 * j4 + 2], accl[i][4 * j4 + 3]);
      *reinterpret_cast<float4*>(pwr + k * d1 + c) = make_float4(
          accr[i][4 * j4], accr[i][4 * j4 + 1], accr[i][4 * j4 + 2], accr[i][4 * j4 + 3]);
    }
  }
}

// The bias gradients into their slots of grads: blockIdx.x = 2 * GLU + side
// (da: bl, ds: br), blockIdx.y = a run of 32 columns; the column sums the rows
// kernel left per 8 rows (bpart, `parts` of them), added in a fixed order:
// lane q of a column takes parts q, q + kBiasLanes, ... in order, then a fixed
// tree over the lanes.
constexpr int kBiasLanes = 16;

__global__ void __launch_bounds__(32 * kBiasLanes)
spectral_bias_kernel(const float* __restrict__ bpart, float* __restrict__ grads, int parts,
                     int d0, int d1) {
  __shared__ float lane_sum[kBiasLanes][33];
  const int m = blockIdx.x, gi = m / 2, side = m % 2;
  const int din = gi < 2 ? d0 : d1;
  const int c = blockIdx.y * 32 + threadIdx.x, q = threadIdx.y;
  float acc = 0.f;
  if (c < d1) {
#pragma unroll 4
    for (int p = q; p < parts; p += kBiasLanes) acc += bpart[((long)p * 12 + m) * d1 + c];
  }
  lane_sum[q][threadIdx.x] = acc;
  __syncthreads();
  for (int half = kBiasLanes / 2; half >= 1; half /= 2) {
    if (q < half) lane_sum[q][threadIdx.x] += lane_sum[q + half][threadIdx.x];
    __syncthreads();
  }
  if (q == 0 && c < d1)
    grads[glu_grad_offset(gi, d0, d1) + (side == 0 ? (long)din * d1 : 2L * din * d1 + d1) +
          c] = lane_sum[0][threadIdx.x];
}

// True for the bias slots of the flat gradient buffer (wl, bl, wr, br per GLU).
__device__ __forceinline__ bool is_bias_slot(long i, int d0, int d1) {
  const long s0 = 2L * ((long)d0 * d1 + d1), s1 = 2L * ((long)d1 * d1 + d1);
  const long off = i < 2 * s0 ? i % s0 : (i - 2 * s0) % s1;
  const long w = (long)(i < 2 * s0 ? d0 : d1) * d1;
  return (off >= w && off < w + d1) || off >= 2 * w + d1;
}

// grads[i] = part[0][i] + part[1][i] + ... in that order, for the weight
// slots (the bias slots are `spectral_bias_kernel`'s)
__global__ void spectral_reduce_kernel(const float* __restrict__ part,
                                       float* __restrict__ grads, long total, int nsplit,
                                       int d0, int d1) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total || is_bias_slot(i, d0, d1)) return;
  float acc = part[i];
  for (int s = 1; s < nsplit; ++s) acc += part[(long)s * total + i];
  grads[i] = acc;
}

// ---- tensor-core helpers of the bf16 kernels (D1 up to kMmaMaxD1) ----
//
// Every operand of every product of the bf16 arm is a bf16 value, so
// Hopper's bf16 x bf16 -> f32 tensor-core products compute the scalar
// kernels' exact products; only the order of the f32 sums differs. The chain
// forward runs on mma.sync (below; mma_bf16 and the ldmatrix loads are in
// device_utils.cuh), the backward on mma.sync and wgmma fed by TMA
// (`bwd_tc_launch`, after the forward).
constexpr int kMmaMaxD1 = 2048;

// ---- the bf16 chain forward on tensor cores (D1 up to kMmaMaxD1) ----
//
// `spectral_chain_mma_kernel` runs every bf16 chain up to D1 = kMmaMaxD1:
// `spectral_fwd_bf16` (kOut), `spectral_fwd_save_bf16` (kSave and kOut) and
// step 2 of `spectral_bwd_bf16` (kSave). Its operands are bf16 values (x, the
// folded weights and the inverse DFT's block as the caller hands them, each
// GLU's input round(a * s)), so mma.sync bf16 x bf16 -> f32 computes the
// scalar kernel's exact products; only the order of the f32 sums differs (k
// ascending in steps of 16). A block per row tile of 16 MT rows and chain (a
// cluster of 2 with kOut), on the plan of ops/cuda_spectral.py
// `fwd_mma_plan`:
//   * two bf16 [TM][k] buffers: a GLU's products read one and its epilogue
//     writes round(a * s) into the other, so no sum waits across a barrier
//     and a warp may take its columns in passes (D1 past the block's columns);
//   * a weight's [Din][D1] rows are the `.row` B operand, which mma.sync does
//     not take: panels of kp k rows (16 to 64, the deepest the block's shared
//     memory holds: fewer barriers a GLU) of Wl and Wr over the pass's
//     columns come into a ring of `stages` shared stages by cp.async, all but
//     one in flight, and ldmatrix.trans turns them into B fragments. The
//     panels of the three GLUs are one stream (the next GLU's first panels
//     land while this one's last are summed); a step waits for its panel,
//     passes the block's one barrier, sums, and only then starts the copy of
//     a later panel, its addresses walked without a division;
//   * warp w owns NT n8 column tiles of a pass, both sums of each (u @ Wl and
//     u @ Wr: 8 MT NT accumulators); the epilogue takes a = acc_l + bl and
//     s = sigmoid(acc_r + br) in f32 (the exponential and the division of
//     the fast intrinsics), writes them with kSave (the f32 planes the
//     backward reads, as streaming stores: 51.6 MB at the flagship, more than
//     L2 holds) and round(a * s) into the other buffer;
//   * the bf16-storage arm (TA = bf16) stages each GLU's a and s of the tile,
//     rounded, in shared memory as the planes lay them out ([rows][D1]: the
//     tile's rows are one contiguous run of a plane) and writes each with one
//     TMA bulk store (cp.async.bulk) after the GLU's last pass, while the next
//     GLU's products run; the next epilogue waits for the store's reads of the
//     staging before it writes there. Where the staging does not fit beside
//     the plan's buffers (`stage_acts` 0: D1 past about a thousand) each lane
//     stores its pairs itself, cached in L2 only;
//   * with kOut the two blocks of a row tile join as the scalar kernel's do:
//     each copies the other chain's last buffer through distributed shared
//     memory and computes half of the output's n8 tiles as one product over
//     the k of their orders' windows, R @ Ci, then I @ Si into the same sums,
//     its block-diagonal B built from the [WM][WM] block (Ci, Si symmetric).
// Rows past B*N are x = 0: the chain's values for an all-zero input row, as
// the saved rows up to rows_pad must hold. The saving forward and the
// recompute run the same code for a and s, and an element's sum does not
// depend on the tile, so the reread backward stays bitwise the recompute
// backward. Bound: bytes with kSave (the 12 f32 planes written), else bf16
// tensor-core operations.
constexpr int kFIdftNT = 2;    // n8 tiles a warp takes at a time in the inverse DFT

// bf16 elements between two rows of the forward's buffers and panels: `cols`
// rounded up to 16, then to 16 bytes past a multiple of 128, so that the 8
// rows of 16 bytes an ldmatrix reads fall on distinct banks
__host__ __device__ constexpr int ldsm_stride(int cols) {
  return ((cols + 15) / 16 * 16 + 55) / 64 * 64 + 8;
}

// the most threads a block of the forward mma kernel of MT 16-row tiles has
// (320 for MT = 5: 168 registers a thread, as three of its ten warps share a
// quarter of the SM's registers; its 120 sums fit with a few spilled bytes)
__host__ __device__ constexpr int chain_mma_bound(int mt) { return mt >= 5 ? 320 : 512; }

// bytes of shared memory of a forward mma block: two buffers of tm rows and
// `stages` panels of both weights' kp k rows over pw columns
__host__ __device__ inline int chain_mma_smem(int tm, int d1, int pw, int kp, int stages) {
  return (2 * tm * ldsm_stride(d1) + stages * 2 * kp * ldsm_stride(pw)) * (int)sizeof(bf16);
}

// two 8 x 8 bf16 matrices of shared memory, transposed (lanes 0-15 give the
// addresses; four: device_utils.cuh ldsm_x4_trans)
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a)
               : "memory");
}

// The forward's inverse DFT on the warp's NT n8 tiles from column n0:
// acc = R @ Ci over the k of their orders' windows, then + I @ Si, k
// ascending in steps of 16; B[k][n] = Ci[n % WM][k % WM] where k and n lie in
// one order's window (Ci symmetric), else 0. re, im: [TM][S] shared buffers.
template <int MT, int NT>
__device__ __forceinline__ void idft_fwd_mma(const bf16* re, const bf16* im, int S,
                                             const bf16* __restrict__ ci,
                                             const bf16* __restrict__ si, int WM, int d1,
                                             int n0, float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  const int lane = threadIdx.x % 32, gq = lane / 4, tq = lane % 4, mrow = lane % 8, mat = lane / 8;
  const int last = min(d1, n0 + 8 * NT) - 1;
  const int kb = n0 / WM * WM / 16 * 16;
  const int ke = min((d1 + 15) / 16 * 16, ((last / WM + 1) * WM + 15) / 16 * 16);
  int lo[NT], off[NT];  // each column's window start (past every k: none), its row of the block
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int n = n0 + 8 * nt + gq;
    lo[nt] = n < d1 ? n / WM * WM : INT_MAX / 2;
    off[nt] = n < d1 ? (n % WM) * WM : 0;
  }
#pragma unroll
  for (int part = 0; part < 2; ++part) {
    const bf16* a_src = part == 0 ? re : im;
    const bf16* blk = part == 0 ? ci : si;
#pragma unroll 2
    for (int k = kb; k < ke; k += 16) {
      uint32_t b[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          unsigned v[2];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int j = k + 8 * h + 2 * tq + q - lo[nt];
            v[q] = j >= 0 && j < WM ? __bfloat16_as_ushort(blk[off[nt] + j]) : 0u;
          }
          b[nt][h] = v[0] | v[1] << 16;
        }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4];
        ldsm_x4(a, a_src + (16 * mt + (mat & 1) * 8 + mrow) * S + k + (mat >> 1) * 8);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], a, b[nt][0], b[nt][1]);
      }
    }
  }
}

// One tile of 16 MT rows of one chain (0 real, 1 imaginary; block x takes
// chain x % 2 of tile x / 2, as the f32 chain kernel): x (bf16 [B,K,N,W]) ->
// the chain's three GLUs -> with kOut, in clusters of 2 along x, the output
// (f32 [B,K,N,WM]); with kSave a and s of the chain's GLUs to acts (12 planes
// [rows_pad][D1], `plane` elements apart, of the storage type TA: f32, or
// bf16 rounded from the same f32 values).
// blockDim.x: 32 per NT n8 tiles of a column pass; kp: k rows of a weight
// panel (a multiple of 16), `stages` of them in the ring; stage_acts (bf16
// planes only): the planes go through the shared staging by bulk stores.
template <int MT, int NT, bool kSave, bool kOut, typename TA = float>
__global__ void __launch_bounds__(chain_mma_bound(MT), 1)
spectral_chain_mma_kernel(const bf16* __restrict__ x, GluWeights<bf16> g,
                          const bf16* __restrict__ ci, const bf16* __restrict__ si,
                          float* __restrict__ out, TA* __restrict__ acts, long plane,
                          long rows_pad, int kp, int stages, int stage_acts, int B, int K,
                          int N, int W, int WM) {
  constexpr int TM = 16 * MT;
  extern __shared__ __align__(16) float smem[];
  const int d0 = K * W, d1 = K * WM, S = ldsm_stride(d1);
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4, mrow = lane % 8, mat = lane / 8;
  const int pw = warps * NT * 8, pws = ldsm_stride(pw), passes = (d1 + pw - 1) / pw;
  bf16* const buf0 = reinterpret_cast<bf16*>(smem);  // [TM][S]: x, then GLU 1's output
  bf16* const buf1 = buf0 + TM * S;                  // [TM][S]: GLU 0's, then GLU 2's
  bf16* const panels = buf1 + TM * S;                // [stages][2][kp][pws]: Wl's, Wr's rows
  // the bf16 planes' staging, [2][TM][d1]: a, then s (bf16 storage with stage_acts)
  constexpr bool kBulk = kSave && !std::is_same<TA, float>::value;
  bf16* const stg = panels + stages * 2 * kp * pws;
  const long rows = (long)B * N;
  const int chain = blockIdx.x & 1;
  const long row0 = (long)(blockIdx.x >> 1) * TM;
  const bf16 zero = __float2bfloat16_rn(0.f);

  // x, a row a warp at a time (each order's W values of a row are contiguous
  // in x), and zeros in the columns past what each buffer's writers fill,
  // which the last k step of a product reads
  for (int r = warp; r < TM; r += warps) {
    const long row = row0 + r;
    const bool live = row < rows;
    const bf16* xr = x + (live ? (row / N * K * N + row % N) * W : 0);
    for (int kk = 0; kk < K; ++kk)
      for (int m = lane; m < W; m += 32)
        buf0[r * S + kk * W + m] = live ? xr[(long)kk * N * W + m] : zero;
    for (int c = d0 + 2 * lane; c < S; c += 64)
      *reinterpret_cast<uint32_t*>(buf0 + r * S + c) = 0u;
    for (int c = d1 + 2 * lane; c < S; c += 64)
      *reinterpret_cast<uint32_t*>(buf1 + r * S + c) = 0u;
  }

  // the panels of GLUs 0, 1, 2 of the chain, each pass's k steps in order,
  // panel i into stage i % stages: rows past the GLU's input zeros, columns
  // past D1 left as they are (they reach only the sums of dead columns)
  const int units = pw / (d1 % 8 == 0 ? 8 : 4);  // 16-byte copies where the weight
  const bool vec16 = d1 % 8 == 0;                  // rows are 16-byte aligned, else 8
  const int unit = vec16 ? 8 : 4;
  const int line0 = threadIdx.x / units, u0 = threadIdx.x % units;  // this thread's first copy
  const int dl = blockDim.x / units, du = blockDim.x % units;        // and its step
  int c_layer = 0, c_pass = 0, c_k = 0, c_slot = 0;                 // the next panel to copy
  auto load_panel = [&]() {
    if (c_layer < 3) {
      const int din = c_layer == 0 ? d0 : d1, gi = 2 * c_layer + chain, c0 = c_pass * pw;
      const bf16* wl = g.wl[gi] + c0;
      const bf16* wr = g.wr[gi] + c0;
      bf16* const dst = panels + c_slot * 2 * kp * pws;
      for (int line = line0, u = u0; line < 2 * kp;) {  // line: side * kp + row
        const int k = c_k + (line < kp ? line : line - kp), c = u * unit;
        bf16* d = dst + line * pws + c;
        if (k >= din) {
          if (vec16) *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
          else *reinterpret_cast<uint2*>(d) = make_uint2(0u, 0u);
        } else if (c0 + c < d1) {
          const bf16* src = (line < kp ? wl : wr) + (long)k * d1 + c;
          if (vec16) cp_async16(d, src);
          else cp_async8(d, src);
        }
        line += dl;
        u += du;
        if (u >= units) {
          u -= units;
          ++line;
        }
      }
      if ((c_k += kp) >= din) {
        c_k = 0;
        if (++c_pass == passes) {
          c_pass = 0;
          ++c_layer;
        }
      }
    }
    if (++c_slot == stages) c_slot = 0;
  };
  for (int i = 0; i + 1 < stages; ++i) {
    load_panel();
    cp_async_commit();
  }

  int slot = 0;  // the stage of the panel being summed
  for (int layer = 0; layer < 3; ++layer) {
    const int gi = 2 * layer + chain, din = layer == 0 ? d0 : d1;
    const bf16* in = layer == 1 ? buf1 : buf0;
    bf16* nxt = layer == 1 ? buf0 : buf1;
    for (int p = 0; p < passes; ++p) {
      const int n0 = p * pw + warp * NT * 8;  // the warp's first column
      const bool busy = n0 < d1;
      float accl[MT][NT][4], accr[MT][NT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) accl[mt][nt][e] = accr[mt][nt][e] = 0.f;
      for (int k0 = 0; k0 < din; k0 += kp) {
        if (stages == 4) cp_async_wait_group<2>();
        else if (stages == 3) cp_async_wait_group<1>();
        else cp_async_wait_group<0>();
        __syncthreads();  // the panel is in; every read of the stage the next copy fills is done
        if (busy) {
          const bf16* pl = panels + slot * 2 * kp * pws + warp * NT * 8;
          const bf16* pr = pl + kp * pws;
          for (int sub = 0; sub < kp && k0 + sub < din; sub += 16) {
            // B fragments: (k 0-7, tile np), (k 8-15, np), (k 0-7, np + 1), (k 8-15, np + 1)
            uint32_t bl[NT][2], br[NT][2];
#pragma unroll
            for (int np = 0; np < NT; np += 2) {
              const int off = (sub + (mat & 1) * 8 + mrow) * pws + 8 * (np + (mat >> 1));
              if (np + 1 < NT) {
                uint32_t q[4];
                ldsm_x4_trans(q, pl + off);
                bl[np][0] = q[0]; bl[np][1] = q[1]; bl[np + 1][0] = q[2]; bl[np + 1][1] = q[3];
                ldsm_x4_trans(q, pr + off);
                br[np][0] = q[0]; br[np][1] = q[1]; br[np + 1][0] = q[2]; br[np + 1][1] = q[3];
              } else {
                uint32_t q[2];
                ldsm_x2_trans(q, pl + off);
                bl[np][0] = q[0]; bl[np][1] = q[1];
                ldsm_x2_trans(q, pr + off);
                br[np][0] = q[0]; br[np][1] = q[1];
              }
            }
            // A fragments: (rows 0-7, k 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15)
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              uint32_t a[4];
              ldsm_x4(a, in + (16 * mt + (mat & 1) * 8 + mrow) * S + k0 + sub + (mat >> 1) * 8);
#pragma unroll
              for (int nt = 0; nt < NT; ++nt) {
                mma_bf16(accl[mt][nt], a, bl[nt][0], bl[nt][1]);
                mma_bf16(accr[mt][nt], a, br[nt][0], br[nt][1]);
              }
            }
          }
        }
        load_panel();  // into the stage summed a step ago
        cp_async_commit();
        if (++slot == stages) slot = 0;
      }
      if constexpr (kBulk) {
        // the last GLU's bulk stores have read the staging before it is rewritten
        if (stage_acts && layer > 0 && p == 0) {
          if (threadIdx.x == 0) bulk_wait_read();
          __syncthreads();
        }
      }
      if (!busy) continue;
      // the epilogue: a, s in f32 (saved), round(a * s) into the other buffer
      // (the last GLU's only where the inverse DFT reads it)
      TA* ga = kSave ? acts + (2 * gi) * plane : nullptr;
      TA* gs = kSave ? acts + (2 * gi + 1) * plane : nullptr;
      const bool keep_u = kOut || layer < 2;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = n0 + 8 * nt + 2 * tq;
        if (col >= d1) continue;
        const float2 bL = __ldg(reinterpret_cast<const float2*>(g.bl[gi] + col));
        const float2 bR = __ldg(reinterpret_cast<const float2*>(g.br[gi] + col));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 16 * mt + gq + 8 * h;
            const float a0 = accl[mt][nt][2 * h] + bL.x, a1 = accl[mt][nt][2 * h + 1] + bL.y;
            const float s0 = __fdividef(1.f, 1.f + __expf(-(accr[mt][nt][2 * h] + bR.x)));
            const float s1 = __fdividef(1.f, 1.f + __expf(-(accr[mt][nt][2 * h + 1] + bR.y)));
            if (keep_u) *reinterpret_cast<uint32_t*>(nxt + r * S + col) = pack_bf16x2(a0 * s0, a1 * s1);
            if (kSave) {
              const long row = row0 + r;
              if (row < rows_pad) {
                if constexpr (std::is_same<TA, float>::value) {
                  __stcs(reinterpret_cast<float2*>(ga + row * d1 + col), make_float2(a0, a1));
                  __stcs(reinterpret_cast<float2*>(gs + row * d1 + col), make_float2(s0, s1));
                } else if (stage_acts) {  // bf16 planes through the staging
                  *reinterpret_cast<uint32_t*>(stg + r * d1 + col) = pack_bf16x2(a0, a1);
                  *reinterpret_cast<uint32_t*>(stg + (TM + r) * d1 + col) = pack_bf16x2(s0, s1);
                } else {
                  // bf16 planes, no staging: a pair as one word, cached in L2 only
                  __stcg(reinterpret_cast<unsigned int*>(ga + row * d1 + col), pack_bf16x2(a0, a1));
                  __stcg(reinterpret_cast<unsigned int*>(gs + row * d1 + col), pack_bf16x2(s0, s1));
                }
              }
            }
          }
      }
    }
    if constexpr (kBulk) {
      if (stage_acts) {
        // every warp's a, s of the GLU are staged: one bulk store each, read
        // by the copy engine while the next GLU's products run
        fence_proxy_async();
        __syncthreads();
        if (threadIdx.x == 0) {
          const long n = min((long)TM, rows_pad - row0);
          if (n > 0) {
            const unsigned bytes = (unsigned)(n * d1 * sizeof(bf16));
            bulk_store(acts + (2 * gi) * plane + row0 * d1, stg, bytes);
            bulk_store(acts + (2 * gi + 1) * plane + row0 * d1, stg + TM * d1, bytes);
          }
          bulk_commit();
        }
      }
    }
  }
  if constexpr (kBulk) {
    if (stage_acts && threadIdx.x == 0) bulk_wait_read();  // before the block's shared memory goes
  }

  if constexpr (kOut) {
    // GLU 2's output is in buf1 of both blocks; buf0 is free
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // both chains' last outputs are in place, every product's reads done
    const uint4* src = reinterpret_cast<const uint4*>(cluster.map_shared_rank(buf1, chain ^ 1));
    uint4* dst = reinterpret_cast<uint4*>(buf0);
    constexpr int kBatch = 8;  // remote loads in flight a thread
    for (int e0 = threadIdx.x; e0 < TM * S / 8; e0 += kBatch * blockDim.x) {
      uint4 v[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        if (e0 + j * (int)blockDim.x < TM * S / 8) v[j] = src[e0 + j * blockDim.x];
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        if (e0 + j * (int)blockDim.x < TM * S / 8) dst[e0 + j * blockDim.x] = v[j];
    }
    cluster.sync();  // every copy is done: no block reads the other's buffer after this
    const bf16* re = chain == 0 ? buf1 : buf0;
    const bf16* im = chain == 0 ? buf0 : buf1;
    // this block's half of the output's n8 tiles
    const int tiles = (d1 + 7) / 8, half = (tiles + 1) / 2;
    const int t0 = chain * half, t1 = min(tiles, t0 + half);
    for (int tt = t0 + warp * kFIdftNT; tt < t1; tt += warps * kFIdftNT) {
      float acc[MT][kFIdftNT][4];
      idft_fwd_mma<MT, kFIdftNT>(re, im, S, ci, si, WM, d1, 8 * tt, acc);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long row = row0 + 16 * mt + gq + 8 * h;
          if (row >= rows) continue;
          const long b = row / N, n = row % N;
#pragma unroll
          for (int nt = 0; nt < kFIdftNT; ++nt) {
            const int col = 8 * (tt + nt) + 2 * tq;
            if (tt + nt >= t1 || col >= d1) continue;
            const float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
            float* o = out + ((b * K + col / WM) * N + n) * WM + col % WM;
            if (WM % 2 == 0) {  // the pair in one window, 8-byte aligned
              *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
            } else {
              o[0] = v0;
              out[((b * K + (col + 1) / WM) * N + n) * WM + (col + 1) % WM] = v1;
            }
          }
        }
    }
  }
}

// ---- the bf16 backward on Hopper (D1 up to kMmaMaxD1) ----
//
// Three launches a call (`bwd_tc_launch`), every sum in one fixed order, no
// atomics:
//   * `spectral_pack_kernel` lays the twelve weights out as the rows kernel's
//     B operand: per chain one stream of items, an item the mma.sync B
//     fragments of P k16 steps by NT n8 tiles of one warp, in the order that
//     warp sums them (`tc_stream`). A warp then reads a fragment as one
//     8-byte shared load, and an item is one bulk copy.
//   * `spectral_bwd_rows_tc_kernel`: clusters of 2 blocks, the real and the
//     imaginary chain of one range of 16-row m tiles; as many clusters as
//     half the card's SMs where the rows allow, the ranges balanced to a tile
//     (every SM busy at the flagship: 132 blocks, 4 or 5 m tiles each). Warp
//     w of W owns NT n8 column tiles of every product (mma.sync m16n8k16, A
//     by ldmatrix from the tile's da, ds in shared memory, B from the item);
//     warp W is the producer: TMA bulk copies (cp.async.bulk) keep the
//     weight items in flight in a ring of R shared slots, R / W a warp (a
//     warp's items take its slots in turn, so no warp waits on a slot whose
//     last use it has not consumed itself: an mbarrier's parity tells only
//     two uses apart), a full and an empty mbarrier a slot, and ahead of
//     each GLU's epilogue bring the
//     saved a and s of each m tile (16 rows by D1, contiguous in the planes:
//     half the bytes where they are bf16) into a ring of two slots, where
//     two fit the block's shared memory (`stage_acts`; else the epilogue
//     reads them from L2, prefetched a product ahead). The epilogue writes
//     da and ds (bf16) for the next product, and through a warp's scratch
//     into the weight gradients' transposed planes (below) with u = round(a
//     * s) of GLUs 0-3 beside them, and the column sums of the unrounded da,
//     ds over the block's rows for the bias gradients. dx = real part +
//     imaginary part: the imaginary block's part is read by the real one
//     from its shared memory in the cluster (no dx kernel).
//   * `spectral_wgrad_wg_kernel`: wgmma m64n128k16, both operands from
//     shared memory, of u^T by da (warpgroup 0, dWl) and by ds (warpgroup 1,
//     dWr): a block per GLU, 128 input features (two m64 halves) and 128
//     columns, for one of C row segments; the C segments are a cluster. A
//     producer warp feeds a ring of 64-row stages by bulk copies. The
//     segments' sums, and the bias gradients from the rows kernel's column
//     sums, are added in rank order through distributed shared memory and
//     written to the gradients: no reduce or bias kernel.
// The transposed planes (da, ds of the six GLUs, u of GLUs 2-5, x^T for
// layer 0) are wgmma's K-major layout without swizzle: chunks of 64 rows; a
// chunk ceil(F / 8) groups of 8 features, 1 KB each; a group 8 k-groups of 8
// rows, 128 bytes each; a k-group 8 features by 16 bytes (8 consecutive
// rows). So a stage is one bulk copy an operand, its core matrices 128 bytes
// apart along K and 1 KB apart along M or N. Rows past rows_pad, to a
// multiple of 64, are zeros. Bound: bytes at the flagship (the 12 saved
// arrays read), against 9.4 GFLOP.
constexpr int kTR = 64;            // rows of a chunk of the transposed planes
constexpr int kTcBarBytes = 1024;  // the mbarriers at the head of a block's shared memory
constexpr int kTcMaxRing = (kTcBarBytes / 8 - 4) / 2;  // weight items in a rows block's ring
constexpr int kWgM = 128, kWgN = 128;  // input features and columns of a weight-gradient block
constexpr int kWgStages = 4;           // its ring of 64-row stages
constexpr int kWgStage = (kWgM + 2 * kWgN) * kTR * 2;  // bytes of a stage: u^T, da, ds
constexpr int kWgThreads = 288;        // two consumer warpgroups and a producer warp
constexpr int kWgMaxCluster = 8;       // row segments a cluster (the portable size)

__host__ __device__ inline long rows_pad64(long rows) { return (rows + kTR - 1) / kTR * kTR; }

// bytes of a 64-row chunk of a transposed plane of f features
__host__ __device__ inline long tchunk_bytes(int f) { return (long)((f + 7) / 8) * 1024; }

// the byte offset of (row, feature c) in a transposed plane of f features
__device__ __forceinline__ long toff(long row, int c, int f) {
  return row / kTR * tchunk_bytes(f) + (c / 8) * 1024 + (row % kTR) / 8 * 128 + (c % 8) * 16 +
         (row % 8) * 2;
}

// A rows block of NT n8 tiles a warp (4, 5, 8, 16 or 32): its most 16-row m
// tiles (its accumulators: MT NT 4 floats), its most consumer warps and its
// launch bound (with the producer warp; the registers a thread may have are
// 64K over the bound rounded up to 4 warps: 255 at 256 threads, 168 at 384,
// 128 at 512).
__host__ __device__ constexpr int tc_max_mt(int nt) { return nt <= 5 ? 5 : nt == 8 ? 2 : 1; }
__host__ __device__ constexpr int tc_max_warps(int nt) {
  return nt <= 5 ? 7 : nt == 32 ? 11 : 15;
}
__host__ __device__ constexpr int tc_bound(int nt) { return 32 * (tc_max_warps(nt) + 1); }

// One chain's weight stream, four products in the order the rows kernel
// sums them: the inverse DFT (K = D1, the cotangent's columns: `isteps` k16
// steps in `ichunks` groups of p), then layers 2 and 1 (K = 2 kp, da's
// columns then ds's: `steps` k16 steps in `chunks` groups) with D1 outputs
// on w warps of nt n8 tiles, then layer 0 with D0 outputs on w0 warps of
// nt0 tiles; within a group the warps in order.
struct TcStream {
  int isteps, ichunks, steps, chunks, w, w0, nt0, items;
};

__host__ __device__ inline TcStream tc_stream(int d0, int d1, int nt, int p) {
  TcStream s;
  s.isteps = (d1 + 15) / 16;
  s.ichunks = (s.isteps + p - 1) / p;
  s.steps = 2 * s.isteps;
  s.chunks = (s.steps + p - 1) / p;
  const int ct = (d1 + 7) / 8, ct0 = (d0 + 7) / 8;
  s.w = (ct + nt - 1) / nt;
  s.nt0 = (ct0 + s.w - 1) / s.w;
  s.w0 = (ct0 + s.nt0 - 1) / s.nt0;
  s.items = s.ichunks * s.w + s.chunks * (2 * s.w + s.w0);
  return s;
}

// The first item of product q (0: the inverse DFT, 1-3: layers 2, 1, 0) in a
// chain's stream, and the warps and n8 tiles a warp of its items.
__host__ __device__ inline int tc_first(const TcStream& s, int q) {
  return q == 0 ? 0 : s.ichunks * s.w + (q - 1) * s.chunks * s.w;
}

// packed: [2 chains][items][p][nt][32 lanes] of uint2, item i of a chain as
// `tc_stream` orders them; lane (g, t) of n8 tile j at k16 step s holds
// (B[k][n], B[k + 1][n]) and (B[k + 8][n], B[k + 9][n]) for n = 8 j + g, k =
// 16 s' + 2 t (s' the step within da's or ds's half): for the GLUs B[k][n] =
// Wl[n][k] (ds's half: Wr), for the inverse DFT of chain c B[k][n] =
// idft[n % WM][k % WM] where k and n lie in one order's window (idft: Ci for
// the real chain, Si for the imaginary one, both symmetric), zero past the
// matrices. Then x^T, the transposed plane of layer 0's weight gradients
// (x [B,K,N,W] bf16 to `xt`, rows64 rows of D0 features).
__global__ void spectral_pack_kernel(GluWeights<bf16> g, const bf16* __restrict__ ci,
                                     const bf16* __restrict__ si, const bf16* __restrict__ x,
                                     uint2* __restrict__ packed, unsigned char* __restrict__ xt,
                                     long rows64, int nt, int p, int B, int K, int N, int W,
                                     int WM) {
  const int d0 = K * W, d1 = K * WM;
  const TcStream s = tc_stream(d0, d1, nt, p);
  const long per_item = (long)p * nt * 32;
  const long total = 2L * s.items * per_item;
  const long stride = (long)gridDim.x * blockDim.x;
  for (long e = (long)blockIdx.x * blockDim.x + threadIdx.x; e < total; e += stride) {
    const int lane = (int)(e % 32), t = (int)(e / 32 % nt), st = (int)(e / (32L * nt) % p);
    const long all = e / per_item;
    const int chain = (int)(all / s.items);
    int item = (int)(all % s.items), q = 0, wl = s.w, ntl = nt;
    if (item >= tc_first(s, 1)) {
      q = item >= tc_first(s, 3) ? 3 : item >= tc_first(s, 2) ? 2 : 1;
      item -= tc_first(s, q);
      if (q == 3) {
        wl = s.w0;
        ntl = s.nt0;
      }
    }
    const int step = item / wl * p + st, tile = item % wl * ntl + t;
    const int nn = q == 3 ? d0 : d1;
    const int n = tile * 8 + lane / 4;
    uint2 v = make_uint2(0u, 0u);
    if (q == 0 && step < s.isteps && t < ntl && n < d1) {
      const bf16* blk = (chain == 0 ? ci : si) + (n % WM) * WM;
      const int k = step * 16 + 2 * (lane % 4);
      auto at = [&](int kk) -> unsigned {
        return kk < d1 && kk / WM == n / WM ? (unsigned)__bfloat16_as_ushort(blk[kk % WM])
                                            : 0u;
      };
      v = make_uint2(at(k) | at(k + 1) << 16, at(k + 8) | at(k + 9) << 16);
    } else if (q > 0 && step < s.steps && t < ntl && tile * 8 < nn) {
      const int gi = 2 * (3 - q) + chain, side = step / s.isteps;
      const int k = step % s.isteps * 16 + 2 * (lane % 4);
      const bf16* w = (side == 0 ? g.wl[gi] : g.wr[gi]) + (long)n * d1;
      auto at = [&](int kk) -> unsigned {
        return n < nn && kk < d1 ? (unsigned)__bfloat16_as_ushort(w[kk]) : 0u;
      };
      v = make_uint2(at(k) | at(k + 1) << 16, at(k + 8) | at(k + 9) << 16);
    }
    packed[e] = v;
  }
  // x^T: a 16-byte run of 8 rows of one feature a thread, zeros past the rows
  const int f8 = (d0 + 7) / 8 * 8;
  const long rows = (long)B * N, units = rows64 / 8 * f8;
  for (long u = (long)blockIdx.x * blockDim.x + threadIdx.x; u < units; u += stride) {
    const int c = (int)(u % f8);
    const long r8 = u / f8 * 8;
    uint32_t wv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      unsigned short h[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const long row = r8 + 2 * i + e;
        h[e] = row < rows && c < d0
                   ? __bfloat16_as_ushort(x[((row / N * K + c / W) * N + row % N) * W + c % W])
                   : (unsigned short)0;
      }
      wv[i] = h[0] | (uint32_t)h[1] << 16;
    }
    *reinterpret_cast<uint4*>(xt + toff(r8, c, d0)) = make_uint4(wv[0], wv[1], wv[2], wv[3]);
  }
}

// a barrier of the rows block's W consumer warps alone (not the producer)
__device__ __forceinline__ void consumers_sync(int warps) {
  asm volatile("bar.sync 1, %0;" ::"r"(warps * 32) : "memory");
}

// two saved activations of the storage type TA as f32 (shared or device memory)
__device__ __forceinline__ float2 load_act2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_act2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// bytes of shared memory of a rows block: the mbarriers, da and ds of 16 bm
// rows, `ring` weight items, two staged m tiles of a and s (stage_acts), the
// warps' scratch
__host__ __device__ inline long rows_tc_smem(int d0, int d1, int bm, int nt, int p, int ring,
                                             int stage_acts, int act_bytes) {
  const TcStream s = tc_stream(d0, d1, nt, p);
  return kTcBarBytes + 2L * 16 * bm * ldsm_stride(d1) * (long)sizeof(bf16) +
         (long)ring * p * nt * 256 + (stage_acts ? 4L * 16 * d1 * act_bytes : 0) + s.w * 768L;
}

// One range of 16-row m tiles (cluster blockIdx.x / 2 of `clusters`, its
// ranges balanced over rows64 / 16 tiles) of one chain (blockIdx.x % 2): g
// (f32 [B,K,N,WM]) -> dR (dI) -> the chain's three GLUs backwards -> the
// chain's part of dx, the two parts added in the cluster into dx [B,K,N,W];
// da, ds of the chain's GLUs and u of GLUs 2-5 into the transposed planes at
// tws; the block's column sums into bpart [clusters][12][D1]. acts: the
// saved planes [12][rows_pad][D1] of the storage type TA (f32, or bf16 for
// the bf16-storage arm). blockDim.x: 32 per consumer warp (`tc_stream`'s w)
// and the producer warp.
template <int MT, int NT, typename TA>
__global__ void __launch_bounds__(tc_bound(NT), 1)
spectral_bwd_rows_tc_kernel(const float* __restrict__ g, const TA* __restrict__ acts, long plane,
                            const uint2* __restrict__ packed, unsigned char* __restrict__ tws,
                            long rows_pad, long rows64, int bm, int p, int ring, int stage_acts,
                            int clusters, float* __restrict__ dx, float* __restrict__ bpart,
                            int B, int K, int N, int W, int WM) {
  extern __shared__ __align__(16) float smem[];
  const int d0 = K * W, d1 = K * WM, S = ldsm_stride(d1), kp = (d1 + 15) / 16 * 16;
  const TcStream st = tc_stream(d0, d1, NT, p);
  const int warps = st.w, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4, mrow = lane % 8, mat = lane / 8;
  const int chain = blockIdx.x & 1;
  const long cl = blockIdx.x >> 1, mtiles = rows64 / 16;
  const long q = mtiles / clusters, rem = mtiles % clusters;
  const long row0 = 16 * (cl * q + min(cl, rem));
  const int nmt = (int)(q + (cl < rem ? 1 : 0)), TM = 16 * bm;
  const long rows = (long)B * N;
  unsigned char* const base = reinterpret_cast<unsigned char*>(smem);
  uint64_t* const full = reinterpret_cast<uint64_t*>(base);
  uint64_t* const empty = full + ring;
  uint64_t* const afull = empty + ring;
  uint64_t* const aempty = afull + 2;
  bf16* const da = reinterpret_cast<bf16*>(base + kTcBarBytes);  // [TM][S]: the cotangent, then da
  bf16* const ds = da + TM * S;                                   // [TM][S]
  unsigned char* const items = reinterpret_cast<unsigned char*>(ds + TM * S);
  const int item_bytes = p * NT * 256;
  const int rw = ring / warps;        // each warp's part of the ring: its items in turn
  const long tile_elems = 16L * d1;  // a 16-row m tile of a plane
  TA* const aring = reinterpret_cast<TA*>(items + (long)ring * item_bytes);  // [2][a, s][16][d1]
  uint32_t* const scratch = reinterpret_cast<uint32_t*>(
      reinterpret_cast<unsigned char*>(aring) + (stage_acts ? 4 * tile_elems * sizeof(TA) : 0)) +
      warp * 192;  // [3 planes][16 rows][4 words]: a warp's n8 tile of da, ds, u
  const long pd1 = rows64 / kTR * tchunk_bytes(d1);  // bytes of a transposed plane of D1 features

  if (threadIdx.x == 0) {
    for (int i = 0; i < ring; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 1);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(afull + i, 1);
      mbar_init(aempty + i, warps);
    }
    mbar_init_fence();
  }
  // the cotangent tile: the block's threads walk (order kk, row r, m) so
  // that neighbouring threads read neighbouring floats (within an order a
  // batch element's rows are contiguous in g), 4 at a time where WM % 4 ==
  // 0, many loads in flight a thread; then the pad columns of both buffers
  const bf16 zero = __float2bfloat16_rn(0.f);
  {
    const int per = 16 * nmt * WM, total = K * per;
    const int vec = WM % 4 == 0 ? 4 : 1;
    constexpr int kBatch = 8;
    for (int e0 = threadIdx.x * vec; e0 < total; e0 += kBatch * blockDim.x * vec) {
      float4 v[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int e = e0 + j * blockDim.x * vec;
        const int kk = e / per, r = e % per / WM, m = e % WM;
        const int row = (int)row0 + r, b = row / N;  // rows stay below 2^31
        const float* src = g + ((long)(b * K + kk) * N + (row - b * N)) * WM + m;
        v[j] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (e < total && row < rows) {
          if (vec == 4) v[j] = *reinterpret_cast<const float4*>(src);
          else v[j].x = *src;
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int e = e0 + j * blockDim.x * vec;
        if (e >= total) continue;
        bf16* dst = da + e % per / WM * S + e / per * WM + e % WM;
        if (vec == 4) {
          *reinterpret_cast<uint2*>(dst) =
              make_uint2(pack_bf16x2(v[j].x, v[j].y), pack_bf16x2(v[j].z, v[j].w));
        } else {
          *dst = __float2bfloat16_rn(v[j].x);
        }
      }
    }
  }
  for (int r = warp; r < TM; r += warps + 1) {
    if (r >= 16 * nmt)  // rows past the block's m tiles: zeros (they are never summed)
      for (int col = lane; col < d1; col += 32) da[r * S + col] = zero;
    for (int col = d1 + lane; col < kp; col += 32) {
      da[r * S + col] = zero;
      ds[r * S + col] = zero;  // ds's pad columns: zero for good
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // both blocks' barriers are initialised, the tiles staged

  if (warp == warps) {
    // the producer, one thread: two queues in the order the consumers need
    // them, the stream's items of product q (B; the inverse DFT first) and
    // the saved a, s of each m tile for the epilogue after product q (A, or
    // read from L2 where they are not staged); their L2 prefetch goes with
    // product q's first item. Each copy is started as soon as its slot is
    // free, the earlier-needed queue first, and neither queue waits for the
    // other's slots.
    if (lane == 0) {
      const unsigned char* src = reinterpret_cast<const unsigned char*>(packed) +
                                 (long)chain * st.items * item_bytes;
      const long live_rows = min((long)(16 * nmt), rows_pad - row0);
      const int na = stage_acts ? 3 * nmt : 0, nb = st.items;
      int ja = 0, ib = 0, slot_b = 0, use_b = 0;
      unsigned idle = 0;
      while (ja < na || ib < nb) {
        const int qb = ib >= tc_first(st, 3) ? 3 : ib >= tc_first(st, 2) ? 2
                       : ib >= tc_first(st, 1) ? 1 : 0;  // the product of item ib
        const bool a_first = ja < na && (ib >= nb || 2 * (ja / nmt) + 1 <= 2 * qb);
        bool a_ok = false, b_ok = false;
        if (ja < na) a_ok = ja < 2 || mbar_test(aempty + (ja & 1), ((ja >> 1) - 1) & 1);
        if (ib < nb && !(a_first && a_ok)) {
          // item ib is item k of its warp: slot k % rw of the warp's part of the ring
          const int rel = ib - tc_first(st, qb), wl = qb < 3 ? st.w : st.w0;
          const int k = (qb == 0 ? 0 : st.ichunks + (qb - 1) * st.chunks) + rel / wl;
          slot_b = rel % wl * rw + k % rw;
          use_b = k / rw;
          b_ok = use_b == 0 || mbar_test(empty + slot_b, (use_b - 1) & 1);
        }
        if (a_ok && (a_first || !b_ok)) {
          const int slot = ja & 1, gi = 2 * (2 - ja / nmt) + chain;
          const long r = row0 + 16 * (ja % nmt);
          if (r < rows_pad) {
            const unsigned bytes = (unsigned)(tile_elems * sizeof(TA));
            TA* dst = aring + slot * 2 * tile_elems;
            mbar_expect(afull + slot, 2 * bytes);
            bulk_load(dst, acts + (2 * gi) * plane + r * d1, bytes, afull + slot);
            bulk_load(dst + tile_elems, acts + (2 * gi + 1) * plane + r * d1, bytes,
                      afull + slot);
          } else {
            mbar_arrive(afull + slot);  // a tile past the planes: zeros, nothing to copy
          }
          ++ja;
        } else if (!b_ok) {
          __nanosleep(64);  // nothing free: leave the issue slots to the consumer warps
          if (++idle == kMbarPolls) __trap();  // as a wait that runs out
        } else {
          const int slot = slot_b;
          // the planes of the epilogue after product qb into L2 as it starts:
          // the staged tiles' copies then come from L2, the unstaged reads too
          if (qb < 3 && ib == tc_first(st, qb) && live_rows > 0) {
            const int gi = 2 * (2 - qb) + chain;
            const unsigned bytes = (unsigned)(live_rows * d1 * sizeof(TA));
            prefetch_l2(acts + (2 * gi) * plane + row0 * d1, bytes);
            prefetch_l2(acts + (2 * gi + 1) * plane + row0 * d1, bytes);
          }
          mbar_expect(full + slot, item_bytes);
          bulk_load(items + (long)slot * item_bytes, src + (long)ib * item_bytes, item_bytes,
                    full + slot);
          ++ib;
        }
      }
    }
    __syncwarp();
  } else {
    const int n0 = warp * NT * 8;
    float acc[MT][NT][4];
    int j = 0;  // m tiles of a, s consumed so far
    // four phases: the inverse DFT's product (acc = dR, dI of the warp's
    // columns), then for layers 2, 1, 0 the epilogue of the GLU on acc and
    // the product of its da, ds with the GLU's weights
    for (int qp = 0; qp < 4; ++qp) {
      if (qp > 0) {
        const int layer = 3 - qp, gi = 2 * layer + chain;
        // the epilogue of GLU gi on acc (the cotangent of its output): da = d *
        // s, ds = d * a * (s * (1 - s)); da, ds rounded to bf16 into the tile's
        // buffers and the transposed planes, u = round(a * s) (GLUs 0-3) there
        // too; the column sums of the unrounded da, ds over the block's rows:
        // a lane's rows in order, then a fixed butterfly over the 8 lanes of a
        // column
        {
          unsigned char* const tda = tws + (2 * gi) * pd1;
          unsigned char* const tds = tda + pd1;
          unsigned char* const tu = tws + (12 + gi) * pd1;  // used for gi < 4 only
          const int planes = gi < 4 ? 3 : 2;
          float sa[NT][2] = {}, ss[NT][2] = {};
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            if (mt >= nmt) break;
            const long rc = row0 + 16 * mt;
            const bool valid = rc < rows_pad;
            const TA* pa;
            if (stage_acts) {
              mbar_wait(afull + (j & 1), (j >> 1) & 1);
              pa = aring + (j & 1) * 2 * tile_elems;
            } else {
              pa = acts + (2 * gi) * plane + rc * d1;
            }
            const TA* ps = stage_acts ? pa + tile_elems : acts + (2 * gi + 1) * plane + rc * d1;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              const int col = n0 + 8 * nt + 2 * tq;
              const bool live = col < d1;
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int r = gq + 8 * h;
                float2 a = make_float2(0.f, 0.f), s = a;
                if (live && valid) {
                  a = load_act2(pa + r * d1 + col);
                  s = load_act2(ps + r * d1 + col);
                }
                const float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
                const float va0 = v0 * s.x, va1 = v1 * s.y;
                const float vs0 = v0 * a.x * (s.x * (1.f - s.x));
                const float vs1 = v1 * a.y * (s.y * (1.f - s.y));
                sa[nt][0] += va0;
                sa[nt][1] += va1;
                ss[nt][0] += vs0;
                ss[nt][1] += vs1;
                const uint32_t pa2 = pack_bf16x2(va0, va1), ps2 = pack_bf16x2(vs0, vs1);
                if (live) {
                  *reinterpret_cast<uint32_t*>(da + (16 * mt + r) * S + col) = pa2;
                  *reinterpret_cast<uint32_t*>(ds + (16 * mt + r) * S + col) = ps2;
                }
                scratch[r * 4 + tq] = pa2;
                scratch[64 + r * 4 + tq] = ps2;
                scratch[128 + r * 4 + tq] = pack_bf16x2(a.x * s.x, a.y * s.y);
              }
              __syncwarp();
              if (n0 + 8 * nt < d1) {
                // the n8 tile's 16 rows as 16-byte runs of 8 rows of one
                // feature: lanes 0-7 (8-15) the 8 features of the first (last)
                // 8 rows of da (then ds, then u), 128 contiguous bytes
                for (int e = lane; e < 16 * planes; e += 32) {
                  const int pl = e / 16, f = e % 8, kg = e / 8 % 2;
                  const unsigned short* sc =
                      reinterpret_cast<const unsigned short*>(scratch + 64 * pl) + kg * 64 + f;
                  uint32_t wv[4];
#pragma unroll
                  for (int i = 0; i < 4; ++i) wv[i] = sc[16 * i] | (uint32_t)sc[16 * i + 8] << 16;
                  *reinterpret_cast<uint4*>((pl == 0 ? tda : pl == 1 ? tds : tu) +
                                            toff(rc + 8 * kg, n0 + 8 * nt + f, d1)) =
                      make_uint4(wv[0], wv[1], wv[2], wv[3]);
                }
              }
              __syncwarp();
            }
            if (stage_acts && lane == 0) mbar_arrive(aempty + (j & 1));
            ++j;
          }
          float* const bias = bpart + (cl * 12 + 2 * gi) * d1;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int col = n0 + 8 * nt + 2 * tq;
#pragma unroll
            for (int off = 4; off < 32; off *= 2) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                sa[nt][e] += __shfl_xor_sync(0xffffffffu, sa[nt][e], off);
                ss[nt][e] += __shfl_xor_sync(0xffffffffu, ss[nt][e], off);
              }
            }
            if (col < d1 && gq == 0) {  // the same for the 8 lanes of a column pair
              *reinterpret_cast<float2*>(bias + col) = make_float2(sa[nt][0], sa[nt][1]);
              *reinterpret_cast<float2*>(bias + d1 + col) = make_float2(ss[nt][0], ss[nt][1]);
            }
          }
        }
        consumers_sync(warps);  // the tile's da, ds are in place
      }
      // product qp of the stream into acc: the warp's items, k16 steps
      // ascending (K: the cotangent's columns for the inverse DFT; da's, then
      // ds's for the GLUs)
      const int wl = qp < 3 ? st.w : st.w0, ntl = qp < 3 ? NT : st.nt0;
      const int chunks = qp == 0 ? st.ichunks : st.chunks;
      const int steps = qp == 0 ? st.isteps : st.steps;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
      for (int c = 0; c < (warp < wl ? chunks : 0); ++c) {
        // the warp's item k in slot k % rw of its part of the ring: a warp
        // waits only on slots it consumed the last use of
        const int k = (qp == 0 ? 0 : st.ichunks + (qp - 1) * st.chunks) + c;
        const int slot = warp * rw + k % rw;
        mbar_wait(full + slot, (k / rw) & 1);
        const uint2* bp = reinterpret_cast<const uint2*>(items + (long)slot * item_bytes) + lane;
        for (int s = 0; s < p; ++s) {
          const int step = c * p + s;
          if (step >= steps) break;
          const int side = qp > 0 && step >= st.isteps;
          const bf16* ab = (side ? ds : da) + (step - side * st.isteps) * 16 +
                           (mat & 1) * 8 * S + mrow * S + (mat >> 1) * 8;
          uint32_t a[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            if (mt < nmt) ldsm_x4(a[mt], ab + 16 * mt * S);
#pragma unroll
          for (int t = 0; t < NT; ++t) {
            if (t >= ntl) break;
            const uint2 b = bp[(s * NT + t) * 32];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
              if (mt < nmt) mma_bf16(acc[mt][t], a[mt], b.x, b.y);
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + slot);
      }
      consumers_sync(warps);  // every read of the tile's buffers is done before they are rewritten
    }
    // the chain's part of dx ([16 bm][D0] f32 over the tile's buffers)
    float* const dxs = reinterpret_cast<float*>(da);
    if (warp < st.w0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (mt >= nmt) break;
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const int col = (warp * st.nt0 + t) * 8 + 2 * tq;
          if (t >= st.nt0 || col >= d0) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float2*>(dxs + (16 * mt + gq + 8 * h) * d0 + col) =
                make_float2(acc[mt][t][2 * h], acc[mt][t][2 * h + 1]);
        }
      }
    }
  }
  // dx = the real chain's part + the imaginary chain's, by the real block:
  // 4 floats a load (D0 % 4 == 0: one row each), many remote loads in flight
  cluster.sync();
  if (chain == 0) {
    const float* own = reinterpret_cast<const float*>(da);
    const float* other = cluster.map_shared_rank(own, 1);
    constexpr int kBatch = 8;
    const int total = 16 * nmt * d0;
    for (int e0 = 4 * threadIdx.x; e0 < total; e0 += 4 * kBatch * blockDim.x) {
      float4 v[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int e = e0 + 4 * j * blockDim.x;
        if (e < total) v[j] = *reinterpret_cast<const float4*>(other + e);
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int e = e0 + 4 * j * blockDim.x;
        const int row = (int)row0 + e / d0;
        if (e >= total || row >= rows) continue;
        const float4 o = *reinterpret_cast<const float4*>(own + e);
        const float sum[4] = {o.x + v[j].x, o.y + v[j].y, o.z + v[j].z, o.w + v[j].w};
        const int b = row / N, nn = row - b * N;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = e % d0 + i;
          dx[((long)(b * K + c / W) * N + nn) * W + c % W] = sum[i];
        }
      }
    }
  }
  cluster.sync();  // the imaginary block's part is read before it goes
}

// --- the weight gradients on wgmma ---

// a wgmma matrix descriptor of a K-major operand without swizzle at p: core
// matrices of 8 rows by 16 bytes, 128 bytes apart along K (the leading
// offset) and 1 KB apart along M or N (the stride offset)
__device__ __forceinline__ uint64_t wg_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t)(128 >> 4) << 16 |
         (uint64_t)(1024 >> 4) << 32;
}

// d[64] (this thread's part of a 64 x 128 f32 tile) += A (64 x 16) B (16 x 128)
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));  // scale-d 1: d += A B
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// the registers of d hold their values here for the compiler too (after a
// wait: no read of d moves above it)
__device__ __forceinline__ void wgmma_hold(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Weight-gradient blocks (units) of each GLU: ceil(Din / 128) by ceil(D1 / 128).
__host__ __device__ inline int wg_units(int d0, int d1) {
  const int nt = (d1 + kWgN - 1) / kWgN;
  return 2 * ((d0 + kWgM - 1) / kWgM) * nt + 4 * ((d1 + kWgM - 1) / kWgM) * nt;
}

// blockIdx.x = unit * C + segment z (clusters of C along x); a unit (GLU,
// 128 input features, 128 columns) in the order of `wg_units`. The block sums
// u^T @ da (warpgroup 0) and u^T @ ds (warpgroup 1) over the 64-row chunks of
// segment z (the chunks of rows64 balanced over the C segments), then the
// cluster adds its segments in rank order (rank z: rows z * 64 / C onwards of
// each m64 half) into grads; the units of the first 128 features also add
// the rows kernel's column sums (`parts` of them, balanced over the ranks)
// into the bias gradients. tws: the transposed planes as the rows kernel
// writes them.
__global__ void __launch_bounds__(kWgThreads, 1)
spectral_wgrad_wg_kernel(const unsigned char* __restrict__ tws, const float* __restrict__ bpart,
                         float* __restrict__ grads, long rows64, int parts, int C, int d0,
                         int d1) {
  extern __shared__ __align__(16) float smem[];
  unsigned char* const base = reinterpret_cast<unsigned char*>(smem);
  uint64_t* const full = reinterpret_cast<uint64_t*>(base);
  uint64_t* const empty = full + kWgStages;
  unsigned char* const stages = base + kTcBarBytes;  // [kWgStages][u^T 16 KB | da 16 KB | ds 16 KB]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int unit = blockIdx.x / C, z = blockIdx.x % C;
  const int ntn = (d1 + kWgN - 1) / kWgN, m0 = (d0 + kWgM - 1) / kWgM, m1 = (d1 + kWgM - 1) / kWgM;
  int gi, rest;
  if (unit < 2 * m0 * ntn) {
    gi = unit / (m0 * ntn);
    rest = unit % (m0 * ntn);
  } else {
    gi = 2 + (unit - 2 * m0 * ntn) / (m1 * ntn);
    rest = (unit - 2 * m0 * ntn) % (m1 * ntn);
  }
  const int mtile = rest / ntn, ntile = rest % ntn, din = gi < 2 ? d0 : d1;
  const long pd1 = rows64 / kTR * tchunk_bytes(d1);
  const unsigned char* const tu = gi < 2 ? tws + 16 * pd1 : tws + (12 + gi - 2) * pd1;
  const unsigned char* const tl = tws + (2 * gi) * pd1;
  const long cha = tchunk_bytes(din), chb = tchunk_bytes(d1);
  const unsigned bytes_a = (unsigned)(min(kWgM / 8, (din + 7) / 8 - mtile * (kWgM / 8)) * 1024);
  const unsigned bytes_b = (unsigned)(min(kWgN / 8, (d1 + 7) / 8 - ntile * (kWgN / 8)) * 1024);
  const long chunks = rows64 / kTR, cq = chunks / C, crem = chunks % C;
  const long c0 = z * cq + min((long)z, crem);
  const int nch = (int)(cq + (z < crem ? 1 : 0));

  // zeros in the stages (the feature groups past an operand's stay zero),
  // visible to the tensor cores; the barriers
  for (int e = threadIdx.x; e < kWgStages * kWgStage / 16; e += blockDim.x)
    reinterpret_cast<uint4*>(stages)[e] = make_uint4(0u, 0u, 0u, 0u);
  if (threadIdx.x == 0) {
    for (int i = 0; i < kWgStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 8);
    }
    mbar_init_fence();
  }
  fence_proxy_async();
  __syncthreads();

  float d[2][64];
  if (warp == 8) {
    if (lane == 0) {
      for (int i = 0; i < nch; ++i) {
        const int slot = i % kWgStages;
        if (i >= kWgStages) mbar_wait(empty + slot, (i / kWgStages - 1) & 1);
        const long ch = c0 + i;
        unsigned char* const dst = stages + slot * kWgStage;
        mbar_expect(full + slot, bytes_a + 2 * bytes_b);
        bulk_load(dst, tu + ch * cha + mtile * (kWgM / 8) * 1024L, bytes_a, full + slot);
        bulk_load(dst + kWgM * kTR * 2, tl + ch * chb + ntile * (kWgN / 8) * 1024L, bytes_b,
                  full + slot);
        bulk_load(dst + (kWgM + kWgN) * kTR * 2, tl + pd1 + ch * chb + ntile * (kWgN / 8) * 1024L,
                  bytes_b, full + slot);
      }
    }
    __syncwarp();
  } else {
    const int side = warp / 4;  // 0: u^T @ da (dWl), 1: u^T @ ds (dWr)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 64; ++i) d[h][i] = 0.f;
    for (int i = 0; i < nch; ++i) {
      const int slot = i % kWgStages;
      mbar_wait(full + slot, (i / kWgStages) & 1);
      const unsigned char* const stg = stages + slot * kWgStage;
      const unsigned char* const bsrc = stg + (kWgM + side * kWgN) * kTR * 2;
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kTR / 16; ++k) {  // k16 steps: k-groups 2k and 2k + 1
        const uint64_t db = wg_desc(bsrc + 256 * k);
        wgmma_m64n128(d[0], wg_desc(stg + 256 * k), db);
        wgmma_m64n128(d[1], wg_desc(stg + 64 * kTR * 2 + 256 * k), db);
      }
      wgmma_commit();
      wgmma_wait_all();
      wgmma_hold(d[0]);
      wgmma_hold(d[1]);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + slot);
    }
  }

  // the cluster's sum, an m64 half at a time: each block's partials [2
  // sides][64][128] f32 over its stages, then rank z adds its rows of every
  // block's in rank order
  cg::cluster_group cluster = cg::this_cluster();
  float* const part = reinterpret_cast<float*>(stages);
  float* const bsum = part + 2 * 64 * kWgN;  // [2 sides][128]: the bias sums of the block's parts
  const bool bias_unit = mtile == 0;
  __syncthreads();  // every stage is read
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (warp < 8) {
      const int side = warp / 4, wr = warp % 4, gq = lane / 4, tq = lane % 4;
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const int m = 16 * wr + gq + 8 * (i / 2 % 2), col = 8 * (i / 4) + 2 * tq;
        *reinterpret_cast<float2*>(part + (side * 64 + m) * kWgN + col) =
            make_float2(d[h][i], d[h][i + 1]);
      }
      if (h == 0 && bias_unit) {
        const int bside = threadIdx.x / kWgN, c = ntile * kWgN + threadIdx.x % kWgN;
        const int p0 = (int)((long)z * parts / C), p1 = (int)((long)(z + 1) * parts / C);
        float acc = 0.f;
        if (c < d1) {
          const float* src = bpart + (2 * gi + bside) * (long)d1 + c;
#pragma unroll 8
          for (int pp = p0; pp < p1; ++pp) acc += src[pp * 12L * d1];
        }
        bsum[threadIdx.x] = acc;
      }
    }
    cluster.sync();
    const int mlo = z * 64 / C, mhi = (z + 1) * 64 / C;
    for (int e = threadIdx.x; e < 2 * (mhi - mlo) * (kWgN / 4); e += blockDim.x) {
      const int side = e / ((mhi - mlo) * (kWgN / 4));
      const int m = mlo + e / (kWgN / 4) % (mhi - mlo), c4 = e % (kWgN / 4) * 4;
      const long k = (long)mtile * kWgM + h * 64 + m;
      const int c = ntile * kWgN + c4;
      if (k >= din || c >= d1) continue;
      const int off = (side * 64 + m) * kWgN + c4;
      float4 u[kWgMaxCluster];  // every rank's partial in flight, then summed in rank order
#pragma unroll
      for (int r = 0; r < kWgMaxCluster; ++r)
        if (r < C) u[r] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, r) + off);
      float4 v = u[0];
#pragma unroll
      for (int r = 1; r < kWgMaxCluster; ++r) {
        if (r >= C) break;
        v.x += u[r].x;
        v.y += u[r].y;
        v.z += u[r].z;
        v.w += u[r].w;
      }
      *reinterpret_cast<float4*>(grads + glu_grad_offset(gi, d0, d1) +
                                 (side ? (long)din * d1 + d1 : 0) + k * d1 + c) = v;
    }
    if (h == 0 && bias_unit && z == 0) {
      for (int e = threadIdx.x; e < 2 * kWgN; e += blockDim.x) {
        const int bside = e / kWgN, c = ntile * kWgN + e % kWgN;
        if (c >= d1) continue;
        float u[kWgMaxCluster];
#pragma unroll
        for (int r = 0; r < kWgMaxCluster; ++r)
          if (r < C) u[r] = cluster.map_shared_rank(bsum, r)[e];
        float v = u[0];
#pragma unroll
        for (int r = 1; r < kWgMaxCluster; ++r) {
          if (r >= C) break;
          v += u[r];
        }
        grads[glu_grad_offset(gi, d0, d1) + (bside == 0 ? (long)din * d1 : 2L * din * d1 + d1) +
              c] = v;
      }
    }
    cluster.sync();  // every block's partials are read before they are rewritten
  }
}

template <typename T>
GluWeights<T> glu_weights(const void* const* w) {
  GluWeights<T> g;
  for (int i = 0; i < 6; ++i) {
    g.wl[i] = static_cast<const T*>(w[4 * i + 0]);
    g.bl[i] = static_cast<const float*>(w[4 * i + 1]);
    g.wr[i] = static_cast<const T*>(w[4 * i + 2]);
    g.br[i] = static_cast<const float*>(w[4 * i + 3]);
  }
  return g;
}

// Rows of the saved arrays and of the backward's buffers: B*N padded to the
// weight-gradient kernel's stage of rows.
long rows_padded(int B, int N) { return ((long)B * N + kWRC - 1) / kWRC * kWRC; }

long grads_total(int d0, int d1) { return glu_grad_offset(6, d0, d1); }

// The shapes every entry takes, the forward's and the backward's alike: D0
// and D1 in runs of 4 columns (K = 4 in the model). Past D1 = 2048 the wide
// kernels take the shapes the others' blocks do not hold.
bool shape_ok(int K, int W, int WM) {
  const int d0 = K * W, d1 = K * WM;
  return d0 % 4 == 0 && d1 % 4 == 0;
}

// threads of a chain block of `tile` rows: tile / 8 row groups by D1 / 4
// column groups, in whole warps
int chain_threads(int tile, int d1) { return (tile / 8 * (d1 / 4) + 31) / 32 * 32; }

// bytes of shared memory of a chain block with kOut: its tile and the other
// chain's copy
int chain_smem(int tile, int d1) { return 2 * d1 * (tile + 4) * (int)sizeof(float); }

constexpr int kSmemPerBlock = 232448;  // the most a block can opt in to on sm_90

// The wide chain kernel where no 8-row chain block holds a thread for every run.
bool chain_wide(int d1) { return chain_threads(kFTiles[2], d1) > kFWideThreads; }

// The current device's SMs, as the runtime reports them.
cudaError_t current_sms(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return err;
}

// Row-tile slots of a workspace route: one a tile, up to half the card's
// `sms` SMs (a slot is two blocks, a block an SM).
long wide_slots(long rows_pad, int tile, int sms) {
  return std::min<long>((rows_pad + tile - 1) / tile, std::max(sms / 2, 1));
}

// Floats of the wide chain kernel's workspace (0 where its buffers fit a
// block's shared memory): two [D1][12] buffers a block, two blocks a slot.
long chain_ws_floats(long rows_pad, int d1, int sms) {
  const long buffers = 2L * d1 * (kFWideTile + 4);
  if (!chain_wide(d1) || buffers * (long)sizeof(float) <= kSmemPerBlock) return 0;
  return 2 * wide_slots(rows_pad, kFWideTile, sms) * buffers;
}

// The chain kernel's row tile: of the kFTiles whose block fits kFWideThreads
// threads and a block's shared memory, the one whose blocks (two a tile) give
// the busiest of `sms` SMs the fewest rows to work through, the earlier on a
// tie (24 rows at the flagship's 4480, 16 at 800; D1 past 680 leaves 16 or 8).
int chain_tile(long rows_pad, int sms, int d1) {
  int best = kFTiles[2];
  long best_rows = LONG_MAX;
  for (int t : kFTiles) {
    if (chain_threads(t, d1) > kFWideThreads || chain_smem(t, d1) > kSmemPerBlock) continue;
    const long blocks = 2 * ((rows_pad + t - 1) / t);
    const long busiest = (blocks + sms - 1) / sms * t;
    if (busiest < best_rows) {
      best = t;
      best_rows = busiest;
    }
  }
  return best;
}

// The most blocks a grid may have along y, on every card.
constexpr long kMaxGridY = 65535;

// Launches a chain kernel over `tiles` row tiles with `smem` bytes of dynamic
// shared memory, in clusters of 2 (the two chains of a row tile) with kOut.
// kFlat (the chain kernels): grid (2 * tiles), block x the chain x % 2 of
// tile x / 2, which takes any row count (a grid's x stops at 2^31 - 1).
// Otherwise (the wide kernel, which walks its tiles in steps of gridDim.y):
// grid (2, min(tiles, kMaxGridY)).
template <bool kOut, bool kFlat, typename... Params, typename... Args>
int launch_chains(void (*kernel)(Params...), long tiles, int threads, int smem,
                  cudaStream_t st, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 2;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = kFlat ? dim3((unsigned)(2 * tiles))
                      : dim3(2, (unsigned)std::min(tiles, kMaxGridY));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = kOut ? 1 : 0;
  return (int)cudaLaunchKernelEx(&cfg, kernel, args...);
}

// The wide chain kernel: its buffers in shared memory or, past a block's,
// in ws (chain_ws_floats floats), which the caller hands in; acts of the
// storage type TA.
template <typename T, bool kSave, bool kOut, typename TA = float>
int chain_wide_launch(const T* x, const GluWeights<T>& gw, const T* ci, const T* si,
                      float* out, TA* acts, float* ws, int B, int K, int N, int W, int WM,
                      int sms, cudaStream_t st) {
  const int d1 = K * WM;
  const long rows_pad = rows_padded(B, N);
  const bool in_ws = chain_ws_floats(rows_pad, d1, sms) > 0;
  const auto kernel = in_ws ? spectral_chain_wide_kernel<T, kSave, kOut, true, TA>
                            : spectral_chain_wide_kernel<T, kSave, kOut, false, TA>;
  if (in_ws && ws == nullptr) return (int)cudaErrorInvalidValue;
  const long tiles = in_ws ? wide_slots(rows_pad, kFWideTile, sms)
                           : (rows_pad + kFWideTile - 1) / kFWideTile;
  return launch_chains<kOut, false>(kernel, tiles, kFWideThreads,
                                    in_ws ? 0 : 2 * d1 * (kFWideTile + 4) * (int)sizeof(float),
                                    st, x, gw, ci, si, out, acts, kSave ? rows_pad * d1 : 0L,
                                    rows_pad, ws, B, K, N, W, WM);
}

template <typename T, bool kSave, bool kOut>
int chain_launch(const T* x, const GluWeights<T>& gw, const T* ci, const T* si, float* out,
                 float* acts, float* ws, int B, int K, int N, int W, int WM, cudaStream_t st) {
  if (!shape_ok(K, W, WM)) return (int)cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t err = current_sms(&sms);
  if (err != cudaSuccess) return (int)err;
  const int d1 = K * WM;
  if (chain_wide(d1))
    return chain_wide_launch<T, kSave, kOut>(x, gw, ci, si, out, acts, ws, B, K, N, W, WM, sms,
                                             st);
  const long rows_pad = rows_padded(B, N);
  const int tile = chain_tile(rows_pad, sms, d1);
  const int threads = chain_threads(tile, d1);
  const bool ragged = WM % 4 != 0;
  const auto kernel =
      threads <= kFMaxThreads
          ? (ragged ? spectral_chain_kernel<T, kFMaxThreads, kSave, kOut, true>
                    : spectral_chain_kernel<T, kFMaxThreads, kSave, kOut, false>)
      : threads <= kFMidThreads
          ? (ragged ? spectral_chain_kernel<T, kFMidThreads, kSave, kOut, true>
                    : spectral_chain_kernel<T, kFMidThreads, kSave, kOut, false>)
          : (ragged ? spectral_chain_kernel<T, kFWideThreads, kSave, kOut, true>
                    : spectral_chain_kernel<T, kFWideThreads, kSave, kOut, false>);
  return launch_chains<kOut, true>(kernel, (rows_pad + tile - 1) / tile, threads,
                                   (kOut ? 2 : 1) * d1 * (tile + 4) * (int)sizeof(float), st, x,
                                   gw, ci, si, out, acts, kSave ? rows_pad * d1 : 0L, rows_pad,
                                   tile, B, K, N, W, WM);
}

// The plan of the bf16 chain on tensor cores (ops/cuda_spectral.py
// `fwd_mma_plan`): rows a tile (16 MT), n8 tiles a warp, threads a block, k
// rows a weight panel, panel stages; and, for the bf16-storage arm, whether
// its planes go through the shared staging (1) or straight from the lanes.
struct FwdMmaPlan {
  int tm, nt, threads, kp, stages, stage_acts;
};

template <typename TA>
using ChainMmaKernel = void (*)(const bf16*, GluWeights<bf16>, const bf16*, const bf16*, float*,
                                TA*, long, long, int, int, int, int, int, int, int, int);

// The forward mma kernel of (MT, NT), or nullptr for a pair not instantiated;
// TA: the storage type of the saved planes.
template <bool kSave, bool kOut, typename TA = float>
ChainMmaKernel<TA> chain_mma_kernel_for(int mt, int nt) {
  if (mt == 5 && nt == 3) return spectral_chain_mma_kernel<5, 3, kSave, kOut, TA>;
  if (mt == 2 && nt == 4) return spectral_chain_mma_kernel<2, 4, kSave, kOut, TA>;
  if (mt == 1 && nt == 4) return spectral_chain_mma_kernel<1, 4, kSave, kOut, TA>;
  return nullptr;
}

// Bytes of shared memory of a block of the bf16 chain on plan p at D1, or -1
// for a plan the kernel does not take; stage_acts (the bf16-storage saving
// forward only) adds the staging of the tile's bf16 a and s.
int chain_mma_plan_smem(int d1, const FwdMmaPlan& p) {
  if (d1 > kMmaMaxD1 || p.tm % 16 != 0 || chain_mma_kernel_for<false, true>(p.tm / 16, p.nt) ==
      nullptr || p.threads < 32 || p.threads % 32 != 0 ||
      p.threads > chain_mma_bound(p.tm / 16) || p.kp < 16 || p.kp > 64 || p.kp % 16 != 0 ||
      p.stages < 2 || p.stages > 4 || p.stage_acts < 0 || p.stage_acts > 1)
    return -1;
  const int smem = chain_mma_smem(p.tm, d1, p.threads / 32 * p.nt * 8, p.kp, p.stages) +
                   (p.stage_acts ? 4 * p.tm * d1 : 0);
  return smem <= kSmemPerBlock ? smem : -1;
}

// The bf16 chain up to kMmaMaxD1 on the padded rows, on plan p: with kOut in
// clusters of 2 writing out, with kSave writing acts (of the storage type
// TA). A plan the kernel does not take returns cudaErrorInvalidValue before
// any launch.
template <bool kSave, bool kOut, typename TA = float>
int chain_mma_launch(const bf16* x, const GluWeights<bf16>& gw, const bf16* ci, const bf16* si,
                     float* out, TA* acts, int B, int K, int N, int W, int WM,
                     const FwdMmaPlan& p, cudaStream_t st) {
  const int d1 = K * WM, smem = chain_mma_plan_smem(d1, p);
  // the staging is the bf16-storage saving forward's alone
  const bool staged_arm = kSave && !std::is_same<TA, float>::value;
  if (!shape_ok(K, W, WM) || smem < 0 || (p.stage_acts && !staged_arm))
    return (int)cudaErrorInvalidValue;
  const ChainMmaKernel<TA> kernel = chain_mma_kernel_for<kSave, kOut, TA>(p.tm / 16, p.nt);
  const long rows_pad = rows_padded(B, N);
  return launch_chains<kOut, true>(kernel, (rows_pad + p.tm - 1) / p.tm, p.threads, smem, st,
                                   x, gw, ci, si, out, acts, kSave ? rows_pad * d1 : 0L,
                                   rows_pad, p.kp, p.stages, p.stage_acts, B, K, N, W, WM);
}

// The bf16 chain on its route: tensor cores on plan p up to kMmaMaxD1, past
// it the wide scalar kernel (p unused; ws as chain_wide_launch takes it);
// acts of the storage type TA.
template <bool kSave, bool kOut, typename TA = float>
int chain_bf16_launch(const bf16* x, const GluWeights<bf16>& gw, const bf16* ci, const bf16* si,
                      float* out, TA* acts, float* ws, int B, int K, int N, int W, int WM,
                      const FwdMmaPlan& p, cudaStream_t st) {
  if (!shape_ok(K, W, WM)) return (int)cudaErrorInvalidValue;
  if (K * WM <= kMmaMaxD1)
    return chain_mma_launch<kSave, kOut, TA>(x, gw, ci, si, out, acts, B, K, N, W, WM, p, st);
  int sms = 0;
  const cudaError_t err = current_sms(&sms);
  if (err != cudaSuccess) return (int)err;
  return chain_wide_launch<bf16, kSave, kOut, TA>(x, gw, ci, si, out, acts, ws, B, K, N, W, WM,
                                                  sms, st);
}

}  // namespace

// Floats of the scratch the forwards need on the current device (0 but where
// D1 is past 2421: the wide chain kernel's buffers); -1 where the runtime
// cannot say how many SMs the device has.
extern "C" long long spectral_fwd_workspace_floats(int B, int K, int N, int WM) {
  int sms = 0;
  if (current_sms(&sms) != cudaSuccess) return -1;
  return chain_ws_floats(rows_padded(B, N), K * WM, sms);
}

// w: 24 device pointers, per GLU i = 0..5: wl[i], bl[i], wr[i], br[i]
// (wl/wr [Din, D1] row-major, 16-byte aligned, layer-0 weights already
// DFT-folded); ci, si: one [WM, WM] block of the inverse DFT; ws:
// spectral_fwd_workspace_floats floats (null where that is 0). A shape
// `shape_ok` refuses returns cudaErrorInvalidValue before any launch.
extern "C" int spectral_fwd(const float* x, const void* const* w, const float* ci,
                            const float* si, float* out, float* ws, int B, int K, int N, int W,
                            int WM, void* stream) {
  return chain_launch<float, false, true>(x, glu_weights<float>(w), ci, si, out, nullptr, ws,
                                          B, K, N, W, WM, (cudaStream_t)stream);
}

// Bytes of shared memory a block of the bf16 chain on tensor cores takes on
// the plan (tm, nt, threads, kp, stages) of `fwd_mma_plan` at D1 = K * WM, or
// -1 for a plan it does not take (the bf16 forwards then refuse it).
extern "C" int spectral_fwd_bf16_smem(int K, int WM, int tm, int nt, int threads, int kp,
                                      int stages) {
  return chain_mma_plan_smem(K * WM, FwdMmaPlan{tm, nt, threads, kp, stages, 0});
}

// The same for the bf16-storage saving forward, whose plan (`fwd_mma_plan`
// with acts_bf16) also says whether its bf16 planes are staged in shared
// memory for bulk stores (stage_acts 1) or stored by the lanes (0).
extern "C" int spectral_fwd_save_bf16acts_smem(int K, int WM, int tm, int nt, int threads,
                                               int kp, int stages, int stage_acts) {
  return chain_mma_plan_smem(K * WM, FwdMmaPlan{tm, nt, threads, kp, stages, stage_acts});
}

// The bf16 arm: x, ci, si and the 2-D weights (wl, wr) bf16; biases and out
// f32. Up to D1 = kMmaMaxD1 on tensor cores with the plan (tm, nt, threads,
// kp, stages) of `fwd_mma_plan`, past it the wide scalar kernel (plan unused).
extern "C" int spectral_fwd_bf16(const bf16* x, const void* const* w, const bf16* ci,
                                 const bf16* si, float* out, float* ws, int B, int K, int N,
                                 int W, int WM, int tm, int nt, int threads, int kp, int stages,
                                 void* stream) {
  return chain_bf16_launch<false, true>(x, glu_weights<bf16>(w), ci, si, out, (float*)nullptr,
                                        ws, B, K, N, W, WM,
                                        FwdMmaPlan{tm, nt, threads, kp, stages, 0},
                                        (cudaStream_t)stream);
}

// Floats of the 12 saved arrays (a0, s0, ..., a5, s5), each [padded rows, D1].
extern "C" long long spectral_act_floats(int B, int K, int N, int WM) {
  return 12 * rows_padded(B, N) * (long)K * WM;
}

// spectral_fwd that also writes acts (spectral_act_floats floats) for
// spectral_bwd_reread.
extern "C" int spectral_fwd_save(const float* x, const void* const* w, const float* ci,
                                 const float* si, float* out, float* acts, float* ws, int B,
                                 int K, int N, int W, int WM, void* stream) {
  return chain_launch<float, true, true>(x, glu_weights<float>(w), ci, si, out, acts, ws, B,
                                         K, N, W, WM, (cudaStream_t)stream);
}

// The bf16 arm of spectral_fwd_save: operands and plan as spectral_fwd_bf16's,
// acts f32.
extern "C" int spectral_fwd_save_bf16(const bf16* x, const void* const* w, const bf16* ci,
                                      const bf16* si, float* out, float* acts, float* ws,
                                      int B, int K, int N, int W, int WM, int tm, int nt,
                                      int threads, int kp, int stages, void* stream) {
  return chain_bf16_launch<true, true>(x, glu_weights<bf16>(w), ci, si, out, acts, ws, B, K, N,
                                       W, WM, FwdMmaPlan{tm, nt, threads, kp, stages, 0},
                                       (cudaStream_t)stream);
}

// Its bf16-storage arm (the JAX package's `_kernel_save` with SAVE_ACTS_F32
// off): the same kernels, the same f32 a and s, each stored rounded to bf16
// (spectral_act_floats elements of bf16: half the bytes), through the shared
// staging by bulk stores where the plan says stage_acts; the output as
// spectral_fwd_save_bf16's, bit for bit.
extern "C" int spectral_fwd_save_bf16acts(const bf16* x, const void* const* w, const bf16* ci,
                                          const bf16* si, float* out, bf16* acts, float* ws,
                                          int B, int K, int N, int W, int WM, int tm, int nt,
                                          int threads, int kp, int stages, int stage_acts,
                                          void* stream) {
  return chain_bf16_launch<true, true, bf16>(
      x, glu_weights<bf16>(w), ci, si, out, acts, ws, B, K, N, W, WM,
      FwdMmaPlan{tm, nt, threads, kp, stages, stage_acts}, (cudaStream_t)stream);
}

// Floats of the flat gradient buffer: per GLU wl [Din, D1], bl [D1], wr, br.
extern "C" long long spectral_bwd_grad_floats(int K, int W, int WM) {
  return grads_total(K * W, K * WM);
}

namespace {

// Partial column sums the rows kernel leaves for the bias gradients: one per
// 8 rows of its tiles, each [12][D1].
long bias_parts(int B, int N, int d1) {
  const int tile = rows_tile(d1);
  return (rows_padded(B, N) + tile - 1) / tile * (tile / 8);
}

// The wide rows kernel where no 8-row block holds a thread for every column group.
bool rows_wide(int d1) { return rows_threads(d1, kBRN) > kBWideThreads; }

// Floats of the wide rows kernel's buffers: three [D1][12] a block, two
// blocks a slot (0 where the rows kernel takes D1).
long rows_ws_floats(long rows_pad, int d1, int sms) {
  return rows_wide(d1) ? 2 * wide_slots(rows_pad, kBRN, sms) * 3L * d1 * kBRNS : 0;
}

// Floats of the backward's scratch without the saved arrays: da, ds of six
// GLUs for the padded rows, the transposed weights (f32-sized for either
// arm), the two chains' parts of dx, the bias partials, nsplit partial
// gradients, the wide rows kernel's buffers.
long bwd_scratch_floats(int B, int K, int N, int W, int WM, int nsplit, int sms) {
  const long d0 = K * W, d1 = K * WM;
  return 12 * rows_padded(B, N) * d1 + 4 * d0 * d1 + 8 * d1 * d1 +
         2 * rows_padded(B, N) * d0 + bias_parts(B, N, (int)d1) * 12 * d1 +
         (long)nsplit * grads_total(d0, d1) + rows_ws_floats(rows_padded(B, N), (int)d1, sms);
}

// The rows kernel for D1 and the arm: the tile (24 rows, or 8 past D1 =
// 680), the block size and the ragged code only where the shape needs them.
template <typename T>
auto rows_kernel_for(int d1, int WM) {
  const bool ragged = WM % 4 != 0 || d1 / 4 % 2 != 0;
  if (rows_tile(d1) == kBRN)
    return ragged ? spectral_bwd_rows_kernel<T, kBRN, kBWideThreads, true>
                  : spectral_bwd_rows_kernel<T, kBRN, kBWideThreads, false>;
  return rows_threads(d1, kBR) <= kBMaxThreads
             ? (ragged ? spectral_bwd_rows_kernel<T, kBR, kBMaxThreads, true>
                       : spectral_bwd_rows_kernel<T, kBR, kBMaxThreads, false>)
             : (ragged ? spectral_bwd_rows_kernel<T, kBR, kBWideThreads, true>
                       : spectral_bwd_rows_kernel<T, kBR, kBWideThreads, false>);
}

// Steps 1 to 5 of the backward. saved: the forward's 12 arrays, or nullptr to
// recompute them (step 2) into the head of ws, its wide chain's buffers at
// the tail. g of the type Tg: T, or f32 for the bf16 arm, which comes here only
// past kMmaMaxD1 (the wide rows kernel rounds g as it stages it). TA: the
// storage type of saved (bf16 only for the bf16 arm's reread past kMmaMaxD1).
template <typename T, typename Tg, typename TA = float>
int bwd_launch(const T* x, const Tg* g, const void* const* w, const T* ci, const T* si,
               float* dx, float* grads, const TA* saved, float* ws, int B, int K, int N,
               int W, int WM, int nsplit, cudaStream_t st) {
  if (!shape_ok(K, W, WM)) return (int)cudaErrorInvalidValue;
  const int d0 = K * W, d1 = K * WM;
  const long rows_pad = rows_padded(B, N);
  const long plane = rows_pad * d1;
  const long total = grads_total(d0, d1);
  const GluWeights<T> gw = glu_weights<T>(w);
  int sms = 0;
  cudaError_t err = current_sms(&sms);
  if (err != cudaSuccess) return (int)err;

  const TA* acts = saved;
  if constexpr (std::is_same<TA, float>::value) {
    if (saved == nullptr) {
      float* chain_ws = ws + 12 * plane + bwd_scratch_floats(B, K, N, W, WM, nsplit, sms);
      if constexpr (std::is_same<T, float>::value)
        err = (cudaError_t)chain_launch<T, true, false>(x, gw, ci, si, nullptr, ws, chain_ws, B,
                                                        K, N, W, WM, st);
      else  // the bf16 arm comes here only past kMmaMaxD1: the wide chain
        err = (cudaError_t)chain_wide_launch<T, true, false>(x, gw, ci, si, nullptr, ws,
                                                             chain_ws, B, K, N, W, WM, sms, st);
      if (err != cudaSuccess) return (int)err;
      acts = ws;
      ws += 12 * plane;
    }
  } else if (saved == nullptr) {
    return (int)cudaErrorInvalidValue;  // the recompute stores f32 planes
  }
  float* dacts = ws;
  T* wT = reinterpret_cast<T*>(dacts + 12 * plane);
  float* dxc = dacts + 12 * plane + 4L * d0 * d1 + 8L * d1 * d1;
  float* bpart = dxc + 2 * rows_pad * d0;
  float* part = bpart + bias_parts(B, N, d1) * 12 * d1;
  float* rows_ws = part + (long)nsplit * total;

  spectral_transpose_kernel<T><<<dim3((d1 * d1 + 255) / 256, 12), 256, 0, st>>>(gw, wT, d0,
                                                                               d1);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  TransposedWeights<T> wt;
  for (int m = 0; m < 12; ++m) {
    const T* p = wT + (m < 4 ? (long)m * d0 * d1 : 4L * d0 * d1 + (long)(m - 4) * d1 * d1);
    if (m % 2 == 0) wt.l[m / 2] = p; else wt.r[m / 2] = p;
  }
  if (rows_wide(d1)) {
    const auto kernel = WM % 4 != 0 || d1 / 4 % 2 != 0
                            ? spectral_bwd_rows_wide_kernel<T, Tg, true, TA>
                            : spectral_bwd_rows_wide_kernel<T, Tg, false, TA>;
    kernel<<<dim3((int)wide_slots(rows_pad, kBRN, sms), 2), kBWideThreads, 0, st>>>(
        g, acts, dacts, plane, rows_pad, wt, ci, si, dxc, bpart, rows_ws, B, K, N, W, WM);
  } else if constexpr (!std::is_same<T, Tg>::value || !std::is_same<TA, float>::value) {
    return (int)cudaErrorInvalidValue;  // the bf16 arm takes the mma kernels there
  } else {
    const int tile_b = rows_tile(d1);
    const int smem_b = 2 * d1 * rows_stride(tile_b) * (int)sizeof(float);
    const int threads_b = rows_threads(d1, tile_b);
    const auto rows_kernel = rows_kernel_for<T>(d1, WM);
    err = cudaFuncSetAttribute(rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_b);
    if (err != cudaSuccess) return (int)err;
    rows_kernel<<<dim3((int)((rows_pad + tile_b - 1) / tile_b), 2), threads_b, smem_b, st>>>(
        g, acts, dacts, plane, rows_pad, wt, ci, si, dxc, bpart, B, K, N, W, WM);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long nx = (long)B * K * N * W;
  spectral_dx_kernel<<<(int)((nx + 255) / 256), 256, 0, st>>>(dxc, dx, rows_pad, B, K, N, W);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int chunks = (int)(rows_pad / kWRC);
  const int chunks_per_seg = (chunks + nsplit - 1) / nsplit;
  const int cw = std::min(d1, kWC), ctiles = (d1 + kWC - 1) / kWC;
  const int smem_w = 3 * kWRC * (2 * kWK + 2 * cw) * (int)sizeof(float);
  err = cudaFuncSetAttribute(spectral_wgrad_kernel<T, TA>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_w);
  if (err != cudaSuccess) return (int)err;
  const int threads_w = ((kWK / 8) * ((cw / 4 + 1) / 2) + 31) / 32 * 32;
  spectral_wgrad_kernel<T, TA><<<dim3((d1 + kWK - 1) / kWK * ctiles, 6, nsplit), threads_w,
                                 smem_w, st>>>(
      x, acts, dacts, plane, part, total, chunks, chunks_per_seg, B, K, N, W, WM);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  spectral_reduce_kernel<<<(int)((total + 255) / 256), 256, 0, st>>>(part, grads, total,
                                                                     nsplit, d0, d1);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  spectral_bias_kernel<<<dim3(12, (d1 + 31) / 32), dim3(32, kBiasLanes), 0, st>>>(
      bpart, grads, (int)bias_parts(B, N, d1), d0, d1);
  return (int)cudaGetLastError();
}

// The plan of the bf16 backward on Hopper (ops/cuda_spectral.py
// `bwd_tc_plan`): the rows kernel's most m tiles a block (bm), n8 tiles a
// warp, k16 steps a weight item (p), items in its ring, whether a and s are
// staged (1) or read from L2 (0), its clusters; the weight gradients' row
// segments a cluster.
struct BwdTcPlan {
  int bm, nt, p, ring, stage, clusters, nseg;
};

template <typename TA>
using RowsTcKernel = void (*)(const float*, const TA*, long, const uint2*, unsigned char*, long,
                              long, int, int, int, int, int, float*, float*, int, int, int, int,
                              int);

// The rows kernel of NT n8 tiles a warp reading planes of the storage type
// TA, or nullptr for an NT not instantiated.
template <typename TA>
RowsTcKernel<TA> rows_tc_kernel_for(int nt) {
  if (nt == 4) return spectral_bwd_rows_tc_kernel<tc_max_mt(4), 4, TA>;
  if (nt == 5) return spectral_bwd_rows_tc_kernel<tc_max_mt(5), 5, TA>;
  if (nt == 8) return spectral_bwd_rows_tc_kernel<tc_max_mt(8), 8, TA>;
  if (nt == 16) return spectral_bwd_rows_tc_kernel<tc_max_mt(16), 16, TA>;
  if (nt == 32) return spectral_bwd_rows_tc_kernel<tc_max_mt(32), 32, TA>;
  return nullptr;
}

// Bytes of shared memory of a rows block on plan p with saved planes of
// act_bytes an element, or -1 for a plan the kernels do not take (the rows
// of `rows` padded to 64 in its clusters' ranges).
long tc_plan_smem(int d0, int d1, long rows, const BwdTcPlan& p, int act_bytes) {
  if (d1 > kMmaMaxD1 || (p.nt != 4 && p.nt != 5 && p.nt != 8 && p.nt != 16 && p.nt != 32) ||
      p.bm < 1 ||
      p.bm > tc_max_mt(p.nt) || p.p < 1 || p.ring < 1 || p.ring > kTcMaxRing ||
      p.stage < 0 || p.stage > 1 || p.clusters < 1 || p.nseg < 1 || p.nseg > kWgMaxCluster)
    return -1;
  const TcStream s = tc_stream(d0, d1, p.nt, p.p);
  const long mtiles = rows_pad64(rows) / 16;
  if (s.w > tc_max_warps(p.nt) || p.clusters > mtiles ||
      (mtiles + p.clusters - 1) / p.clusters > p.bm || p.ring % s.w != 0)
    return -1;
  const long smem = rows_tc_smem(d0, d1, p.bm, p.nt, p.p, p.ring, p.stage, act_bytes);
  return smem <= kSmemPerBlock ? smem : -1;
}

// Floats of the Hopper route's scratch, the saved arrays not counted: the
// packed weights, the 17 transposed planes, the rows kernel's column sums.
long tc_scratch_floats(int B, int K, int N, int W, int WM, const BwdTcPlan& p) {
  const int d0 = K * W, d1 = K * WM;
  const TcStream s = tc_stream(d0, d1, p.nt, p.p);
  const long chunks = rows_pad64((long)B * N) / kTR;
  return (2L * s.items * p.p * p.nt * 256 + chunks * (16 * tchunk_bytes(d1) + tchunk_bytes(d0)) +
          4L * p.clusters * 12 * d1) / 4;
}

constexpr int kWgSmem = kTcBarBytes + kWgStages * kWgStage;

// A kernel of clusters of `cluster` blocks along x.
template <typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), long blocks, int cluster, int threads,
                            int smem, cudaStream_t st, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// The bf16 backward on Hopper, D1 up to kMmaMaxD1, on plan p (ops/
// cuda_spectral.py `bwd_tc_plan`). x, the weights, ci and si bf16, g f32.
// saved: the 12 planes of the saving forward, of the storage type TA, or
// nullptr to recompute them (f32) into the head of ws by the chain on
// tensor cores on plan fp. A plan the kernels do not take returns
// cudaErrorInvalidValue before any launch.
template <typename TA>
int bwd_tc_launch(const bf16* x, const float* g, const void* const* w, const bf16* ci,
                  const bf16* si, float* dx, float* grads, const TA* saved, float* ws, int B,
                  int K, int N, int W, int WM, const BwdTcPlan& p, const FwdMmaPlan& fp,
                  cudaStream_t st) {
  const int d0 = K * W, d1 = K * WM;
  const long rows = (long)B * N;
  const long smem = tc_plan_smem(d0, d1, rows, p, (int)sizeof(TA));
  const RowsTcKernel<TA> rows_kernel = rows_tc_kernel_for<TA>(p.nt);
  if (!shape_ok(K, W, WM) || smem < 0 || rows_kernel == nullptr)
    return (int)cudaErrorInvalidValue;
  const long rows_pad = rows_padded(B, N), r64 = rows_pad64(rows);
  const long plane = rows_pad * d1;
  const GluWeights<bf16> gw = glu_weights<bf16>(w);
  cudaError_t err;

  const TA* acts = saved;
  if constexpr (std::is_same<TA, float>::value) {
    if (saved == nullptr) {
      err = (cudaError_t)chain_mma_launch<true, false>(x, gw, ci, si, nullptr, ws, B, K, N, W,
                                                       WM, fp, st);
      if (err != cudaSuccess) return (int)err;
      acts = ws;
      ws += 12 * plane;
    }
  } else if (saved == nullptr) {
    return (int)cudaErrorInvalidValue;  // the recompute stores f32 planes
  }
  const TcStream s = tc_stream(d0, d1, p.nt, p.p);
  uint2* const packed = reinterpret_cast<uint2*>(ws);
  const long packed_bytes = 2L * s.items * p.p * p.nt * 256;
  unsigned char* const tws = reinterpret_cast<unsigned char*>(ws) + packed_bytes;
  float* const bpart = reinterpret_cast<float*>(
      tws + r64 / kTR * (16 * tchunk_bytes(d1) + tchunk_bytes(d0)));

  const long units = packed_bytes / 8;
  spectral_pack_kernel<<<(int)std::min<long>((units + 255) / 256, 2048), 256, 0, st>>>(
      gw, ci, si, x, packed, tws + 16 * (r64 / kTR) * tchunk_bytes(d1), r64, p.nt, p.p, B, K, N,
      W, WM);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  err = launch_clusters(rows_kernel, 2L * p.clusters, 2, 32 * (s.w + 1), (int)smem, st, g, acts,
                        plane, (const uint2*)packed, tws, rows_pad, r64, p.bm, p.p, p.ring,
                        p.stage, p.clusters, dx, bpart, B, K, N, W, WM);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_clusters(spectral_wgrad_wg_kernel, (long)wg_units(d0, d1) * p.nseg, p.nseg,
                              kWgThreads, kWgSmem, st, (const unsigned char*)tws,
                              (const float*)bpart, grads, r64, p.clusters, p.nseg, d0, d1);
}

}  // namespace

// Floats of the scratch `spectral_bwd` needs on the current device: a, s of
// six GLUs for the padded rows, the backward's scratch (either arm) and the
// recompute's wide chain buffers; -1 where the runtime cannot say how many SMs
// the device has.
extern "C" long long spectral_bwd_workspace_floats(int B, int K, int N, int W, int WM,
                                                   int nsplit) {
  int sms = 0;
  if (current_sms(&sms) != cudaSuccess) return -1;
  return 12 * rows_padded(B, N) * (long)K * WM +
         bwd_scratch_floats(B, K, N, W, WM, nsplit, sms) +
         chain_ws_floats(rows_padded(B, N), K * WM, sms);
}

// The same for `spectral_bwd_reread`, which brings a and s with it: 12 arrays
// fewer.
extern "C" long long spectral_bwd_reread_workspace_floats(int B, int K, int N, int W,
                                                          int WM, int nsplit) {
  int sms = 0;
  if (current_sms(&sms) != cudaSuccess) return -1;
  return bwd_scratch_floats(B, K, N, W, WM, nsplit, sms);
}

// The bf16 arm's scratch: up to D1 = kMmaMaxD1 the Hopper route's on the
// plan of `bwd_tc_plan` (with the 12 recomputed arrays where `recompute`;
// -1 for a plan the route does not take), past it the scalar route's as
// above (the plan unused).
static long long bf16_bwd_workspace_floats(int B, int K, int N, int W, int WM, int nsplit,
                                           const BwdTcPlan& p, bool recompute) {
  if (K * WM > kMmaMaxD1)
    return recompute ? spectral_bwd_workspace_floats(B, K, N, W, WM, nsplit)
                     : spectral_bwd_reread_workspace_floats(B, K, N, W, WM, nsplit);
  if (tc_plan_smem(K * W, K * WM, (long)B * N, p, 2) < 0 &&
      tc_plan_smem(K * W, K * WM, (long)B * N, p, 4) < 0)
    return -1;
  return (recompute ? 12 * rows_padded(B, N) * (long)K * WM : 0) +
         tc_scratch_floats(B, K, N, W, WM, p);
}

extern "C" long long spectral_bwd_bf16_workspace_floats(int B, int K, int N, int W, int WM,
                                                        int nsplit, int bm, int nt, int p,
                                                        int ring, int stage, int clusters,
                                                        int nseg) {
  const BwdTcPlan plan{bm, nt, p, ring, stage, clusters, nseg};
  return bf16_bwd_workspace_floats(B, K, N, W, WM, nsplit, plan, true);
}

extern "C" long long spectral_bwd_reread_bf16_workspace_floats(int B, int K, int N, int W,
                                                               int WM, int nsplit, int bm, int nt,
                                                               int p, int ring, int stage,
                                                               int clusters,
                                                               int nseg) {
  const BwdTcPlan plan{bm, nt, p, ring, stage, clusters, nseg};
  return bf16_bwd_workspace_floats(B, K, N, W, WM, nsplit, plan, false);
}

// Bytes of shared memory of a block of the bf16 backward's rows kernel on
// the plan (bm, nt, p, ring, stage, clusters, nseg) of `bwd_tc_plan`
// at B * N rows,
// with saved planes of act_bytes (4: f32, 2: bf16) an element; -1 for a plan
// the kernels do not take (the bf16 backwards then refuse it).
extern "C" long long spectral_bwd_bf16_smem(int B, int K, int N, int W, int WM, int bm, int nt,
                                            int p, int ring, int stage, int clusters,
                                            int nseg, int act_bytes) {
  return tc_plan_smem(K * W, K * WM, (long)B * N,
                      BwdTcPlan{bm, nt, p, ring, stage, clusters, nseg}, act_bytes);
}

// x [B,K,N,W], g [B,K,N,WM], w as for spectral_fwd -> dx like x and grads
// (flat, layer 0 in folded space). ws: spectral_bwd_workspace_floats floats.
extern "C" int spectral_bwd(const float* x, const float* g, const void* const* w,
                            const float* ci, const float* si, float* dx, float* grads,
                            float* ws, int B, int K, int N, int W, int WM, int nsplit,
                            void* stream) {
  return bwd_launch<float, float>(x, g, w, ci, si, dx, grads, (const float*)nullptr, ws, B, K,
                                  N, W, WM, nsplit, (cudaStream_t)stream);
}

// The bf16 arm: x, ci, si and the 2-D weights bf16, g, dx and grads f32; up
// to D1 = kMmaMaxD1 on Hopper's route with the plan (bm, nt, p, ring, stage,
// clusters, nseg) of `bwd_tc_plan` and the recompute's chain on the plan
// (ftm, fnt, fthreads, fkp, fstages) of `fwd_mma_plan`, past it the wide
// scalar kernels (the plans unused; nsplit their row segments). ws:
// spectral_bwd_bf16_workspace_floats floats.
extern "C" int spectral_bwd_bf16(const bf16* x, const float* g, const void* const* w,
                                 const bf16* ci, const bf16* si, float* dx, float* grads,
                                 float* ws, int B, int K, int N, int W, int WM, int nsplit, int bm,
                                 int nt, int p, int ring, int stage, int clusters,
                                 int nseg, int ftm, int fnt, int fthreads, int fkp, int fstages,
                                 void* stream) {
  if (K * WM > kMmaMaxD1)
    return bwd_launch<bf16, float>(x, g, w, ci, si, dx, grads, (const float*)nullptr, ws, B, K,
                                   N, W, WM, nsplit, (cudaStream_t)stream);
  return bwd_tc_launch<float>(x, g, w, ci, si, dx, grads, nullptr, ws, B, K, N, W, WM,
                              BwdTcPlan{bm, nt, p, ring, stage, clusters, nseg},
                              FwdMmaPlan{ftm, fnt, fthreads, fkp, fstages, 0},
                              (cudaStream_t)stream);
}

// spectral_bwd on the arrays spectral_fwd_save wrote (acts), without the
// recompute. ws: spectral_bwd_reread_workspace_floats floats.
extern "C" int spectral_bwd_reread(const float* x, const float* g, const void* const* w,
                                   const float* ci, const float* si, const float* acts,
                                   float* dx, float* grads, float* ws, int B, int K, int N,
                                   int W, int WM, int nsplit, void* stream) {
  return bwd_launch<float, float>(x, g, w, ci, si, dx, grads, acts, ws, B, K, N, W, WM,
                                  nsplit, (cudaStream_t)stream);
}

// The bf16 arm of spectral_bwd_reread on what spectral_fwd_save_bf16 wrote,
// as spectral_bwd_bf16 takes its operands and plan. ws:
// spectral_bwd_reread_bf16_workspace_floats floats.
extern "C" int spectral_bwd_reread_bf16(const bf16* x, const float* g, const void* const* w,
                                        const bf16* ci, const bf16* si, const float* acts,
                                        float* dx, float* grads, float* ws, int B, int K,
                                        int N, int W, int WM, int nsplit, int bm, int nt, int p,
                                        int ring, int stage, int clusters, int nseg,
                                        void* stream) {
  if (K * WM > kMmaMaxD1)
    return bwd_launch<bf16, float>(x, g, w, ci, si, dx, grads, acts, ws, B, K, N, W, WM,
                                   nsplit, (cudaStream_t)stream);
  return bwd_tc_launch<float>(x, g, w, ci, si, dx, grads, acts, ws, B, K, N, W, WM,
                              BwdTcPlan{bm, nt, p, ring, stage, clusters, nseg},
                              FwdMmaPlan{}, (cudaStream_t)stream);
}

// Its bf16-storage arm (the JAX package's `_bwd_kernel_reread` on the bf16
// planes of SAVE_ACTS_F32 off), on what spectral_fwd_save_bf16acts wrote
// (acts: spectral_act_floats bf16 elements): the same kernels reading bf16
// a and s (bulk copies of half the bytes), every use of them (u = round(a *
// s) of the weight gradients too) on the rounded values. ws:
// spectral_bwd_reread_bf16_workspace_floats floats.
extern "C" int spectral_bwd_reread_bf16acts(const bf16* x, const float* g, const void* const* w,
                                            const bf16* ci, const bf16* si, const bf16* acts,
                                            float* dx, float* grads, float* ws, int B, int K,
                                            int N, int W, int WM, int nsplit, int bm, int nt,
                                            int p, int ring, int stage, int clusters,
                                            int nseg, void* stream) {
  if (acts == nullptr) return (int)cudaErrorInvalidValue;
  if (K * WM > kMmaMaxD1)
    return bwd_launch<bf16, float, bf16>(x, g, w, ci, si, dx, grads, acts, ws, B, K, N, W, WM,
                                         nsplit, (cudaStream_t)stream);
  return bwd_tc_launch<bf16>(x, g, w, ci, si, dx, grads, acts, ws, B, K, N, W, WM,
                             BwdTcPlan{bm, nt, p, ring, stage, clusters, nseg},
                             FwdMmaPlan{}, (cudaStream_t)stream);
}
