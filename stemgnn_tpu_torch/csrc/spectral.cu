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
// against a few MB of traffic). The design keeps every intermediate out of device memory, as
// the TPU kernel kept it out of HBM: one block per tile of 32 rows holds
// the input tile and both chains' [32, D1] activations in shared memory
// (stored column-major, [k][row], so a thread reads 4 rows per 16-byte
// load), about 110 KB at the flagship widths, which needs the opt-in
// dynamic shared memory limit. Each thread owns one output column for all
// 32 rows, for the left and right products at once, so every weight
// element is read once per block from global memory (L2-resident, 2.5 MB)
// and reused 32 times from a register. Only the [rows, D1] result is
// written to device memory.
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
// only a sequential grid allows. So the backward is five kernels behind one
// C entry, with (a, s) and (da, ds) staged through a workspace in device
// memory (103 MB at the flagship shapes, mostly L2 traffic next to 13 GFLOP):
//   1. transpose the 12 weight matrices, so that step 3 reads them with
//      neighbouring threads on neighbouring addresses;
//   2. the forward chain again, without the inverse DFT, writing a and s of
//      every GLU ([rows, D1] row-major each): the forward kernel itself,
//      compiled with kSave; a forward that must save is the same kernel with
//      kOut as well;
//   3. per 32-row tile, the chain backwards in shared memory, the real chain
//      and then the imaginary one (d, da, ds of one chain: 110 KB, two blocks
//      on an SM), writing da and ds of every GLU and dx;
//   4. the weight gradients as products over the rows: a block owns a
//      [48, 48] tile of dWl and dWr of one GLU (u = x or a * s of the GLU
//      before, rebuilt on load) for one of `nsplit` row segments and writes
//      its partial sums, bias sums included;
//   5. the segments' partials summed in order.
// Every sum has one fixed order, so two runs give the same bits; no atomics.
// Rows past the end of a tile's data carry g = 0, hence da = ds = 0, and add
// nothing to any gradient. Ci and Si are symmetric, which step 3 uses to
// read them along rows.
//
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
// entries pad the rows to the same tile (kTR); rows of the saved arrays past
// the end hold the chain's values for an all-zero input row.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTR = 32;   // rows per block
constexpr int kTRS = 36;  // floats between two columns of a [k][row] buffer
constexpr int kThreads = 256;

struct GluWeights {
  const float* wl[6];
  const float* bl[6];
  const float* wr[6];
  const float* br[6];
};

__device__ __forceinline__ float sigmoidf(float v) { return 1.f / (1.f + expf(-v)); }

// out[c][r] = a * s, a = in[:, r] . Wl[:, c] + bl[c], s = sigmoid(in[:, r] .
// Wr[:, c] + br[c]); with ga, also a and s to ga, gs [r][dout] row-major.
__device__ void glu_tile(const float* in, int din, const float* __restrict__ wl,
                         const float* __restrict__ bl, const float* __restrict__ wr,
                         const float* __restrict__ br, float* out, int dout,
                         float* __restrict__ ga, float* __restrict__ gs) {
  for (int c = threadIdx.x; c < dout; c += blockDim.x) {
    float al[kTR] = {}, ar[kTR] = {};
    for (int k = 0; k < din; ++k) {
      const float l = wl[(long)k * dout + c];
      const float r = wr[(long)k * dout + c];
      const float4* u4 = reinterpret_cast<const float4*>(in + k * kTRS);
#pragma unroll
      for (int q = 0; q < kTR / 4; ++q) {
        const float4 u = u4[q];
        al[4 * q + 0] = fmaf(u.x, l, al[4 * q + 0]);
        al[4 * q + 1] = fmaf(u.y, l, al[4 * q + 1]);
        al[4 * q + 2] = fmaf(u.z, l, al[4 * q + 2]);
        al[4 * q + 3] = fmaf(u.w, l, al[4 * q + 3]);
        ar[4 * q + 0] = fmaf(u.x, r, ar[4 * q + 0]);
        ar[4 * q + 1] = fmaf(u.y, r, ar[4 * q + 1]);
        ar[4 * q + 2] = fmaf(u.z, r, ar[4 * q + 2]);
        ar[4 * q + 3] = fmaf(u.w, r, ar[4 * q + 3]);
      }
    }
    const float bL = bl[c], bR = br[c];
#pragma unroll
    for (int i = 0; i < kTR; ++i) {
      const float a = al[i] + bL, sg = sigmoidf(ar[i] + bR);
      out[c * kTRS + i] = a * sg;
      if (ga != nullptr) {
        ga[(long)i * dout + c] = a;
        gs[(long)i * dout + c] = sg;
      }
    }
  }
}

// acts: with kSave, 12 arrays [gridDim.x * kTR, D1] (a0, s0, ..., a5, s5; GLU
// 2 * layer + chain), `plane` floats apart. out: with kOut.
template <bool kSave, bool kOut>
__global__ void __launch_bounds__(kThreads)
spectral_chain_kernel(const float* __restrict__ x, GluWeights g,
                      const float* __restrict__ ci, const float* __restrict__ si,
                      float* __restrict__ out, float* __restrict__ acts, long plane,
                      int B, int K, int N, int W, int WM) {
  extern __shared__ __align__(16) float smem[];
  const int d0 = K * W, d1 = K * WM;
  const long rows = (long)B * N;
  const long row0 = (long)blockIdx.x * kTR;
  float* xs = smem;
  float* real = xs + d0 * kTRS;
  float* imag = real + d1 * kTRS;
  float* spare = imag + d1 * kTRS;

  for (int e = threadIdx.x; e < kTR * d0; e += blockDim.x) {
    const int r = e / d0, col = e % d0;
    const long row = row0 + r;
    float v = 0.f;
    if (row < rows) {
      const long b = row / N, n = row % N;
      v = x[((b * K + col / W) * N + n) * W + col % W];
    }
    xs[col * kTRS + r] = v;
  }
  __syncthreads();

  // the tile's rows of saved array `idx` (a of GLU i: 2 * i, s: 2 * i + 1)
  float* tile_acts = kSave ? acts + row0 * d1 : nullptr;
#define ACT(idx) (kSave ? tile_acts + (idx) * plane : nullptr)
  glu_tile(xs, d0, g.wl[0], g.bl[0], g.wr[0], g.br[0], real, d1, ACT(0), ACT(1));
  glu_tile(xs, d0, g.wl[1], g.bl[1], g.wr[1], g.br[1], imag, d1, ACT(2), ACT(3));
  __syncthreads();
  for (int layer = 1; layer < 3; ++layer) {
    const int e = 2 * layer, o = 2 * layer + 1;
    glu_tile(real, d1, g.wl[e], g.bl[e], g.wr[e], g.br[e], spare, d1, ACT(2 * e),
             ACT(2 * e + 1));
    __syncthreads();
    float* t = real; real = spare; spare = t;
    glu_tile(imag, d1, g.wl[o], g.bl[o], g.wr[o], g.br[o], spare, d1, ACT(2 * o),
             ACT(2 * o + 1));
    __syncthreads();
    t = imag; imag = spare; spare = t;
  }
#undef ACT

  if constexpr (kOut) {
    for (int c = threadIdx.x; c < d1; c += blockDim.x) {
      const int kk = c / WM, m = c % WM;
      float acc[kTR] = {};
      for (int j = 0; j < WM; ++j) {
        const float wc = ci[j * WM + m];
        const float ws = si[j * WM + m];
        const int k = kk * WM + j;
        const float4* r4 = reinterpret_cast<const float4*>(real + k * kTRS);
        const float4* i4 = reinterpret_cast<const float4*>(imag + k * kTRS);
#pragma unroll
        for (int q = 0; q < kTR / 4; ++q) {
          const float4 u = r4[q], v = i4[q];
          acc[4 * q + 0] = fmaf(v.x, ws, fmaf(u.x, wc, acc[4 * q + 0]));
          acc[4 * q + 1] = fmaf(v.y, ws, fmaf(u.y, wc, acc[4 * q + 1]));
          acc[4 * q + 2] = fmaf(v.z, ws, fmaf(u.z, wc, acc[4 * q + 2]));
          acc[4 * q + 3] = fmaf(v.w, ws, fmaf(u.w, wc, acc[4 * q + 3]));
        }
      }
#pragma unroll
      for (int i = 0; i < kTR; ++i) {
        const long row = row0 + i;
        if (row >= rows) break;
        const long b = row / N, n = row % N;
        out[((b * K + kk) * N + n) * WM + m] = acc[i];
      }
    }
  }
}

// ---- backward ----

struct TransposedWeights {
  const float* l[6];  // Wl^T of GLU i, [D1, Din] row-major
  const float* r[6];
};

// wT[c][k] = w[k][c] for the 12 weight matrices; blockIdx.y = 2 * GLU + side
__global__ void spectral_transpose_kernel(GluWeights g, float* __restrict__ wT, int d0,
                                          int d1) {
  const int m = blockIdx.y, gi = m / 2;
  const int din = gi < 2 ? d0 : d1;
  const float* w = (m % 2 == 0) ? g.wl[gi] : g.wr[gi];
  float* o = wT + (m < 4 ? (long)m * d0 * d1 : 4L * d0 * d1 + (long)(m - 4) * d1 * d1);
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= din * d1) return;
  const int k = e / d1, c = e % d1;
  o[(long)c * din + k] = w[e];
}

// out[k][r] (+)= sum_c da[c][r] * wlT[c][k] + ds[c][r] * wrT[c][k], k < din
__device__ void bwd_tile(const float* da, const float* ds, int dmid,
                         const float* __restrict__ wlT, const float* __restrict__ wrT,
                         float* out, int din, bool accumulate) {
  for (int k = threadIdx.x; k < din; k += blockDim.x) {
    float acc[kTR] = {};
    for (int c = 0; c < dmid; ++c) {
      const float l = wlT[(long)c * din + k];
      const float r = wrT[(long)c * din + k];
      const float4* a4 = reinterpret_cast<const float4*>(da + c * kTRS);
      const float4* s4 = reinterpret_cast<const float4*>(ds + c * kTRS);
#pragma unroll
      for (int q = 0; q < kTR / 4; ++q) {
        const float4 u = a4[q], v = s4[q];
        acc[4 * q + 0] = fmaf(v.x, r, fmaf(u.x, l, acc[4 * q + 0]));
        acc[4 * q + 1] = fmaf(v.y, r, fmaf(u.y, l, acc[4 * q + 1]));
        acc[4 * q + 2] = fmaf(v.z, r, fmaf(u.z, l, acc[4 * q + 2]));
        acc[4 * q + 3] = fmaf(v.w, r, fmaf(u.w, l, acc[4 * q + 3]));
      }
    }
#pragma unroll
    for (int i = 0; i < kTR; ++i) {
      if (accumulate) acc[i] += out[k * kTRS + i];
      out[k * kTRS + i] = acc[i];
    }
  }
}

// One 32-row tile, the real chain and then the imaginary chain: g -> dR (dI)
// -> the chain's three GLUs backwards -> dx; da, ds of every GLU to dacts
// (laid out like acts). One chain at a time keeps the block at three
// [D1, 32] buffers, so that two blocks fit on an SM.
__global__ void __launch_bounds__(kThreads)
spectral_bwd_rows_kernel(const float* __restrict__ g, const float* __restrict__ acts,
                         float* __restrict__ dacts, long plane, TransposedWeights wt,
                         const float* __restrict__ ci, const float* __restrict__ si,
                         float* __restrict__ dx, int B, int K, int N, int W, int WM) {
  extern __shared__ __align__(16) float smem[];
  const int d0 = K * W, d1 = K * WM;
  const long rows = (long)B * N;
  const long row0 = (long)blockIdx.x * kTR;
  float* dy = smem;
  float* da = dy + d1 * kTRS;
  float* ds = da + d1 * kTRS;
  float* dxs = ds + d1 * kTRS;  // [d0][kTRS]

  for (int chain = 0; chain < 2; ++chain) {
    for (int e = threadIdx.x; e < kTR * d1; e += blockDim.x) {
      const int r = e / d1, col = e % d1;
      const long row = row0 + r;
      float v = 0.f;
      if (row < rows) {
        const long b = row / N, n = row % N;
        v = g[((b * K + col / WM) * N + n) * WM + col % WM];
      }
      da[col * kTRS + r] = v;  // the cotangent tile, until da is first written
    }
    __syncthreads();

    // dR[j] = sum_m g[m] * Ci[j][m] = sum_m g[m] * Ci[m][j] (symmetric), per
    // order; Si for the imaginary chain
    const float* idft = chain == 0 ? ci : si;
    for (int c = threadIdx.x; c < d1; c += blockDim.x) {
      const int kk = c / WM, j = c % WM;
      float acc[kTR] = {};
      for (int m = 0; m < WM; ++m) {
        const float w = idft[m * WM + j];
        const float4* g4 = reinterpret_cast<const float4*>(da + (kk * WM + m) * kTRS);
#pragma unroll
        for (int q = 0; q < kTR / 4; ++q) {
          const float4 u = g4[q];
          acc[4 * q + 0] = fmaf(u.x, w, acc[4 * q + 0]);
          acc[4 * q + 1] = fmaf(u.y, w, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(u.z, w, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(u.w, w, acc[4 * q + 3]);
        }
      }
#pragma unroll
      for (int i = 0; i < kTR; ++i) dy[c * kTRS + i] = acc[i];
    }
    __syncthreads();

    for (int layer = 2; layer >= 0; --layer) {
      const int gi = 2 * layer + chain;
      const float* a_g = acts + (2 * gi) * plane + row0 * d1;
      const float* s_g = acts + (2 * gi + 1) * plane + row0 * d1;
      float* da_g = dacts + (2 * gi) * plane + row0 * d1;
      float* ds_g = dacts + (2 * gi + 1) * plane + row0 * d1;
      for (int e = threadIdx.x; e < kTR * d1; e += blockDim.x) {
        const int r = e / d1, c = e % d1;
        const float a = a_g[e], s = s_g[e], v = dy[c * kTRS + r];
        const float va = v * s;
        const float vs = v * a * (s * (1.f - s));
        da[c * kTRS + r] = va;
        ds[c * kTRS + r] = vs;
        da_g[e] = va;
        ds_g[e] = vs;
      }
      __syncthreads();
      if (layer > 0) {
        bwd_tile(da, ds, d1, wt.l[gi], wt.r[gi], dy, d1, false);
      } else {
        bwd_tile(da, ds, d1, wt.l[gi], wt.r[gi], dxs, d0, chain == 1);
      }
      __syncthreads();
    }
  }

  for (int e = threadIdx.x; e < kTR * d0; e += blockDim.x) {
    const int r = e / d0, col = e % d0;
    const long row = row0 + r;
    if (row < rows) {
      const long b = row / N, n = row % N;
      dx[((b * K + col / W) * N + n) * W + col % W] = dxs[col * kTRS + r];
    }
  }
}

constexpr int kWT = 48;        // edge of a weight-gradient tile
constexpr int kWEdge = kWT / 4;  // threads along an edge, 4 outputs each
constexpr int kWThreads = kWEdge * kWEdge;
constexpr int kWRows = kTR;    // rows staged per step

// floats of GLU gi's block in the flat gradient buffer: wl, bl, wr, br
__host__ __device__ inline long glu_grad_offset(int gi, int d0, int d1) {
  const long s0 = 2L * ((long)d0 * d1 + d1), s1 = 2L * ((long)d1 * d1 + d1);
  return gi < 2 ? gi * s0 : 2 * s0 + (gi - 2) * s1;
}

// blockIdx: x = tile (k tile * tiles + c tile), y = GLU, z = row segment.
// part: [gridDim.z][total] partial gradients in the flat layout.
__global__ void __launch_bounds__(kWThreads)
spectral_wgrad_kernel(const float* __restrict__ x, const float* __restrict__ acts,
                      const float* __restrict__ dacts, long plane,
                      float* __restrict__ part, long total, int chunks, int chunks_per_seg,
                      int B, int K, int N, int W, int WM) {
  __shared__ __align__(16) float us[kWRows][kWT];
  __shared__ __align__(16) float das[kWRows][kWT];
  __shared__ __align__(16) float dss[kWRows][kWT];
  const int d0 = K * W, d1 = K * WM;
  const int tiles = (d1 + kWT - 1) / kWT;
  const int gi = blockIdx.y;
  const int din = gi < 2 ? d0 : d1;
  const int k0 = (blockIdx.x / tiles) * kWT, c0 = (blockIdx.x % tiles) * kWT;
  if (k0 >= din) return;  // the whole block: layer 0 has fewer k tiles
  const long rows = (long)B * N;
  const int tx = threadIdx.x % kWEdge, ty = threadIdx.x / kWEdge;
  const bool bias = (k0 == 0 && ty == 0);
  const float* a_src = gi < 2 ? nullptr : acts + (2 * (gi - 2)) * plane;
  const float* s_src = gi < 2 ? nullptr : acts + (2 * (gi - 2) + 1) * plane;
  const float* da_src = dacts + (2 * gi) * plane;
  const float* ds_src = dacts + (2 * gi + 1) * plane;

  float accl[4][4] = {}, accr[4][4] = {}, bl[4] = {}, br[4] = {};
  const int ch0 = blockIdx.z * chunks_per_seg;
  const int ch1 = min(chunks, ch0 + chunks_per_seg);
  for (int ch = ch0; ch < ch1; ++ch) {
    for (int e = threadIdx.x; e < kWRows * kWT; e += blockDim.x) {
      const int r = e / kWT, col = e % kWT;
      const long row = (long)ch * kWRows + r;
      const int kc = k0 + col, cc = c0 + col;
      float u = 0.f, va = 0.f, vs = 0.f;
      if (kc < din) {
        if (gi < 2) {
          if (row < rows) {
            const long b = row / N, n = row % N;
            u = x[((b * K + kc / W) * N + n) * W + kc % W];
          }
        } else {
          u = a_src[row * d1 + kc] * s_src[row * d1 + kc];
        }
      }
      if (cc < d1) {
        va = da_src[row * d1 + cc];
        vs = ds_src[row * d1 + cc];
      }
      us[r][col] = u;
      das[r][col] = va;
      dss[r][col] = vs;
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < kWRows; ++r) {
      const float4 u4 = *reinterpret_cast<const float4*>(&us[r][4 * ty]);
      const float4 a4 = *reinterpret_cast<const float4*>(&das[r][4 * tx]);
      const float4 s4 = *reinterpret_cast<const float4*>(&dss[r][4 * tx]);
      const float u[4] = {u4.x, u4.y, u4.z, u4.w};
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float s[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          accl[i][j] = fmaf(u[i], a[j], accl[i][j]);
          accr[i][j] = fmaf(u[i], s[j], accr[i][j]);
        }
      }
      if (bias) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          bl[j] += a[j];
          br[j] += s[j];
        }
      }
    }
    __syncthreads();
  }

  float* base = part + (long)blockIdx.z * total + glu_grad_offset(gi, d0, d1);
  float* pwl = base;
  float* pbl = pwl + (long)din * d1;
  float* pwr = pbl + d1;
  float* pbr = pwr + (long)din * d1;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = c0 + 4 * tx + j;
    if (c >= d1) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + 4 * ty + i;
      if (k >= din) continue;
      pwl[(long)k * d1 + c] = accl[i][j];
      pwr[(long)k * d1 + c] = accr[i][j];
    }
    if (bias) {
      pbl[c] = bl[j];
      pbr[c] = br[j];
    }
  }
}

// grads[i] = part[0][i] + part[1][i] + ... in that order
__global__ void spectral_reduce_kernel(const float* __restrict__ part,
                                       float* __restrict__ grads, long total,
                                       int nsplit) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float acc = part[i];
  for (int s = 1; s < nsplit; ++s) acc += part[(long)s * total + i];
  grads[i] = acc;
}

GluWeights glu_weights(const void* const* w) {
  GluWeights g;
  for (int i = 0; i < 6; ++i) {
    g.wl[i] = static_cast<const float*>(w[4 * i + 0]);
    g.bl[i] = static_cast<const float*>(w[4 * i + 1]);
    g.wr[i] = static_cast<const float*>(w[4 * i + 2]);
    g.br[i] = static_cast<const float*>(w[4 * i + 3]);
  }
  return g;
}

long chain_smem(int K, int W, int WM) {
  return (long)(K * W + 3 * K * WM) * kTRS * (long)sizeof(float);
}

long rows_padded(int B, int N) { return ((long)B * N + kTR - 1) / kTR * kTR; }

long grads_total(int d0, int d1) { return glu_grad_offset(6, d0, d1); }

}  // namespace

// w: 24 device pointers, per GLU i = 0..5: wl[i], bl[i], wr[i], br[i]
// (wl/wr [Din, D1] row-major, layer-0 weights already DFT-folded); ci, si:
// one [WM, WM] block of the inverse DFT. A shape whose buffers exceed the
// shared memory of a block fails at cudaFuncSetAttribute.
extern "C" int spectral_fwd(const float* x, const void* const* w, const float* ci,
                            const float* si, float* out, int B, int K, int N, int W,
                            int WM, void* stream) {
  const long smem = chain_smem(K, W, WM);
  cudaError_t err = cudaFuncSetAttribute(
      spectral_chain_kernel<false, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (int)(rows_padded(B, N) / kTR);
  spectral_chain_kernel<false, true><<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      x, glu_weights(w), ci, si, out, nullptr, 0, B, K, N, W, WM);
  return (int)cudaGetLastError();
}

// Floats of the 12 saved arrays (a0, s0, ..., a5, s5), each [padded rows, D1].
extern "C" long long spectral_act_floats(int B, int K, int N, int WM) {
  return 12 * rows_padded(B, N) * (long)K * WM;
}

// spectral_fwd that also writes acts (spectral_act_floats floats) for
// spectral_bwd_reread.
extern "C" int spectral_fwd_save(const float* x, const void* const* w, const float* ci,
                                 const float* si, float* out, float* acts, int B, int K,
                                 int N, int W, int WM, void* stream) {
  const long smem = chain_smem(K, W, WM);
  cudaError_t err = cudaFuncSetAttribute(
      spectral_chain_kernel<true, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long rows_pad = rows_padded(B, N);
  spectral_chain_kernel<true, true>
      <<<(int)(rows_pad / kTR), kThreads, smem, (cudaStream_t)stream>>>(
          x, glu_weights(w), ci, si, out, acts, rows_pad * K * WM, B, K, N, W, WM);
  return (int)cudaGetLastError();
}

// Floats of the flat gradient buffer: per GLU wl [Din, D1], bl [D1], wr, br.
extern "C" long long spectral_bwd_grad_floats(int K, int W, int WM) {
  return grads_total(K * W, K * WM);
}

namespace {

// Floats of the backward's scratch without the saved arrays: da, ds of six
// GLUs for the padded rows, the transposed weights, nsplit partial gradients.
long bwd_scratch_floats(int B, int K, int N, int W, int WM, int nsplit) {
  const long d0 = K * W, d1 = K * WM;
  return 12 * rows_padded(B, N) * d1 + 4 * d0 * d1 + 8 * d1 * d1 +
         (long)nsplit * grads_total(d0, d1);
}

// Steps 1 to 5 of the backward. saved: the forward's 12 arrays, or nullptr to
// recompute them (step 2) into the head of ws.
int bwd_launch(const float* x, const float* g, const void* const* w, const float* ci,
               const float* si, float* dx, float* grads, const float* saved, float* ws,
               int B, int K, int N, int W, int WM, int nsplit, cudaStream_t st) {
  const int d0 = K * W, d1 = K * WM;
  const long rows_pad = rows_padded(B, N);
  const long plane = rows_pad * d1;
  const long total = grads_total(d0, d1);
  const GluWeights gw = glu_weights(w);
  const int blocks = (int)(rows_pad / kTR);
  cudaError_t err;

  const float* acts = saved;
  if (saved == nullptr) {
    const long smem_f = chain_smem(K, W, WM);
    err = cudaFuncSetAttribute(spectral_chain_kernel<true, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_f);
    if (err != cudaSuccess) return (int)err;
    spectral_chain_kernel<true, false><<<blocks, kThreads, smem_f, st>>>(
        x, gw, ci, si, nullptr, ws, plane, B, K, N, W, WM);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    acts = ws;
    ws += 12 * plane;
  }
  float* dacts = ws;
  float* wT = dacts + 12 * plane;
  float* part = wT + 4L * d0 * d1 + 8L * d1 * d1;

  spectral_transpose_kernel<<<dim3((d1 * d1 + 255) / 256, 12), 256, 0, st>>>(gw, wT, d0,
                                                                            d1);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  TransposedWeights wt;
  for (int m = 0; m < 12; ++m) {
    const float* p = wT + (m < 4 ? (long)m * d0 * d1 : 4L * d0 * d1 + (long)(m - 4) * d1 * d1);
    if (m % 2 == 0) wt.l[m / 2] = p; else wt.r[m / 2] = p;
  }
  const long smem_b = chain_smem(K, W, WM);  // three [D1, 32] buffers and dx's
  err = cudaFuncSetAttribute(spectral_bwd_rows_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_b);
  if (err != cudaSuccess) return (int)err;
  spectral_bwd_rows_kernel<<<blocks, kThreads, smem_b, st>>>(
      g, acts, dacts, plane, wt, ci, si, dx, B, K, N, W, WM);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int tiles = (d1 + kWT - 1) / kWT;
  const int chunks = (int)(rows_pad / kWRows);
  const int chunks_per_seg = (chunks + nsplit - 1) / nsplit;
  spectral_wgrad_kernel<<<dim3(tiles * tiles, 6, nsplit), kWThreads, 0, st>>>(
      x, acts, dacts, plane, part, total, chunks, chunks_per_seg, B, K, N, W, WM);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  spectral_reduce_kernel<<<(int)((total + 255) / 256), 256, 0, st>>>(part, grads, total,
                                                                     nsplit);
  return (int)cudaGetLastError();
}

}  // namespace

// Floats of the scratch `spectral_bwd` needs: a, s of six GLUs for the padded
// rows and the backward's scratch.
extern "C" long long spectral_bwd_workspace_floats(int B, int K, int N, int W, int WM,
                                                   int nsplit) {
  return 12 * rows_padded(B, N) * (long)K * WM + bwd_scratch_floats(B, K, N, W, WM, nsplit);
}

// The same for `spectral_bwd_reread`, which brings a and s with it: 12 arrays
// fewer.
extern "C" long long spectral_bwd_reread_workspace_floats(int B, int K, int N, int W,
                                                          int WM, int nsplit) {
  return bwd_scratch_floats(B, K, N, W, WM, nsplit);
}

// x [B,K,N,W], g [B,K,N,WM], w as for spectral_fwd -> dx like x and grads
// (flat, layer 0 in folded space). ws: spectral_bwd_workspace_floats floats.
extern "C" int spectral_bwd(const float* x, const float* g, const void* const* w,
                            const float* ci, const float* si, float* dx, float* grads,
                            float* ws, int B, int K, int N, int W, int WM, int nsplit,
                            void* stream) {
  return bwd_launch(x, g, w, ci, si, dx, grads, nullptr, ws, B, K, N, W, WM, nsplit,
                    (cudaStream_t)stream);
}

// spectral_bwd on the arrays spectral_fwd_save wrote (acts), without the
// recompute. ws: spectral_bwd_reread_workspace_floats floats.
extern "C" int spectral_bwd_reread(const float* x, const float* g, const void* const* w,
                                   const float* ci, const float* si, const float* acts,
                                   float* dx, float* grads, float* ws, int B, int K, int N,
                                   int W, int WM, int nsplit, void* stream) {
  return bwd_launch(x, g, w, ci, si, dx, grads, acts, ws, B, K, N, W, WM, nsplit,
                    (cudaStream_t)stream);
}
