// Spectral-sequential cell, forward.
//
// Replaces stemgnn_tpu/ops/pallas_spectral.py `_kernel` (reached from
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

// out[c][r] = (in[:, r] . Wl[:, c] + bl[c]) * sigmoid(in[:, r] . Wr[:, c] + br[c])
__device__ void glu_tile(const float* in, int din, const float* __restrict__ wl,
                         const float* __restrict__ bl, const float* __restrict__ wr,
                         const float* __restrict__ br, float* out, int dout) {
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
    for (int i = 0; i < kTR; ++i) out[c * kTRS + i] = (al[i] + bL) * sigmoidf(ar[i] + bR);
  }
}

__global__ void __launch_bounds__(kThreads)
spectral_fwd_kernel(const float* __restrict__ x, GluWeights g,
                    const float* __restrict__ ci, const float* __restrict__ si,
                    float* __restrict__ out, int B, int K, int N, int W, int WM) {
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

  glu_tile(xs, d0, g.wl[0], g.bl[0], g.wr[0], g.br[0], real, d1);
  glu_tile(xs, d0, g.wl[1], g.bl[1], g.wr[1], g.br[1], imag, d1);
  __syncthreads();
  for (int layer = 1; layer < 3; ++layer) {
    glu_tile(real, d1, g.wl[2 * layer], g.bl[2 * layer], g.wr[2 * layer],
             g.br[2 * layer], spare, d1);
    __syncthreads();
    float* t = real; real = spare; spare = t;
    glu_tile(imag, d1, g.wl[2 * layer + 1], g.bl[2 * layer + 1],
             g.wr[2 * layer + 1], g.br[2 * layer + 1], spare, d1);
    __syncthreads();
    t = imag; imag = spare; spare = t;
  }

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

}  // namespace

// w: 24 device pointers, per GLU i = 0..5: wl[i], bl[i], wr[i], br[i]
// (wl/wr [Din, D1] row-major, layer-0 weights already DFT-folded); ci, si:
// one [WM, WM] block of the inverse DFT. A shape whose buffers exceed the
// shared memory of a block fails at cudaFuncSetAttribute.
extern "C" int spectral_fwd(const float* x, const void* const* w, const float* ci,
                            const float* si, float* out, int B, int K, int N, int W,
                            int WM, void* stream) {
  GluWeights g;
  for (int i = 0; i < 6; ++i) {
    g.wl[i] = static_cast<const float*>(w[4 * i + 0]);
    g.bl[i] = static_cast<const float*>(w[4 * i + 1]);
    g.wr[i] = static_cast<const float*>(w[4 * i + 2]);
    g.br[i] = static_cast<const float*>(w[4 * i + 3]);
  }
  const long smem = (long)(K * W + 3 * K * WM) * kTRS * (long)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      spectral_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long rows = (long)B * N;
  const int blocks = (int)((rows + kTR - 1) / kTR);
  spectral_fwd_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      x, g, ci, si, out, B, K, N, W, WM);
  return (int)cudaGetLastError();
}
