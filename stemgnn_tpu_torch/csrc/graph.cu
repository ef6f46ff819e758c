// Chebyshev graph convolution, forward.
//
// Replaces stemgnn_tpu/ops/pallas_graph.py `_kernel` (reached from
// `_forward` / `cheb_graph_conv_pallas`): out[b,k,n,w] = sum_m
// mul_L[k,n,m] * x[b,m,w] for k = 1..K-1, with the k = 0 slab all zeros
// (the reference's T0 = 0), mul_L [K,N,N], x [B,N,W], out [B,K,N,W], f32.
//
// Bound on the H100: f32 operations (2*(K-1)*N*N*B*W of them against
// about 4*(K-1)*N*N + 4*(K+1)*B*N*W bytes). The design is a shared-memory
// tiled f32 GEMM of each order's [N,N] by x viewed as [N, B*W]: 64x64
// output tiles, a K-slab of 16, 256 threads with a 4x4 register tile each,
// blockIdx.z the order. The kernel reads x in its [B,N,W] layout and
// writes straight into [B,K,N,W], so no transpose or pad ever reaches
// device memory; ragged edges are masked. The z = 0 blocks skip the
// all-zero product and only write its zero slab.

#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
cheb_graph_conv_kernel(const float* __restrict__ L, const float* __restrict__ x,
                       float* __restrict__ out, int K, int N, int B, int W) {
  const int k = blockIdx.z;
  const int n0 = blockIdx.y * kBM;
  const int c0 = blockIdx.x * kBN;
  const int ncols = B * W;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;

  if (k == 0) {  // T0 = 0: the slab is zeros, no product
    for (int e = tid; e < kBM * kBN; e += kThreads) {
      const int n = n0 + e / kBN, col = c0 + e % kBN;
      if (n < N && col < ncols) {
        const int b = col / W, w = col % W;
        out[(((long)b * K) * N + n) * W + w] = 0.f;
      }
    }
    return;
  }

  __shared__ float As[kBK][kBM];
  __shared__ float Bs[kBK][kBN];
  const float* Lk = L + (long)k * N * N;
  float acc[4][4] = {};

  for (int m0 = 0; m0 < N; m0 += kBK) {
    for (int e = tid; e < kBM * kBK; e += kThreads) {
      const int r = e / kBK, kk = e % kBK;
      const int n = n0 + r, m = m0 + kk;
      As[kk][r] = (n < N && m < N) ? Lk[(long)n * N + m] : 0.f;
    }
    for (int e = tid; e < kBK * kBN; e += kThreads) {
      const int kk = e / kBN, c = e % kBN;
      const int m = m0 + kk, col = c0 + c;
      float v = 0.f;
      if (m < N && col < ncols) {
        const int b = col / W, w = col % W;
        v = x[((long)b * N + m) * W + w];
      }
      Bs[kk][c] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ty + 16 * i;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = c0 + tx + 16 * j;
      if (col >= ncols) continue;
      const int b = col / W, w = col % W;
      out[(((long)b * K + k) * N + n) * W + w] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" int cheb_graph_conv_fwd(const float* L, const float* x, float* out,
                                   int K, int N, int B, int W, void* stream) {
  const dim3 grid((B * W + kBN - 1) / kBN, (N + kBM - 1) / kBM, K);
  cheb_graph_conv_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      L, x, out, K, N, B, W);
  return (int)cudaGetLastError();
}
