// GRU recurrence over the node axis, forward.
//
// Replaces stemgnn_tpu/ops/pallas_gru.py `_fwd_kernel` (reached from
// `_run_forward` / `gru_over_nodes_pallas`): N dependent steps of
//   hp = h @ A + bh            (A = W_hh^T, [H, 3H], gate-major r, z, n)
//   r = sigmoid(x_r + hp_r); z = sigmoid(x_z + hp_z)
//   c = tanh(x_n + r * hp_n);  h' = (1 - z) * c + z * h
// with xp = x @ W_ih^T + b_ih computed outside (one matmul, as the JAX
// package leaves it to XLA). Serving needs only the outputs, so the saved
// gate activations of the TPU kernel are not written.
//
// Bound on the H100: f32 operations on the serial chain. Each step is a
// [B,H] x [H,3H] product (2*B*H*3H operations) that depends on the step
// before, so the work cannot spread over the card without a grid-wide
// barrier per step. The fused f32 weight at H = 140 is 235,200 bytes, more
// than the 232,448 bytes of shared memory a block can have, so keeping the
// weights resident as the TPU kernel does in VMEM does not carry over.
// Design: ONE persistent block loops over the N steps. h lives in shared
// memory, double-buffered ([H][B] layout, two copies) so one
// __syncthreads() per step separates reads of h from writes of h'. A and
// bh are read from global memory, where they stay L2-resident. Each thread
// owns one hidden unit j (all three of its gate columns) for 8 batch rows,
// so the gate math needs no exchange between threads. Works at any H whose
// double-buffered h fits in shared memory.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBSub = 8;  // batch rows per thread
constexpr int kMaxThreads = 1024;

__device__ __forceinline__ float sigmoidf(float v) { return 1.f / (1.f + expf(-v)); }

__global__ void __launch_bounds__(kMaxThreads)
gru_fwd_kernel(const float* __restrict__ xp, const float* __restrict__ A,
               const float* __restrict__ bh, float* __restrict__ out, int N,
               int B, int H) {
  extern __shared__ __align__(16) float smem[];
  const int Bp = (B + kBSub - 1) / kBSub * kBSub;
  float* h_cur = smem;
  float* h_next = smem + (long)H * Bp;
  for (int e = threadIdx.x; e < 2 * H * Bp; e += blockDim.x) smem[e] = 0.f;
  __syncthreads();

  const int H3 = 3 * H;
  const int items = H * (Bp / kBSub);
  for (int t = 0; t < N; ++t) {
    for (int item = threadIdx.x; item < items; item += blockDim.x) {
      const int j = item % H;
      const int b0 = (item / H) * kBSub;
      float ar[kBSub] = {}, az[kBSub] = {}, an[kBSub] = {};
      const float* a = A + j;
      for (int k = 0; k < H; ++k) {
        const float wr = a[(long)k * H3];
        const float wz = a[(long)k * H3 + H];
        const float wn = a[(long)k * H3 + 2 * H];
        const float4 lo = *reinterpret_cast<const float4*>(h_cur + k * Bp + b0);
        const float4 hi = *reinterpret_cast<const float4*>(h_cur + k * Bp + b0 + 4);
        const float hv[kBSub] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int i = 0; i < kBSub; ++i) {
          ar[i] = fmaf(hv[i], wr, ar[i]);
          az[i] = fmaf(hv[i], wz, az[i]);
          an[i] = fmaf(hv[i], wn, an[i]);
        }
      }
      const float br = bh[j], bz = bh[H + j], bn = bh[2 * H + j];
#pragma unroll
      for (int i = 0; i < kBSub; ++i) {
        const int b = b0 + i;
        if (b >= B) break;
        const float* x = xp + ((long)t * B + b) * H3;
        const float r = sigmoidf(x[j] + (ar[i] + br));
        const float z = sigmoidf(x[H + j] + (az[i] + bz));
        const float c = tanhf(x[2 * H + j] + r * (an[i] + bn));
        const float h = (1.f - z) * c + z * h_cur[j * Bp + b];
        h_next[j * Bp + b] = h;
        out[((long)b * N + t) * H + j] = h;
      }
    }
    __syncthreads();
    float* tmp = h_cur;
    h_cur = h_next;
    h_next = tmp;
  }
}

}  // namespace

// A (B, H) whose double-buffered h exceeds the shared memory of a block
// fails at cudaFuncSetAttribute.
extern "C" int gru_fwd(const float* xp, const float* A, const float* bh, float* out,
                       int N, int B, int H, void* stream) {
  const int Bp = (B + kBSub - 1) / kBSub * kBSub;
  const long smem = 2L * H * Bp * (long)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gru_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int items = H * (Bp / kBSub);
  int threads = (items + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  gru_fwd_kernel<<<1, threads, smem, (cudaStream_t)stream>>>(xp, A, bh, out, N, B, H);
  return (int)cudaGetLastError();
}
