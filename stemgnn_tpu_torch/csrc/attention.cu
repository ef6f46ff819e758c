// Latent-correlation attention, forward.
//
// Replaces stemgnn_tpu/ops/pallas_attention.py `_kernel` (reached from
// `_forward_kq` / `attention_kq_pallas`): scores[b,i,j] = key[b,i] +
// query[b,j], LeakyReLU(alpha), stable row softmax, out [B, N, N] f32.
//
// Bound on the H100: bytes. The kernel reads 2*B*N floats and writes
// B*N*N; its arithmetic is a few operations per output element. The design
// writes each output element exactly once and never stores the scores:
// one warp owns one (b, i) row, the lanes stride over j, and warp shuffles
// give the row max and the row sum, so the only traffic to device memory is
// the coalesced row write (the query row is re-read from L1/L2). The TPU
// kept alpha in SMEM; here it is a kernel argument.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float leaky(float s, float alpha) {
  return s >= 0.f ? s : alpha * s;
}

__global__ void attention_kq_kernel(const float* __restrict__ key,
                                    const float* __restrict__ query,
                                    float* __restrict__ out, int B, int N,
                                    float alpha) {
  const int lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= (long)B * N) return;  // whole warp leaves together
  const int b = (int)(row / N);
  const float k = key[row];
  const float* q = query + (long)b * N;
  float* o = out + row * N;

  float m = -INFINITY;
  for (int j = lane; j < N; j += 32) m = fmaxf(m, leaky(k + q[j], alpha));
  m = warp_max(m);
  float s = 0.f;
  for (int j = lane; j < N; j += 32) s += expf(leaky(k + q[j], alpha) - m);
  s = warp_sum(s);
  const float inv = 1.f / s;
  for (int j = lane; j < N; j += 32) o[j] = expf(leaky(k + q[j], alpha) - m) * inv;
}

}  // namespace

extern "C" int attention_kq_fwd(const float* key, const float* query, float* out,
                                int B, int N, float alpha, void* stream) {
  const long rows = (long)B * N;
  const int blocks = (int)((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  attention_kq_kernel<<<blocks, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
      key, query, out, B, N, alpha);
  return (int)cudaGetLastError();
}
