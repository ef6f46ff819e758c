// Latent-correlation attention, forward and backward.
//
// Forward: replaces stemgnn_tpu/ops/pallas_attention.py `_kernel` (reached from
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
//
// Backward (`attention_kq_bwd`): replaces `_bwd_kernel` (reached from `_bwd`):
// from the saved softmax output p and the cotangent g, both [B, N, N],
//   dl = g * p - p * rowsum(g * p)            (softmax backward)
//   dpre = pre >= 0 ? dl : alpha * dl, pre = key_i + query_j   (recomputed)
//   dkey[b, i] = sum_j dpre;  dquery[b, j] = sum_i dpre
// Bytes bound again: p and g are read once, nothing of size N*N is written.
// The TPU kernel adds dquery up across row tiles in one output block, which
// its sequential grid allows. Here a block owns (b, a tile of 32 rows): each
// warp walks its rows, reduces dkey with shuffles and adds its rows' dpre
// into its own row of a [warps][N] shared array; the block then sums the
// warps in order into part[b][tile][:], and a second kernel sums the tiles
// in order. Every sum has one fixed order, so two runs give the same bits;
// no atomics.

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

constexpr int kBwdRows = 32;  // rows of one (b, tile) block

__global__ void attention_kq_bwd_kernel(const float* __restrict__ key,
                                        const float* __restrict__ query,
                                        const float* __restrict__ p,
                                        const float* __restrict__ g,
                                        float* __restrict__ dkey,
                                        float* __restrict__ part, int B, int N,
                                        int tiles, float alpha) {
  extern __shared__ float col[];  // [kWarpsPerBlock][N]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const float* q = query + (long)b * N;
  float* mine = col + warp * N;
  for (int j = lane; j < N; j += 32) mine[j] = 0.f;
  const int i_end = min(N, (tile + 1) * kBwdRows);
  for (int i = tile * kBwdRows + warp; i < i_end; i += kWarpsPerBlock) {
    const long row = (long)b * N + i;
    const float* pr = p + row * N;
    const float* gr = g + row * N;
    float dot = 0.f;
    for (int j = lane; j < N; j += 32) dot += gr[j] * pr[j];
    dot = warp_sum(dot);
    const float k = key[row];
    float dk = 0.f;
    for (int j = lane; j < N; j += 32) {
      const float pj = pr[j];
      const float dl = gr[j] * pj - pj * dot;
      const float dpre = (k + q[j] >= 0.f) ? dl : alpha * dl;
      dk += dpre;
      mine[j] += dpre;  // lane owns column j of its warp's row
    }
    dk = warp_sum(dk);
    if (lane == 0) dkey[row] = dk;
  }
  __syncthreads();
  float* out = part + ((long)b * tiles + tile) * N;
  for (int j = threadIdx.x; j < N; j += blockDim.x) {
    float acc = 0.f;
    for (int w = 0; w < kWarpsPerBlock; ++w) acc += col[w * N + j];
    out[j] = acc;
  }
}

__global__ void attention_dquery_kernel(const float* __restrict__ part,
                                        float* __restrict__ dquery, int B, int N,
                                        int tiles) {
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long)B * N) return;
  const long b = e / N, j = e % N;
  float acc = 0.f;
  for (int t = 0; t < tiles; ++t) acc += part[(b * tiles + t) * N + j];
  dquery[e] = acc;
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

// Row tiles of one batch element: part is [B, tiles, N] scratch.
extern "C" int attention_kq_bwd_tiles(int N) { return (N + kBwdRows - 1) / kBwdRows; }

extern "C" int attention_kq_bwd(const float* key, const float* query, const float* p,
                                const float* g, float* dkey, float* dquery,
                                float* part, int B, int N, float alpha,
                                void* stream) {
  const int tiles = attention_kq_bwd_tiles(N);
  const long smem = (long)kWarpsPerBlock * N * (long)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      attention_kq_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  attention_kq_bwd_kernel<<<B * tiles, kWarpsPerBlock * 32, smem,
                            (cudaStream_t)stream>>>(key, query, p, g, dkey, part, B, N,
                                                    tiles, alpha);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long total = (long)B * N;
  attention_dquery_kernel<<<(int)((total + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      part, dquery, B, N, tiles);
  return (int)cudaGetLastError();
}
