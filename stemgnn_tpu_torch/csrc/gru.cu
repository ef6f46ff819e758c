// GRU recurrence over the node axis, forward and backward.
//
// Forward: replaces stemgnn_tpu/ops/pallas_gru.py `_fwd_kernel` (reached from
// `_run_forward` / `gru_over_nodes_pallas`): N dependent steps of
//   hp = h @ A + bh            (A = W_hh^T, [H, 3H], gate-major r, z, n)
//   r = sigmoid(x_r + hp_r); z = sigmoid(x_z + hp_z)
//   c = tanh(x_n + r * hp_n);  h' = (1 - z) * c + z * h
// with xp = x @ W_ih^T + b_ih computed outside (one matmul, as the JAX
// package leaves it to XLA). Serving needs only the outputs (`gru_fwd`);
// training also needs the TPU kernel's saved gate activations
// sv[t] = (r, z, hpn, c, h - c), hpn = hp_n, which `gru_fwd_save` writes as
// [N, 5, B, H].
//
// Backward (`gru_bwd`): replaces `_bwd_kernel` (reached from `_vjp_bwd`): the
// reverse recurrence over sv with the cotangent g [B, N, H] of the outputs,
//   dh_total = g[t] + dh
//   dz = dh_total * (h - c) * z * (1 - z); dn = dh_total * (1 - z) * (1 - c^2)
//   dr = dn * hpn * r * (1 - r);           dxp[t] = (dr, dz, dn)
//   dh = dh_total * z + (dr, dz, dn * r) @ A^T
// writing dxp [N, B, 3H]. The weight and bias gradients are products over
// all steps at once, outside the kernel, as the JAX package leaves them.
//
// Bound on the H100: f32 operations on the serial chain. Each step is a
// [B,H] x [H,3H] product (2*B*H*3H operations) that depends on the step
// before, so the work cannot spread over the card without a grid-wide
// barrier per step. The fused f32 weight at H = 140 is 235,200 bytes, more
// than the 232,448 bytes of shared memory a block can have, so keeping the
// weights resident as the TPU kernel does in VMEM does not carry over.
// Design: ONE persistent block loops over the N steps. h lives in shared
// memory, double-buffered ([H][B + 4] layout, two copies) so one
// __syncthreads() per step separates reads of h from writes of h'. A and
// bh are read from global memory, where they stay L2-resident. Each thread
// owns one hidden unit j (all three of its gate columns) for 8 batch rows,
// so the gate math needs no exchange between threads, and reads and writes
// its 8 rows of h as two float4 (see kPad). Works at any H whose
// double-buffered h fits in shared memory.
//
// The backward has the same bound and the same shape: one persistent block,
// dh [H][B + 4] and the step's (dr, dz, dn * r) [3H][B + 4] in shared memory, the
// same thread owning hidden unit j for 8 batch rows in the elementwise half
// and in the product, so dh needs no exchange and a step takes two
// barriers (after the gate gradients are written, after the product has
// read them). A^T is W_hh itself ([3H, H] row-major), read from L2 with
// neighbouring threads on neighbouring addresses; sv is laid out [N, 5, B, H]
// so both kernels touch it with the threads running along H.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBSub = 8;  // batch rows per thread
constexpr int kMaxThreads = 1024;

__device__ __forceinline__ float sigmoidf(float v) { return 1.f / (1.f + expf(-v)); }

// Rows of the [H][.] shared arrays are kPad floats longer than the padded
// batch: with the lanes of a warp along j, a thread's float4 at [j * Bs + b0]
// then falls 4 banks after its neighbour's, so the 8 lanes served together
// cover all 32 banks. At a stride of 32 every such access was a 32-way
// conflict.
constexpr int kPad = 4;

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

template <bool kSave>
__global__ void __launch_bounds__(kMaxThreads)
gru_fwd_kernel(const float* __restrict__ xp, const float* __restrict__ A,
               const float* __restrict__ bh, float* __restrict__ out,
               float* __restrict__ sv, int N, int B, int H) {
  extern __shared__ __align__(16) float smem[];
  const int Bp = (B + kBSub - 1) / kBSub * kBSub;
  const int Bs = Bp + kPad;
  float* h_cur = smem;
  float* h_next = smem + (long)H * Bs;
  for (int e = threadIdx.x; e < 2 * H * Bs; e += blockDim.x) smem[e] = 0.f;
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
        float hv[kBSub];
        load8(h_cur + k * Bs + b0, hv);
#pragma unroll
        for (int i = 0; i < kBSub; ++i) {
          ar[i] = fmaf(hv[i], wr, ar[i]);
          az[i] = fmaf(hv[i], wz, az[i]);
          an[i] = fmaf(hv[i], wn, an[i]);
        }
      }
      const float br = bh[j], bz = bh[H + j], bn = bh[2 * H + j];
      float h_prev[kBSub], h_new[kBSub] = {};
      load8(h_cur + j * Bs + b0, h_prev);
#pragma unroll
      for (int i = 0; i < kBSub; ++i) {
        const int b = b0 + i;
        if (b < B) {
          const float* x = xp + ((long)t * B + b) * H3;
          const float r = sigmoidf(x[j] + (ar[i] + br));
          const float z = sigmoidf(x[H + j] + (az[i] + bz));
          const float hpn = an[i] + bn;
          const float c = tanhf(x[2 * H + j] + r * hpn);
          const float h = (1.f - z) * c + z * h_prev[i];
          if (kSave) {
            const long plane = (long)B * H;
            float* s = sv + (long)t * 5 * plane + (long)b * H + j;
            s[0] = r;
            s[plane] = z;
            s[2 * plane] = hpn;
            s[3 * plane] = c;
            s[4 * plane] = h_prev[i] - c;
          }
          h_new[i] = h;
          out[((long)b * N + t) * H + j] = h;
        }
      }
      store8(h_next + j * Bs + b0, h_new);
    }
    __syncthreads();
    float* tmp = h_cur;
    h_cur = h_next;
    h_next = tmp;
  }
}

__global__ void __launch_bounds__(kMaxThreads)
gru_bwd_kernel(const float* __restrict__ sv, const float* __restrict__ g,
               const float* __restrict__ At, float* __restrict__ dxp, int N,
               int B, int H) {
  extern __shared__ __align__(16) float smem[];
  const int Bp = (B + kBSub - 1) / kBSub * kBSub;
  const int Bs = Bp + kPad;
  const int H3 = 3 * H;
  float* dh = smem;                   // [H][Bs]
  float* dcat = smem + (long)H * Bs;  // [3H][Bs]: dr, dz, dn * r
  for (int e = threadIdx.x; e < 4 * H * Bs; e += blockDim.x) smem[e] = 0.f;
  __syncthreads();

  const long plane = (long)B * H;
  const int items = H * (Bp / kBSub);
  for (int t = N - 1; t >= 0; --t) {
    // gate gradients of this thread's (j, 8 batch rows); dh keeps dh_total * z
    for (int item = threadIdx.x; item < items; item += blockDim.x) {
      const int j = item % H;
      const int b0 = (item / H) * kBSub;
      float dh_in[kBSub];
      load8(dh + j * Bs + b0, dh_in);
      float vr[kBSub] = {}, vz[kBSub] = {}, vn[kBSub] = {}, vh[kBSub] = {};
#pragma unroll
      for (int i = 0; i < kBSub; ++i) {
        const int b = b0 + i;
        if (b < B) {
          const float* s = sv + (long)t * 5 * plane + (long)b * H + j;
          const float r = s[0], z = s[plane], hpn = s[2 * plane];
          const float c = s[3 * plane], hmc = s[4 * plane];
          const float dh_total = g[((long)b * N + t) * H + j] + dh_in[i];
          const float dz = dh_total * hmc * z * (1.f - z);
          const float dn = dh_total * (1.f - z) * (1.f - c * c);
          const float dr = dn * hpn * r * (1.f - r);
          float* d = dxp + ((long)t * B + b) * H3 + j;
          d[0] = dr;
          d[H] = dz;
          d[2 * H] = dn;
          vr[i] = dr;
          vz[i] = dz;
          vn[i] = dn * r;
          vh[i] = dh_total * z;
        }
      }
      store8(dcat + j * Bs + b0, vr);
      store8(dcat + (H + j) * Bs + b0, vz);
      store8(dcat + (2 * H + j) * Bs + b0, vn);
      store8(dh + j * Bs + b0, vh);
    }
    __syncthreads();
    // dh[b][j] += sum_c dcat[b][c] * At[c][j]
    for (int item = threadIdx.x; item < items; item += blockDim.x) {
      const int j = item % H;
      const int b0 = (item / H) * kBSub;
      float acc[kBSub] = {};
      const float* a = At + j;
      for (int c = 0; c < H3; ++c) {
        const float w = a[(long)c * H];
        float v[kBSub];
        load8(dcat + c * Bs + b0, v);
#pragma unroll
        for (int i = 0; i < kBSub; ++i) acc[i] = fmaf(v[i], w, acc[i]);
      }
      float dh_z[kBSub];
      load8(dh + j * Bs + b0, dh_z);
#pragma unroll
      for (int i = 0; i < kBSub; ++i) acc[i] += dh_z[i];
      store8(dh + j * Bs + b0, acc);
    }
    __syncthreads();
  }
}

int gru_threads(int B, int H) {
  const int Bp = (B + kBSub - 1) / kBSub * kBSub;
  const int items = H * (Bp / kBSub);
  const int threads = (items + 31) / 32 * 32;
  return threads > kMaxThreads ? kMaxThreads : threads;
}

template <bool kSave>
int launch_fwd(const float* xp, const float* A, const float* bh, float* out,
               float* sv, int N, int B, int H, void* stream) {
  const int Bp = (B + kBSub - 1) / kBSub * kBSub;
  const long smem = 2L * H * (Bp + kPad) * (long)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gru_fwd_kernel<kSave>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  gru_fwd_kernel<kSave><<<1, gru_threads(B, H), smem, (cudaStream_t)stream>>>(
      xp, A, bh, out, sv, N, B, H);
  return (int)cudaGetLastError();
}

}  // namespace

// A (B, H) whose buffers exceed the shared memory of a block fails at
// cudaFuncSetAttribute.
extern "C" int gru_fwd(const float* xp, const float* A, const float* bh, float* out,
                       int N, int B, int H, void* stream) {
  return launch_fwd<false>(xp, A, bh, out, nullptr, N, B, H, stream);
}

// The training forward: also writes sv [N, 5, B, H].
extern "C" int gru_fwd_save(const float* xp, const float* A, const float* bh,
                            float* out, float* sv, int N, int B, int H,
                            void* stream) {
  return launch_fwd<true>(xp, A, bh, out, sv, N, B, H, stream);
}

// At = A^T = W_hh, [3H, H] row-major; g [B, N, H]; dxp [N, B, 3H].
extern "C" int gru_bwd(const float* sv, const float* g, const float* At, float* dxp,
                       int N, int B, int H, void* stream) {
  const int Bp = (B + kBSub - 1) / kBSub * kBSub;
  const long smem = 4L * H * (Bp + kPad) * (long)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gru_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  gru_bwd_kernel<<<1, gru_threads(B, H), smem, (cudaStream_t)stream>>>(
      sv, g, At, dxp, N, B, H);
  return (int)cudaGetLastError();
}
