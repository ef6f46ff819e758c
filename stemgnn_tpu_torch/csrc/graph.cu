// Chebyshev graph convolution, forward.
//
// Replaces stemgnn_tpu/ops/pallas_graph.py `_kernel` (reached from
// `_forward` / `cheb_graph_conv_pallas`): out[b,k,n,w] = sum_m
// mul_L[k,n,m] * x[b,m,w] for k = 1..K-1, with the k = 0 slab all zeros
// (the reference's T0 = 0), mul_L [K,N,N], x [B,N,W], out [B,K,N,W], f32.
// The same kernel takes a row block of mul_L: [K,M,N] against the whole x,
// out [B,K,M,W] (the node-sharded dense path: one rank's rows of the conv).
// Its tiles then walk M rows (grid y) over the N-long sum; at M = N every
// index and sum order is the square call's.
//
// Bound on the H100: f32 operations (2*(K-1)*N*N*B*W of them against
// about 4*(K-1)*N*N + 4*(K+1)*B*N*W bytes), but at the model's sizes the
// whole call is a few microseconds, so what counts is how many barriers and
// dependent loads lie between the launch and the last store, and how many
// bytes a thread must bring from shared memory into registers for each FMA
// (an SM delivers 128 bytes a clock, broadcast or not, against 128 FMAs).
// Design: the whole reduction dimension sits in shared memory at once. A
// block takes 32 rows of one order's L (a [32][N] panel) and 4 whole batches
// of x (each a contiguous [N][W] run, so a tile never splits a batch and no
// index is divided by W), both brought in by cp.async in 16-byte pieces, ONE
// barrier, then one loop over m. A warp owns 8 rows of L by four w of the 4
// batches, and its lanes are (batch, k-part): the 8 lanes of a batch split
// the sum over m between them (m = p, p + 8, ...), each summing all 8 rows by
// four w in registers (32 FMAs for 8 floats of L and one float4 of x, 1.5
// bytes an FMA), then a butterfly of shuffles adds the 8 partial sums in a
// fixed order and leaves lane p with row p, which it stores as one float4 of
// out[b,k,n,:]: whole rows of the [B,K,N,W] layout, no transpose or pad in
// device memory, no atomics. The chunks of four w go to different warps (at
// most 4 chunks at a time), so a block of the model's shapes has 12 warps in
// flight. The grid is (B / 4, M / 32, K - 1): the all-zero product of order
// 0 is skipped, and the blocks of order 1 write its zero slab with float4
// stores while their panels are on the way. Ragged N, B
// and W are masked (a W that is no multiple of 4 takes scalar reads of x and
// scalar stores); an N whose panels exceed shared memory is walked in panels
// of MP rows of x.
//
// The bf16 arm (`cheb_graph_conv_fwd_bf16`, the JAX kernel at
// compute_dtype=bfloat16): L and x come in as f32, as the model holds them,
// and each value is rounded to bf16 (to nearest, ties to even, as the JAX
// package's astype) on its way into shared memory (`round_panels`: float4
// loads of both panels in flight together while the zero slab is stored,
// through registers, since cp.async cannot convert), so the call is one
// launch and no cast kernel runs before it. The panels are
// bf16 in shared memory, and each product converts its two operands to f32,
// exact, for the same f32 fmaf sums as the f32 arm: out stays f32.

#include <cuda_runtime.h>

#include "device_utils.cuh"

namespace {

constexpr int kTM = 32;    // rows of L a block
constexpr int kTB = 4;     // batches a block: a warp's lanes are (batch, k-part)
constexpr int kParts = 8;  // lanes that split the sum over m; also the rows a warp owns
constexpr int kChunkThreads = 32 * (kTM / kParts);  // threads that share a chunk of four w
constexpr int kMaxChunks = 4;                       // chunks in flight a block: 512 threads

// four operands of x at p (16-byte aligned for float, 8 for bf16) as f32
__device__ __forceinline__ void lds4(const float* p, float (&v)[4]) {
  unpack4(*reinterpret_cast<const float4*>(p), v);
}
__device__ __forceinline__ void lds4(const bf16* p, float (&v)[4]) {
  unpack4(*reinterpret_cast<const uint2*>(p), v);
}

// A thread's float4 runs of a panel with w4 runs a row: tid, tid +
// blockDim.x, ..., as (row, run), advanced without a division.
struct PanelWalk {
  int r, c, dr, dc, w;
  __device__ explicit PanelWalk(int w4)
      : r(threadIdx.x / w4), c(threadIdx.x % w4), dr(blockDim.x / w4), dc(blockDim.x % w4),
        w(w4) {}
  __device__ void next() {
    r += dr;
    c += dc;
    if (c >= w) {
      c -= w;
      ++r;
    }
  }
};

// The bf16 arm's panels from f32 operands: L's [rows][cl] (leading
// dimensions ldl in device memory, lda in shared memory) and x's [nb][cx]
// (ldx, ldxs), each value rounded to bf16 on its way through registers. A
// thread starts up to kRoundBatch float4 loads of each panel, runs `between`
// (work that needs none of them: the zero slab's and the pads' stores) while
// they are on the way, then rounds and stores them, 8 bytes at a time; where
// a row of either side allows no float4, one value at a time. Ordinary
// stores, which the barrier after the panel's wait makes visible.
constexpr int kRoundBatch = 4;

// four f32 values rounded to bf16, stored as 8 bytes
__device__ __forceinline__ void store_bf16x4(bf16* dst, const float4& v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(dst) =
      make_uint2(*reinterpret_cast<const unsigned*>(&lo), *reinterpret_cast<const unsigned*>(&hi));
}

template <typename F>
__device__ __forceinline__ void round_panels(bf16* As, int lda, const float* __restrict__ L,
                                             long ldl, int rows, int cl, bf16* Xs, int ldxs,
                                             const float* __restrict__ X, long ldx, int nb,
                                             int cx, F between) {
  const bool vec = ((cl | lda | (int)(ldl & 3) | cx | ldxs | (int)(ldx & 3)) & 3) == 0 &&
                   (((uintptr_t)L | (uintptr_t)X) & 15) == 0 &&
                   (((uintptr_t)As | (uintptr_t)Xs) & 7) == 0;
  if (!vec) {
    between();
    for (int e = threadIdx.x; e < rows * cl; e += blockDim.x)
      As[e / cl * lda + e % cl] = __float2bfloat16_rn(__ldg(L + e / cl * ldl + e % cl));
    for (int e = threadIdx.x; e < nb * cx; e += blockDim.x)
      Xs[e / cx * ldxs + e % cx] = __float2bfloat16_rn(__ldg(X + e / cx * ldx + e % cx));
    return;
  }
  PanelWalk wl(cl / 4), wx(cx / 4);
  bool waiting = true;  // `between` still to run
  while (wl.r < rows || wx.r < nb) {
    float4 vl[kRoundBatch], vx[kRoundBatch];
    bf16* dl[kRoundBatch];
    bf16* dx[kRoundBatch];
#pragma unroll
    for (int j = 0; j < kRoundBatch; ++j) {
      dl[j] = dx[j] = nullptr;
      if (wl.r < rows) {
        vl[j] = __ldg(reinterpret_cast<const float4*>(L + wl.r * ldl + 4 * wl.c));
        dl[j] = As + wl.r * lda + 4 * wl.c;
        wl.next();
      }
      if (wx.r < nb) {
        vx[j] = __ldg(reinterpret_cast<const float4*>(X + wx.r * ldx + 4 * wx.c));
        dx[j] = Xs + wx.r * ldxs + 4 * wx.c;
        wx.next();
      }
    }
    if (waiting) {
      between();
      waiting = false;
    }
#pragma unroll
    for (int j = 0; j < kRoundBatch; ++j) {
      if (dl[j] != nullptr) store_bf16x4(dl[j], vl[j]);
      if (dx[j] != nullptr) store_bf16x4(dx[j], vx[j]);
    }
  }
  if (waiting) between();  // a thread with no element
}

// Shared memory: As [kTM][RSA] (the panel of L, RSA >= MP a multiple of 8),
// then Xs [kTB][XBS] (a batch's [MP][W] rows of x, XBS >= MP * W + 4 so a
// ragged last read stays inside, and a whole number of 16-byte pieces), both
// of the operand type T (L and x f32 for both arms). blockDim.x =
// kChunkThreads * min(chunks, kMaxChunks).
template <typename T, bool kVec>
__global__ void __launch_bounds__(kChunkThreads * kMaxChunks)
cheb_graph_conv_kernel(const float* __restrict__ L, const float* __restrict__ x,
                       float* __restrict__ out, int K, int M, int N, int B, int W, int MP,
                       int RSA, int XBS) {
  extern __shared__ __align__(16) float smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int k = blockIdx.z + 1;  // the order of this block's product
  const int n0 = blockIdx.y * kTM;
  const int b0 = blockIdx.x * kTB;
  const int tid = threadIdx.x;
  const int rows = min(kTM, M - n0);

  // T0 = 0: the k = 0 slab is zeros, no product. The blocks of order 1 write
  // their tile of it while their panels are on the way.
  auto zero_slab = [&] {
    for (int i = 0; i < kTB && b0 + i < B; ++i) {
      float* o = out + (((long)(b0 + i) * K) * M + n0) * W;
      const int len = rows * W;
      if (kVec) {
        for (int e = tid; e < len / 4; e += blockDim.x)
          reinterpret_cast<float4*>(o)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        for (int e = tid; e < len; e += blockDim.x) o[e] = 0.f;
      }
    }
  };
  if (k >= K) {  // K = 1: there is no product at all
    zero_slab();
    return;
  }

  T* As = smem;
  T* Xs = smem + kTM * RSA;
  const int slot = tid / kChunkThreads;            // which of the chunks in flight
  const int r0 = tid % kChunkThreads / 32 * kParts;  // the warp's first row of the tile
  const int lane = tid & 31;
  const int bb = lane / kParts, p = lane % kParts;
  const int n = n0 + r0 + p, b = b0 + bb;  // the row this lane stores
  const int chunks = (W + 3) / 4;
  const int slots = blockDim.x / kChunkThreads;
  const int panels = (N + MP - 1) / MP;
  const float* Lk = L + ((long)k * M + n0) * N;
  const T zero = T(0.f);

  for (int wc0 = 0; wc0 < chunks; wc0 += slots) {
    const int wc = min(wc0 + slot, chunks - 1);  // a spare slot repeats the last chunk
    float acc[4][kParts] = {};                   // [w][row]
    for (int pi = 0; pi < panels; ++pi) {
      const int m0 = pi * MP;
      const int mr = min(MP, N - m0);                   // rows of x in this panel
      const int mp = (mr + kParts - 1) / kParts * kParts;  // a whole round of the k-parts
      if (wc0 == 0 || panels > 1) {    // one panel: loaded once for every w
        if (wc0 > 0 || pi > 0) __syncthreads();  // the last panel's readers are done
        // what needs none of the panels' values: the zero slab, and zeros past
        // the last real row of x, up to a whole round of the k-parts: columns
        // of L (the tile's rows past N and the batches past B are never
        // stored and stay as they are) and rows of x
        auto beside = [&] {
          if (k == 1 && wc0 == 0 && pi == 0) zero_slab();
          for (int r = tid / kParts; r < rows; r += blockDim.x / kParts)
            if (mr + tid % kParts < mp) As[r * RSA + mr + tid % kParts] = zero;
          for (int i = 0; i < kTB && b0 + i < B; ++i)
            for (int e = mr * W + tid; e < mp * W + 4; e += blockDim.x)
              Xs[i * XBS + e] = zero;
        };
        if constexpr (sizeof(T) == 2) {
          // both panels in one pass of loads, `beside` while they are on the way
          round_panels(As, RSA, Lk + m0, N, rows, mr, Xs, XBS, x + ((long)b0 * N + m0) * W,
                       (long)N * W, min(kTB, B - b0), mr * W, beside);
        } else {
          copy_panel_async(As, RSA, Lk + m0, N, rows, mr);
          for (int i = 0; i < kTB && b0 + i < B; ++i)
            copy_panel_async(Xs + i * XBS, 0, x + ((long)(b0 + i) * N + m0) * W, 0, 1,
                             mr * W);
          cp_async_commit();
          beside();
        }
        cp_async_wait_group<0>();
        __syncthreads();
      }
      const T* a = As + r0 * RSA;
      const T* xb = Xs + bb * XBS + wc * 4;
#pragma unroll 3
      for (int m = p; m < mp; m += kParts) {
        float xv[4];
        if (kVec) {
          lds4(xb + m * W, xv);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) xv[q] = to_f32(xb[m * W + q]);
        }
#pragma unroll
        for (int i = 0; i < kParts; ++i) {
          const float l = to_f32(a[i * RSA + m]);
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[q][i] = fmaf(l, xv[q], acc[q][i]);
        }
      }
    }
    transpose_reduce<kParts, 4>(acc, p, 1);
    if (n < M && b < B && wc0 + slot < chunks) {
      float* o = out + (((long)b * K + k) * M + n) * W + wc * 4;
      if (kVec) {
        *reinterpret_cast<float4*>(o) =
            make_float4(acc[0][0], acc[1][0], acc[2][0], acc[3][0]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (wc * 4 + q < W) o[q] = acc[q][0];
      }
    }
  }
}

template <typename T>
int launch(const float* L, const float* x, float* out, int K, int M, int N, int B, int W,
           int panel, int row_stride, int batch_stride, int threads, int smem, int vec,
           cudaStream_t stream) {
  auto kernel = vec ? cheb_graph_conv_kernel<T, true> : cheb_graph_conv_kernel<T, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + kTB - 1) / kTB, (M + kTM - 1) / kTM, K > 1 ? K - 1 : 1);
  kernel<<<grid, threads, smem, stream>>>(L, x, out, K, M, N, B, W, panel, row_stride,
                                          batch_stride);
  return (int)cudaGetLastError();
}

}  // namespace

// The plan comes from ops/cuda_graph.py `launch_plan`: `panel` rows of x at a
// time (a multiple of 4), `row_stride` elements a row of the panel of L,
// `batch_stride` elements a batch of the panel of x, `threads` a block, `smem`
// bytes of dynamic shared memory; `vec` when W is a multiple of 4 and x and
// out are 16-byte aligned. L [K, M, N], x [B, N, W], out [B, K, M, W]: M = N is
// the whole conv, M < N a row block of it (a node block's rows of mul_L
// against every node of x).
extern "C" int cheb_graph_conv_fwd(const float* L, const float* x, float* out,
                                   int K, int M, int N, int B, int W, int panel,
                                   int row_stride, int batch_stride, int threads,
                                   int smem, int vec, void* stream) {
  return launch<float>(L, x, out, K, M, N, B, W, panel, row_stride, batch_stride, threads,
                       smem, vec, (cudaStream_t)stream);
}

// The bf16 arm: L and x f32, rounded to bf16 as they are staged (the plan's
// strides in bf16 elements), out f32.
extern "C" int cheb_graph_conv_fwd_bf16(const float* L, const float* x, float* out,
                                        int K, int M, int N, int B, int W, int panel,
                                        int row_stride, int batch_stride, int threads,
                                        int smem, int vec, void* stream) {
  return launch<bf16>(L, x, out, K, M, N, B, W, panel, row_stride, batch_stride, threads,
                      smem, vec, (cudaStream_t)stream);
}
