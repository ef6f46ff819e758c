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
// compute_dtype=bfloat16, which feeds the TPU's matrix unit bf16 operands
// with f32 sums) is its own kernel on the tensor cores,
// `cheb_graph_conv_mma_kernel` (below): out_k [M, B*W] = L_k [M, N] . X [N,
// B*W] for each order k, X[m][b*W + w] = x[b,m,w] as `_forward` lays it out,
// on mma.sync m16n8k16 (bf16 x bf16 -> f32: the products are exact, only the
// order of the f32 sums is the card's). L and x come in as f32, as the model
// holds them, and each value is rounded to bf16 (to nearest, ties to even,
// as the JAX package's astype) in registers on its way into shared memory:
// one launch, no cast kernel, no second pass.
// Bound on the H100: bytes. The call must read L and x as f32 and write out
// (7.5 MB at synthetic-1k's (1, 2) row block: 2.2 us at 3.35 TB/s); its
// products are 0.3 GFLOP there, 0.3 us at the bf16 tensor-core rate. What
// the design meets first is the traffic from L2 into the SMs: every row tile
// of every order reads the whole of x (9.4 of the 15.7 MB the blocks read at
// that block) and each chunk waits for one load round trip.
//   * A block takes a tile of TM rows (16, 32 or 64) of one order by TB
//     whole batches of x (TB * W <= 128 columns, padded to TN, a multiple of
//     16), or at W > 128 one batch's W in column tiles of TW: each element
//     of L is staged by one block a column tile, and at the model's widths
//     (B * W <= 128) there is one column tile.
//   * The N-long sum walks chunks of 32 nodes through two bf16 stages: the
//     f32 loads of chunk c + 1 are in flight in registers while chunk c is
//     multiplied, then rounded and stored into the other stage, one barrier
//     a chunk. L's rows are the `.row` A operand (ldmatrix), x's [node]
//     [column] rows the `.row` B operand (ldmatrix.trans); a warp loads both
//     k16 steps' fragments of a column pair before its four products. A thread's share of
//     a chunk is the same in every chunk, its offsets worked out once: L by
//     rows of 128 bytes, x by the chunk's runs in the order of device memory
//     (whole 128-byte lines where TW = W).
//   * Where row tiles x column tiles x orders fall short of the card's SMs,
//     the node sum is split into C segments (1, 2, 4 or 8 of the chunks, in
//     order), the blocks of one cluster of C. Each writes its f32 partial
//     tile to its shared memory, and one thread sends slice q (rows q * TM /
//     C..) to rank q with a TMA bulk copy, counted on rank q's mbarrier (whose
//     wait traps after a bounded poll); rank z adds the C slices of its rows
//     in rank order: the bits depend on the plan, never on timing. The
//     mbarrier is set up while the first chunk's loads are on the way (its
//     cluster-wide fence would hold them up at the start), and a last cluster
//     barrier keeps each block until every copy that reads its shared memory
//     has landed.
//   * The epilogue stores column j of the tile at (b, w) = (b0 + j / TW, w0 +
//     j % TW) of [B, K, M, W], as float4 where W is a multiple of 4; the
//     blocks of order 1 store the zero slab of order 0 beside it.
// Ragged M, N, B and W are masked: nodes past N are zeros in both operands.
// ops/cuda_graph.py `mma_plan` makes the tiles from the shape and the SMs.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "device_utils.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kTM = 32;    // rows of L a block
constexpr int kTB = 4;     // batches a block: a warp's lanes are (batch, k-part)
constexpr int kParts = 8;  // lanes that split the sum over m; also the rows a warp owns
constexpr int kChunkThreads = 32 * (kTM / kParts);  // threads that share a chunk of four w
constexpr int kMaxChunks = 4;                       // chunks in flight a block: 512 threads

// four operands of x at p (16-byte aligned) as f32
__device__ __forceinline__ void lds4(const float* p, float (&v)[4]) {
  unpack4(*reinterpret_cast<const float4*>(p), v);
}

// four f32 values rounded to bf16 (the bf16 arm's staging), stored as 8 bytes
__device__ __forceinline__ void store_bf16x4(bf16* dst, const float4& v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(dst) =
      make_uint2(*reinterpret_cast<const unsigned*>(&lo), *reinterpret_cast<const unsigned*>(&hi));
}

// Shared memory: As [kTM][RSA] (the panel of L, RSA >= MP a multiple of 8),
// then Xs [kTB][XBS] (a batch's [MP][W] rows of x, XBS >= MP * W + 4 so a
// ragged last read stays inside, and a whole number of 16-byte pieces), both
// of the operand type T (float: the f32 arm). blockDim.x =
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
        copy_panel_async(As, RSA, Lk + m0, N, rows, mr);
        for (int i = 0; i < kTB && b0 + i < B; ++i)
          copy_panel_async(Xs + i * XBS, 0, x + ((long)(b0 + i) * N + m0) * W, 0, 1,
                           mr * W);
        cp_async_commit();
        beside();
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

// ---- the bf16 arm on the tensor cores ----

constexpr int kMmaThreads = 256;  // 8 warps: TM / 16 along the rows, the rest along the columns
constexpr int kKC = 32;           // nodes of the sum a stage holds: two k16 steps
constexpr int kLda = kKC + 8;     // bf16 a row of a stage's L: 80 bytes, an odd count of 16
constexpr int kMaxTN = 128;       // columns a tile
constexpr int kMaxPairs = 4;      // n16 column pairs a warp: 32 sums a thread
constexpr int kMaxCluster = 8;    // segments of the node sum: the portable cluster size

// bf16 a row of a stage's x: TN + 8 (TN a multiple of 16), an odd count of
// 16 bytes, so the 8 rows an ldmatrix reads fall on distinct banks
__host__ __device__ constexpr int mma_xs(int tn) { return tn + 8; }
// f32 a row of the partial tiles: 8 past a multiple of 32, so a warp's float2
// stores of its sums take no bank twice
__host__ __device__ constexpr int mma_ps(int tn) { return (tn + 31) / 32 * 32 + 8; }
// bf16 of one stage: L [TM][kLda], then x [kKC][mma_xs]
__host__ __device__ constexpr int mma_stage(int tm, int tn) {
  return tm * kLda + kKC * mma_xs(tn);
}
// bytes of shared memory: the two bf16 stages, and over them once they are
// read the block's partial tile [TM][mma_ps] f32; then the partials it
// receives, [C ranks][TM / C rows][mma_ps] f32 (TM rows in all); then the
// mbarrier that counts their bytes
__host__ __device__ constexpr int mma_front(int tm, int tn) {
  return 2 * mma_stage(tm, tn) * 2 > tm * mma_ps(tn) * 4 ? 2 * mma_stage(tm, tn) * 2
                                                         : tm * mma_ps(tn) * 4;
}
__host__ __device__ constexpr int mma_smem(int tm, int tn) {
  return mma_front(tm, tn) + tm * mma_ps(tn) * 4 + 16;
}

// grid (C * column tiles, row tiles, orders with a product: 1..K-1, or 1 at
// K = 1), clusters of C along x: rank z of a cluster sums segment z of the
// chunks. vec_l: N a multiple of 4 and L 16-byte aligned (float4 loads of
// L); kVecX, vec_o: W and TW multiples of 4 and x, out aligned (float4
// loads of x, float4 stores of out).
template <bool kVecX>
__global__ void __launch_bounds__(kMmaThreads, kVecX ? 2 : 1)
cheb_graph_conv_mma_kernel(const float* __restrict__ L, const float* __restrict__ x,
                           float* __restrict__ out, int K, int M, int N, int B, int W, int TM,
                           int TB, int TW, int TN, int wtiles, bool vec_l, bool vec_o) {
  extern __shared__ __align__(16) float smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int z = (int)cluster.block_rank();  // this block's segment of the sum
  const int ct = blockIdx.x / C;            // column tile
  const int b0 = ct / wtiles * TB, w0 = ct % wtiles * TW;
  const int tb = min(TB, B - b0), tw = min(TW, W - w0);
  const int n0 = blockIdx.y * TM, rows = min(TM, M - n0);
  const int k = blockIdx.z + 1;
  const bool product = k < K;  // K = 1: the zero slab alone
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int xs = mma_xs(TN), ps = mma_ps(TN), se = mma_stage(TM, TN);
  const int share = TM / C;  // rows of the tile whose sums this rank adds and stores
  bf16* const stages = reinterpret_cast<bf16*>(smem_raw);
  float* const part = smem_raw;  // over the stages once they are read
  float* const recv = smem_raw + mma_front(TM, TN) / 4;
  uint64_t* const bar = reinterpret_cast<uint64_t*>(recv + TM * ps);

  if (product) {
    const int chunks = (N + kKC - 1) / kKC;
    const int c_lo = z * chunks / C, c_hi = (z + 1) * chunks / C;
    const float* const Lk = L + ((long)k * M + n0) * N;
    // A thread's part of a chunk, the same in every chunk (no division in the
    // loop). L: column lc of rows lr + 32 s (float4, vec_l) or lr + 8 s. x:
    // the chunk's runs of the tile's batches, [tb][kKC nodes][tw] in the
    // order of device memory (whole 128-byte lines where tw = W), element
    // 4 (tid + 256 s) (float4, kVecX) or tid + 256 s of them: node xm[s] of
    // the chunk (-1: past the tile), xg[s] past the chunk's first element in
    // device memory, xo[s] into the stage.
    const int lc = vec_l ? 4 * (tid & 7) : tid & 31, lr = vec_l ? tid >> 3 : tid >> 5;
    const float* const xt = x + ((long)b0 * N) * W + w0;
    constexpr int kXSlots = kVecX ? 4 : 16, kWidth = kVecX ? 4 : 1;
    int xg[kXSlots], xm[kXSlots], xo[kXSlots];
    const int run = kKC * tw;
#pragma unroll
    for (int s = 0; s < kXSlots; ++s) {
      const int e = kWidth * (tid + kMmaThreads * s), bb = e / run, r = e - bb * run;
      const int m = r / tw, w = r - m * tw;
      xm[s] = bb < tb ? m : -1;
      xg[s] = (bb * N + m) * W + w;
      xo[s] = m * xs + bb * TW + w;
    }
    float lreg[8], xreg[16];
    auto load = [&](int c) {
      const int m0 = c * kKC;
      if (vec_l) {
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const int r = lr + 32 * s;
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (r < rows && m0 + lc < N)
            v = __ldg(reinterpret_cast<const float4*>(Lk + (long)r * N + m0 + lc));
          lreg[4 * s] = v.x, lreg[4 * s + 1] = v.y, lreg[4 * s + 2] = v.z, lreg[4 * s + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int s = 0; s < 8; ++s) {
          const int r = lr + 8 * s;
          lreg[s] = r < rows && m0 + lc < N ? __ldg(Lk + (long)r * N + m0 + lc) : 0.f;
        }
      }
      const float* const xc0 = xt + (long)m0 * W;
      if constexpr (kVecX) {
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (xm[s] >= 0 && m0 + xm[s] < N)
            v = __ldg(reinterpret_cast<const float4*>(xc0 + xg[s]));
          xreg[4 * s] = v.x, xreg[4 * s + 1] = v.y, xreg[4 * s + 2] = v.z, xreg[4 * s + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int s = 0; s < 16; ++s)
          xreg[s] = xm[s] >= 0 && m0 + xm[s] < N ? __ldg(xc0 + xg[s]) : 0.f;
      }
    };
    // the chunk in registers, rounded to bf16, into stage st (nodes past N
    // and rows past M are zeros; a column past the tile's batches is never
    // written, and its sums, which nothing stores, may be anything)
    auto store = [&](int st) {
      bf16* const as = stages + st * se;
      bf16* const xsm = as + TM * kLda;
      if (vec_l) {
#pragma unroll
        for (int s = 0; s < 2; ++s)
          if (lr + 32 * s < TM)
            store_bf16x4(as + (lr + 32 * s) * kLda + lc,
                         make_float4(lreg[4 * s], lreg[4 * s + 1], lreg[4 * s + 2],
                                     lreg[4 * s + 3]));
      } else {
#pragma unroll
        for (int s = 0; s < 8; ++s)
          if (lr + 8 * s < TM) as[(lr + 8 * s) * kLda + lc] = __float2bfloat16_rn(lreg[s]);
      }
      if constexpr (kVecX) {
#pragma unroll
        for (int s = 0; s < 4; ++s)
          if (xm[s] >= 0)
            store_bf16x4(xsm + xo[s], make_float4(xreg[4 * s], xreg[4 * s + 1],
                                                  xreg[4 * s + 2], xreg[4 * s + 3]));
      } else {
#pragma unroll
        for (int s = 0; s < 16; ++s)
          if (xm[s] >= 0) xsm[xo[s]] = __float2bfloat16_rn(xreg[s]);
      }
    };

    // warp (wr, wc): rows 16 wr.. of the tile by the n16 column pairs
    // p0..p0 + np - 1 (the pairs split as evenly as the warps allow)
    const int wm = TM / 16, wr = warp % wm, wc = warp / wm, wn = kMmaThreads / 32 / wm;
    const int pairs = TN / 16, p0 = wc * pairs / wn, np = (wc + 1) * pairs / wn - p0;
    float acc[kMaxPairs][2][4] = {};
    // the chunk's two k16 steps: every fragment loaded before the products
    // (each sum takes k16 step 0, then step 1)
    auto products = [&](int st) {
      const bf16* const as = stages + st * se;
      const bf16* const xsm = as + TM * kLda;
      uint32_t a[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        ldsm_x4(a[h], as + (16 * wr + (lane & 15)) * kLda + 16 * h + (lane >> 4) * 8);
#pragma unroll
      for (int p = 0; p < kMaxPairs; ++p) {
        if (p < np) {
          // B fragments (k 0-7, tile 2p), (k 8-15, 2p), (k 0-7, 2p + 1), (k 8-15, 2p + 1)
          uint32_t b[2][4];
#pragma unroll
          for (int h = 0; h < 2; ++h)
            ldsm_x4_trans(b[h], xsm + (16 * h + (lane & 15)) * xs + 16 * (p0 + p) +
                                    (lane >> 4) * 8);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            mma_bf16(acc[p][0], a[h], b[h][0], b[h][1]);
            mma_bf16(acc[p][1], a[h], b[h][2], b[h][3]);
          }
        }
      }
    };

    load(c_lo);
    if (C > 1) {
      // the barrier that counts the C slices of rows this block adds, each
      // share rows of a rank's partial: initialised, and visible to the
      // cluster (the barrier's wait comes before the sends), while the first
      // chunk's loads are on the way
      if (tid == 0) {
        mbar_init(bar, 1);
        mbar_init_fence();
        mbar_expect(bar, 4u * C * share * ps);
      }
      cluster_arrive();
    }
    store(0);
    __syncthreads();
    for (int c = c_lo; c < c_hi; ++c) {
      const int st = (c - c_lo) & 1;
      if (c + 1 < c_hi) load(c + 1);  // in flight while this chunk is multiplied
      products(st);
      if (c + 1 < c_hi) store(st ^ 1);
      __syncthreads();  // the next stage is in; every read of this one is done
    }

    // the block's partial tile, f32, over the stages (all read)
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* const dst = part + (16 * wr + g + 8 * h) * ps;
#pragma unroll
      for (int p = 0; p < kMaxPairs; ++p)
        if (p < np) {
#pragma unroll
          for (int u = 0; u < 2; ++u)
            *reinterpret_cast<float2*>(dst + 16 * (p0 + p) + 8 * u + 2 * t) =
                make_float2(acc[p][u][2 * h], acc[p][u][2 * h + 1]);
        }
    }
    if (C > 1) fence_proxy_async();  // the copy engine reads them next
  }
  const float* got = part;  // [C][share][ps]: rank q's partial of this rank's rows
  if (C > 1) {
    // each rank's slice of its partial to the rank that adds those rows: one
    // bulk copy a slice, counted on the receiver's barrier (rank q holds rows
    // q * share.. of every rank's partial at recv [z][share][ps])
    __syncthreads();
    cluster_wait();  // every block's barrier is initialised
    if (tid == 0)
      for (int q = 0; q < C; ++q)
        bulk_to_cluster(cluster_addr(recv + z * share * ps, q), part + q * share * ps,
                        4u * share * ps, cluster_addr(bar, q));
    mbar_wait(bar, 0);  // every rank's slice has landed (traps if one never does)
    cluster_arrive_relaxed();  // the second half waits at the end
    got = recv;
  } else {
    __syncthreads();
  }

  // rank z: rows z * share.. of the tile, the ranks' partials added in rank
  // order; the blocks of order 1 store the zero slab's rows beside them
  const int rlo = z * share, rhi = min(rlo + share, rows);
  const int oj = vec_o ? 4 * (tid & 31) : tid & 127;  // the thread's tile column
  const int ob = oj / TW, ow = oj % TW;
  if (ob < tb && ow < tw) {
    float* const o = out + ((long)(b0 + ob) * K * M + n0) * W + w0 + ow;  // order 0, row n0
    if (vec_o) {
      for (int r = rlo + (tid >> 5); r < rhi; r += kMmaThreads / 32) {
        if (product) {
          const float* const src = got + (r - rlo) * ps + oj;
          float4 v = *reinterpret_cast<const float4*>(src);
          for (int q = 1; q < C; ++q) {
            const float4 u = *reinterpret_cast<const float4*>(src + q * share * ps);
            v.x += u.x, v.y += u.y, v.z += u.z, v.w += u.w;
          }
          *reinterpret_cast<float4*>(o + ((long)k * M + r) * W) = v;
        }
        if (k == 1) *reinterpret_cast<float4*>(o + (long)r * W) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    } else {
      for (int r = rlo + (tid >> 7); r < rhi; r += kMmaThreads / 128) {
        if (product) {
          const float* const src = got + (r - rlo) * ps + oj;
          float v = src[0];
          for (int q = 1; q < C; ++q) v += src[q * share * ps];
          o[((long)k * M + r) * W] = v;
        }
        if (k == 1) o[(long)r * W] = 0.f;
      }
    }
  }
  // every block has received its slices, so no copy still reads this
  // block's partial when it leaves
  if (C > 1) cluster_wait();
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


// The plan comes from ops/cuda_graph.py `mma_plan`: row tiles of `tm` rows
// (16, 32 or 64), column tiles of `tb` batches by `tw` of the W columns (tb
// = 1 where tw < W), padded to `tn` columns (a multiple of 16, at most 128),
// the node sum split over `cluster` blocks (1 to 8), `smem` bytes of
// dynamic shared memory (at least `mma_smem`). L [K, M, N], x [B, N, W] f32, rounded
// to bf16 in the kernel; out [B, K, M, W] f32.
extern "C" int cheb_graph_conv_fwd_bf16(const float* L, const float* x, float* out, int K,
                                        int M, int N, int B, int W, int tm, int tb, int tw,
                                        int tn, int cluster, int smem, void* stream) {
  if (tw < 1) return (int)cudaErrorInvalidValue;
  const int wtiles = (W + tw - 1) / tw;
  if ((tm != 16 && tm != 32 && tm != 64) || tn % 16 != 0 || tn > kMaxTN || tb < 1 ||
      tb * tw > tn || (tb > 1 && wtiles > 1) || cluster < 1 || cluster > kMaxCluster ||
      (cluster & (cluster - 1)) != 0 || (K <= 1 && cluster != 1) ||
      cluster > (N + kKC - 1) / kKC || smem < mma_smem(tm, tn))
    return (int)cudaErrorInvalidValue;
  const bool vec_l = N % 4 == 0 && ((uintptr_t)L & 15) == 0;
  const bool vec_x = W % 4 == 0 && tw % 4 == 0 && ((uintptr_t)x & 15) == 0;
  auto kernel = vec_x ? cheb_graph_conv_mma_kernel<true> : cheb_graph_conv_mma_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const bool vec_o = W % 4 == 0 && tw % 4 == 0 && ((uintptr_t)out & 15) == 0;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * ((B + tb - 1) / tb) * wtiles, (M + tm - 1) / tm, K > 1 ? K - 1 : 1);
  cfg.blockDim = dim3(kMmaThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, L, x, out, K, M, N, B, W, tm, tb, tw, tn, wtiles, vec_l,
                           vec_o);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
