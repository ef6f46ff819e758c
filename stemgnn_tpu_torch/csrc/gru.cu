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
// Backward (`gru_bwd_cluster`, `gru_bwd_one_block`): replaces `_bwd_kernel`
// (reached from `_vjp_bwd`): the
// reverse recurrence over sv with the cotangent g [B, N, H] of the outputs,
//   dh_total = g[t] + dh
//   dz = dh_total * (h - c) * z * (1 - z); dn = dh_total * (1 - z) * (1 - c^2)
//   dr = dn * hpn * r * (1 - r);           dxp[t] = (dr, dz, dn)
//   dh = dh_total * z + (dr, dz, dn * r) @ A^T
// writing dxp [N, B, 3H]. The weight and bias gradients are products over
// all steps at once, outside the kernel, as the JAX package leaves them.
//
// Bound on the H100: f32 operations on a serial chain. Each step is a
// [B,H] x [H,3H] product (2*B*H*3H operations) that depends on the step
// before, so what a step costs is latency: the product's longest dependent
// chain plus whatever the blocks must exchange before the next step starts.
//
// Forward design (`gru_fwd_cluster`): the recurrence is cut two ways.
// - Batch rows never exchange anything, so groups of R = 4 rows run as
//   independent thread-block clusters (blockIdx.y), with no barrier between
//   them.
// - Inside a cluster of C blocks, block c owns the hidden units of slice c
//   (S = ceil(H / C) of them, the last slice short) with all three gate
//   columns of each, so the gate math needs no exchange. Its slice of A,
//   [H][3 * S] f32, is loaded ONCE into shared memory (cp.async) and stays
//   there for all N steps; the fused weight as a whole (235,200 bytes at
//   H = 140) does not fit the 232,448 bytes a block can have, a slice does.
//   Every block keeps the whole h of its R rows, [H][R], double-buffered.
//   At the end of a step a thread sends its h' into the next buffer of EVERY
//   block of the cluster through distributed shared memory (st.async), each
//   copy counted on an mbarrier of the receiving block; it then stores `out`
//   and `sv` and waits on its OWN block's mbarrier until all H * R values of
//   the step have landed. That wait takes the place of __syncthreads(), and
//   no cluster-wide barrier is needed inside the loop: a thread sends step
//   t's values only after its own reads of the buffer step t reads, and a
//   block passes its wait of step t only when every thread of the cluster
//   has sent them; so when anybody sends step t + 1's values into that
//   buffer, nobody reads it any more. (The hardware cluster barrier alone
//   cost a quarter of a step.)
//   x_proj of the next step is loaded a step ahead.
// - Inside a block a warp holds 32 / R units, and the R lanes that share a
//   unit split the k-sum between them (k = p, p + R, ...): each lane sums
//   its k's for all R rows and 3 gates (3 * R independent FMA chains, one
//   broadcast float4 of h and three conflict-free weights per k), then a
//   butterfly of shuffles both adds the R partial sums and hands lane p the
//   three gate sums of row p, in a fixed order: no atomics, the same bits on
//   every run. The lane then does the gate math of (unit, row p).
// The plan (rows, groups, cluster size, slice, shared row stride, threads,
// shared bytes) is made in Python from (B, H) and passed in. Where no slice
// fits at the largest cluster size, the wrapper launches the one-block
// kernel below instead (`gru_fwd_one_block`), by shape.
//
// Backward design (`gru_bwd_cluster`), the same cut:
// - Groups of R = 4 batch rows are independent clusters; block c of a
//   cluster owns the hidden units of slice c. The lane that does the gate
//   math of (unit j, row p) keeps dh[p][j] in a register from step to step.
// - A step: dh_total = g[t] + dh, the gate gradients of the lane's (j, p),
//   dxp[t] stored, and (dr, dz, dn * r) sent to EVERY block of the cluster by
//   st.async onto an mbarrier, as the forward sends h'. A block so holds the
//   whole dcat [3H][R] of the step and, after its wait, forms
//   dh[p][j] = dh_total * z + sum_c dcat[c][p] * A[j][c] for its own units:
//   no second exchange. The R lanes of a unit split the 3H-long sum
//   (c = p, p + R, ...) and `transpose_reduce` adds the partials and hands
//   lane p row p, the lane of that row's gate math: no block barrier in the
//   loop either. The double buffer of dcat is safe by the forward's argument.
// - The block's rows of A (= W_hh^T, [H, 3H]), [S][3H], are one contiguous
//   panel of the tensor the forward reads; they are copied once (cp.async)
//   and stay resident for all N steps. Their row stride is 4 (mod 32) floats,
//   so the 8 units by 4 k-parts a warp reads fall in 32 different banks, and
//   no row is padded by more than 31 floats (H = 360 fits a cluster of 8).
//   The other split (partial dh exchanged, A's 3S gate columns resident)
//   sends a third of the bytes but needs the block's own gate gradients
//   visible to all its threads: a block barrier a step.
// - sv[t - 1] and g[t - 1] are loaded a step ahead.
// Bound: the forward's f32 operations; the exchange is three times the
// forward's, and each k of the sum brings one float4 of dcat for one weight
// (5 bytes of shared memory an FMA, the forward's 2.3).
//
// One-block kernels (`gru_fwd_one_block`, `gru_bwd_one_block`, the large-H
// route): a block per group of `rows` batch rows (a multiple of 8, from the
// plan), the grid over the groups, since batch rows never exchange anything.
// Each block loops over the N steps. The forward keeps h in shared memory,
// double-buffered ([H][rows + 4] layout, two copies) so one __syncthreads()
// per step separates reads of h from writes of h'; A and bh are read from
// global memory, where they stay L2-resident. Each thread owns one hidden
// unit j (all three of its gate columns) for 8 batch rows, and reads and
// writes its 8 rows of h as two float4 (see kPad). The backward keeps dh
// [H][rows + 4] and the step's (dr, dz, dn * r) [3H][rows + 4] in shared
// memory, the same thread owning unit j for 8 batch rows in the elementwise
// half and in the product, so dh needs no exchange and a step takes two
// barriers; it reads A^T = W_hh ([3H, H] row-major) from L2 with
// neighbouring threads on neighbouring addresses. sv is laid out
// [N, 5, B, H] so all kernels touch it with the threads running along H.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "device_utils.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kBSub = 8;  // batch rows per thread
constexpr int kMaxThreads = 1024;
constexpr int kClusterThreads = 256;  // a block of the cluster kernel has at most these

__device__ __forceinline__ float sigmoidf(float v) { return 1.f / (1.f + expf(-v)); }

// Rows of the [H][.] shared arrays are kPad floats longer than the padded
// batch: with the lanes of a warp along j, a thread's float4 at [j * Bs + b0]
// then falls 4 banks after its neighbour's, so the 8 lanes served together
// cover all 32 banks. At a stride of 32 every such access was a 32-way
// conflict.
constexpr int kPad = 4;

// --- pieces of the cluster kernels ---

// The exchange between the blocks of a cluster goes by messages, not by a
// barrier: a sender writes a value into another block's shared memory with
// st.async, which also counts its 4 bytes on an mbarrier of that block; the
// receiver arms the mbarrier once a step with the bytes it expects and waits
// on it. Observing the phase complete makes the values visible.

__device__ __forceinline__ unsigned shared_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// The address that `addr` of this block's shared memory has in block `rank`.
__device__ __forceinline__ unsigned cluster_addr(unsigned addr, unsigned rank) {
  unsigned mapped;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(mapped) : "r"(addr), "r"(rank));
  return mapped;
}

// One arrival completes a phase (the arming thread's), once the expected
// bytes have come. Call from one thread, then sync the cluster before use.
__device__ __forceinline__ void mbarrier_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Arms the current phase: it completes when `bytes` more have been counted.
// Bytes that came before the arming count too.
__device__ __forceinline__ void mbarrier_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of the given parity is complete. A message that never
// comes is a fault of the protocol: after about ten seconds the kernel traps,
// so the launch fails instead of holding the card for good.
__device__ __forceinline__ void mbarrier_wait(unsigned bar, unsigned parity) {
  const long long start = clock64();
  unsigned done = 0;
  while (true) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > 20000000000LL) __trap();
  }
}

// Sends v to the shared-memory address `dst` (this block's) of every block of
// the cluster, this block's own included, each copy counted on that block's
// mbarrier at `bar`.
__device__ __forceinline__ void cluster_send_all(unsigned dst, float v, unsigned bar,
                                                 unsigned blocks) {
  for (unsigned rank = 0; rank < blocks; ++rank)
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.u32 [%0], %1, [%2];" ::"r"(
            cluster_addr(dst, rank)),
        "r"(__float_as_uint(v)), "r"(cluster_addr(bar, rank))
        : "memory");
}

// Grid (C, groups), cluster (C, 1, 1). Shared memory: As [Hp][RS], the
// block's slice of A with the gates side by side (r at column 0, z at S, n at
// 2 * S; Hp is H rounded up to R, the added rows zeros), then h [2][Hp][R].
// RS is 3 * S rounded up to an odd multiple of 32 / R, so the R x (32 / R)
// weights a warp reads per gate fall in 32 different banks. Two mbarriers,
// one for each h buffer.
template <int R, bool kSave>
__global__ void __launch_bounds__(kClusterThreads)
gru_fwd_cluster_kernel(const float* __restrict__ xp, const float* __restrict__ A,
                       const float* __restrict__ bh, float* __restrict__ out,
                       float* __restrict__ sv, int N, int B, int H, int S, int RS) {
  constexpr int JW = 32 / R;  // hidden units per warp
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int Hp = (H + R - 1) / R * R;
  const int j0 = (int)cluster.block_rank() * S;
  const int Sc = min(S, H - j0);
  float* As = smem;
  float* hbuf = smem + (long)Hp * RS;

  for (int g = 0; g < 3; ++g)
    copy_panel_async(As + g * S, RS, A + g * H + j0, 3L * H, H, Sc);
  for (int e = threadIdx.x; e < (Hp - H) * RS; e += blockDim.x) As[H * RS + e] = 0.f;
  for (int e = threadIdx.x; e < 2 * Hp * R; e += blockDim.x) hbuf[e] = 0.f;
  __shared__ __align__(8) unsigned long long arrived[2];
  if (threadIdx.x == 0) {
    mbarrier_init(shared_addr(&arrived[0]));
    mbarrier_init(shared_addr(&arrived[1]));
  }
  cp_async_commit();
  cp_async_wait_group<0>();
  // every block of the cluster runs and has its buffers and mbarriers ready
  // before any block sends to them
  cluster.sync();
  const unsigned blocks = cluster.num_blocks();

  const int lane = threadIdx.x & 31;
  const int p = lane / JW;  // the batch row of the gate math, the k-part of the sum
  const int jl = (threadIdx.x >> 5) * JW + lane % JW;
  const bool unit_live = jl < Sc;
  const int js = unit_live ? jl : Sc - 1;  // a warp's spare lanes repeat the last unit
  const int j = j0 + js;
  const int b = blockIdx.y * R + p;
  const bool row_live = b < B;
  const bool live = unit_live && row_live;
  const int H3 = 3 * H;
  const float br = bh[j], bz = bh[H + j], bn = bh[2 * H + j];
  const float* a = As + js;

  float x_cur[3] = {}, x_nxt[3] = {};
  if (row_live) {
    const float* x = xp + (long)b * H3 + j;
    x_cur[0] = x[0]; x_cur[1] = x[H]; x_cur[2] = x[2 * H];
  }
  for (int t = 0; t < N; ++t) {
    const float* h_cur = hbuf + (t & 1) * Hp * R;
    float* h_next = hbuf + ((t + 1) & 1) * Hp * R;
    // this step's h' of the whole cluster: H units by R rows (rows past B send zeros)
    const unsigned bar = shared_addr(&arrived[(t + 1) & 1]);
    if (threadIdx.x == 0) mbarrier_expect(bar, (unsigned)(H * R) * 4u);
    if (row_live && t + 1 < N) {  // needs no h: in flight during the sum
      const float* x = xp + ((long)(t + 1) * B + b) * H3 + j;
      x_nxt[0] = x[0]; x_nxt[1] = x[H]; x_nxt[2] = x[2 * H];
    }
    float acc[3][R] = {};
#pragma unroll 5
    for (int k = p; k < Hp; k += R) {
      const float wr = a[k * RS], wz = a[k * RS + S], wn = a[k * RS + 2 * S];
      float hv[R];
#pragma unroll
      for (int i = 0; i < R; i += 4) {
        const float4 q = *reinterpret_cast<const float4*>(h_cur + k * R + i);
        hv[i] = q.x; hv[i + 1] = q.y; hv[i + 2] = q.z; hv[i + 3] = q.w;
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        acc[0][i] = fmaf(hv[i], wr, acc[0][i]);
        acc[1][i] = fmaf(hv[i], wz, acc[1][i]);
        acc[2][i] = fmaf(hv[i], wn, acc[2][i]);
      }
    }
    transpose_reduce<R, 3>(acc, p, JW);

    const float h_prev = h_cur[j * R + p];
    const float r = sigmoidf(x_cur[0] + (acc[0][0] + br));
    const float z = sigmoidf(x_cur[1] + (acc[1][0] + bz));
    const float hpn = acc[2][0] + bn;
    const float c = tanhf(x_cur[2] + r * hpn);
    const float h = (1.f - z) * c + z * h_prev;
    if (unit_live)
      cluster_send_all(shared_addr(h_next + j * R + p), row_live ? h : 0.f, bar, blocks);
    if (live) {  // off the other blocks' critical path: their values are on the way
      out[((long)b * N + t) * H + j] = h;
      if (kSave) {
        const long plane = (long)B * H;
        float* s = sv + (long)t * 5 * plane + (long)b * H + j;
        s[0] = r;
        s[plane] = z;
        s[2 * plane] = hpn;
        s[3 * plane] = c;
        s[4 * plane] = h_prev - c;
      }
    }
    // an mbarrier's phases alternate, and this one is used every other step
    mbarrier_wait(bar, (unsigned)(t >> 1) & 1u);
#pragma unroll
    for (int g = 0; g < 3; ++g) x_cur[g] = x_nxt[g];
  }
  cluster.sync();  // no block leaves while another may still send to it
}

// Grid (C, groups), cluster (C, 1, 1). Dynamic shared memory: two mbarriers
// (16 bytes, one for each dcat buffer), then Au [S][LD], row jl the row
// j0 + jl of A (3H floats, zeros from 3H to LD), then dcat [2][C3][R] (C3 is
// 3H rounded up to R; rows from 3H on stay zero).
template <int R>
__global__ void __launch_bounds__(kClusterThreads)
gru_bwd_cluster_kernel(const float* __restrict__ sv, const float* __restrict__ g,
                       const float* __restrict__ A, float* __restrict__ dxp, int N,
                       int B, int H, int S, int LD) {
  constexpr int JW = 32 / R;  // hidden units per warp
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int H3 = 3 * H;
  const int C3 = (H3 + R - 1) / R * R;
  const int j0 = (int)cluster.block_rank() * S;
  const int Sc = min(S, H - j0);
  unsigned long long* arrived = reinterpret_cast<unsigned long long*>(smem);
  float* Au = smem + 4;
  float* dbuf = Au + (long)S * LD;

  copy_panel_async(Au, LD, A + (long)j0 * H3, H3, Sc, H3);
  const int pad = LD - H3;
  for (int e = threadIdx.x; e < Sc * pad; e += blockDim.x)
    Au[(e / pad) * LD + H3 + e % pad] = 0.f;
  for (int e = threadIdx.x; e < 2 * C3 * R; e += blockDim.x) dbuf[e] = 0.f;
  if (threadIdx.x == 0) {
    mbarrier_init(shared_addr(&arrived[0]));
    mbarrier_init(shared_addr(&arrived[1]));
  }
  cp_async_commit();
  cp_async_wait_group<0>();
  cluster.sync();
  const unsigned blocks = cluster.num_blocks();

  const int lane = threadIdx.x & 31;
  const int p = lane / JW;  // the batch row of the gate math, the k-part of the sum
  const int jl = (threadIdx.x >> 5) * JW + lane % JW;
  const bool unit_live = jl < Sc;
  const int js = unit_live ? jl : Sc - 1;  // a warp's spare lanes repeat the last unit
  const int j = j0 + js;
  const int b = blockIdx.y * R + p;
  const bool row_live = b < B;
  const bool live = unit_live && row_live;
  const long plane = (long)B * H;
  const float* w = Au + (long)js * LD;

  // sv[t] (r, z, hpn, c, h - c) and g[t] of (j, b), loaded a step ahead
  float s_cur[6] = {}, s_nxt[6] = {};
  if (row_live) {
    const float* s = sv + (long)(N - 1) * 5 * plane + (long)b * H + j;
#pragma unroll
    for (int q = 0; q < 5; ++q) s_cur[q] = s[q * plane];
    s_cur[5] = g[((long)b * N + N - 1) * H + j];
  }
  float dh = 0.f;
  for (int u = 0; u < N; ++u) {
    const int t = N - 1 - u;
    float* d_cur = dbuf + (u & 1) * C3 * R;
    // this step's dcat of the whole cluster: 3H columns by R rows
    const unsigned bar = shared_addr(&arrived[u & 1]);
    if (threadIdx.x == 0) mbarrier_expect(bar, (unsigned)(H3 * R) * 4u);
    if (row_live && t > 0) {  // needs no dh: in flight during the sum
      const float* s = sv + (long)(t - 1) * 5 * plane + (long)b * H + j;
#pragma unroll
      for (int q = 0; q < 5; ++q) s_nxt[q] = s[q * plane];
      s_nxt[5] = g[((long)b * N + t - 1) * H + j];
    }
    const float r = s_cur[0], z = s_cur[1], hpn = s_cur[2], c = s_cur[3], hmc = s_cur[4];
    const float dh_total = s_cur[5] + dh;
    const float dz = dh_total * hmc * z * (1.f - z);
    const float dn = dh_total * (1.f - z) * (1.f - c * c);
    const float dr = dn * hpn * r * (1.f - r);
    if (unit_live) {
      const float v[3] = {dr, dz, dn * r};
#pragma unroll
      for (int gate = 0; gate < 3; ++gate)
        cluster_send_all(shared_addr(d_cur + (gate * H + j) * R + p),
                         row_live ? v[gate] : 0.f, bar, blocks);
    }
    if (live) {  // off the other blocks' critical path: their values are on the way
      float* d = dxp + ((long)t * B + b) * H3 + j;
      d[0] = dr;
      d[H] = dz;
      d[2 * H] = dn;
    }
    // an mbarrier's phases alternate, and this one is used every other step
    mbarrier_wait(bar, (unsigned)(u >> 1) & 1u);
    float acc[1][R] = {};
#pragma unroll 7
    for (int k = p; k < C3; k += R) {
      const float wk = w[k];
      float dv[R];
#pragma unroll
      for (int i = 0; i < R; i += 4) {
        const float4 q = *reinterpret_cast<const float4*>(d_cur + k * R + i);
        dv[i] = q.x; dv[i + 1] = q.y; dv[i + 2] = q.z; dv[i + 3] = q.w;
      }
#pragma unroll
      for (int i = 0; i < R; ++i) acc[0][i] = fmaf(dv[i], wk, acc[0][i]);
    }
    transpose_reduce<R, 1>(acc, p, JW);
    dh = dh_total * z + acc[0][0];
#pragma unroll
    for (int q = 0; q < 6; ++q) s_cur[q] = s_nxt[q];
  }
  cluster.sync();  // no block leaves while another may still send to it
}

// --- the one-block kernels: a block per group of `rows` batch rows ---
//
// A group's buffers live in shared memory or, where they do not fit a block's
// (ws not null: H above 2421 in the forward, 1210 in the backward), in the
// group's slice of a workspace in device memory (kWs). The arithmetic is the
// same: __syncthreads() orders a block's writes to device memory for its own
// threads as it orders its shared-memory writes. The place is a template
// argument: a pointer that may point to either compiles to generic loads,
// which made the shared-memory route 1.5-2.4x slower on an H100.

template <bool kSave, bool kWs>
__global__ void __launch_bounds__(kMaxThreads)
gru_fwd_one_block_kernel(const float* __restrict__ xp, const float* __restrict__ A,
               const float* __restrict__ bh, float* __restrict__ out,
               float* __restrict__ sv, float* ws, int N, int B, int H, int rows) {
  extern __shared__ __align__(16) float smem[];
  const int Bs = rows + kPad;
  const int g0 = blockIdx.x * rows;  // the group's first batch row
  float* buf = kWs ? ws + (long)blockIdx.x * 2 * H * Bs : smem;
  float* h_cur = buf;
  float* h_next = buf + (long)H * Bs;
  for (int e = threadIdx.x; e < 2 * H * Bs; e += blockDim.x) buf[e] = 0.f;
  __syncthreads();

  const int H3 = 3 * H;
  const int items = H * (rows / kBSub);
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
        const int b = g0 + b0 + i;
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

template <bool kWs>
__global__ void __launch_bounds__(kMaxThreads)
gru_bwd_one_block_kernel(const float* __restrict__ sv, const float* __restrict__ g,
                         const float* __restrict__ At, float* __restrict__ dxp, float* ws,
                         int N, int B, int H, int rows) {
  extern __shared__ __align__(16) float smem[];
  const int Bs = rows + kPad;
  const int g0 = blockIdx.x * rows;  // the group's first batch row
  const int H3 = 3 * H;
  float* buf = kWs ? ws + (long)blockIdx.x * 4 * H * Bs : smem;
  float* dh = buf;                   // [H][Bs]
  float* dcat = buf + (long)H * Bs;  // [3H][Bs]: dr, dz, dn * r
  for (int e = threadIdx.x; e < 4 * H * Bs; e += blockDim.x) buf[e] = 0.f;
  __syncthreads();

  const long plane = (long)B * H;
  const int items = H * (rows / kBSub);
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
        const int b = g0 + b0 + i;
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

constexpr int kRows = 4;           // batch rows of a cluster
constexpr int kPortableCluster = 8;

// Launches `kernel` on grid (cluster, groups) in clusters of `cluster` blocks.
template <typename... Params, typename... Args>
int launch_clustered(void (*kernel)(Params...), int cluster, int groups, int threads,
                     int smem, void* stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (cluster > kPortableCluster) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, groups);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, args...);
}

// Launches a one-block kernel on `groups` blocks.
template <typename... Params, typename... Args>
int launch_groups(void (*kernel)(Params...), int groups, int threads, int smem,
                  void* stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<groups, threads, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

// The forward across a thread-block cluster per group of `rows` batch rows.
// The plan comes from ops/cuda_gru.py `launch_plan`: grid (cluster, groups),
// `slice` hidden units a block, `row_stride` floats a row of the resident
// slice, `threads` a block, `smem` bytes of dynamic shared memory. sv
// [N, 5, B, H] is written when it is not null (the training forward).
extern "C" int gru_fwd_cluster(const float* xp, const float* A, const float* bh,
                               float* out, float* sv, int N, int B, int H, int rows,
                               int groups, int cluster, int slice, int row_stride,
                               int threads, int smem, void* stream) {
  if (rows != kRows) return (int)cudaErrorInvalidValue;
  if (sv)
    return launch_clustered(gru_fwd_cluster_kernel<kRows, true>, cluster, groups,
                            threads, smem, stream, xp, A, bh, out, sv, N, B, H, slice,
                            row_stride);
  return launch_clustered(gru_fwd_cluster_kernel<kRows, false>, cluster, groups, threads,
                          smem, stream, xp, A, bh, out, (float*)nullptr, N, B, H, slice,
                          row_stride);
}

// The forward in a block per group of `rows` batch rows (a multiple of 8),
// for an H whose slices fit no cluster. The plan comes from ops/cuda_gru.py
// `one_block_plan`: `smem` bytes of shared memory a block, or 0 and ws, a
// workspace of groups * 2 * H * (rows + 4) floats. sv as above.
extern "C" int gru_fwd_one_block(const float* xp, const float* A, const float* bh,
                                 float* out, float* sv, float* ws, int N, int B, int H,
                                 int rows, int groups, int threads, int smem, void* stream) {
  if (rows % kBSub || (smem == 0) != (ws != nullptr)) return (int)cudaErrorInvalidValue;
  const auto kernel = sv ? (ws ? gru_fwd_one_block_kernel<true, true>
                               : gru_fwd_one_block_kernel<true, false>)
                         : (ws ? gru_fwd_one_block_kernel<false, true>
                               : gru_fwd_one_block_kernel<false, false>);
  return launch_groups(kernel, groups, threads, smem, stream, xp, A, bh, out, sv, ws, N, B,
                       H, rows);
}

// The backward across a thread-block cluster per group of `rows` batch rows,
// by ops/cuda_gru.py `bwd_plan`: A = W_hh^T [H, 3H] (the forward's operand),
// `row_stride` floats a resident row of it. g [B, N, H]; dxp [N, B, 3H].
extern "C" int gru_bwd_cluster(const float* sv, const float* g, const float* A,
                               float* dxp, int N, int B, int H, int rows, int groups,
                               int cluster, int slice, int row_stride, int threads,
                               int smem, void* stream) {
  if (rows != kRows) return (int)cudaErrorInvalidValue;
  return launch_clustered(gru_bwd_cluster_kernel<kRows>, cluster, groups, threads, smem,
                          stream, sv, g, A, dxp, N, B, H, slice, row_stride);
}

// The backward in a block per group of `rows` batch rows, for an H whose
// slices fit no cluster. At = A^T = W_hh, [3H, H] row-major. smem and ws as
// for the forward, the workspace groups * 4 * H * (rows + 4) floats.
extern "C" int gru_bwd_one_block(const float* sv, const float* g, const float* At,
                                 float* dxp, float* ws, int N, int B, int H, int rows,
                                 int groups, int threads, int smem, void* stream) {
  if (rows % kBSub || (smem == 0) != (ws != nullptr)) return (int)cudaErrorInvalidValue;
  return launch_groups(ws ? gru_bwd_one_block_kernel<true> : gru_bwd_one_block_kernel<false>,
                       groups, threads, smem, stream, sv, g, At, dxp, ws, N, B, H, rows);
}
