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
// Backward (`gru_bwd_cluster`, `gru_bwd_grid`): replaces `_bwd_kernel`
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
//   independent thread-block clusters (group x / C of the blocks x along a
//   flat grid), with no barrier between them.
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
// fits at the largest cluster size, the wrapper launches the grid kernel
// below instead (`gru_fwd_grid`), by shape.
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
// Grid kernels (`gru_fwd_grid`, `gru_bwd_grid`, every H no cluster holds):
// the cut of the cluster kernels spread over the whole card, the exchange
// through L2; see "the grid kernels" below. sv is laid out [N, 5, B, H] so
// all kernels touch it with the threads running along H.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "device_utils.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kClusterThreads = 256;  // a block of the cluster kernel has at most these

__device__ __forceinline__ float sigmoidf(float v) { return 1.f / (1.f + expf(-v)); }

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

// Grid (C * groups), cluster (C, 1, 1). Shared memory: As [Hp][RS], the
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
  const int b = (int)(blockIdx.x / blocks) * R + p;  // the cluster's batch group
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

// Grid (C * groups), cluster (C, 1, 1). Dynamic shared memory: two mbarriers
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
  const int b = (int)(blockIdx.x / blocks) * R + p;  // the cluster's batch group
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

// --- the grid kernels: one recurrence spread over every SM of the card ---
//
// A cooperative launch of P blocks (at most the blocks the card holds at
// once, so all of them run together); block c owns the hidden units of slice
// c (S = ceil(H / P) of them, the last slice short) for all B rows. Its part
// of W_hh^T, the forward's [H][3S] gate columns or the backward's [S][3H]
// rows, is copied into shared memory once and stays there for all N steps
// where it fits (kResA; else it is read from L2 every step). A step's values
// go through L2: each block writes its slice of them (the forward h', the
// backward (dr, dz, dn * r)) into a double-buffered exchange buffer in the
// workspace, [2][H][Bp] or [2][3H][Bp] (Bp: B rounded up to 8, the rows past
// B zero), then counts itself on a step counter with a release add; before
// the next step's product one thread of every block spins with acquire loads
// until the counter has all P arrivals of the step, and the block copies the
// whole buffer into shared memory, KC rows at a time (all of it where it
// fits), each copy followed by its part of the product. The double buffer is
// safe by the cluster kernels' argument: a block writes a buffer at step t + 1
// only after every block has
// counted step t, which each did after its last read of that buffer at step
// t - 1. The entry zeroes the counter and the buffers (h of step 0, the
// padding rows) with a cudaMemsetAsync on the launch's stream just before
// the launch, so a captured CUDA graph replays both.
// Inside a block a warp's task is 4 units by 8 rows and one of KS k-splits:
// lane (unit, p) sums k = p + 8 ks, p + 8 ks + 8 KS, ... for the 8 rows (and
// 3 gates, forward), `transpose_reduce` adds the 8 lanes' partials in a fixed
// tree and hands lane p the sums of row p, which are added to shared memory
// chunk after chunk; after a barrier a thread per (unit, row) adds the KS
// splits in order and does the gate math. No atomics in any sum: the same
// bits on every run.
// x_proj (forward) and sv, g (backward) of the next step are copied into
// shared memory by cp.async a step ahead.
// Bound: the f32 operations, 2 B H 3H a step (0.39 ms at B = 32, H = N =
// 512). What sets the pace on an H100 is the exchange: every block reads the
// whole of a step's values from L2 (at B = 32, H = 512: h 64 KB, dcat 192 KB
// a block, 8.4 and 25 MB a step over the card) and waits out the counter's
// round trip. `kernel_variants gru_grid` takes each piece out (PERF.md): at
// B = 32, H = 512 the backward's staging of dcat is 5.1 of its 11.0 us a
// step, the counter's wait 1.1; the forward's product 2.4 of 6.9, staging 2.0.

constexpr int kGridRows = 8;                   // batch rows of a warp's task
constexpr int kGridUnits = 32 / kGridRows;     // hidden units of a warp's task
constexpr int kGridThreads = 512;

__device__ __forceinline__ unsigned ld_acquire_gpu(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Counts this block on the step counter once all its threads' writes of the
// step are done: the barrier orders them before thread 0's add, and the add's
// release makes them visible to whoever acquires the count (no fence: one
// more before the add cost 0.3-0.4 us a step on an H100, `kernel_variants
// gru_grid`).
__device__ __forceinline__ void grid_arrive(unsigned* counter) {
  __syncthreads();
  if (threadIdx.x == 0)
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(counter) : "memory");
}

// Holds the block until the counter reaches `target`. An arrival that never
// comes is a fault: after about ten seconds the kernel traps, as
// `mbarrier_wait` does.
__device__ __forceinline__ void grid_wait(const unsigned* counter, unsigned target) {
  if (threadIdx.x == 0) {
    const long long start = clock64();
    while (ld_acquire_gpu(counter) < target)
      if (clock64() - start > 20000000000LL) __trap();
  }
  __syncthreads();
}

// Copies `rows` rows of a [.][Bp] exchange buffer into shared memory with
// Bs = Bp + 4 floats a row (the 8 k-parts a warp reads then fall in
// different banks), through L2 only (a line another SM wrote must not come
// from this SM's L1). A thread has 8 loads in flight before it stores.
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int rows, int Bp) {
  const int q = Bp / 4, total = rows * q;
  const float4* s4 = reinterpret_cast<const float4*>(src);
  for (int e0 = threadIdx.x; e0 < total; e0 += 8 * blockDim.x) {
    float4 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * blockDim.x;
      if (e < total) v[u] = __ldcg(s4 + e);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * blockDim.x;
      if (e < total) {
        const int k = e / q;
        *reinterpret_cast<float4*>(dst + k * (Bp + 4) + (e - k * q) * 4) = v[u];
      }
    }
  }
}

// Grid (P), cooperative. ws: the step counter (16 bytes), then hx [2][H][Bp].
// Shared memory: As [H][RS] (kResA; r at column 0, z at S, n at 2S; RS an
// odd multiple of 4, so the 8 k-parts by 4 units of a warp fall in 32 banks),
// hs [KC][Bp + 4] (KC rows of h at a time), xs [2][3][S][Bp], red
// [KS][3][S][Bp] (the sums, added up over the chunks of KC rows in order).
template <bool kSave, bool kResA>
__global__ void __launch_bounds__(kGridThreads, 1)
gru_fwd_grid_kernel(const float* __restrict__ xp, const float* __restrict__ A,
                    const float* __restrict__ bh, float* __restrict__ out,
                    float* __restrict__ sv, float* ws, int N, int B, int H, int S, int KS,
                    int RS, int KC) {
  constexpr int R = kGridRows, JW = kGridUnits;
  extern __shared__ __align__(16) float smem[];
  const int Bp = (B + R - 1) / R * R, Bs = Bp + 4, H3 = 3 * H;
  const int j0 = blockIdx.x * S, Sc = min(S, H - j0);
  unsigned* counter = reinterpret_cast<unsigned*>(ws);
  float* hx = ws + 4;
  float* As = smem;
  float* hs = As + (kResA ? H * RS : 0);
  float* xs = hs + KC * Bs;
  float* red = xs + 2 * 3 * S * Bp;

  // x_proj of step t (its [3][Sc][B] part) into xs[t & 1]
  auto prefetch_x = [&](int t) {
    float* dst = xs + (t & 1) * 3 * S * Bp;
    for (int e = threadIdx.x; e < 3 * Sc * B; e += blockDim.x) {
      const int u = e % Sc, g = (e / Sc) % 3, b = e / (3 * Sc);
      cp_async4(dst + (g * S + u) * Bp + b, xp + ((long)t * B + b) * H3 + g * H + j0 + u);
    }
  };
  if (kResA)
    for (int g = 0; g < 3; ++g) copy_panel_async(As + g * S, RS, A + g * H + j0, H3, H, Sc);
  prefetch_x(0);
  cp_async_commit();

  const int UG = (S + JW - 1) / JW, tasks = UG * (Bp / R) * KS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int p = lane / JW, ul = lane % JW;
  const unsigned P = gridDim.x;
  for (int t = 0; t < N; ++t) {
    const float* hcur = hx + (t & 1) * H * Bp;
    float* hnext = hx + ((t + 1) & 1) * H * Bp;
    if (t + 1 < N) prefetch_x(t + 1);
    cp_async_commit();
    cp_async_wait_group<1>();  // As (t = 0) and this step's x_proj
    if (t > 0) grid_wait(counter, P * t); else __syncthreads();

    for (int c0 = 0; c0 < H; c0 += KC) {
      const int c1 = min(H, c0 + KC);
      stage_rows(hs, hcur + c0 * Bp, c1 - c0, Bp);
      __syncthreads();
      for (int task = warp; task < tasks; task += warps) {
        const int ks = task % KS, rest = task / KS, uu = (rest % UG) * JW + ul;
        const int r0 = rest / UG * R;
        const int us = min(uu, Sc - 1);  // a task's spare lanes repeat the last unit
        const float* a = kResA ? As + us : A + j0 + us;
        const int lda = kResA ? RS : H3, go = kResA ? S : H;
        float acc[3][R] = {};
#pragma unroll 4
        for (int k = c0 + p + R * ks; k < c1; k += R * KS) {
          const float* ak = a + (long)k * lda;
          const float wr = kResA ? ak[0] : __ldg(ak), wz = kResA ? ak[go] : __ldg(ak + go),
                      wn = kResA ? ak[2 * go] : __ldg(ak + 2 * go);
          float hv[R];
          load8(hs + (k - c0) * Bs + r0, hv);
#pragma unroll
          for (int i = 0; i < R; ++i) {
            acc[0][i] = fmaf(hv[i], wr, acc[0][i]);
            acc[1][i] = fmaf(hv[i], wz, acc[1][i]);
            acc[2][i] = fmaf(hv[i], wn, acc[2][i]);
          }
        }
        transpose_reduce<R, 3>(acc, p, JW);
        if (uu < Sc)
#pragma unroll
          for (int g = 0; g < 3; ++g) {
            float* d = red + ((ks * 3 + g) * S + uu) * Bp + r0 + p;
            *d = c0 == 0 ? acc[g][0] : *d + acc[g][0];
          }
      }
      __syncthreads();  // the chunk's reads are done before the next one lands
    }

    const float* xv = xs + (t & 1) * 3 * S * Bp;
    for (int it = threadIdx.x; it < Sc * B; it += blockDim.x) {
      const int u = it % Sc, b = it / Sc, j = j0 + u;
      float hp[3];
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        float s = red[(g * S + u) * Bp + b];
        for (int ks = 1; ks < KS; ++ks) s += red[((ks * 3 + g) * S + u) * Bp + b];
        hp[g] = s;
      }
      const float h_prev = __ldcg(hcur + j * Bp + b);
      const float r = sigmoidf(xv[u * Bp + b] + (hp[0] + __ldg(bh + j)));
      const float z = sigmoidf(xv[(S + u) * Bp + b] + (hp[1] + __ldg(bh + H + j)));
      const float hpn = hp[2] + __ldg(bh + 2 * H + j);
      const float c = tanhf(xv[(2 * S + u) * Bp + b] + r * hpn);
      const float h = (1.f - z) * c + z * h_prev;
      __stcg(hnext + j * Bp + b, h);
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
    grid_arrive(counter);
  }
}

// Grid (P), cooperative. ws: the step counter (16 bytes), then dx [2][3H][Bp]
// (a step's dr, dz, dn * r). Shared memory: Au [S][LD] (kResA: the slice's
// rows of A, LD = 8 (mod 32) floats, so a warp's 4 rows by 8 k-parts fall in
// 32 banks), dsb [KC][Bp + 4] (KC rows of dcat at a time), ss [2][6][S][Bp]
// (sv[t] and g[t]), red [KS][S][Bp], dh [S][Bp], dhz [S][Bp] (dh_total * z).
template <bool kResA>
__global__ void __launch_bounds__(kGridThreads, 1)
gru_bwd_grid_kernel(const float* __restrict__ sv, const float* __restrict__ g,
                    const float* __restrict__ A, float* __restrict__ dxp, float* ws, int N,
                    int B, int H, int S, int KS, int LD, int KC) {
  constexpr int R = kGridRows, JW = kGridUnits;
  extern __shared__ __align__(16) float smem[];
  const int Bp = (B + R - 1) / R * R, Bs = Bp + 4, H3 = 3 * H;
  const int j0 = blockIdx.x * S, Sc = min(S, H - j0);
  const long plane = (long)B * H;
  unsigned* counter = reinterpret_cast<unsigned*>(ws);
  float* dx = ws + 4;
  float* Au = smem;
  float* dsb = Au + (kResA ? S * LD : 0);
  float* ss = dsb + KC * Bs;
  float* red = ss + 2 * 6 * S * Bp;
  float* dh = red + KS * S * Bp;
  float* dhz = dh + S * Bp;

  // sv[t] (r, z, hpn, c, h - c) and g[t] of the slice into ss[buf]
  auto prefetch_s = [&](int t, int buf) {
    float* dst = ss + buf * 6 * S * Bp;
    for (int e = threadIdx.x; e < 6 * Sc * B; e += blockDim.x) {
      const int u = e % Sc, q = (e / Sc) % 6, b = e / (6 * Sc);
      const float* src = q < 5 ? sv + ((long)t * 5 + q) * plane + (long)b * H + j0 + u
                               : g + ((long)b * N + t) * H + j0 + u;
      cp_async4(dst + (q * S + u) * Bp + b, src);
    }
  };
  if (kResA) copy_panel_async(Au, LD, A + (long)j0 * H3, H3, Sc, H3);
  prefetch_s(N - 1, 0);
  cp_async_commit();
  for (int e = threadIdx.x; e < S * Bp; e += blockDim.x) dh[e] = 0.f;

  const int UG = (S + JW - 1) / JW, tasks = UG * (Bp / R) * KS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int p = lane / JW, ul = lane % JW;
  const unsigned P = gridDim.x;
  for (int u = 0; u < N; ++u) {
    const int t = N - 1 - u;
    float* dcur = dx + (u & 1) * H3 * Bp;
    if (t > 0) prefetch_s(t - 1, (u + 1) & 1);
    cp_async_commit();
    cp_async_wait_group<1>();  // Au (u = 0) and this step's sv, g
    __syncthreads();           // ... and dh of the step before

    const float* sc = ss + (u & 1) * 6 * S * Bp;
    for (int it = threadIdx.x; it < Sc * B; it += blockDim.x) {
      const int v = it % Sc, b = it / Sc, j = j0 + v;
      const float r = sc[v * Bp + b], z = sc[(S + v) * Bp + b];
      const float hpn = sc[(2 * S + v) * Bp + b], c = sc[(3 * S + v) * Bp + b];
      const float hmc = sc[(4 * S + v) * Bp + b];
      const float dh_total = sc[(5 * S + v) * Bp + b] + dh[v * Bp + b];
      const float dz = dh_total * hmc * z * (1.f - z);
      const float dn = dh_total * (1.f - z) * (1.f - c * c);
      const float dr = dn * hpn * r * (1.f - r);
      float* d = dxp + ((long)t * B + b) * H3 + j;
      d[0] = dr;
      d[H] = dz;
      d[2 * H] = dn;
      __stcg(dcur + j * Bp + b, dr);
      __stcg(dcur + (H + j) * Bp + b, dz);
      __stcg(dcur + (2 * H + j) * Bp + b, dn * r);
      dhz[v * Bp + b] = dh_total * z;
    }
    if (t == 0) break;  // the first step's dh is nobody's
    grid_arrive(counter);
    grid_wait(counter, P * (u + 1));

    for (int c0 = 0; c0 < H3; c0 += KC) {
      const int c1 = min(H3, c0 + KC);
      stage_rows(dsb, dcur + c0 * Bp, c1 - c0, Bp);
      __syncthreads();
      for (int task = warp; task < tasks; task += warps) {
        const int ks = task % KS, rest = task / KS, uu = (rest % UG) * JW + ul;
        const int r0 = rest / UG * R;
        const int us = min(uu, Sc - 1);
        const float* w = kResA ? Au + us * LD : A + (long)(j0 + us) * H3;
        float acc[1][R] = {};
#pragma unroll 4
        for (int c = c0 + p + R * ks; c < c1; c += R * KS) {
          const float wk = kResA ? w[c] : __ldg(w + c);
          float dv[R];
          load8(dsb + (c - c0) * Bs + r0, dv);
#pragma unroll
          for (int i = 0; i < R; ++i) acc[0][i] = fmaf(dv[i], wk, acc[0][i]);
        }
        transpose_reduce<R, 1>(acc, p, JW);
        if (uu < Sc) {
          float* d = red + (ks * S + uu) * Bp + r0 + p;
          *d = c0 == 0 ? acc[0][0] : *d + acc[0][0];
        }
      }
      __syncthreads();  // the chunk's reads are done before the next one lands
    }

    for (int it = threadIdx.x; it < Sc * B; it += blockDim.x) {
      const int v = it % Sc, b = it / Sc;
      float s = red[v * Bp + b];
      for (int ks = 1; ks < KS; ++ks) s += red[(ks * S + v) * Bp + b];
      dh[v * Bp + b] = dhz[v * Bp + b] + s;
    }
  }
}

constexpr int kRows = 4;           // batch rows of a cluster
constexpr int kPortableCluster = 8;

// Launches `kernel` on grid (cluster * groups) in clusters of `cluster` blocks
// along x: block x is rank x % cluster of group x / cluster (a grid's x takes
// 2^31 - 1 blocks, where its y stops at 65,535 groups of kRows batch rows).
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
  cfg.gridDim = dim3((unsigned)cluster * (unsigned)groups);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, args...);
}

// Zeroes the first `ws_bytes` of ws (the step counter and exchange buffers),
// then launches a grid kernel on `blocks` blocks cooperatively: the launch is
// refused (cudaErrorCooperativeLaunchTooLarge) unless every block can be
// resident at once, which the kernel's spinning needs.
template <typename... Params, typename... Args>
int launch_grid(void (*kernel)(Params...), int blocks, int threads, int smem, float* ws,
                long ws_bytes, void* stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return (int)err;
  if ((long)per_sm * sms < blocks) return (int)cudaErrorCooperativeLaunchTooLarge;
  err = cudaMemsetAsync(ws, 0, ws_bytes, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, args...);
}

// bytes of a grid kernel's workspace: the counter and two buffers of `rows` x Bp
long grid_ws_bytes(int rows, int B) {
  return 16 + 2L * rows * ((B + kGridRows - 1) / kGridRows * kGridRows) * 4;
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

// The forward across the whole card, for an H no cluster holds. The plan
// comes from ops/cuda_gru.py `grid_plan`: `blocks` blocks of `slice` units,
// `ksplit` k-splits a task, `row_stride` floats a row of the resident slice,
// `threads`, `smem` bytes; `resident` keeps the slice of W_hh^T in shared
// memory, `chunk` rows of each step's h are copied there at a time. ws:
// 16 + 8 H Bp bytes (Bp: B rounded up to 8), zeroed here before the launch.
// sv as above.
extern "C" int gru_fwd_grid(const float* xp, const float* A, const float* bh, float* out,
                            float* sv, float* ws, int N, int B, int H, int blocks, int slice,
                            int ksplit, int row_stride, int threads, int smem, int resident,
                            int chunk, void* stream) {
  if (threads > kGridThreads || ksplit < 1 || chunk < 1 || (long)blocks * slice < H ||
      (long)(blocks - 1) * slice >= H)
    return (int)cudaErrorInvalidValue;
  using K = void (*)(const float*, const float*, const float*, float*, float*, float*, int,
                     int, int, int, int, int, int);
  static const K kernels[2][2] = {
      {gru_fwd_grid_kernel<false, false>, gru_fwd_grid_kernel<false, true>},
      {gru_fwd_grid_kernel<true, false>, gru_fwd_grid_kernel<true, true>}};
  return launch_grid(kernels[sv != nullptr][resident != 0], blocks, threads, smem, ws,
                     grid_ws_bytes(H, B), stream, xp, A, bh, out, sv, ws, N, B, H, slice,
                     ksplit, row_stride, chunk);
}

// The backward across the whole card, by ops/cuda_gru.py `grid_plan(...,
// backward=True)`: A = W_hh^T [H, 3H] as the cluster backward reads it,
// `row_stride` floats a resident row. ws: 16 + 24 H Bp bytes, zeroed here.
extern "C" int gru_bwd_grid(const float* sv, const float* g, const float* A, float* dxp,
                            float* ws, int N, int B, int H, int blocks, int slice, int ksplit,
                            int row_stride, int threads, int smem, int resident, int chunk,
                            void* stream) {
  if (threads > kGridThreads || ksplit < 1 || chunk < 1 || (long)blocks * slice < H ||
      (long)(blocks - 1) * slice >= H)
    return (int)cudaErrorInvalidValue;
  return launch_grid(resident ? gru_bwd_grid_kernel<true> : gru_bwd_grid_kernel<false>, blocks,
                     threads, smem, ws, grid_ws_bytes(3 * H, B), stream, sv, g, A, dxp, ws, N,
                     B, H, slice, ksplit, row_stride, chunk);
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
