// Latent-correlation attention, forward and backward.
//
// Forward: replaces stemgnn_tpu/ops/pallas_attention.py `_kernel` (reached from
// `_forward_kq` / `attention_kq_pallas`): scores[b,i,j] = key[b,i] +
// query[b,j], LeakyReLU(alpha), stable row softmax, out [B, N, N] f32.
//
// Both kernels also take a row block: key [B, M] of M < N rows against the
// whole query [B, N], out [B, M, N] (the node-sharded dense path: one rank's
// rows of the attention, the rows of `attention_from_kq` for its node
// block). Rows are laid over warps and blocks by M, columns by N; at M = N
// every index, plan and sum order is the square call's.
//
// Bound on the H100: bytes. The kernel reads 2*B*N floats and writes
// B*N*N; its arithmetic is a few operations per output element. At the
// flagship (B = 32, N = 140) the 2.5 MB it writes take 0.75 us at the memory's
// rate, so what a call costs is latency: the chain from the first load to the
// last store of a row, and how many rows are in flight.
// - A warp owns `rows_per_warp` rows of one batch element (the plan of
//   ops/cuda_attention.py `fwd_plan` sizes them so that one wave of warps
//   fills the card). Its lanes load their columns of query[b] into registers
//   once and keep them across the rows.
// - A lane owns runs of V columns, the lanes of the warp on neighbouring runs:
//   V = 4 where N % 4 == 0 (16-byte loads and stores), V = 1 otherwise. A row
//   of up to 32 * V * T columns lies in T runs a lane.
// - For each row the scores are formed once in registers, max and sum go by
//   shuffles, expf runs once an element (f32 expf, not __expf), and each run
//   is stored as it is normalised.
// - A row wider than a span of 32 * V * T columns (N > 1024) takes the wide
//   instantiation: three sweeps over the spans (max, sum, store), the query
//   read again from L1 each sweep, expf twice an element. Nothing is refused.
// The TPU kept alpha in SMEM; here it is a kernel argument.
//
// Backward (`attention_kq_bwd`): replaces `_bwd_kernel` (reached from `_bwd`):
// from the saved softmax output p and the cotangent g, both [B, N, N],
//   dl = g * p - p * rowsum(g * p)            (softmax backward)
//   dpre = pre >= 0 ? dl : alpha * dl, pre = key_i + query_j   (recomputed)
//   dkey[b, i] = sum_j dpre;  dquery[b, j] = sum_i dpre
// Bytes bound again: p and g are read once (twice past N = 1024), nothing of
// size N*N is written.
// The TPU kernel adds dquery up across row tiles in one output block, which
// its sequential grid allows. Here one launch does it, with no scratch in
// device memory and no atomics:
// - The grid is B thread-block clusters of C <= 8 blocks (the portable size).
//   Block c of cluster b owns a band of `rows_per_block` rows of batch element
//   b; its warps take the band's rows in turn.
// - A warp holds its row of p and g in registers, read once by 16-byte loads
//   where N % 4 == 0, takes the row's dot and dkey by shuffles, and keeps its
//   column partials of dpre in registers across its rows.
// - The block sums its warps' partials in warp order through shared memory;
//   each thread then stores the block's sum of a column into the shared
//   memory of the block that owns the column (block c owns the c-th of C
//   slices of the columns) through distributed shared memory. After one
//   cluster barrier every block sums what it received in rank order and
//   writes its slice of dquery. Every sum has one order whatever the run, so
//   two runs give the same bits.
// - A row wider than 32 * V * T columns (N > 1024) takes the chunked
//   instantiation: a warp walks its rows in groups of 32 (lane r keeps row
//   r's dot and dkey), makes a dot pass over the group's rows, then reduces
//   chunk by chunk of 256 columns, the cluster's sums of a chunk added to
//   dquery group after group; two rows at a time and blocks of up to 1024
//   threads, so that enough loads are in flight where B is small (a cluster
//   of 8 SMs a batch element). Its shared memory does not depend on N.
// Shared memory: the warps' partials [warps][32 * V * T] and the received
// slices [C][slice] (two buffers in the chunked route), at most 36 KB.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;

// Max and sum over the lanes of a warp, a fixed butterfly.
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float leaky(float s, float alpha) {
  return s >= 0.f ? s : alpha * s;
}

// First column of run t of a lane in a span: runs of V columns, the 32 lanes
// on neighbouring runs, then the next 32 runs.
template <int V>
__device__ __forceinline__ int run_col(int t, int lane) {
  return (t * 32 + lane) * V;
}

// V consecutive floats: one 16-byte load for V = 4 (the address 16-byte
// aligned), one 4-byte load for V = 1.
template <int V>
__device__ __forceinline__ void load_run(const float* p, float (&x)[V]) {
  if constexpr (V == 4) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = f.x; x[1] = f.y; x[2] = f.z; x[3] = f.w;
  } else {
    x[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store_run(float* p, const float (&x)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    p[0] = x[0];
  }
}

// A lane's runs of the n columns from `p` (zeros past them).
template <int V, int T>
__device__ __forceinline__ void load_span(const float* p, int n, int lane, float (&x)[T][V]) {
#pragma unroll
  for (int t = 0; t < T; ++t) {
#pragma unroll
    for (int v = 0; v < V; ++v) x[t][v] = 0.f;
    if (run_col<V>(t, lane) < n) load_run<V>(p + run_col<V>(t, lane), x[t]);
  }
}

constexpr int kFwdThreads = 256;

template <int V, int T, bool kWide>
__global__ void __launch_bounds__(kFwdThreads)
attention_fwd_kernel(const float* __restrict__ key, const float* __restrict__ query,
                     float* __restrict__ out, int B, int M, int N, float alpha,
                     int rows_per_warp, int bands) {
  constexpr int kSpan = 32 * V * T;
  const int lane = threadIdx.x & 31;
  const long task = (long)blockIdx.x * (kFwdThreads / 32) + (threadIdx.x >> 5);
  if (task >= (long)B * bands) return;  // the whole warp leaves together
  const int b = (int)(task / bands);
  const int i0 = (int)(task % bands) * rows_per_warp;
  const int i1 = min(M, i0 + rows_per_warp);
  const float* q = query + (long)b * N;
  const float* kb = key + (long)b * M;
  float* ob = out + (long)b * M * N;

  if constexpr (!kWide) {
    float qv[T][V];
    load_span<V, T>(q, N, lane, qv);  // the query: once a warp, kept across its rows
    float kl = 0.f;  // lane r: the key of the warp's next rows, 32 at a time
    for (int i = i0; i < i1; ++i) {
      if ((i - i0) % 32 == 0) kl = i + lane < i1 ? __ldg(kb + i + lane) : 0.f;
      const float k = __shfl_sync(kFull, kl, (i - i0) % 32);
      float e[T][V];
      float m = -INFINITY;
#pragma unroll
      for (int t = 0; t < T; ++t)
        if (run_col<V>(t, lane) < N)
#pragma unroll
          for (int v = 0; v < V; ++v) {
            e[t][v] = leaky(k + qv[t][v], alpha);
            m = fmaxf(m, e[t][v]);
          }
      m = warp_max(m);
      float s = 0.f;
#pragma unroll
      for (int t = 0; t < T; ++t)
        if (run_col<V>(t, lane) < N)
#pragma unroll
          for (int v = 0; v < V; ++v) {
            e[t][v] = expf(e[t][v] - m);
            s += e[t][v];
          }
      s = warp_sum(s);
      const float inv = 1.f / s;
      float* o = ob + (long)i * N;
#pragma unroll
      for (int t = 0; t < T; ++t)
        if (run_col<V>(t, lane) < N) {
#pragma unroll
          for (int v = 0; v < V; ++v) e[t][v] *= inv;
          store_run<V>(o + run_col<V>(t, lane), e[t]);
        }
    }
  } else {
    for (int i = i0; i < i1; ++i) {
      const float k = __ldg(kb + i);
      float m = -INFINITY;
      for (int c0 = 0; c0 < N; c0 += kSpan) {
        float qv[T][V];
        load_span<V, T>(q + c0, N - c0, lane, qv);
#pragma unroll
        for (int t = 0; t < T; ++t)
          if (run_col<V>(t, lane) < N - c0)
#pragma unroll
            for (int v = 0; v < V; ++v) m = fmaxf(m, leaky(k + qv[t][v], alpha));
      }
      m = warp_max(m);
      float s = 0.f;
      for (int c0 = 0; c0 < N; c0 += kSpan) {
        float qv[T][V];
        load_span<V, T>(q + c0, N - c0, lane, qv);
#pragma unroll
        for (int t = 0; t < T; ++t)
          if (run_col<V>(t, lane) < N - c0)
#pragma unroll
            for (int v = 0; v < V; ++v) s += expf(leaky(k + qv[t][v], alpha) - m);
      }
      s = warp_sum(s);
      const float inv = 1.f / s;
      float* o = ob + (long)i * N;
      for (int c0 = 0; c0 < N; c0 += kSpan) {
        float qv[T][V];
        load_span<V, T>(q + c0, N - c0, lane, qv);
#pragma unroll
        for (int t = 0; t < T; ++t)
          if (run_col<V>(t, lane) < N - c0) {
            float e[V];
#pragma unroll
            for (int v = 0; v < V; ++v) e[v] = expf(leaky(k + qv[t][v], alpha) - m) * inv;
            store_run<V>(o + c0 + run_col<V>(t, lane), e);
          }
      }
    }
  }
}

// The cluster barrier in two halves: arrive (release: this thread's stores,
// to its own and to other blocks' shared memory, are visible to the cluster
// once everyone has arrived; relaxed: no such promise, for the barrier that
// only says every block has started) and wait (acquire).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

// Sums the warps' partials of the first `width` columns of the block's span
// in warp order and stores each column's sum into the received slices of
// the block that owns it: [rank][slice] in `recv` of block (column / slice).
__device__ __forceinline__ void send_to_owners(const float* part, int warps, int span,
                                               int width, int slice, float* recv, int rank,
                                               cg::cluster_group& cluster) {
  for (int j = threadIdx.x; j < width; j += blockDim.x) {
    float s = part[j];
    for (int w = 1; w < warps; ++w) s += part[w * span + j];
    const int owner = j / slice;
    cluster.map_shared_rank(recv, owner)[rank * slice + (j - owner * slice)] = s;
  }
}

// Rows of a group a warp of the chunked backward takes at once (a divisor of
// 32).
constexpr int kChunkRows = 2;

// Threads a backward block may have where a lane holds `values` of a row:
// the register route's p, g * p, query and partials take 4 * values
// registers, the chunked route's kChunkRows rows of p and g more.
constexpr int bwd_max_threads(int values, bool chunked) {
  return chunked ? 1024 : values >= 32 ? 256 : values >= 16 ? 512 : 1024;
}

template <int V, int T, bool kChunked>
__global__ void __launch_bounds__(bwd_max_threads(V * T, kChunked))
attention_bwd_kernel(const float* __restrict__ key, const float* __restrict__ query,
                     const float* __restrict__ p, const float* __restrict__ g,
                     float* __restrict__ dkey, float* __restrict__ dquery, int M, int N,
                     float alpha, int rows_per_block, int slice) {
  constexpr int kSpan = 32 * V * T;  // columns a warp holds at once
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = gridDim.x, c = blockIdx.x;  // the cluster's size and this block's rank
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* part = smem;                          // [warps][kSpan]
  float* recv = smem + warps * kSpan;          // [C][slice], twice when chunked
  float* part_w = part + warp * kSpan;
  const int b = blockIdx.y;
  const int r0 = c * rows_per_block, r1 = min(M, r0 + rows_per_block);
  const float* qb = query + (long)b * N;
  const float* kb = key + (long)b * M;
  const float* pb = p + (long)b * M * N;
  const float* gb = g + (long)b * M * N;
  // every block of the cluster has started before anyone stores into it
  cluster_arrive_relaxed();

  if constexpr (!kChunked) {
    float qv[T][V], acc[T][V];
    load_span<V, T>(qb, N, lane, qv);  // the query's columns: once a warp
#pragma unroll
    for (int t = 0; t < T; ++t)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[t][v] = 0.f;
    float kl = 0.f;  // lane r: the key of the warp's next rows, 32 at a time
    int n = 0;
    for (int i = r0 + warp; i < r1; i += warps, ++n) {
      if (n % 32 == 0) kl = i + lane * warps < r1 ? __ldg(kb + i + lane * warps) : 0.f;
      float pv[T][V], gp[T][V];
      load_span<V, T>(pb + (long)i * N, N, lane, pv);
      load_span<V, T>(gb + (long)i * N, N, lane, gp);
      float dot = 0.f;
#pragma unroll
      for (int t = 0; t < T; ++t)
#pragma unroll
        for (int v = 0; v < V; ++v) {
          gp[t][v] *= pv[t][v];
          dot += gp[t][v];
        }
      dot = warp_sum(dot);
      const float k = __shfl_sync(kFull, kl, n % 32);
      float dk = 0.f;
#pragma unroll
      for (int t = 0; t < T; ++t)
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float dl = gp[t][v] - pv[t][v] * dot;
          const float d = k + qv[t][v] >= 0.f ? dl : alpha * dl;
          acc[t][v] += d;
          dk += d;
        }
      dk = warp_sum(dk);
      if (lane == 0) dkey[(long)b * M + i] = dk;
    }
#pragma unroll
    for (int t = 0; t < T; ++t) store_run<V>(part_w + run_col<V>(t, lane), acc[t]);
    __syncthreads();
    cluster_wait();
    send_to_owners(part, warps, kSpan, N, slice, recv, c, cluster);
    cluster_arrive();
    cluster_wait();
    for (int j = threadIdx.x; j < slice && c * slice + j < N; j += blockDim.x) {
      float s = recv[j];
      for (int r = 1; r < C; ++r) s += recv[r * slice + j];
      dquery[(long)b * N + c * slice + j] = s;
    }
  } else {
    const int groups = ((rows_per_block + warps - 1) / warps + 31) / 32;
    cluster_wait();
    int step = 0;
    for (int grp = 0; grp < groups; ++grp) {
      // the dot of each row of the group: lane r keeps row r's. kChunkRows
      // rows at a time, so that their loads are in flight together; a row
      // past the band loads nothing and adds zeros
      float my_dot = 0.f;
      for (int r = 0; r < 32; r += kChunkRows) {
        const int i = r0 + warp + (grp * 32 + r) * warps;
        if (i >= r1) break;  // the same for the whole warp
        float s[kChunkRows];
#pragma unroll
        for (int u = 0; u < kChunkRows; ++u) s[u] = 0.f;
        for (int c0 = 0; c0 < N; c0 += kSpan) {
          float pv[kChunkRows][T][V], gv[kChunkRows][T][V];
#pragma unroll
          for (int u = 0; u < kChunkRows; ++u) {
            const long row = i + u * warps;
            const int n = row < r1 ? N - c0 : 0;
            load_span<V, T>(pb + row * N + c0, n, lane, pv[u]);
            load_span<V, T>(gb + row * N + c0, n, lane, gv[u]);
          }
#pragma unroll
          for (int u = 0; u < kChunkRows; ++u)
#pragma unroll
            for (int t = 0; t < T; ++t)
#pragma unroll
              for (int v = 0; v < V; ++v) {
                const float gpv = gv[u][t][v] * pv[u][t][v];
                s[u] += gpv;
              }
        }
#pragma unroll
        for (int u = 0; u < kChunkRows; ++u) {
          const float su = warp_sum(s[u]);
          if (lane == r + u) my_dot = su;
        }
      }
      float my_dk = 0.f;
      for (int c0 = 0; c0 < N; c0 += kSpan, ++step) {
        const int width = min(kSpan, N - c0);
        float qv[T][V], acc[T][V];
        load_span<V, T>(qb + c0, width, lane, qv);
#pragma unroll
        for (int t = 0; t < T; ++t)
#pragma unroll
          for (int v = 0; v < V; ++v) acc[t][v] = 0.f;
        for (int r = 0; r < 32; r += kChunkRows) {
          const int i = r0 + warp + (grp * 32 + r) * warps;
          if (i >= r1) break;
          float pv[kChunkRows][T][V], gv[kChunkRows][T][V], dot[kChunkRows], k[kChunkRows];
#pragma unroll
          for (int u = 0; u < kChunkRows; ++u) {
            const long row = i + u * warps;
            const int n = row < r1 ? width : 0;
            dot[u] = __shfl_sync(kFull, my_dot, r + u);
            k[u] = row < r1 ? __ldg(kb + row) : 0.f;
            load_span<V, T>(pb + row * N + c0, n, lane, pv[u]);
            load_span<V, T>(gb + row * N + c0, n, lane, gv[u]);
          }
          float rs[kChunkRows];
#pragma unroll
          for (int u = 0; u < kChunkRows; ++u) {  // the rows in order: acc adds row i first
            rs[u] = 0.f;
#pragma unroll
            for (int t = 0; t < T; ++t)
#pragma unroll
              for (int v = 0; v < V; ++v) {
                const float gpv = gv[u][t][v] * pv[u][t][v];
                const float dl = gpv - pv[u][t][v] * dot[u];
                const float d = k[u] + qv[t][v] >= 0.f ? dl : alpha * dl;
                acc[t][v] += d;
                rs[u] += d;
              }
          }
#pragma unroll
          for (int u = 0; u < kChunkRows; ++u) {
            const float ru = warp_sum(rs[u]);
            if (lane == r + u) my_dk += ru;
          }
        }
#pragma unroll
        for (int t = 0; t < T; ++t) store_run<V>(part_w + run_col<V>(t, lane), acc[t]);
        __syncthreads();
        // two buffers of received slices in turn: a block stores into one
        // only after the barrier that its owner passed once done with it
        float* buf = recv + (step & 1) * C * slice;
        send_to_owners(part, warps, kSpan, width, slice, buf, c, cluster);
        cluster_arrive();
        cluster_wait();
        for (int j = threadIdx.x; j < slice && c * slice + j < width; j += blockDim.x) {
          float s = buf[j];
          for (int r = 1; r < C; ++r) s += buf[r * slice + j];
          float* d = dquery + (long)b * N + c0 + c * slice + j;
          *d = grp == 0 ? s : *d + s;
        }
      }
      const int i = r0 + warp + (grp * 32 + lane) * warps;
      if (i < r1) dkey[(long)b * M + i] = my_dk;
    }
  }
}

typedef void (*FwdKernel)(const float*, const float*, float*, int, int, int, float, int, int);
typedef void (*BwdKernel)(const float*, const float*, const float*, const float*, float*,
                          float*, int, int, float, int, int);

// The instantiation of a plan's (vec, runs, wide or chunked), or null.
FwdKernel fwd_kernel(int vec, int runs, bool wide) {
  if (vec == 4) {
    if (wide) return runs == 8 ? attention_fwd_kernel<4, 8, true> : nullptr;
    switch (runs) {
      case 1: return attention_fwd_kernel<4, 1, false>;
      case 2: return attention_fwd_kernel<4, 2, false>;
      case 4: return attention_fwd_kernel<4, 4, false>;
      case 8: return attention_fwd_kernel<4, 8, false>;
    }
  } else if (vec == 1) {
    if (wide) return runs == 32 ? attention_fwd_kernel<1, 32, true> : nullptr;
    switch (runs) {
      case 1: return attention_fwd_kernel<1, 1, false>;
      case 2: return attention_fwd_kernel<1, 2, false>;
      case 4: return attention_fwd_kernel<1, 4, false>;
      case 8: return attention_fwd_kernel<1, 8, false>;
      case 16: return attention_fwd_kernel<1, 16, false>;
      case 32: return attention_fwd_kernel<1, 32, false>;
    }
  }
  return nullptr;
}

BwdKernel bwd_kernel(int vec, int runs, bool chunked) {
  if (vec == 4) {
    if (chunked) return runs == 2 ? attention_bwd_kernel<4, 2, true> : nullptr;
    switch (runs) {
      case 1: return attention_bwd_kernel<4, 1, false>;
      case 2: return attention_bwd_kernel<4, 2, false>;
      case 4: return attention_bwd_kernel<4, 4, false>;
      case 8: return attention_bwd_kernel<4, 8, false>;
    }
  } else if (vec == 1) {
    if (chunked) return runs == 8 ? attention_bwd_kernel<1, 8, true> : nullptr;
    switch (runs) {
      case 1: return attention_bwd_kernel<1, 1, false>;
      case 2: return attention_bwd_kernel<1, 2, false>;
      case 4: return attention_bwd_kernel<1, 4, false>;
      case 8: return attention_bwd_kernel<1, 8, false>;
      case 16: return attention_bwd_kernel<1, 16, false>;
      case 32: return attention_bwd_kernel<1, 32, false>;
    }
  }
  return nullptr;
}

constexpr int kPortableCluster = 8;

}  // namespace

// The plan comes from ops/cuda_attention.py `fwd_plan`: runs of `vec` columns,
// `runs` of them a lane, the wide instantiation past a span, `rows_per_warp`
// rows of one batch element a warp, `bands` warps a batch element, `blocks`
// blocks of 256 threads. key [B, M], query [B, N], out [B, M, N]: M = N is the
// whole attention, M < N a row block of it (the rows of a node block).
extern "C" int attention_kq_fwd(const float* key, const float* query, float* out, int B,
                                int M, int N, float alpha, int vec, int runs, int wide,
                                int rows_per_warp, int bands, int blocks, void* stream) {
  const FwdKernel kernel = fwd_kernel(vec, runs, wide != 0);
  if (kernel == nullptr || (long)bands * rows_per_warp < M ||
      (long)blocks * (kFwdThreads / 32) < (long)B * bands)
    return (int)cudaErrorInvalidValue;
  kernel<<<blocks, kFwdThreads, 0, (cudaStream_t)stream>>>(key, query, out, B, M, N, alpha,
                                                           rows_per_warp, bands);
  return (int)cudaGetLastError();
}

// The plan comes from ops/cuda_attention.py `bwd_plan`: grid (cluster, B) in
// clusters of `cluster` blocks of `threads` threads, `rows_per_block` rows a
// block (of M), `slice` columns a block owns (of N, or of a chunk when
// chunked), `smem` bytes of dynamic shared memory. key [B, M], query [B, N],
// p and g [B, M, N] -> dkey [B, M] and dquery [B, N], the sums over the M
// rows (where M < N, this row block's share of dquery).
extern "C" int attention_kq_bwd(const float* key, const float* query, const float* p,
                                const float* g, float* dkey, float* dquery, int B, int M,
                                int N, float alpha, int vec, int runs, int chunked,
                                int cluster, int threads, int rows_per_block, int slice,
                                int smem, void* stream) {
  const BwdKernel kernel = bwd_kernel(vec, runs, chunked != 0);
  const int width = chunked ? 32 * vec * runs : N;
  if (kernel == nullptr || cluster < 1 || cluster > kPortableCluster || threads % 32 ||
      threads > bwd_max_threads(vec * runs, chunked) || (long)cluster * rows_per_block < M ||
      (long)cluster * slice < width)
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, B);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, key, query, p, g, dkey, dquery, M, N, alpha,
                                 rows_per_block, slice);
}
