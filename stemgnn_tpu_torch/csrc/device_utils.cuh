// Device functions shared by the kernels that keep an operand resident in
// shared memory and split a sum over the lanes of a warp, and the operand
// types of the kernels' two arms.
//
// Asynchronous copies from device memory into a block's shared memory are
// cp.async: the data does not pass through registers, so a thread keeps as
// many copies in flight as it starts.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Operand types. The f32 arm reads float operands; the bf16 arm reads
// __nv_bfloat16 operands (as the JAX package's wrappers cast them before
// their kernels) and converts each to f32 for its product: a product of two
// bf16 values is exact in f32, so an f32 fmaf sum of them is the bf16 x bf16
// -> f32 product of a matrix unit up to the order of the sum.
using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float ldg1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg1(const bf16* p) { return __bfloat162float(__ldg(p)); }

// v rounded to the operand type T (to nearest, ties to even, as the JAX
// package's astype), as an f32: the identity for float
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (sizeof(T) == 2) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

// Four consecutive operands as one load: a float4 (16-byte aligned), or four
// bf16 as a uint2 (8-byte aligned); unpack4 converts them to f32.
template <typename T>
struct Vec4 {
  using type = float4;
};
template <>
struct Vec4<bf16> {
  using type = uint2;
};

__device__ __forceinline__ float4 ldg_vec4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ uint2 ldg_vec4(const bf16* p) {
  return __ldg(reinterpret_cast<const uint2*>(p));
}
__device__ __forceinline__ void unpack4(const float4& v, float (&f)[4]) {
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
// a bf16 is the high half of the f32 with the same value
__device__ __forceinline__ void unpack4(const uint2& v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x << 16);
  f[1] = __uint_as_float(v.x & 0xffff0000u);
  f[2] = __uint_as_float(v.y << 16);
  f[3] = __uint_as_float(v.y & 0xffff0000u);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
}

// Closes the group of the copies this thread has started since the last one.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// All but the newest `kPending` groups of this thread have landed; a barrier
// then makes the other threads' copies visible too.
template <int kPending>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// 8 consecutive floats (16-byte aligned) as two float4.
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

// Starts the copy of a [rows][cols] panel of `src` (leading dimension src_ld)
// into shared memory at `dst` (leading dimension dst_ld), all threads of the
// block taking elements in turn. 16 bytes a copy where every row of both
// sides is 16-byte aligned, 4 bytes otherwise.
__device__ __forceinline__ void copy_panel_async(float* dst, int dst_ld,
                                                 const float* __restrict__ src,
                                                 long src_ld, int rows, int cols) {
  const bool vec = ((cols | dst_ld | (int)(src_ld & 3)) & 3) == 0 &&
                   (((uintptr_t)src | (uintptr_t)dst) & 15) == 0;
  if (vec) {
    const int c4 = cols / 4;
    for (int e = threadIdx.x; e < rows * c4; e += blockDim.x) {
      const int r = e / c4, c = (e - r * c4) * 4;
      cp_async16(dst + r * dst_ld + c, src + r * src_ld + c);
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += blockDim.x) {
      const int r = e / cols, c = e - r * cols;
      cp_async4(dst + r * dst_ld + c, src + r * src_ld + c);
    }
  }
}

// v[g][i] holds this lane's partial sum for row i of value g; the R lanes
// `stride` apart (p = 0..R-1) hold partials of the same R rows. Adds them so
// that lane p ends with the full sums of row p in v[g][0]. Each round a lane
// keeps one half of its rows and sends the other half to its partner, so a
// sum is a fixed binary tree over the lanes: the same bits on every run.
template <int R, int G>
__device__ __forceinline__ void transpose_reduce(float (&v)[G][R], int p, int stride) {
#pragma unroll
  for (int half = R / 2; half >= 1; half /= 2) {
    const bool upper = (p & half) != 0;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int i = 0; i < half; ++i) {
        const float send = upper ? v[g][i] : v[g][i + half];
        const float keep = upper ? v[g][i + half] : v[g][i];
        v[g][i] = keep + __shfl_xor_sync(0xffffffffu, send, half * stride);
      }
  }
}

// ---- the tensor cores' bf16 products (the bf16 spectral and graph kernels) ----

// d += a (16 x 16, row) * b (16 x 8, col), bf16 operands, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 bf16 matrices of shared memory: lane i gives the address of row
// i % 8 of matrix i / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

// the same, transposed
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

// Starts bringing `bytes` (a multiple of 16, 16-byte aligned) from p into L2
// (the TMA's bulk prefetch: one thread, no registers, nothing to wait for).
__device__ __forceinline__ void prefetch_l2(const void* p, unsigned bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(p), "r"(bytes) : "memory");
}

// ---- the TMA's bulk copies and the mbarriers that count them ----

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// an mbarrier of shared memory expecting `count` arrivals a phase
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// the barriers initialised are visible to the copy engine (call after the inits)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// one arrival that also expects `bytes` of bulk copies in this phase
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// true where the phase of parity `parity` of bar has completed (no waiting)
__device__ __forceinline__ bool mbar_test(uint64_t* bar, unsigned parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n}"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Polls of a barrier before a wait gives up: each try_wait blocks for up to
// a hardware time slice, so this is seconds. A wait that runs out traps (the
// launch fails with an error) rather than leaving the card hung.
constexpr unsigned kMbarPolls = 1u << 24;

// waits until the phase of parity `parity` of bar has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  for (unsigned n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (n == kMbarPolls) __trap();
  }
}



// `bytes` (a multiple of 16, both ends 16-byte aligned) from device memory
// into this block's shared memory, counted on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// the same from shared memory into device memory, in the thread's bulk group
__device__ __forceinline__ void bulk_store(void* dst, const void* src, unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// every bulk store this thread committed has read its shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// this thread's writes to shared memory are visible to the copy engine and
// the tensor cores (the async proxy): before a bulk store or wgmma reads them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// ---- a cluster's blocks: addresses in one another's shared memory, barriers ----

// the address of `p` (in this block's shared memory) in the shared memory of
// block `rank` of the cluster, as a shared::cluster address
__device__ __forceinline__ unsigned cluster_addr(const void* p, unsigned rank) {
  unsigned a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(a) : "r"(smem_u32(p)), "r"(rank));
  return a;
}

// `bytes` (a multiple of 16, both ends 16-byte aligned) of this block's
// shared memory from src to dst in another block's (a cluster_addr), counted
// on that block's mbarrier bar (a cluster_addr)
__device__ __forceinline__ void bulk_to_cluster(unsigned dst, const void* src, unsigned bytes,
                                                unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];" ::"r"(dst),
      "r"(smem_u32(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// the cluster barrier in halves: arrive (release: this thread's writes, the
// barriers it initialised among them, are visible to the cluster once every
// block has arrived), arrive without ordering anything, and wait
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}
