// Data-movement probes for NVIDIA Hopper (sm_90a): the counterparts of
// the four Mosaic feasibility probes of benchmarks/exp_mosaic.py, each a
// question that sets a redesign of a kernel on the product path.  They lie
// on no path themselves.  Each kernel is one block per window (or per 256
// rows for the relayout), 256 threads, f32 data moved as float4.
//
// T1 dynamic_slice_kernel<kStaged> replaces t1_dynamic_sublane_slice
//   (benchmarks/exp_mosaic.py:19, call :26): out[b] = x[b, s : s + n] with
//   s = clamp(d[b] + R * (d[b] < 0), 0, R - n), lax.dynamic_slice's wrap
//   and clamp.  The block reads d[b] itself (the scalar prefetch's
//   counterpart).  kStaged: the block copies all of x[b] into shared memory
//   with coalesced float4 loads, as the TPU's BlockSpec puts the block in
//   VMEM, then writes the window from shared memory; !kStaged: the block
//   copies the window straight from device memory.  Bound by bytes: the
//   window read once and written once; the staged form reads R / n times
//   the window.  The question: what a window at a dynamic offset costs
//   through shared memory against a direct read (K6 and K4's staging read
//   straight from device memory).
//
// T2 reshape_rows_kernel replaces t2_reshape (:38, call :43): the
//   (R, C) -> (R * C / 16, 16) relayout, rows of W4 = 4 float4s (the
//   16-float rows of exp_pack.py's packed table).  The bytes do not
//   move, so the kernel performs the relayout that a packed table would
//   cost a staging loop: a warp loads its 32 rows' W4 * 32 float4s
//   coalesced (lane l holds float4 32 j + l in slot j), then W4 rounds of
//   __shfl_sync leave each thread holding one whole row in registers (the
//   layout K1's staging wants, one thread per row), and each thread writes
//   its row.  In round r a thread t = (32 / W4) hi + lo reads float4
//   (hi + r) % W4 of its row from lane W4 lo + (hi + r) % W4, which sends
//   its slot (l % W4 - r) mod W4: one value a lane a round, and every slot
//   index is a compile-time select, so nothing leaves the registers.
//   Bound by bytes: the table read once and written once.
//
// T3 double_block_window_kernel replaces t3_double_blockspec_window (:53,
//   call :75): out[k] = x[src[k] : src[k] + g], fetched as the TPU fetches
//   it: blocks src[k] / g and src[k] / g + 1 of g rows, each one bulk
//   asynchronous copy (cp.async.bulk, completed on an mbarrier) into
//   shared memory, then rows d .. d + g of the pair, d = src[k] % g.  A
//   start outside [0, P - g) traps (block src / g + 1 must exist; the
//   reference raises).  With every count g this is K6's function
//   (window_copy), so the question is whether the fetch of two aligned
//   blocks plus a select beats K6's direct copy.  Bound by bytes: the rows
//   the windows need read once, the output written.
//
// T4 dma_residue_sum_kernel<kBulk> replaces t4_dma_packed_rows (:86, call
//   :98): out[b] = sum over p = 0..7 of x[s[b] : s[b] + rows, 16 p : 16 p +
//   16], x of 128-float rows (exp_pack.py's table of 16-float rows packed 8
//   a row), added in p order from 0 so it equals the reference bit for bit
//   (-fmad=false; no tree).  kBulk: one cp.async.bulk of the rows * 512 B
//   slab into shared memory, completed on an mbarrier (the TPU's
//   make_async_copy); !kBulk: per-thread coalesced float4 loads into the
//   same buffer, the way K1 stages its rows today.  A start outside
//   [0, R - rows] traps.  Bound by bytes: the rows needed read once, the
//   output written.  The question: what a bulk copy saves over per-thread
//   staging loads.
//
// The bulk copies need 16-byte aligned source, destination and size (the
// wrapper checks the source and size; the shared buffers are aligned
// here).  A wait on an mbarrier whose bytes never arrive would spin
// forever; mbar_wait traps after kWaitNs instead, so a wrong byte count
// surfaces as a launch failure at the next synchronisation.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned long long kWaitNs = 2000000000ull;   // 2 s

// ---- bulk asynchronous copy and mbarrier -------------------------------

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// one thread: an mbarrier expecting `count` arrivals, made visible to the
// async proxy; the caller then synchronises the block
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(shared_addr(bar)), "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// arrive once and add `bytes` to the transactions the phase waits for
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(shared_addr(bar)), "r"(bytes) : "memory");
}

// copy `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// device memory to shared memory; completes its bytes on `bar`
__device__ __forceinline__ void bulk_copy_to_shared(void* dst,
                                                    const void* src,
                                                    uint32_t bytes,
                                                    uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(shared_addr(dst)), "l"(src), "r"(bytes), "r"(shared_addr(bar))
      : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// every thread: wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = shared_addr(bar);
  const unsigned long long t0 = global_ns();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (global_ns() - t0 > kWaitNs) __trap();
  }
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// ---- T1 ----------------------------------------------------------------

struct SliceParams {
  const float4* x;     // (B, r, c4) float4
  const int* d;        // (B,)
  float4* out;         // (B, n, c4)
  int r, c4, n;
};

template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
dynamic_slice_kernel(SliceParams p) {
  extern __shared__ float4 stage[];
  const int b = blockIdx.x;
  const long long d = p.d[b];
  const long long s = min(max(d < 0 ? d + p.r : d, 0LL),
                          static_cast<long long>(p.r - p.n));
  const float4* xb = p.x + static_cast<long long>(b) * p.r * p.c4;
  float4* o = p.out + static_cast<long long>(b) * p.n * p.c4;
  const int span = p.n * p.c4;
  if constexpr (kStaged) {
    const int all = p.r * p.c4;
#pragma unroll 4
    for (int e = threadIdx.x; e < all; e += kThreads) stage[e] = __ldg(xb + e);
    __syncthreads();
    const float4* w = stage + s * p.c4;
#pragma unroll 4
    for (int e = threadIdx.x; e < span; e += kThreads) o[e] = w[e];
  } else {
    const float4* w = xb + s * p.c4;
#pragma unroll 4
    for (int e = threadIdx.x; e < span; e += kThreads) o[e] = __ldg(w + e);
  }
}

// ---- T2 ----------------------------------------------------------------

constexpr int W4 = 4;   // float4s a row

struct ReshapeParams {
  const float4* x;     // rows * W4 float4
  float4* out;
  long long rows;      // output rows
};

__global__ void __launch_bounds__(kThreads)
reshape_rows_kernel(ReshapeParams p) {
  constexpr int kLo = 32 / W4;
  const int lane = threadIdx.x & 31;
  const long long row0 = static_cast<long long>(blockIdx.x) * kThreads
                         + (threadIdx.x & ~31);
  const long long q0 = row0 * W4;
  const long long nq = p.rows * W4;
  float4 a[W4];
#pragma unroll
  for (int j = 0; j < W4; ++j) {
    const long long q = q0 + 32 * j + lane;
    a[j] = q < nq ? __ldg(p.x + q) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int hi = lane / kLo, lo = lane % kLo;
  float4 row[W4];
#pragma unroll
  for (int r = 0; r < W4; ++r) {
    const int send = ((lane % W4) - r + W4) % W4;
    float4 v = a[0];
#pragma unroll
    for (int j = 1; j < W4; ++j)
      if (send == j) v = a[j];
    const int k = (hi + r) % W4;
    const int from = W4 * lo + k;
    float4 got;
    got.x = __shfl_sync(kFull, v.x, from);
    got.y = __shfl_sync(kFull, v.y, from);
    got.z = __shfl_sync(kFull, v.z, from);
    got.w = __shfl_sync(kFull, v.w, from);
#pragma unroll
    for (int j = 0; j < W4; ++j)
      if (k == j) row[j] = got;
  }
  const long long t = row0 + lane;
  if (t < p.rows) {
#pragma unroll
    for (int k = 0; k < W4; ++k) p.out[t * W4 + k] = row[k];
  }
}

// ---- T3 ----------------------------------------------------------------

struct WindowParams {
  const float4* x;     // (P, c4) float4
  const int* src;      // (K,)
  float4* out;         // (K, g, c4)
  int p_rows, g, c4;
};

__global__ void __launch_bounds__(kThreads)
double_block_window_kernel(WindowParams p) {
  extern __shared__ __align__(128) float4 pair[];     // 2 g rows
  __shared__ __align__(8) uint64_t bar;
  const int k = blockIdx.x;
  const int s = p.src[k];
  if (s < 0 || s >= p.p_rows - p.g) __trap();
  const int blk = s / p.g;
  const int block4 = p.g * p.c4;
  if (threadIdx.x == 0) mbar_init(&bar, 1);
  __syncthreads();
  if (threadIdx.x == 0) {
    const uint32_t bytes = static_cast<uint32_t>(block4) * 16u;
    mbar_arrive_expect_tx(&bar, 2u * bytes);
    const float4* a = p.x + static_cast<long long>(blk) * block4;
    bulk_copy_to_shared(pair, a, bytes, &bar);
    bulk_copy_to_shared(pair + block4, a + block4, bytes, &bar);
  }
  mbar_wait(&bar, 0);
  const float4* w = pair + (s - blk * p.g) * p.c4;
  float4* o = p.out + static_cast<long long>(k) * block4;
#pragma unroll 4
  for (int e = threadIdx.x; e < block4; e += kThreads) o[e] = w[e];
}

// ---- T4 ----------------------------------------------------------------

struct ResidueParams {
  const float4* x;     // (r_rows, 32) float4: 128 floats a row
  const int* s;        // (B,)
  float4* out;         // (B, rows, 4) float4: 16 floats a row
  int r_rows, rows;
};

template <bool kBulk>
__global__ void __launch_bounds__(kThreads)
dma_residue_sum_kernel(ResidueParams p) {
  extern __shared__ __align__(128) float4 slab[];     // rows x 32
  __shared__ __align__(8) uint64_t bar;
  const int b = blockIdx.x;
  const int s = p.s[b];
  if (s < 0 || s > p.r_rows - p.rows) __trap();
  const float4* src = p.x + static_cast<long long>(s) * 32;
  const int n4 = p.rows * 32;
  if constexpr (kBulk) {
    if (threadIdx.x == 0) mbar_init(&bar, 1);
    __syncthreads();
    if (threadIdx.x == 0) {
      const uint32_t bytes = static_cast<uint32_t>(n4) * 16u;
      mbar_arrive_expect_tx(&bar, bytes);
      bulk_copy_to_shared(slab, src, bytes, &bar);
    }
    mbar_wait(&bar, 0);
  } else {
#pragma unroll 8
    for (int e = threadIdx.x; e < n4; e += kThreads) slab[e] = __ldg(src + e);
    __syncthreads();
  }
  // output float4 e = (row e / 4, columns 4 (e % 4) ..): residue q of it
  // is float4 32 row + 4 q + e % 4 of the slab
  float4* o = p.out + static_cast<long long>(b) * p.rows * 4;
  for (int e = threadIdx.x; e < p.rows * 4; e += kThreads) {
    const float4* in = slab + (e >> 2) * 32 + (e & 3);
    float4 v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = in[4 * q];
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int q = 0; q < 8; ++q) acc = add4(acc, v[q]);
    o[e] = acc;
  }
}

unsigned grid(long long n) { return static_cast<unsigned>(n); }

}  // namespace

// Each entry launches on `stream` with 256 threads a block and returns
// cudaGetLastError() (0 on success).  Pointers are 16-byte aligned f32
// data as float4 units (the wrapper checks); smem is the block's dynamic
// shared memory, which the wrapper computes and bounds.

// x (b, r, c4 float4), d (b,) int32, out (b, n, c4); staged != 0: through
// shared memory (smem = r * c4 * 16), else direct (smem 0)
extern "C" int tpu_splat_dynamic_slice_rows(const void* x, const int* d,
                                            void* out, int b, int r, int c4,
                                            int n, int staged,
                                            long long smem, void* stream) {
  SliceParams p{static_cast<const float4*>(x), d, static_cast<float4*>(out),
                r, c4, n};
  const void* fn = staged ? (const void*)&dynamic_slice_kernel<true>
                          : (const void*)&dynamic_slice_kernel<false>;
  return launch_kernel(fn, p, grid(b), kThreads, smem,
                       static_cast<cudaStream_t>(stream));
}

// x and out: rows of 16 floats
extern "C" int tpu_splat_reshape_rows(const void* x, void* out,
                                      long long rows, void* stream) {
  ReshapeParams p{static_cast<const float4*>(x), static_cast<float4*>(out),
                  rows};
  return launch_kernel((const void*)&reshape_rows_kernel, p,
                       grid((rows + kThreads - 1) / kThreads), kThreads, 0,
                       static_cast<cudaStream_t>(stream));
}

// x (p_rows, c4 float4), src (k,) int32, out (k, g, c4); smem = 2 g c4 16
extern "C" int tpu_splat_double_block_window(const void* x, const int* src,
                                             void* out, int k, int p_rows,
                                             int g, int c4, long long smem,
                                             void* stream) {
  WindowParams p{static_cast<const float4*>(x), src,
                 static_cast<float4*>(out), p_rows, g, c4};
  return launch_kernel((const void*)&double_block_window_kernel, p, grid(k),
                       kThreads, smem, static_cast<cudaStream_t>(stream));
}

// x (r_rows, 128) f32, s (b,) int32, out (b, rows, 16); bulk != 0: one
// cp.async.bulk a block, else per-thread loads; smem = rows * 512
extern "C" int tpu_splat_dma_residue_sum(const void* x, const int* s,
                                         void* out, int b, int r_rows,
                                         int rows, int bulk, long long smem,
                                         void* stream) {
  ResidueParams p{static_cast<const float4*>(x), s,
                  static_cast<float4*>(out), r_rows, rows};
  const void* fn = bulk ? (const void*)&dma_residue_sum_kernel<true>
                        : (const void*)&dma_residue_sum_kernel<false>;
  return launch_kernel(fn, p, grid(b), kThreads, smem,
                       static_cast<cudaStream_t>(stream));
}

// {resident blocks per SM, registers, local bytes} at 256 threads and
// `smem` bytes: kernel 0 T1 staged, 1 T1 direct, 2 T2, 3 T3,
// 4 T4 bulk, 5 T4 loads
extern "C" int tpu_splat_mosaic_occupancy(int kernel, long long smem,
                                          int* out) {
  const void* fns[] = {(const void*)&dynamic_slice_kernel<true>,
                       (const void*)&dynamic_slice_kernel<false>,
                       (const void*)&reshape_rows_kernel,
                       (const void*)&double_block_window_kernel,
                       (const void*)&dma_residue_sum_kernel<true>,
                       (const void*)&dma_residue_sum_kernel<false>};
  if (kernel < 0 || kernel >= 6) return static_cast<int>(cudaErrorInvalidValue);
  return kernel_occupancy(fns[kernel], kThreads, static_cast<size_t>(smem),
                          out);
}
