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
//   cost a staging loop: every output row passes through one thread's
//   registers (the layout K1's staging wants, one thread per row).  Bound
//   by bytes: the table read once and written once.  A warp loads tiles
//   of 32 rows coalesced (lane l holds float4 32 j + l in slot j), W4
//   rounds of __shfl_sync leave each lane holding one whole row, in order
//   (rows_of_tile), W4 more rounds take the rows back to the coalesced
//   slots (tile_of_rows), and the warp stores them as it loaded them.  In
//   each round a lane sends one float4, chosen by compile-time selects,
//   so nothing leaves the registers.  A warp has kT2Unroll tiles' loads in
//   flight; one launch covers the table, a warp kT2Unroll tiles.  The
//   first design stored each thread's row as four float4s 64 B apart,
//   touching twice the sectors of a coalesced store: 1.06 x slower than a
//   clone on the H100.  A ring of bulk loads and bulk stores through
//   shared memory, the row round trip in between, stayed 3% slower than
//   a clone there (chip_smoke.py phase 8), whatever its depth; so did
//   persistent grids of this kernel.
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
//   (-fmad=false; no tree).  A start outside [0, R - rows] traps.  Bound by
//   bytes: the rows needed read once, the output written.  Output row j of
//   slab b depends on table row s[b] + j alone, so a row needed by several
//   slabs (overlapping windows) is summed once and written to each.
//   Design (the first design read each slab's 64 rows with one bulk copy
//   a block, about 3.2 reads a needed row at phase 8's starts): block
//   g takes the slabs that start in its range of `width` rows (it reads
//   all the starts from L2 and keeps its own: no sort of the starts
//   ahead, which took 0.042 ms as torch.sort and as a one-block counting
//   pass alike), sorts them by start in shared memory (bitonic), cuts the
//   union of their rows into chunks (segments without a gap, in kT4Chunk
//   rows, by a block scan) and streams them in order through a ring of
//   kT4Stages stages.  kBulk: one thread fills each stage with one bulk
//   asynchronous copy on the stage's mbarrier; !kBulk: every thread
//   fills it with 16-byte cp.async copies (one commit group a stage).
//   Either way the next stages' copies are in flight while the block sums
//   a stage's rows (a thread a row and float4 column) into shared memory
//   and writes them to every slab that holds them.  A range with more
//   than kT4Cap slabs goes in batches of kT4Cap, in slab order.  Rows
//   read twice: those shared by two neighbouring ranges (the ring's
//   boundary rows), at most rows - 1 a boundary, and those two batches of
//   one range share.
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

// ---- per-thread asynchronous copies ------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(shared_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// ---- T2 ----------------------------------------------------------------

constexpr int W4 = 4;            // float4s a row
constexpr int kT2Unroll = 2;     // tiles of 32 rows a warp has in flight

struct ReshapeParams {
  const float4* x;     // rows * W4 float4
  float4* out;
  long long rows;      // output rows
};

// a[k] for a runtime k in [0, W4): selects, so a stays in registers
__device__ __forceinline__ float4 pick(const float4 (&a)[W4], int k) {
  float4 v = a[0];
#pragma unroll
  for (int j = 1; j < W4; ++j)
    if (k == j) v = a[j];
  return v;
}

__device__ __forceinline__ float4 shfl4(float4 v, int from) {
  return make_float4(__shfl_sync(kFull, v.x, from),
                     __shfl_sync(kFull, v.y, from),
                     __shfl_sync(kFull, v.z, from),
                     __shfl_sync(kFull, v.w, from));
}

// A warp's tile of 32 rows: a[j] of lane l is float4 32 j + l (loaded
// coalesced); afterwards row[k] of lane t is float4 k of row t.  In round
// r lane t takes float4 k = (t / 8 + r) % 4 of its row from lane 4 (t % 8)
// + k, which sends its slot (l % 4 - r) mod 4: one value a lane a round.
__device__ __forceinline__ void rows_of_tile(const float4 (&a)[W4],
                                             float4 (&row)[W4], int lane) {
  const int hi = lane >> 3, lo = lane & 7;
#pragma unroll
  for (int r = 0; r < W4; ++r) {
    const int k = (hi + r) & 3;
    const float4 got = shfl4(pick(a, ((lane & 3) - r) & 3), 4 * lo + k);
#pragma unroll
    for (int j = 0; j < W4; ++j)
      if (k == j) row[j] = got;
  }
}

// the inverse: from row[k] of lane t back to a[j] of lane l = float4
// 32 j + l.  In round r lane l takes slot j = (l % 4 - r) mod 4 from lane
// 8 j + l / 4, which sends float4 (t / 8 + r) % 4 of its row.
__device__ __forceinline__ void tile_of_rows(const float4 (&row)[W4],
                                             float4 (&a)[W4], int lane) {
  const int hi = lane >> 3;
#pragma unroll
  for (int r = 0; r < W4; ++r) {
    const int j = ((lane & 3) - r) & 3;
    const float4 got = shfl4(pick(row, (hi + r) & 3), 8 * j + (lane >> 2));
#pragma unroll
    for (int i = 0; i < W4; ++i)
      if (j == i) a[i] = got;
  }
}

__global__ void __launch_bounds__(kThreads)
reshape_rows_kernel(ReshapeParams p) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const long long warps = static_cast<long long>(gridDim.x) * (kThreads / 32);
  const long long nq = p.rows * W4;
  const long long tiles = (p.rows + 31) / 32;
  for (long long t0 = warp * kT2Unroll; t0 < tiles;
       t0 += warps * kT2Unroll) {   // once, at the wrapper's grid
    float4 a[kT2Unroll][W4];
#pragma unroll
    for (int u = 0; u < kT2Unroll; ++u) {
#pragma unroll
      for (int j = 0; j < W4; ++j) {
        const long long q = (t0 + u) * 32 * W4 + 32 * j + lane;
        a[u][j] = q < nq ? __ldg(p.x + q) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int u = 0; u < kT2Unroll; ++u) {
      float4 row[W4];                   // row 32 (t0 + u) + lane, in order
      rows_of_tile(a[u], row, lane);
      tile_of_rows(row, a[u], lane);
#pragma unroll
      for (int j = 0; j < W4; ++j) {
        const long long q = (t0 + u) * 32 * W4 + 32 * j + lane;
        if (q < nq) p.out[q] = a[u][j];
      }
    }
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

constexpr int kT4Chunk = 64;     // rows a ring stage (32 KB): a row a thread
                                 // and float4 column, 256 threads
constexpr int kT4Stages = 3;
constexpr int kT4Cap = kThreads; // slabs a block sorts and streams at once
constexpr int kT4Batch = 16;     // starts a thread loads before it keeps any

// exclusive prefix sum of one int a thread over the block (x = its value;
// `warp_sums` 32 ints of shared memory); returns the sum of the earlier
// threads' values and leaves the block's total in *total
__device__ __forceinline__ int block_exclusive_scan(int x, int* warp_sums,
                                                    int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = (blockDim.x + 31) >> 5;
  int inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = lane < warps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    if (lane < warps) warp_sums[lane] = w;   // inclusive over warps
  }
  __syncthreads();
  const int before = (warp > 0 ? warp_sums[warp - 1] : 0) + inc - x;
  *total = warp_sums[warps - 1];
  __syncthreads();
  return before;
}

struct ResidueParams {
  const float4* x;     // (r_rows, 32) float4: 128 floats a row
  const int* s;        // (b,)
  float4* out;         // (b, rows, 4) float4: 16 floats a row
  int b, r_rows, rows, width, max_chunks;   // width: starts a block
};

template <bool kBulk>
__global__ void __launch_bounds__(kThreads)
dma_residue_sum_kernel(ResidueParams p) {
  extern __shared__ __align__(128) float4 t4_smem[];
  __shared__ __align__(8) uint64_t full[kT4Stages];
  __shared__ int warp_sums[32];
  __shared__ int n_in, n_chunks;
  float4* ring = t4_smem;                            // kT4Stages x kT4Chunk rows
  float4* fsum = ring + kT4Stages * kT4Chunk * 32;   // a chunk's residue sums
  unsigned long long* key =                          // (start, slab), kT4Cap
      reinterpret_cast<unsigned long long*>(fsum + kT4Chunk * 4);
  int* s_start = reinterpret_cast<int*>(key + kT4Cap);
  int* s_slab = s_start + kT4Cap;
  int* s_chunk = s_slab + kT4Cap;   // [first row, rows] of each chunk
  const int tid = threadIdx.x;
  const int lo = blockIdx.x * p.width;
  const int hi = min(lo + p.width, p.r_rows - p.rows + 1);
  auto key_of = [](int v, int i) {
    return (static_cast<unsigned long long>(v) << 32)
           | static_cast<unsigned>(i);
  };
  if (tid == 0) {
    n_in = 0;
    if constexpr (kBulk) {
      for (int st = 0; st < kT4Stages; ++st) mbar_init(&full[st], 1);
    }
  }
  __syncthreads();
  // this block's slabs: those starting in [lo, hi), appended as they come
  for (int i0 = 0; i0 < p.b; i0 += kThreads * kT4Batch) {
    int v[kT4Batch];
#pragma unroll
    for (int j = 0; j < kT4Batch; ++j) {
      const int i = i0 + j * kThreads + tid;
      v[j] = i < p.b ? __ldg(p.s + i) : 0;
    }
#pragma unroll
    for (int j = 0; j < kT4Batch; ++j) {
      const int i = i0 + j * kThreads + tid;
      if (i < p.b) {
        if (v[j] < 0 || v[j] > p.r_rows - p.rows) __trap();
        if (v[j] >= lo && v[j] < hi) {
          const int pos = atomicAdd(&n_in, 1);
          if (pos < kT4Cap) key[pos] = key_of(v[j], i);
        }
      }
    }
  }
  __syncthreads();
  const int total = n_in;
  const int jr = tid >> 2, q = tid & 3;   // this thread's chunk row, column
  const int odd = jr & 1;                 // odd rows load from residue 1 on
  int ci = 0;                             // chunks streamed so far
  // more than kT4Cap slabs (a crowded range): batches of kT4Cap in slab
  // order, each sorted and streamed on its own
  for (int bt = 0; bt * kT4Cap < total; ++bt) {
    const int nb = min(kT4Cap, total - bt * kT4Cap);
    if (total > kT4Cap) {
      __syncthreads();                    // the last batch's keys are read
      int base = 0;
      for (int t0 = 0; t0 < p.b; t0 += kThreads) {
        const int i = t0 + tid;
        const int v = i < p.b ? __ldg(p.s + i) : -1;
        const int in = v >= lo && v < hi;
        int tile = 0;
        const int r = base + block_exclusive_scan(in, warp_sums, &tile)
                      - bt * kT4Cap;
        if (in && r >= 0 && r < nb) key[r] = key_of(v, i);
        base += tile;
      }
    }
    int pow2 = 1;
    while (pow2 < nb) pow2 <<= 1;
    for (int k = nb + tid; k < pow2; k += kThreads) key[k] = ~0ull;
    __syncthreads();
    // the batch in (start, slab) order: a bitonic sort in shared memory
    for (int k = 2; k <= pow2; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int i = tid; i < pow2; i += kThreads) {
          const int ixj = i ^ j;
          if (ixj > i) {
            const unsigned long long a = key[i], c = key[ixj];
            if ((a > c) == ((i & k) == 0)) {
              key[i] = c;
              key[ixj] = a;
            }
          }
        }
        __syncthreads();
      }
    }
    // the union of the batch's rows as chunks: a segment (slabs with no
    // gap between them) starts at a slab whose start lies past the
    // previous slab's rows and is cut into chunks of kT4Chunk rows from
    // its first row
    auto start_of = [&](int k) { return static_cast<int>(key[k] >> 32); };
    int st0 = 0, end = 0, nck = 0;
    if (tid < nb) {
      st0 = start_of(tid);
      s_start[tid] = st0;
      s_slab[tid] = static_cast<int>(key[tid] & 0xffffffffu);
      if (tid == 0 || st0 > start_of(tid - 1) + p.rows) {
        int k = tid + 1;
        while (k < nb && start_of(k) <= start_of(k - 1) + p.rows) ++k;
        end = start_of(k - 1) + p.rows;
        nck = (end - st0 + kT4Chunk - 1) / kT4Chunk;
      }
    }
    const int off = block_exclusive_scan(nck, warp_sums, &n_chunks);
    if (nck > 0) {
      if (off + nck > p.max_chunks) __trap();
      for (int c = 0; c < nck; ++c) {
        const int at = st0 + c * kT4Chunk;
        s_chunk[2 * (off + c)] = at;
        s_chunk[2 * (off + c) + 1] = min(kT4Chunk, end - at);
      }
    }
    __syncthreads();
    const int nc = n_chunks;

    // the batch's chunk i into stage (ci + i) % kT4Stages: one bulk copy,
    // or 16 bytes a thread in one commit group (an empty group past the
    // last chunk keeps the group count)
    auto issue = [&](int i) {
      const int st = (ci + i) % kT4Stages;
      if (i < nc) {
        float4* dst = ring + st * kT4Chunk * 32;
        const float4* src = p.x + static_cast<long long>(s_chunk[2 * i]) * 32;
        const int n4 = s_chunk[2 * i + 1] * 32;
        if constexpr (kBulk) {
          if (tid == 0) {
            mbar_arrive_expect_tx(&full[st], static_cast<uint32_t>(n4) * 16u);
            bulk_copy_to_shared(dst, src, static_cast<uint32_t>(n4) * 16u,
                                &full[st]);
          }
        } else {
          for (int e = tid; e < n4; e += kThreads) cp_async16(dst + e, src + e);
        }
      }
      if constexpr (!kBulk) cp_async_commit();
    };
    for (int i = 0; i < kT4Stages; ++i) issue(i);
    int k0 = 0;
    for (int i = 0; i < nc; ++i) {
      const int st = (ci + i) % kT4Stages;
      const int a = s_chunk[2 * i], n = s_chunk[2 * i + 1];
      if constexpr (kBulk) {
        mbar_wait(&full[st],
                  static_cast<uint32_t>(((ci + i) / kT4Stages) & 1));
      } else {
        cp_async_wait<kT4Stages - 1>();
      }
      __syncthreads();
      if (jr < n) {
        const float4* in = ring + (st * kT4Chunk + jr) * 32 + q;
        float4 v[8];                      // v[k]: residue (k + odd) % 8
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] = in[4 * ((k + odd) & 7)];
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int r = 0; r < 8; ++r) acc = add4(acc, odd ? v[(r + 7) & 7] : v[r]);
        fsum[jr * 4 + q] = acc;
      }
      __syncthreads();
      issue(i + kT4Stages);               // stage st has been read
      // every slab of the batch holding rows of [a, a + n)
      while (k0 < nb && s_start[k0] + p.rows <= a) ++k0;
      for (int k = k0; k < nb && s_start[k] < a + n; ++k) {
        const int sk = s_start[k];
        const int r0 = max(a, sk), r1 = min(a + n, sk + p.rows);
        float4* o = p.out + (static_cast<long long>(s_slab[k]) * p.rows
                             + (r0 - sk)) * 4;
        const float4* f = fsum + (r0 - a) * 4;
        for (int e = tid; e < (r1 - r0) * 4; e += kThreads) o[e] = f[e];
      }
    }
    ci += nc;
    if constexpr (!kBulk) cp_async_wait<0>();
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

// x and out: rows of 16 floats; `blocks` blocks of 8 warps, a warp
// kT2Unroll tiles of 32 rows (the wrapper's reshape_plan)
extern "C" int tpu_splat_reshape_rows(const void* x, void* out,
                                      long long rows, int blocks,
                                      void* stream) {
  ReshapeParams p{static_cast<const float4*>(x), static_cast<float4*>(out),
                  rows};
  return launch_kernel((const void*)&reshape_rows_kernel, p, blocks,
                       kThreads, 0, static_cast<cudaStream_t>(stream));
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

// x (r_rows, 128) f32, s (b,) int32, out (b, rows, 16); bulk != 0: bulk
// copies into the ring, else per-thread cp.async.  `blocks` blocks, block
// g taking the slabs that start in [g width, (g + 1) width), at most
// max_chunks chunks a batch, smem bytes (the wrapper's residue_plan).
extern "C" int tpu_splat_dma_residue_sum(const void* x, const int* s,
                                         void* out, int b, int r_rows,
                                         int rows, int bulk, int blocks,
                                         int width, int max_chunks,
                                         long long smem, void* stream) {
  ResidueParams p{static_cast<const float4*>(x), s,
                  static_cast<float4*>(out), b, r_rows, rows, width,
                  max_chunks};
  const void* fn = bulk ? (const void*)&dma_residue_sum_kernel<true>
                        : (const void*)&dma_residue_sum_kernel<false>;
  return launch_kernel(fn, p, blocks, kThreads, smem,
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
