// Data-movement kernels of the sorted pipeline for NVIDIA Hopper (sm_90a).
//
// Replaces: tpu_splatting/rasterizer/layout.py:_window_copy_kernel (K6,
// behind window_copy) and :_segment_sum_kernel (K7, behind
// segment_sum_sorted), and the gather probes of benchmarks/exp_gather.py
// (row_gather).
//
// window_copy: out[k*g + r, :] = rows[src[k] + r, :] if r < cnt[k] else 0.
//   A window's g*c output elements are one contiguous span and so are its
//   cnt*c source elements: element e of window k is rows[src[k]*c + e] if
//   e < cnt[k]*c, else 0.  So no thread divides: a row of the block (tpw
//   threads, a multiple of 32) owns one window, loads src[k] and cnt[k]
//   once and strides over the span, about four elements a thread so that
//   each thread keeps several loads in flight.  4- and 8-byte elements are
//   copied bit for bit, so int32 ids and f32 / f64 rows take the same
//   path.  The index math is 32-bit: the wrapper raises when the output or
//   rows hold 2^31 elements or more, and a window that reaches outside
//   rows traps (a device-side fault, as torch's own indexing asserts).
//   Bound by bytes: each output element is written once and each valid
//   one read once, in 128-byte runs per warp.  The TPU kernel's two-block
//   fetch and scratch select (no dynamic slicing of values in Mosaic) have
//   no counterpart here.
//
// segment_sum_sorted: out[s, :] = sum of row(i) over the sorted positions
//   i with bounds[s] <= i < bounds[s+1], where row(i) = rows[order[i]]
//   when an order is given (the gather of the id-sorted rows happens
//   here: no sorted copy is written) and rows[i] otherwise.  The order is
//   torch.sort's int64 indices, read as they are: converting them to
//   int32 first costs more than the narrower reads save.  Two launches:
//   - segment_bounds writes bounds[s] (the first sorted position whose id
//     is >= s, for s in [0, n]) at every id transition of the sorted ids,
//     empty segments included: one thread a position, reading ids[i-1]
//     and ids[i].  Ids >= n (the padding tail) clamp to n and ids < 0 to
//     -1, so the tail's rows lie past bounds[n] and are never read by the
//     sum.  A transition over many empty ids (32 or more) is written by
//     its whole warp, 32 entries a step.
//   - segment_sum: one thread per (segment, unit of the row), a unit
//     being a float4 (f32 rows with c % 4 == 0, 16-byte aligned: 3 lanes
//     per segment at c = 12, all 32 lanes of a warp busy) or one element
//     (any other c, f64; one lane per segment at c = 1).  A thread loads
//     up to four order entries, then their four row units, and only then
//     adds them in ascending sorted position: four gathers in flight per
//     thread, and each output element is the serial sum of its segment's
//     rows in sorted order, as the unfused call on rows[order] sums them,
//     bit for bit (no atomics, deterministic).
//   Bound by bytes: each valid row (id < n) read once with its id and
//   order entry, the output written (the bounds are this design's scratch,
//   not bytes the function must move).  The gather reads 48-byte rows (c = 12) at scattered offsets, so the
//   sectors it touches exceed the bytes it needs.  Bounds outside [0, m]
//   (ids not sorted: unspecified sums) are clamped, so no read leaves the
//   arrays.  The TPU kernel's packed super-rows, by-value f32 ids and
//   bf16 one-hot matmul are TPU residuals, and its caller's sort with the
//   rows as payload becomes the sort of the ids alone plus this gather.
//
// row_gather: out[i, :] = table[idx[i], :] if 0 <= idx[i] < n, else 0: the
//   counterpart of the gather probes of benchmarks/exp_gather.py
//   (feasibility_dynamic_gather, feasibility_dynamic_gather_vmem_idx,
//   make_pallas_gather; the last zeroes indices outside the table as its
//   in_chunk mask does).  A bit copy in 16-byte units where the row is a
//   multiple of 16 bytes and both pointers are 16-byte aligned, else in
//   elements; each thread has four units in flight.  It lies on no
//   product path: it measures the floor of segment_sum's gather.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "kernel_common.cuh"

namespace {

// block (tpw, windows per block); m: rows of `rows`
template <typename T>
__global__ void window_copy_kernel(const T* __restrict__ rows,
                                   const int* __restrict__ src,
                                   const int* __restrict__ cnt,
                                   T* __restrict__ out, int k, int g, int c,
                                   int m) {
  const int w = blockIdx.x * blockDim.y + threadIdx.y;
  if (w >= k) return;
  const int s = src[w];
  const int n_rows = min(max(cnt[w], 0), g);
  if (n_rows > 0 && (s < 0 || s > m - n_rows)) __trap();
  const int n = n_rows * c;
  const int span = g * c;
  const T* in = rows + (n > 0 ? s * c : 0);
  T* o = out + w * span;
#pragma unroll 4
  for (int e = threadIdx.x; e < span; e += blockDim.x)
    o[e] = e < n ? in[e] : T(0);
}

// the units a thread loads and adds: one element, or four f32 at once
__device__ __forceinline__ float zero_of(float) { return 0.0f; }
__device__ __forceinline__ double zero_of(double) { return 0.0; }
__device__ __forceinline__ float4 zero_of(float4) {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}
__device__ __forceinline__ float add(float a, float b) { return a + b; }
__device__ __forceinline__ double add(double a, double b) { return a + b; }
__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// ids < 0 -> -1, ids >= n -> n
__device__ __forceinline__ int clamp_id(int id, int n) {
  return id < 0 ? -1 : min(id, n);
}

// bounds[s] for s in (id of position i-1, id of position i], position -1
// having id -1 and position m id n; m + 1 threads in blocks of whole warps
__global__ void segment_bounds_kernel(const int* __restrict__ ids,
                                      int* __restrict__ bounds, int m,
                                      int n) {
  const long long pos = static_cast<long long>(blockIdx.x) * blockDim.x
                        + threadIdx.x;
  const int i = static_cast<int>(pos);
  int lo = 0, hi = -1;                 // the entries [lo, hi] this i writes
  if (pos <= m) {
    lo = (i > 0 ? clamp_id(ids[i - 1], n) : -1) + 1;
    hi = i < m ? clamp_id(ids[i], n) : n;
  }
  const bool alone = hi - lo < 32;
  if (alone)
    for (int s = lo; s <= hi; ++s) bounds[s] = i;
  // long runs of empty segments: the whole warp writes each in turn
  unsigned todo = __ballot_sync(kFull, !alone);
  const int lane = threadIdx.x & 31;
  while (todo) {
    const int src = __ffs(todo) - 1;
    todo &= todo - 1;
    const int l = __shfl_sync(kFull, lo, src);
    const int h = __shfl_sync(kFull, hi, src);
    const int v = __shfl_sync(kFull, i, src);
    for (int s = l + lane; s <= h; s += 32) bounds[s] = v;
  }
}

// U: the unit (float, double or float4); order == nullptr for rows
// already sorted.  units: units a row.
template <typename U>
__global__ void segment_sum_kernel(const U* __restrict__ rows,
                                   const long long* __restrict__ order,
                                   const int* __restrict__ bounds,
                                   U* __restrict__ out, int num_segments,
                                   int units, int m) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (t >= static_cast<long long>(num_segments) * units) return;
  const int seg = static_cast<int>(t / units);
  const int u = static_cast<int>(t - static_cast<long long>(seg) * units);
  const int lo = max(bounds[seg], 0);
  const int hi = min(bounds[seg + 1], m);
  U acc = zero_of(U());
  for (int i = lo; i < hi; i += 4) {
    long long r[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      r[k] = i + k < hi ? (order != nullptr ? __ldg(order + i + k)
                                            : static_cast<long long>(i + k))
                        : 0;
    U x[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      x[k] = i + k < hi ? __ldg(rows + r[k] * units + u) : zero_of(U());
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (i + k < hi) acc = add(acc, x[k]);
  }
  out[t] = acc;
}

// out[i*units + u] = table[idx[i]*units + u], or 0 outside [0, n); each
// thread copies four units, a block's threads apart
template <typename U, typename I>
__global__ void row_gather_kernel(const U* __restrict__ table,
                                  const I* __restrict__ idx,
                                  U* __restrict__ out, long long a,
                                  int units, long long n) {
  const long long total = a * units;
  const long long base = static_cast<long long>(blockIdx.x) * blockDim.x * 4
                         + threadIdx.x;
  long long src[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const long long t = base + static_cast<long long>(k) * blockDim.x;
    src[k] = -1;
    if (t < total) {
      const long long i = t / units;
      const long long r = static_cast<long long>(__ldg(idx + i));
      if (r >= 0 && r < n) src[k] = r * units + (t - i * units);
    }
  }
  U v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k] = U();
    if (src[k] >= 0) v[k] = __ldg(table + src[k]);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const long long t = base + static_cast<long long>(k) * blockDim.x;
    if (t < total) out[t] = v[k];
  }
}

template <typename T>
int launch_window_copy(const void* rows, const int* src, const int* cnt,
                       void* out, int k, int g, int c, int m,
                       cudaStream_t st) {
  const int span = g * c;
  const int tpw = std::min(std::max(((span + 3) / 4 + 31) / 32 * 32, 32), 256);
  const int wpb = std::max(256 / tpw, 1);
  const dim3 block(tpw, wpb);
  window_copy_kernel<T><<<(k + wpb - 1) / wpb, block, 0, st>>>(
      static_cast<const T*>(rows), src, cnt, static_cast<T*>(out), k, g, c,
      m);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kLayoutThreads = 256;

unsigned blocks_for(long long threads_needed, int per_thread = 1) {
  const long long per_block = static_cast<long long>(kLayoutThreads)
                              * per_thread;
  return static_cast<unsigned>((threads_needed + per_block - 1) / per_block);
}

template <typename U>
int launch_segment_sum(const void* rows, const long long* order,
                       const int* bounds, void* out, int num_segments,
                       int units, int m, cudaStream_t st) {
  const long long threads = static_cast<long long>(num_segments) * units;
  segment_sum_kernel<U><<<blocks_for(threads), kLayoutThreads, 0, st>>>(
      static_cast<const U*>(rows), order, bounds, static_cast<U*>(out),
      num_segments, units, m);
  return static_cast<int>(cudaGetLastError());
}

template <typename U, typename I>
int launch_row_gather(const void* table, const void* idx, void* out,
                      long long a, int units, long long n, cudaStream_t st) {
  row_gather_kernel<U, I><<<blocks_for(a * units, 4), kLayoutThreads, 0,
                            st>>>(
      static_cast<const U*>(table), static_cast<const I*>(idx),
      static_cast<U*>(out), a, units, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename U>
int launch_row_gather_by(const void* table, const void* idx, int idx_bytes,
                         void* out, long long a, int units, long long n,
                         cudaStream_t st) {
  if (idx_bytes == 8)
    return launch_row_gather<U, long long>(table, idx, out, a, units, n, st);
  if (idx_bytes == 4)
    return launch_row_gather<U, int>(table, idx, out, a, units, n, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  rows is
// (m, c); k * g * c and m * c must be below 2^31 (the wrapper checks).
// elem_bytes: 4 (f32 / i32, copied as uint32) or 8 (f64, as uint64).
extern "C" int tpu_splat_window_copy(const void* rows, const int* src,
                                     const int* cnt, void* out, int k, int g,
                                     int c, int m, int elem_bytes,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4)
    return launch_window_copy<uint32_t>(rows, src, cnt, out, k, g, c, m, st);
  if (elem_bytes == 8)
    return launch_window_copy<uint64_t>(rows, src, cnt, out, k, g, c, m, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ids: m sorted int32 ids; order: m int64 row indices, or null (rows
// already sorted, m of them); bounds: num_segments + 1
// ints of scratch; rows (any number, each c elements of elem_bytes: 4 for
// f32, 8 for f64) and out (num_segments x c) as the wrapper allocates
// them.  Launches segment_bounds, then segment_sum with float4 units where
// f32 rows of c % 4 == 0 and both pointers are 16-byte aligned.
extern "C" int tpu_splat_segment_sum_sorted(const void* rows, const int* ids,
                                            const long long* order,
                                            int* bounds,
                                            void* out, int m,
                                            int num_segments, int c,
                                            int elem_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  segment_bounds_kernel<<<blocks_for(static_cast<long long>(m) + 1),
                          kLayoutThreads, 0, st>>>(ids, bounds, m,
                                                   num_segments);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  if (elem_bytes == 4 && c % 4 == 0 && aligned16(rows) && aligned16(out))
    return launch_segment_sum<float4>(rows, order, bounds, out,
                                      num_segments, c / 4, m, st);
  if (elem_bytes == 4)
    return launch_segment_sum<float>(rows, order, bounds, out, num_segments,
                                     c, m, st);
  if (elem_bytes == 8)
    return launch_segment_sum<double>(rows, order, bounds, out,
                                      num_segments, c, m, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// table: n rows of row_bytes (a multiple of elem_bytes, 4 or 8); idx: a
// indices of idx_bytes (4 or 8); out: a rows.  Copies in 16-byte units
// where row_bytes % 16 == 0 and both pointers are 16-byte aligned.
extern "C" int tpu_splat_row_gather(const void* table, const void* idx,
                                    int idx_bytes, void* out, long long a,
                                    long long n, int row_bytes,
                                    int elem_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (row_bytes % 16 == 0 && aligned16(table) && aligned16(out))
    return launch_row_gather_by<uint4>(table, idx, idx_bytes, out, a,
                                       row_bytes / 16, n, st);
  if (elem_bytes == 4)
    return launch_row_gather_by<uint32_t>(table, idx, idx_bytes, out, a,
                                          row_bytes / 4, n, st);
  if (elem_bytes == 8)
    return launch_row_gather_by<unsigned long long>(
        table, idx, idx_bytes, out, a, row_bytes / 8, n, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// {resident blocks per SM, registers, local bytes} at `threads` threads a
// block and no shared memory, as they launch: kernel 0 the window copy (on
// elements of elem_bytes, 4 or 8), 1 the segment sum (float4 units, the
// headline's), 2 the segment bounds, 3 the row
// gather (16-byte units, 4-byte indices).
extern "C" int tpu_splat_layout_occupancy(int kernel, int elem_bytes,
                                          int threads, int* out) {
  const bool wide = elem_bytes == 8;
  const void* fn = nullptr;
  if (kernel == 0)
    fn = wide ? (const void*)&window_copy_kernel<uint64_t>
              : (const void*)&window_copy_kernel<uint32_t>;
  else if (kernel == 1)
    fn = (const void*)&segment_sum_kernel<float4>;
  else if (kernel == 2)
    fn = (const void*)&segment_bounds_kernel;
  else if (kernel == 3)
    fn = (const void*)&row_gather_kernel<uint4, int>;
  return kernel_occupancy(fn, threads, 0, out);
}
