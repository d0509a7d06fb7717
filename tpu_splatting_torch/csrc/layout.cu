// Data-movement kernels of the sorted pipeline for NVIDIA Hopper (sm_90a).
//
// Replaces: tpu_splatting/rasterizer/layout.py:_window_copy_kernel (K6,
// behind window_copy) and :_segment_sum_kernel (K7, behind
// segment_sum_sorted).
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
// segment_sum_sorted: out[s, :] = sum of rows[i, :] over bounds[s] <= i <
//   bounds[s+1], the segments of id-sorted rows (bounds come from one
//   searchsorted over the ids, a torch op, as jnp.searchsorted is in the
//   reference).  One warp per output id: lane c sums column c (then c+32,
//   ...) over the segment's rows in order, so the sum is deterministic and
//   exact in the row type.  Bound by bytes (every row read once, every
//   output row written once).  The TPU kernel's packed super-rows, by-value
//   f32 ids and bf16 one-hot matmul are TPU residuals: this kernel takes
//   any column count and sums in full precision, as the reference's
//   interpret mode does.

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

template <typename T>
__global__ void segment_sum_kernel(const T* __restrict__ rows,
                                   const int* __restrict__ bounds,
                                   T* __restrict__ out, int num_segments,
                                   int c) {
  const int warps_per_block = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long seg = static_cast<long long>(blockIdx.x) * warps_per_block
                        + (threadIdx.x >> 5);
  if (seg >= num_segments) return;
  const int lo = bounds[seg], hi = bounds[seg + 1];
  for (int col = lane; col < c; col += 32) {
    T acc = T(0);
    for (int i = lo; i < hi; ++i)
      acc += rows[static_cast<long long>(i) * c + col];
    out[seg * c + col] = acc;
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

template <typename T>
int launch_segment_sum(const void* rows, const int* bounds, void* out,
                       int num_segments, int c, cudaStream_t st) {
  const int threads = 256;                       // 8 warps = 8 segments
  const long long blocks = (static_cast<long long>(num_segments) + 7) / 8;
  segment_sum_kernel<T><<<static_cast<unsigned>(blocks), threads, 0, st>>>(
      static_cast<const T*>(rows), bounds, static_cast<T*>(out),
      num_segments, c);
  return static_cast<int>(cudaGetLastError());
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

// elem_bytes: 4 (f32) or 8 (f64).
extern "C" int tpu_splat_segment_sum_sorted(const void* rows,
                                            const int* bounds, void* out,
                                            int num_segments, int c,
                                            int elem_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4)
    return launch_segment_sum<float>(rows, bounds, out, num_segments, c, st);
  if (elem_bytes == 8)
    return launch_segment_sum<double>(rows, bounds, out, num_segments, c,
                                      st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// {resident blocks per SM, registers, local bytes} of the window copy
// (kernel 0) or the segment sum (kernel 1) on elements of elem_bytes (4 or
// 8), at `threads` threads a block and no shared memory, as they launch.
extern "C" int tpu_splat_layout_occupancy(int kernel, int elem_bytes,
                                          int threads, int* out) {
  const bool wide = elem_bytes == 8;
  const void* fn =
      kernel == 0 ? (wide ? (const void*)&window_copy_kernel<uint64_t>
                          : (const void*)&window_copy_kernel<uint32_t>)
                  : (wide ? (const void*)&segment_sum_kernel<double>
                          : (const void*)&segment_sum_kernel<float>);
  return kernel_occupancy(fn, threads, 0, out);
}
