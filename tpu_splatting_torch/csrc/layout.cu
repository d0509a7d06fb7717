// Data-movement kernels of the sorted pipeline for NVIDIA Hopper (sm_90a).
//
// Replaces: tpu_splatting/rasterizer/layout.py:_window_copy_kernel (K6,
// behind window_copy) and :_segment_sum_kernel (K7, behind
// segment_sum_sorted).
//
// window_copy: out[k*g + r, :] = rows[src[k] + r, :] if r < cnt[k] else 0.
//   One thread per output element (slot, column), copying 4- or 8-byte
//   elements bit for bit, so int32 ids and f32 / f64 rows take the same
//   path.  Bound by bytes: each output element is written once and each
//   valid one read once; neighbouring threads touch neighbouring columns
//   of one row, so the reads and writes coalesce.  The TPU kernel's
//   two-block fetch and scratch select (no dynamic slicing of values in
//   Mosaic) have no counterpart here.
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

namespace {

template <typename T>
__global__ void window_copy_kernel(const T* __restrict__ rows,
                                   const int* __restrict__ src,
                                   const int* __restrict__ cnt,
                                   T* __restrict__ out, long long total,
                                   int g, int c) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x
                     + threadIdx.x;
       e < total; e += stride) {
    const long long slot = e / c;
    const int col = static_cast<int>(e - slot * c);
    const long long k = slot / g;
    const int r = static_cast<int>(slot - k * g);
    T v = T(0);
    if (r < cnt[k]) v = rows[(static_cast<long long>(src[k]) + r) * c + col];
    out[e] = v;
  }
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
                       void* out, int k, int g, int c, cudaStream_t st) {
  const long long total = static_cast<long long>(k) * g * c;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;   // grid-stride beyond
  window_copy_kernel<T><<<static_cast<int>(blocks), threads, 0, st>>>(
      static_cast<const T*>(rows), src, cnt, static_cast<T*>(out), total, g,
      c);
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

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// elem_bytes: 4 (f32 / i32, copied as uint32) or 8 (f64, as uint64).
extern "C" int tpu_splat_window_copy(const void* rows, const int* src,
                                     const int* cnt, void* out, int k, int g,
                                     int c, int elem_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4)
    return launch_window_copy<uint32_t>(rows, src, cnt, out, k, g, c, st);
  if (elem_bytes == 8)
    return launch_window_copy<uint64_t>(rows, src, cnt, out, k, g, c, st);
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
