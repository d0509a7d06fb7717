// Packed-table probes for NVIDIA Hopper (sm_90a): the counterparts of the
// probes of benchmarks/exp_pack.py.  The question they answer is what a
// table of rows narrower than the stream table's padded stride (rows of
// w_pad >= 32 floats, tpu_splatting_torch/rasterizer/stream.py) costs to
// fetch and to re-lay in shared memory.  They lie on no path themselves.
// Every kernel runs 256 threads a block and is bound by bytes: each input
// byte read once, each output byte written once.
//
// unpack_rows_kernel<kCol> replaces u1_unpack_rowmajor (exp_pack.py:43,
//   call :53), u1b_unpack_rowmajor_w11 (:67, call :76) and
//   u2_unpack_colmajor (:90, call :100): a block b of P packed rows of 8 w
//   floats becomes (w, 8 P), out[b, j, 8 p + k] = the j-th float of
//   logical row 8 p + k, which is x[b, p, k w + j] (row-major, !kCol) or
//   x[b, p, 8 j + k] (column-major, kCol).  One block per b stages the
//   packed block with coalesced float4 loads into shared memory as
//   logical rows of an odd stride s = w | 1 (each float stored alone), so
//   that the output pass, which reads one column j down 32 consecutive
//   rows a warp (stride s: 32 distinct banks), writes out[b, j, :]
//   coalesced.  Staging the packed rows as they come would read them at a
//   stride of w floats: 16-way bank conflicts at w = 16.
//
// slab_relayout_kernel<kPacked> replaces t1_timing's two kernels (:114,
//   calls :130 and :138): the grid's steps are slabs of 512 rows of C
//   floats (!kPacked) or of 64 rows of 128 floats, the 512 rows of 16
//   packed 8 a row (kPacked).  Each block reads its whole slab from device
//   memory and re-lays it in shared memory as (columns, 512 rows) at row
//   stride 513, as every grid step of the TPU kernel transposes its block
//   in VMEM.  The TPU's steps all write the one (12, 128) output, in grid
//   order, so the result is the last slab's block; blocks here run in
//   parallel in no order, so only the last slab's block writes it:
//   out[j, i] = row i, float j of the last slab, j < 12, i < 128.  The
//   probe's question is the cost of the relayout over the fetch, so no
//   block skips its fetch or its relayout.
//
// column_partials_kernel + column_total_kernel replace f1_fetch's two
//   kernels (:157, calls :169 and :177): the column sums of the first g
//   blocks of `rows` rows of x (R, W), g = R / rows (the tail rows are not
//   read, as the reference's grid of n / s_cap steps leaves them).  The
//   reference adds every step into an output that no step zeroes (F13);
//   here the sums start from zero and are deterministic: block b sums its
//   rows into partial[b, :] (threads laid as lanes x columns, so a warp
//   reads consecutive floats; each lane adds its rows in order, then the
//   lanes are added in order), and a second kernel adds the g partials of
//   each column in a fixed order: contiguous ranges of blocks, each in
//   block order, then the ranges in order.  No atomics: two runs agree
//   bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPack = 8;            // logical rows a packed row
constexpr int kSlabRows = 512;      // t1: rows a slab
constexpr int kSlabStride = kSlabRows + 1;
constexpr int kOutRows = 12, kOutCols = 128;   // t1's output block
constexpr int kPackedWidth = 16;    // t1 packed: floats a logical row
constexpr int kTotalCols = 32;      // column_total: columns a block
constexpr int kTotalThreads = 1024; // column_total: threads a block
constexpr int kBatch = 8;           // column sums: loads in flight a thread

// ---- unpack_rows -------------------------------------------------------

struct UnpackParams {
  const float4* x;     // (B, P, 8 w) f32 as float4
  float* out;          // (B, w, 8 P)
  int p, w;
};

template <bool kCol>
__global__ void __launch_bounds__(kThreads)
unpack_rows_kernel(UnpackParams prm) {
  extern __shared__ float rows[];   // 8 P logical rows at stride w | 1
  const int w = prm.w, s = w | 1, packed_w = kPack * w;
  const int n_rows = kPack * prm.p;
  const int n4 = prm.p * packed_w / 4;
  const float4* xb = prm.x + static_cast<long long>(blockIdx.x) * n4;
#pragma unroll 2
  for (int q = threadIdx.x; q < n4; q += kThreads) {
    const float4 v = __ldg(xb + q);
    const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = 4 * q + i;
      const int pr = e / packed_w, c = e - pr * packed_w;
      const int k = kCol ? c % kPack : c / w;
      const int j = kCol ? c / kPack : c - k * w;
      rows[(kPack * pr + k) * s + j] = f[i];
    }
  }
  __syncthreads();
  float* o = prm.out + static_cast<long long>(blockIdx.x) * w * n_rows;
  for (int j = 0; j < w; ++j)
    for (int r = threadIdx.x; r < n_rows; r += kThreads)
      o[j * n_rows + r] = rows[r * s + j];
}

// ---- slab_relayout -----------------------------------------------------

struct SlabParams {
  const float4* x;     // (slabs * rows a slab, width) f32 as float4
  float* out;          // (12, 128)
  int c;               // floats a row (!kPacked); 128 when kPacked
};

template <bool kPacked>
__global__ void __launch_bounds__(kThreads)
slab_relayout_kernel(SlabParams prm) {
  extern __shared__ float cols[];   // (columns, 512) at row stride 513
  const int n4 = kSlabRows * (kPacked ? kPackedWidth : prm.c) / 4;
  const float4* xb = prm.x + static_cast<long long>(blockIdx.x) * n4;
#pragma unroll 2
  for (int q = threadIdx.x; q < n4; q += kThreads) {
    const float4 v = __ldg(xb + q);
    const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int e = 4 * q + t;
      int i, j;
      if constexpr (kPacked) {   // packed row e / 128, lane e % 128
        i = kPack * (e >> 7) + ((e & 127) >> 4);
        j = e & (kPackedWidth - 1);
      } else {
        i = e / prm.c;
        j = e - i * prm.c;
      }
      cols[j * kSlabStride + i] = f[t];
    }
  }
  __syncthreads();
  if (blockIdx.x != gridDim.x - 1) return;
  for (int o = threadIdx.x; o < kOutRows * kOutCols; o += kThreads)
    prm.out[o] = cols[(o / kOutCols) * kSlabStride + o % kOutCols];
}

// ---- column sums -------------------------------------------------------

struct PartialParams {
  const float* x;      // (g * rows, w) f32
  float* partial;      // (g, w)
  int rows, w;
};

__global__ void __launch_bounds__(kThreads)
column_partials_kernel(PartialParams prm) {
  __shared__ float lane_sum[kThreads];
  const int w = prm.w, wc = min(w, kThreads), lanes = kThreads / wc;
  const int lane = threadIdx.x / wc, c0 = threadIdx.x - lane * wc;
  const float* xb = prm.x + static_cast<long long>(blockIdx.x) * prm.rows * w;
  for (int cc = 0; cc < w; cc += wc) {
    const int c = cc + c0;
    float acc = 0.f;
    if (lane < lanes && c < w) {
      // kBatch loads in flight, then their adds in row order
      for (int r0 = lane; r0 < prm.rows; r0 += kBatch * lanes) {
        float v[kBatch];
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          const int r = r0 + i * lanes;
          v[i] = r < prm.rows ? __ldg(xb + static_cast<long long>(r) * w + c)
                              : 0.f;
        }
#pragma unroll
        for (int i = 0; i < kBatch; ++i)
          if (r0 + i * lanes < prm.rows) acc += v[i];
      }
    }
    lane_sum[threadIdx.x] = acc;
    __syncthreads();
    if (threadIdx.x < wc && cc + threadIdx.x < w) {
      float sum = 0.f;
      for (int l = 0; l < lanes; ++l) sum += lane_sum[l * wc + threadIdx.x];
      prm.partial[static_cast<long long>(blockIdx.x) * w + cc + threadIdx.x] =
          sum;
    }
    __syncthreads();
  }
}

struct TotalParams {
  const float* partial;   // (g, w)
  float* out;             // (w,)
  int g, w;
};

// Block c0 / 32 adds the g partials of columns [c0, c0 + 32): its 1024
// threads are lanes x columns, lane l adds the blocks of its contiguous
// range [l per, (l + 1) per) in block order, kBatch loads in flight, and
// one thread a column adds the lanes in order.  One thread folding all g
// partials would be a chain of g dependent adds waiting on its loads
// (tens of microseconds at g 1,953).
__global__ void __launch_bounds__(kTotalThreads)
column_total_kernel(TotalParams prm) {
  __shared__ float lane_sum[kTotalThreads];
  const int c0 = blockIdx.x * kTotalCols;
  const int wc = min(kTotalCols, prm.w - c0), lanes = kTotalThreads / wc;
  const int lane = threadIdx.x / wc, c = c0 + threadIdx.x - lane * wc;
  const int per = (prm.g + lanes - 1) / lanes;
  float acc = 0.f;
  if (lane < lanes) {
    const int end = min(prm.g, (lane + 1) * per);
    for (int b0 = lane * per; b0 < end; b0 += kBatch) {
      float v[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i)
        v[i] = b0 + i < end
                   ? __ldg(prm.partial + static_cast<long long>(b0 + i) * prm.w
                           + c)
                   : 0.f;
#pragma unroll
      for (int i = 0; i < kBatch; ++i)
        if (b0 + i < end) acc += v[i];
    }
  }
  lane_sum[threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.x < wc) {
    float sum = 0.f;
    for (int l = 0; l < lanes; ++l) sum += lane_sum[l * wc + threadIdx.x];
    prm.out[c] = sum;
  }
}

}  // namespace

// Each entry launches on `stream` with 256 threads a block (column_total:
// 1024) and returns cudaGetLastError() (0 on success).  float4 inputs are
// 16-byte aligned (the wrapper checks); smem is the block's dynamic shared
// memory, which the wrapper computes and bounds.

// x (b, p, 8 w) f32, out (b, w, 8 p); col != 0: column-major packing;
// smem = 8 p (w | 1) 4
extern "C" int tpu_splat_unpack_rows(const void* x, void* out, int b, int p,
                                     int w, int col, long long smem,
                                     void* stream) {
  UnpackParams prm{static_cast<const float4*>(x), static_cast<float*>(out),
                   p, w};
  const void* fn = col ? (const void*)&unpack_rows_kernel<true>
                       : (const void*)&unpack_rows_kernel<false>;
  return launch_kernel(fn, prm, b, kThreads, smem,
                       static_cast<cudaStream_t>(stream));
}

// x (slabs * 512, c) f32 (packed == 0) or (slabs * 64, 128) (packed != 0),
// out (12, 128); smem = columns * 513 * 4 (columns c, or 16 packed)
extern "C" int tpu_splat_slab_relayout(const void* x, void* out, int slabs,
                                       int c, int packed, long long smem,
                                       void* stream) {
  SlabParams prm{static_cast<const float4*>(x), static_cast<float*>(out), c};
  const void* fn = packed ? (const void*)&slab_relayout_kernel<true>
                          : (const void*)&slab_relayout_kernel<false>;
  return launch_kernel(fn, prm, slabs, kThreads, smem,
                       static_cast<cudaStream_t>(stream));
}

// x (>= g * rows, w) f32, partial (g, w) scratch, out (w,): the column
// sums of the first g * rows rows, by blocks, then the block sums in a
// fixed order
extern "C" int tpu_splat_column_sums(const void* x, void* partial, void* out,
                                     int g, int rows, int w, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  PartialParams pp{static_cast<const float*>(x), static_cast<float*>(partial),
                   rows, w};
  int err = launch_kernel((const void*)&column_partials_kernel, pp, g,
                          kThreads, 0, st);
  if (err != 0) return err;
  TotalParams tp{static_cast<const float*>(partial), static_cast<float*>(out),
                 g, w};
  return launch_kernel((const void*)&column_total_kernel, tp,
                       (w + kTotalCols - 1) / kTotalCols, kTotalThreads, 0,
                       st);
}

// {resident blocks per SM, registers, local bytes} at 256 threads and
// `smem` bytes: kernel 0 unpack_rows row-major, 1 column-major,
// 2 slab_relayout flat, 3 packed, 4 column_partials
extern "C" int tpu_splat_pack_occupancy(int kernel, long long smem,
                                        int* out) {
  const void* fns[] = {(const void*)&unpack_rows_kernel<false>,
                       (const void*)&unpack_rows_kernel<true>,
                       (const void*)&slab_relayout_kernel<false>,
                       (const void*)&slab_relayout_kernel<true>,
                       (const void*)&column_partials_kernel};
  if (kernel < 0 || kernel >= 5) return static_cast<int>(cudaErrorInvalidValue);
  return kernel_occupancy(fns[kernel], kThreads, static_cast<size_t>(smem),
                          out);
}
