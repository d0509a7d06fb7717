// Packed-table probes, round 2, for NVIDIA Hopper (sm_90a): the
// counterparts of the probes of benchmarks/exp_pack2.py.  The question
// they answer is whether a packed slab (8 logical rows of w floats a
// packed row) is cheaper to turn into per-float lane vectors in a
// permuted slot order (V_a) than in fetch order, and what the permuted
// order's backward lane permutation costs.  They lie on no path
// themselves.  Every kernel runs 256 threads a block and is bound by
// bytes: each input byte read once, each output byte written once.
//
// permuted_unpack_kernel<kLastOnly> replaces v_a (exp_pack2.py:57, call
//   :65) and t2_timing's k_va (:193, call :212).  A block b of P packed
//   rows of 8 w floats becomes (w, 8 P) with out[b, j, P k + p] =
//   x[b, p, k w + j]: slot c' = P k + p holds logical row 8 p + k (at P 64
//   the probe's perm_cprime).  One block per b stages the packed block
//   with coalesced float4 loads into shared memory by slot, at the odd
//   stride s = w | 1 (each float stored alone), so that the output pass,
//   which reads one float j of 32 consecutive slots a warp, hits 32
//   distinct banks and writes out[b, j, :] coalesced.  At P a multiple of
//   32 and s 17 the slot groups k start P s k words apart, a multiple of
//   32: a warp's stores of one packed row (8 groups x 4 floats j) would
//   then share 4 banks.  So group k is shifted by kGroupPad(k) = (k & 3)
//   + 16 (k >> 2) words, which gives the 32 stores 32 banks.  kLastOnly
//   (k_va): the grid's steps are slabs of 64 packed rows of 128 floats
//   (P 64, w 16), every block stages its slab, and only the last slab's
//   block writes its (12, 128) block, out[j, i] = slot i, float j: the
//   TPU's steps all write the one output in grid order, blocks here run
//   in parallel in no order.
//
// repeat_rows_kernel<kElement> replaces v_b (:80, call :86): (B, R, C) to
//   (B, n R, C), out[b, i] = x[b, i % R] (tile: what pltpu.repeat computes
//   in interpret mode) or x[b, i / n] (element).  One float4 a thread,
//   read through the read-only path and written coalesced.
//
// unpack_direct_kernel replaces v_c (:105, call :129) and t2_timing's k_vc
//   (:198, call :212), which repeat the packed rows 8 times and select by
//   s mod 8 so as to avoid a relayout: the fetch-order unpack, out[b, j,
//   s] = float j of logical row s = x[b, s / 8, (s % 8) w + j].  Its
//   counterpart of "fetch each packed row 8 times in place of one
//   transpose" is to skip shared memory: each thread reads its logical
//   row's w floats straight from device memory (float4 loads where w is a
//   multiple of 4; the L1 keeps a warp's 2 KB of rows between its loads)
//   and writes out[b, j, s] coalesced along s.
//
// permute_lanes_kernel replaces v_p (:143, call :167), which permutes the
//   backward's lanes from c' order to fetch order by a one-hot matmul in
//   two split-bf16 passes: out[r, c] = x[r, inv[c]], inv the inverse of
//   perm (perm[c'] = the slot of lane c'), exact.  A block stages
//   kLaneRows rows with float4 loads and stores, each 32 floats of a row
//   followed by 4 words of padding (a permutation that moves floats by
//   multiples of 32 then spreads over the banks), and writes out[r, c]
//   coalesced, a gather from shared memory by inv: no scattered stores
//   and no atomics.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPack = 8;            // logical rows a packed row
constexpr int kOutRows = 12, kOutCols = 128;   // t2's output block
constexpr int kSlabP = 64, kSlabW = 16;   // t2: packed rows, w a slab
constexpr int kLaneRows = 8;        // permute_lanes: rows a block

__device__ __forceinline__ int kGroupPad(int k) {
  return (k & 3) + 16 * (k >> 2);
}

// ---- permuted_unpack, slab_relayout_permuted ----------------------------

struct PermutedParams {
  const float4* x;     // (B, P, 8 w) f32 as float4
  float* out;          // (B, w, 8 P), or (12, 128) when kLastOnly
  int p, w;
};

template <bool kLastOnly>
__global__ void __launch_bounds__(kThreads)
permuted_unpack_kernel(PermutedParams prm) {
  extern __shared__ float slots[];  // 8 P slots at stride w | 1, padded
  // a slab's shapes are constants: its index arithmetic takes shifts
  const int p = kLastOnly ? kSlabP : prm.p, w = kLastOnly ? kSlabW : prm.w;
  const int s = w | 1, packed_w = kPack * w;
  const int n_slots = kPack * p, group = p * s;
  const int n4 = p * packed_w / 4;
  const float4* xb = prm.x + static_cast<long long>(blockIdx.x) * n4;
#pragma unroll 2
  for (int q = threadIdx.x; q < n4; q += kThreads) {
    const float4 v = __ldg(xb + q);
    const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = 4 * q + i;
      const int pr = e / packed_w, c = e - pr * packed_w;
      const int k = c / w, j = c - k * w;
      slots[k * group + kGroupPad(k) + pr * s + j] = f[i];
    }
  }
  __syncthreads();
  if constexpr (kLastOnly) {
    if (blockIdx.x != gridDim.x - 1) return;
    for (int o = threadIdx.x; o < kOutRows * kOutCols; o += kThreads) {
      const int i = o % kOutCols, k = i / p;
      prm.out[o] = slots[k * group + kGroupPad(k) + (i - k * p) * s +
                         o / kOutCols];
    }
  } else {
    // one slot's address a thread, then its w floats: a warp writes 32
    // consecutive slots of one float j (a division a slot, not a float)
    float* o = prm.out + static_cast<long long>(blockIdx.x) * w * n_slots;
    for (int c = threadIdx.x; c < n_slots; c += kThreads) {
      const int k = c / p;
      const float* slot = slots + k * group + kGroupPad(k) + (c - k * p) * s;
      for (int j = 0; j < w; ++j) o[j * n_slots + c] = slot[j];
    }
  }
}

// ---- repeat_rows --------------------------------------------------------

struct RepeatParams {
  const float4* x;     // (B, R, C) f32 as float4
  float4* out;         // (B, n R, C)
  unsigned int n_out4; // float4s of out (< 2^31, the wrapper checks)
  int r, c4, n;        // rows, float4s a row, repeats
};

template <bool kElement>
__global__ void __launch_bounds__(kThreads)
repeat_rows_kernel(RepeatParams prm) {
  const unsigned int q = blockIdx.x * kThreads + threadIdx.x;
  if (q >= prm.n_out4) return;
  const unsigned int row = q / prm.c4, col = q - row * prm.c4;
  const unsigned int out_rows = prm.n * prm.r;
  const unsigned int b = row / out_rows, i = row - b * out_rows;
  const unsigned int src = kElement ? i / prm.n : i % prm.r;
  prm.out[q] = __ldg(prm.x + (b * prm.r + src) * prm.c4 + col);
}

// ---- unpack_direct ------------------------------------------------------

struct DirectParams {
  const float* x;      // (B, P, 8 w) f32: B 8 P logical rows of w floats
  float* out;          // (B, w, 8 P)
  int n_rows;          // B 8 P
  int n_slots, w;      // 8 P, floats a logical row
};

__global__ void __launch_bounds__(kThreads)
unpack_direct_kernel(DirectParams prm) {
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= prm.n_rows) return;
  const int w = prm.w, b = g / prm.n_slots, s = g - b * prm.n_slots;
  const float* row = prm.x + static_cast<long long>(g) * w;
  float* o = prm.out + static_cast<long long>(b) * w * prm.n_slots + s;
  if ((w & 3) == 0) {
    const float4* row4 = reinterpret_cast<const float4*>(row);
    for (int j4 = 0; j4 < w / 4; ++j4) {
      const float4 v = __ldg(row4 + j4);
      const long long at = static_cast<long long>(4 * j4) * prm.n_slots;
      o[at] = v.x;
      o[at + prm.n_slots] = v.y;
      o[at + 2 * prm.n_slots] = v.z;
      o[at + 3 * prm.n_slots] = v.w;
    }
  } else {
    for (int j = 0; j < w; ++j)
      o[static_cast<long long>(j) * prm.n_slots] = __ldg(row + j);
  }
}

// ---- permute_lanes ------------------------------------------------------

struct LaneParams {
  const float4* x;     // (rows, L) f32 as float4
  const int* inv;      // (L,): out[r, c] = x[r, inv[c]]
  float* out;          // (rows, L)
  int n_rows, l;
};

__host__ __device__ constexpr int lane_stride(int l) {
  return l + 4 * ((l + 31) / 32);
}

__device__ __forceinline__ int lane_at(int i) { return i + 4 * (i >> 5); }

__global__ void __launch_bounds__(kThreads)
permute_lanes_kernel(LaneParams prm) {
  extern __shared__ float rows[];   // kLaneRows rows at lane_stride(L)
  const int l = prm.l, l4 = l / 4, stride = lane_stride(l);
  const int r0 = blockIdx.x * kLaneRows;
  const int nr = min(kLaneRows, prm.n_rows - r0);
  const float4* xb = prm.x + static_cast<long long>(r0) * l4;
  for (int q = threadIdx.x; q < nr * l4; q += kThreads) {
    const int r = q / l4, i = 4 * (q - r * l4);
    *reinterpret_cast<float4*>(rows + r * stride + lane_at(i)) = __ldg(xb + q);
  }
  __syncthreads();
  float* ob = prm.out + static_cast<long long>(r0) * l;
  for (int c = threadIdx.x; c < l; c += kThreads) {
    const int a = lane_at(__ldg(prm.inv + c));
    for (int r = 0; r < nr; ++r) ob[r * l + c] = rows[r * stride + a];
  }
}

}  // namespace

// Each entry launches on `stream` with 256 threads a block and returns
// cudaGetLastError() (0 on success).  float4 inputs are 16-byte aligned
// (the wrapper checks); smem is the block's dynamic shared memory, which
// the wrapper computes and bounds.

// x (b, p, 8 w) f32, out (b, w, 8 p); last_only != 0: x is (b slabs of
// 64, 128), p 64, w 16, and out the last slab's (12, 128) block;
// smem = (8 p (w | 1) + 19) 4
extern "C" int tpu_splat_permuted_unpack(const void* x, void* out, int b,
                                         int p, int w, int last_only,
                                         long long smem, void* stream) {
  PermutedParams prm{static_cast<const float4*>(x), static_cast<float*>(out),
                     p, w};
  const void* fn = last_only ? (const void*)&permuted_unpack_kernel<true>
                             : (const void*)&permuted_unpack_kernel<false>;
  return launch_kernel(fn, prm, b, kThreads, smem,
                       static_cast<cudaStream_t>(stream));
}

// x (b, r, c) f32, out (b, n r, c); c a multiple of 4; element != 0:
// out[b, i] = x[b, i / n], else x[b, i % r]
extern "C" int tpu_splat_repeat_rows(const void* x, void* out, int b, int r,
                                     int c, int n, int element,
                                     void* stream) {
  const long long n_out4 = static_cast<long long>(b) * n * r * (c / 4);
  RepeatParams prm{static_cast<const float4*>(x), static_cast<float4*>(out),
                   static_cast<unsigned int>(n_out4), r, c / 4, n};
  const void* fn = element ? (const void*)&repeat_rows_kernel<true>
                           : (const void*)&repeat_rows_kernel<false>;
  return launch_kernel(fn, prm,
                       static_cast<int>((n_out4 + kThreads - 1) / kThreads),
                       kThreads, 0, static_cast<cudaStream_t>(stream));
}

// x (b, p, 8 w) f32, out (b, w, 8 p) in fetch order
extern "C" int tpu_splat_unpack_direct(const void* x, void* out, int b,
                                       int p, int w, void* stream) {
  DirectParams prm{static_cast<const float*>(x), static_cast<float*>(out),
                   b * kPack * p, kPack * p, w};
  return launch_kernel((const void*)&unpack_direct_kernel, prm,
                       (prm.n_rows + kThreads - 1) / kThreads, kThreads, 0,
                       static_cast<cudaStream_t>(stream));
}

// x (rows, l) f32, inv (l,) int32, out (rows, l); l a multiple of 4;
// smem = 8 (l + 4 ceil(l / 32)) 4
extern "C" int tpu_splat_permute_lanes(const void* x, const void* inv,
                                       void* out, int rows, int l,
                                       long long smem, void* stream) {
  LaneParams prm{static_cast<const float4*>(x), static_cast<const int*>(inv),
                 static_cast<float*>(out), rows, l};
  return launch_kernel((const void*)&permute_lanes_kernel, prm,
                       (rows + kLaneRows - 1) / kLaneRows, kThreads, smem,
                       static_cast<cudaStream_t>(stream));
}

// shared bytes of the kernels whose shared memory depends on the shapes
// (the wrapper's formulas are held against these): 0 permuted_unpack
// (a = p, b = w), 1 permute_lanes (a = l)
extern "C" long long tpu_splat_pack2_smem(int kernel, int a, int b) {
  if (kernel == 0) return (static_cast<long long>(kPack) * a * (b | 1) + 19) * 4;
  if (kernel == 1) return static_cast<long long>(kLaneRows) * lane_stride(a) * 4;
  return -1;
}

// {resident blocks per SM, registers, local bytes} at 256 threads and
// `smem` bytes: kernel 0 permuted_unpack, 1 slab_relayout_permuted,
// 2 repeat_rows tile, 3 element, 4 unpack_direct, 5 permute_lanes
extern "C" int tpu_splat_pack2_occupancy(int kernel, long long smem,
                                         int* out) {
  const void* fns[] = {(const void*)&permuted_unpack_kernel<false>,
                       (const void*)&permuted_unpack_kernel<true>,
                       (const void*)&repeat_rows_kernel<false>,
                       (const void*)&repeat_rows_kernel<true>,
                       (const void*)&unpack_direct_kernel,
                       (const void*)&permute_lanes_kernel};
  if (kernel < 0 || kernel >= 6) return static_cast<int>(cudaErrorInvalidValue);
  return kernel_occupancy(fns[kernel], kThreads, static_cast<size_t>(smem),
                          out);
}
