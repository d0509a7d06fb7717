// Pieces shared by the rasterization kernels: the warp reduce-scatter of
// the backward kernels, the padded stride of a shared [column][row]
// accumulator, the frozen state of padding lanes, the forward kernels'
// pixel map, row footprints and per-warp row lists, and the launch and
// occupancy helpers that every C entry goes through.
//
// Tiles that are not whole warps (tile_size 4: 16 pixels) run in the generic
// instantiations, in blocks rounded up to whole warps (the register
// instantiations run tiles of whole warps only).  A padding lane (a thread
// past the tile's last pixel) starts with its log transmittance at -inf: it
// is frozen from the start, so it never composites, every gradient term it
// adds to a warp reduction is zero, and it votes "done" in every early
// exit, block-wide or per warp.  It reads no pixel input, writes no pixel
// output and is left out of its warp's pixel rectangle (warp_rect).  The
// warp-wide shuffles and votes therefore always see 32 lanes.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// the log transmittance of a padding lane: -inf (transmittance 0)
__device__ __forceinline__ float frozen_lt() {
  return -__int_as_float(0x7f800000);
}

// column stride of a shared [column][row] accumulator of `rows` rows:
// rows rounded up to 32, plus one, so the columns of one row fall in
// different banks
__host__ __device__ __forceinline__ int acc_stride(int rows) {
  return ((rows + 31) & ~31) + 1;
}

// One butterfly stage at offset `off`: a lane holding N slots keeps the
// upper half if its `off` bit is set, else the lower, in v[0, N/2).
template <int N, int V>
__device__ __forceinline__ void scatter_stage(float (&v)[V], int lane,
                                              int off) {
  const bool up = (lane & off) != 0;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float send = up ? v[i] : v[i + N / 2];
    const float keep = up ? v[i + N / 2] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, off);
  }
}

// Reduce-scatter of V slots over the warp: returns the warp's sum of slot
// `lane` (V = 32) or of slot `lane >> 1` (V = 16).  v is overwritten.
// One template stage per offset keeps every slot index compile-time, so
// the slots stay in registers.
template <int V>
__device__ __forceinline__ float reduce_scatter(float (&v)[V], int lane) {
  static_assert(V == 16 || V == 32, "reduction width");
  scatter_stage<V>(v, lane, 16);
  scatter_stage<V / 2>(v, lane, 8);
  scatter_stage<V / 4>(v, lane, 4);
  scatter_stage<V / 8>(v, lane, 2);
  if (V == 32) scatter_stage<2>(v, lane, 1);
  else v[0] += __shfl_xor_sync(kFull, v[0], 1);
  return v[0];
}

// The slot whose warp sum `lane` holds after reduce_scatter<V>, or -1 (the
// odd lanes at V = 16 hold a copy of their even neighbour's).
template <int V>
__device__ __forceinline__ int scatter_slot(int lane) {
  if (V == 32) return lane;
  return (lane & 1) ? -1 : lane >> 1;
}

// ---- the forward kernels' per-warp walk (K1, K4) -------------------------
//
// A row whose alpha stays at or below alpha_threshold at every pixel of a
// warp adds exactly nothing there: a = 0 gives weight 0, adds +-0 to every
// accumulator, log1pf(-0) = -0 leaves the log transmittance's bits, and in
// quantile mode t * (1 - 0) = t selects nothing.  So each warp walks only
// the rows whose footprint rectangle meets the rectangle of its pixel
// centres, bit for bit the result of walking them all.
//
// The footprint (quad_footprint) bounds the very f32 quadratic form the
// walk evaluates, E = c0 x^2 + c1 xy + c2 y^2 + c3 x + c4 y + c5 with the
// staged coefficients (x, y the pixel centre in the tile's basis, |x|,
// |y| <= reach), then a_raw = expf(E).  In exact arithmetic on the staged
// values, Q(x) = Q* + (x - x*)^T A (x - x*), A = [[c0, c1/2], [c1/2, c2]];
// where A is negative definite the set {Q >= L} is an ellipse whose
// bounding box is x* +- sqrt((Q* - L) * diag((-A)^-1)).  The level L is
// log(alpha_threshold) less two margins:
// * the walk's rounding: E is six products of a coefficient and an exact
//   monomial (half-integer pixel centres square exactly) summed left to
//   right without contraction (-fmad=false), so |E - Q| <= gamma_6 * S,
//   S = (|c0| + |c1| + |c2|) reach^2 + (|c3| + |c4|) reach + |c5|, and
//   gamma_6 = 6u / (1 - 6u) = 3.58e-7 (u = 2^-24); the margin is
//   kWalkRel * S with kWalkRel = 2^-21 = 4.77e-7;
// * expf's error (at most 2 ulp, 2.4e-7 relative; torch's exp on the CPU
//   twin is within 1 ulp): kExpSlack = 1e-6 in log space.
// Outside the box Q < L, so E < log(alpha_threshold) - 1e-6 and a_raw <
// alpha_threshold.  The box is computed in double from the f32
// coefficients: each product of two of them is exact in double, so det,
// x* and Q* carry relative errors near 1e-16 of the terms (|c5| and |Q*|
// bound them), which the margins' spare (1.2e-7 S and 7.6e-7) covers; the
// ends round outward to f32.  A form that is not negative definite (in
// exact arithmetic on the f32 coefficients), or any value that is not
// finite, gives the whole tile; a peak below L gives an empty box.
// The tile basis differs per kernel (K1 centred, K4 tile-local with
// pixel centres in [0.5, ts - 0.5], so its c5 can be large): the margin
// scales with S, so neither needs more.
//
// Antialias mode evaluates a sigmoid pixel integral instead, for which no
// such bound is written down here: every row's footprint is the whole tile
// and every warp walks every row, as before.

constexpr double kWalkRel = 4.76837158203125e-7;   // 2^-21
constexpr double kExpSlack = 1e-6;

__device__ __forceinline__ bool finite(double v) {
  return fabs(v) <= 1.7976931348623157e308;   // false for inf and NaN
}

__device__ __forceinline__ float4 whole_tile() {
  const float inf = __int_as_float(0x7f800000);
  return make_float4(-inf, inf, -inf, inf);
}

// Footprint rectangle (x0, x1, y0, y1) of one row's quadratic alpha form:
// a_raw <= alpha_threshold at every pixel centre of the tile outside it
// (log_thr: log(alpha_threshold) in double, from the host).
__device__ __forceinline__ float4 quad_footprint(float c0, float c1, float c2,
                                                 float c3, float c4, float c5,
                                                 double log_thr,
                                                 float reach) {
  const double a = c0, b = c1, c = c2, d = c3, e = c4, f = c5;
  const double det = a * c - 0.25 * b * b;
  if (!(a < 0.0 && c < 0.0 && det > 0.0)) return whole_tile();
  const double m = reach;
  const double s = (fabs(a) + fabs(b) + fabs(c)) * m * m
                   + (fabs(d) + fabs(e)) * m + fabs(f);
  const double inv = 1.0 / det;
  const double xs = -0.5 * (c * d - 0.5 * b * e) * inv;
  const double ys = -0.5 * (a * e - 0.5 * b * d) * inv;
  const double room = f + 0.5 * (d * xs + e * ys)
                      - (log_thr - kExpSlack - kWalkRel * s);
  if (room <= 0.0) {
    const float inf = __int_as_float(0x7f800000);
    return make_float4(inf, -inf, inf, -inf);   // meets no pixel
  }
  const double hx = sqrt(room * -c * inv), hy = sqrt(room * -a * inv);
  if (!(finite(xs + hx) && finite(xs - hx) && finite(ys + hy)
        && finite(ys - hy)))
    return whole_tile();                         // NaN or overflow
  return make_float4(__double2float_rd(xs - hx), __double2float_ru(xs + hx),
                     __double2float_rd(ys - hy), __double2float_ru(ys + hy));
}

// The pixel (row-major index in the tile) of thread `tid`: at tile sizes
// that are a multiple of 8, warp w takes an 8x4 block of pixels, the
// blocks in row-major order (at tile 16 a warp's 32 consecutive pixels,
// a 16x2 strip, meet more footprints: 38% of the headline's (row, warp)
// pairs against 31%); else its threads' 32 consecutive pixels.
__device__ __forceinline__ int pixel_of(int tid, int ts) {
  if (ts % 8 != 0) return tid;
  const int w = tid >> 5, lane = tid & 31, across = ts >> 3;
  return ((w / across) * 4 + (lane >> 3)) * ts + (w % across) * 8
         + (lane & 7);
}

// The rectangle (x0, x1, y0, y1) of the live lanes' pixel centres, the
// same in every lane of the warp.
__device__ __forceinline__ float4 warp_rect(float px, float py, bool live) {
  const float inf = __int_as_float(0x7f800000);
  float x0 = live ? px : inf, x1 = live ? px : -inf;
  float y0 = live ? py : inf, y1 = live ? py : -inf;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    x0 = fminf(x0, __shfl_xor_sync(kFull, x0, o));
    x1 = fmaxf(x1, __shfl_xor_sync(kFull, x1, o));
    y0 = fminf(y0, __shfl_xor_sync(kFull, y0, o));
    y1 = fmaxf(y1, __shfl_xor_sync(kFull, y1, o));
  }
  return make_float4(x0, x1, y0, y1);
}

// Fill this warp's `list` with the slots slot_of(j), j in [0, n) in walk
// order, whose footprint `rect[slot]` meets the warp's rectangle `wr`, 32
// rows a step; returns the list's length.
template <typename SlotOf>
__device__ __forceinline__ int warp_row_list(const float4* rect, int n,
                                             SlotOf slot_of, float4 wr,
                                             unsigned short* list,
                                             int lane) {
  const unsigned below = (1u << lane) - 1u;
  int len = 0;
  for (int j0 = 0; j0 < n; j0 += 32) {
    const int j = j0 + lane;
    int slot = 0;
    bool hit = false;
    if (j < n) {
      slot = slot_of(j);
      const float4 r = rect[slot];
      hit = r.x <= wr.y && wr.x <= r.y && r.z <= wr.w && wr.z <= r.w;
    }
    const unsigned m = __ballot_sync(kFull, hit);
    if (hit) list[len + __popc(m & below)] = static_cast<unsigned short>(slot);
    len += __popc(m);
  }
  __syncwarp();
  return len;
}

// Launch `fn` (a __global__ function taking one Params struct by value)
// on `st` with `smem` bytes of dynamic shared memory; returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a null
// `fn` (no instantiation).
template <typename Params>
int launch_kernel(const void* fn, Params& p, int blocks, int threads,
                  size_t smem, cudaStream_t st) {
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&p};
  err = cudaLaunchKernel(fn, dim3(blocks), dim3(threads), args, smem, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// out = {resident blocks per SM, registers a thread, local (stack and
// spill) bytes a thread} of `fn` at `threads` threads and `smem` bytes;
// returns a CUDA error code (0 on success).
inline int kernel_occupancy(const void* fn, int threads, size_t smem,
                            int* out) {
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads,
                                                      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = blocks;
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

}  // namespace
