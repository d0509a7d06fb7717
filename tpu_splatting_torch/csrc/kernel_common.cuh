// Pieces shared by the rasterization kernels: the warp reduce-scatter of
// the backward kernels, the padded stride of a shared [column][row]
// accumulator, the frozen state of padding lanes, and the launch and
// occupancy helpers that every C entry goes through.
//
// Tiles that are not whole warps (tile_size 4: 16 pixels) run in the generic
// instantiations, in blocks rounded up to whole warps (the register
// instantiations run tiles of whole warps only).  A padding lane (a thread
// past the tile's last pixel) starts with its log transmittance at -inf: it
// is frozen from the start, so it never composites, every gradient term it
// adds to a warp reduction is zero, and it votes "done" in every block-wide
// early exit.  It reads no pixel input and writes no pixel output.  The
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
