// Stream forward rasterization kernel for NVIDIA Hopper (sm_90a).
//
// Replaces: tpu_splatting/rasterizer/stream_kernels.py:_fwd_kernel (the
// Pallas TPU kernel behind stream_forward).  It computes what that kernel
// computes — per tile, per depth slab: assemble the slab's fetch windows
// from the home-sorted table, alpha at every pixel (quadratic form with
// log(point alpha) folded in, or the antialiased pixel integral), threshold
// and clamp, front-to-back compositing in rank-key order
// (depth << 11 | fetch slot) in log-transmittance space with the
// saturation freeze, and the quantile (median) mode — and writes the
// (T, F+1, tile_area) tiled image.  None of the TPU mechanics are carried
// over (rank-mask matmuls, split-bf16 passes, packed-sublane assembly,
// the shared-assembly output).
//
// What bounds it on this card: operations, one exp per row-pixel
// (quadratic) or four (antialias), over the slab's rows; beside them the
// table-row reads (one 128-byte row per fetched slot, gathered by window)
// and the per-slab shared-memory sort of up to slab_cap (<= 2048) rank
// keys.  Most row-pixel pairs lie outside the row's footprint, where alpha
// is 0 and the pair adds nothing.
//
// Design: one block per tile, one thread per pixel (the generic
// instantiation pads a tile to whole warps with frozen lanes:
// kernel_common.cuh); at tiles of a multiple of 8 each warp holds an 8x4
// pixel block.  For each slab the block copies the valid rows into shared
// memory as per-row alpha coefficients (the row's geometry is turned into
// the quadratic form's six coefficients once per row, not once per pixel)
// and a footprint rectangle outside which alpha is 0 (quad_footprint,
// kernel_common.cuh), and bitonic-sorts the rank keys in shared memory
// (the key embeds the slot, so sorting keys alone gives the permutation).
// Then each warp lists, 32 rows a ballot and in rank order, the slots whose
// footprint meets its pixels and walks only those, front to back.
// Skipping a row whose alpha is 0 at every pixel of the warp is exact, so
// the result is bit for bit that of walking every row.  The log
// transmittance stays in a register across slabs; a warp stops walking
// once its pixels are frozen (__all_sync every 32 listed rows), and the
// block skips the remaining slabs once every pixel is (__syncthreads_and
// at a slab boundary).  Row reads are one thread per row, so a window's
// rows are read as whole 128-byte lines.
//
// Instantiations by most features: <4>, <8>, <24> and <56> accumulate a
// pixel's features in registers, for tiles of whole warps up to 256
// pixels; stream_forward_generic_kernel<0> accumulates them in shared
// memory ([feature][thread], each thread its own column) and takes any F
// and any tile up to 1024 pixels.  <4>, the headline's, is
// stream_forward_headline_kernel, held to 48 registers.  The wrapper
// (rasterizer/stream_kernels.py, stream_forward_plan) picks one and the C
// entry launches it.  stream_forward_headline_kernel<4, false> is the
// floor probe (stream_kernels.stream_forward_floor): the same grid, slab
// loop, window assembly, row fetch, staging, rank sort and output write
// with the walk taken out; it writes the number of rows each tile staged
// to channel 0.
//
// Profiling modes (stream_kernels.stream_forward(..., ablate=,
// with_counts=)), the counterparts of the reference _fwd_kernel's
// `ablate` (:412) and `with_counts` (:593): each takes one phase out, so
// that the time saved measures it, and is compiled only for the headline's
// <4> (stream_forward_profile_kernel<kWalk, kMode, kCounts>):
// * kNoAssemble: staging reads one contiguous range from window 0's first
//   row, as long as the windows together (at most a slab), in place of the
//   per-window slots (the window assembly);
// * kNoSort: no rank sort; the walk goes in fetch-slot order (the
//   reference's no_mask: its compositing order);
// * kNoAlpha: alpha is 1e-6 x the row's first table column, with no exp,
//   quadratic form or threshold (footprints and walk unchanged);
// * the reference's skeleton is the floor probe (kWalk false).
// kCounts adds, per tile group, the computed (tile, slab) iterations, the
// rows staged and the (row, warp) pairs in the warps' footprint lists
// into `counts` (integer atomics).  The default mode is the code above.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "kernel_common.cuh"

namespace {

constexpr int kStripSlack = 512;        // rasterizer/stream.py STRIP_SLACK
constexpr int kKeyInvalid = 0x7fffffff;  // invalid slots sort last
constexpr int kGeo = 7;                  // per-row alpha coefficients

// profiling modes (stream_kernels.FWD_ABLATIONS; the floor probe is the
// skeleton)
constexpr int kComposite = 0, kNoAssemble = 1, kNoSort = 2, kNoAlpha = 3;

struct Params {
  const float* table;      // (n_pad, w_pad) row-major
  const int* desc;         // (T, S, w_max, 4) [lo_flat, len, dst, class]
  const int* strip_blk;    // (G, 3)
  float* out;              // (T, F+1, tile_area)
  int tiles_wide, group_width, num_slabs, w_max, strip_cap, slab_cap;
  int sort_cap, rpb, w_pad, f, tile_size, antialias, blending;
  int band0;           // absolute tile band of the first tile (sharding)
  float alpha_threshold, clamp_max_alpha, lcut, quantile_thr;
  double log_thr;      // log(alpha_threshold), for the footprints
  // profiling modes only: (G, 3) int counters [iterations, rows staged,
  // listed (row, warp) pairs], and the table's rows
  int* counts;
  int n_rows;
};

__device__ __forceinline__ float s_sig(float x, float s) {
  float z = x / s;
  return 1.0f / (1.0f + expf(-1.6f * z - 0.07f * z * z * z));
}

template <int MAXF, bool kWalk, int kMode = kComposite, bool kCounts = false>
__device__ __forceinline__ void stream_forward_body(const Params& p) {
  constexpr bool kRegs = MAXF > 0;       // accumulators in registers
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int lane = tid & 31;
  float4* s_rect = reinterpret_cast<float4*>(smem);  // slab_cap footprints
  int* s_key = reinterpret_cast<int*>(s_rect + p.slab_cap);
  float* s_geo = reinterpret_cast<float*>(s_key + p.sort_cap);
  float* s_feat = s_geo + kGeo * p.slab_cap;
  int* s_desc = reinterpret_cast<int*>(s_feat + p.f * p.slab_cap);
  int* s_win = s_desc + 4 * p.w_max;     // [slot0, len, row0] per window
  int* s_cnt = s_win + 3 * p.w_max;      // [slots used, valid rows]
  // generic: this thread's feature accumulators, stride nthr
  float* s_acc = reinterpret_cast<float*>(s_cnt + 2) + tid;
  // this warp's row list (slab_cap slots), after the accumulators
  unsigned short* s_list = reinterpret_cast<unsigned short*>(
      reinterpret_cast<float*>(s_cnt + 2) + (kRegs ? 0 : p.f * nthr))
      + (tid >> 5) * p.slab_cap;

  const int tile = blockIdx.x;
  const int ts = p.tile_size;
  const int pix = ts * ts;
  // register instantiations run whole-warp tiles only; the generic one
  // pads a tile to whole warps (kernel_common.cuh)
  const bool inside = kRegs || tid < pix;
  const int pixel = pixel_of(tid, ts);
  const int g = tile / p.group_width;
  const float half = ts * 0.5f;
  const float ox = static_cast<float>((tile % p.tiles_wide) * ts) + half;
  const float oy =
      static_cast<float>((p.band0 + tile / p.tiles_wide) * ts) + half;
  // tile-centred pixel coordinates (the reference's centred basis)
  const float px = static_cast<float>(pixel % ts) + 0.5f - half;
  const float py = static_cast<float>(pixel / ts) + 0.5f - half;
  const float px2 = px * px, pxy = px * py, py2 = py * py;
  const int band_stride = 2 * p.strip_cap + kStripSlack;

  float acc[kRegs ? MAXF : 1];
  if constexpr (kRegs) {
#pragma unroll
    for (int c = 0; c < MAXF; ++c) acc[c] = 0.0f;
  } else {
    for (int c = 0; c < p.f; ++c) s_acc[c * nthr] = 0.0f;
  }
  float acc_w = 0.0f;
  // log transmittance, carried across slabs
  float lt = inside ? 0.0f : frozen_lt();
  float floor_v = 0.0f;   // the floor probe's output: rows staged
  int c_iters = 0, c_rows = 0, c_pairs = 0;   // kCounts

  for (int s = 0; s < p.num_slabs; ++s) {
    const int* d = p.desc + (static_cast<size_t>(tile) * p.num_slabs + s)
                                * p.w_max * 4;
    if (s > 0) {
      // empty plan slot (window 0 empty) or every pixel saturated: skip;
      // saturation persists, so the remaining slabs are skipped too
      if (__syncthreads_and(lt <= p.lcut)) break;
      if (d[1] <= 0) continue;
    }
    for (int i = tid; i < 4 * p.w_max; i += nthr) s_desc[i] = d[i];
    __syncthreads();
    if constexpr (kMode == kNoAssemble) {
      if (tid == 0) {
        // one contiguous range from window 0's first row
        int len = 0;
        for (int w = 0; w < p.w_max; ++w) len += max(s_desc[4 * w + 1], 0);
        const int b = s_desc[3] / 3;
        const int ln = min(len, p.slab_cap);
        s_win[0] = 0;
        s_win[1] = ln;
        s_win[2] = p.strip_blk[g * 3 + b] * p.strip_cap
                   + (s_desc[0] - b * band_stride);
        for (int w = 1; w < p.w_max; ++w) s_win[3 * w + 1] = 0;
        s_cnt[0] = ln;
        s_cnt[1] = ln;
      }
    } else if (tid == 0) {
      // window slots with the slab-capacity clamp against the
      // rpb-quantized cursor (reference _assemble)
      int cur = 0, valid = 0;
      for (int w = 0; w < p.w_max; ++w) {
        const int lo = s_desc[4 * w], len = s_desc[4 * w + 1];
        const int b = s_desc[4 * w + 3] / 3;
        const int head = lo % p.rpb;
        const int ln = max(min(len, p.slab_cap - (cur + head)), 0);
        s_win[3 * w] = cur + head;
        s_win[3 * w + 1] = ln;
        s_win[3 * w + 2] = p.strip_blk[g * 3 + b] * p.strip_cap
                           + (lo - b * band_stride);
        if (ln > 0) cur += ((head + ln + p.rpb - 1) / p.rpb) * p.rpb;
        valid += ln;
      }
      s_cnt[0] = cur;
      s_cnt[1] = valid;
    }
    __syncthreads();
    const int n_slots = s_cnt[0];
    const int n_valid = s_cnt[1];
    if constexpr (kCounts) {
      ++c_iters;
      c_rows += n_valid;
    }
    int n_sort = 1;
    while (n_sort < n_slots) n_sort <<= 1;
    for (int i = tid; i < n_sort; i += nthr) s_key[i] = kKeyInvalid;
    if constexpr (kMode == kNoSort) {
      // the slots between windows meet no warp in the unsorted walk
      const float inf = __int_as_float(0x7f800000);
      for (int i = tid; i < n_slots; i += nthr)
        s_rect[i] = make_float4(inf, -inf, inf, -inf);
    }
    __syncthreads();

    // rows -> per-slot alpha coefficients, footprints, features and rank
    // keys
    for (int w = 0; w < p.w_max; ++w) {
      const int slot0 = s_win[3 * w], ln = s_win[3 * w + 1];
      const int row0 = s_win[3 * w + 2];
      for (int r = tid; r < ln; r += nthr) {
        const int slot = slot0 + r;
        int ri = row0 + r;
        if constexpr (kMode == kNoAssemble) ri = min(ri, p.n_rows - 1);
        const float* row = p.table + static_cast<size_t>(ri) * p.w_pad;
        const float mlx = row[0] - ox, mly = row[1] - oy;
        const float ax = row[2], ay = row[3];
        const float sx = row[4], sy = row[5], pa = row[6];
        float* geo = s_geo + slot;
        if (p.antialias) {
          geo[0] = ax;
          geo[1 * p.slab_cap] = ay;
          geo[2 * p.slab_cap] = -(mlx * ax + mly * ay);
          geo[3 * p.slab_cap] = mlx * ay - mly * ax;
          geo[4 * p.slab_cap] = fmaxf(sx, 1e-12f);
          geo[5 * p.slab_cap] = fmaxf(sy, 1e-12f);
          geo[6 * p.slab_cap] = pa;
          s_rect[slot] = whole_tile();
        } else {
          const float isx2 = 1.0f / fmaxf(sx * sx, 1e-24f);
          const float isy2 = 1.0f / fmaxf(sy * sy, 1e-24f);
          const float a2 = ax * ax, b2 = ay * ay;
          const float cxx = -0.5f * (a2 * isx2 + b2 * isy2);
          const float cyy = -0.5f * (b2 * isx2 + a2 * isy2);
          const float cxy = -(ax * ay * (isx2 - isy2));
          const float cx = -(2.0f * cxx * mlx + cxy * mly);
          const float cy = -(2.0f * cyy * mly + cxy * mlx);
          const float c1 = cxx * mlx * mlx + cxy * mlx * mly
                           + cyy * mly * mly + logf(fmaxf(pa, 1e-30f));
          geo[0] = cxx;
          geo[1 * p.slab_cap] = cxy;
          geo[2 * p.slab_cap] = cyy;
          geo[3 * p.slab_cap] = cx;
          geo[4 * p.slab_cap] = cy;
          geo[5 * p.slab_cap] = c1;
          s_rect[slot] = quad_footprint(cxx, cxy, cyy, cx, cy, c1,
                                        p.log_thr, half - 0.5f);
        }
        if constexpr (kMode == kNoAlpha) geo[6 * p.slab_cap] = 1e-6f * row[0];
        for (int c = 0; c < p.f; ++c)
          s_feat[c * p.slab_cap + slot] = row[7 + c];
        s_key[slot] = (static_cast<int>(row[7 + p.f]) << 11) | slot;
      }
    }
    __syncthreads();

    // bitonic sort of the rank keys (ascending; invalid slots last)
    for (int k = 2; kMode != kNoSort && k <= n_sort; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int i = tid; i < n_sort; i += nthr) {
          const int ixj = i ^ j;
          if (ixj > i) {
            const int a = s_key[i], b = s_key[ixj];
            if ((a > b) == ((i & k) == 0)) {
              s_key[i] = b;
              s_key[ixj] = a;
            }
          }
        }
        __syncthreads();
      }
    }
    if constexpr (!kWalk) {
      floor_v += static_cast<float>(n_valid);
      __syncthreads();
      continue;
    }

    // this warp's rows in rank order: those whose footprint meets its
    // pixels.  Then the front-to-back walk.  The log transmittance is
    // lt_in + (sequential sum of this slab's log(1 - a)), the association
    // of the twin's exclusive cumsum + carry, so threshold and freeze
    // decisions agree bit for bit.
    // (the warp's rectangle is formed here, not held across the walk)
    int n;
    if constexpr (kMode == kNoSort)
      n = warp_row_list(s_rect, n_slots, [](int j) { return j; },
                        warp_rect(px, py, inside), s_list, lane);
    else
      n = warp_row_list(
          s_rect, n_valid, [s_key](int j) { return s_key[j] & 2047; },
          warp_rect(px, py, inside), s_list, lane);
    if constexpr (kCounts) c_pairs += n;
    const float lt_in = lt;
    float acc_l = 0.0f;
    bool done = lt <= p.lcut && (p.blending || lt < 0.0f);
    for (int i = 0; i < n; ++i) {
      if ((i & 31) == 0 && __all_sync(kFull, done)) break;
      const int slot = s_list[i];
      const float* geo = s_geo + slot;
      float a;
      if constexpr (kMode == kNoAlpha) {
        a = geo[6 * p.slab_cap];
      } else {
        float a_raw;
        if (p.antialias) {
          const float ax = geo[0], ay = geo[1 * p.slab_cap];
          const float sx = geo[4 * p.slab_cap], sy = geo[5 * p.slab_cap];
          const float tu = ax * px + ay * py + geo[2 * p.slab_cap];
          const float tv = -ay * px + ax * py + geo[3 * p.slab_cap];
          const float ix =
              sx * (s_sig(tu + 0.5f, sx) - s_sig(tu - 0.5f, sx));
          const float iy =
              sy * (s_sig(tv + 0.5f, sy) - s_sig(tv - 0.5f, sy));
          a_raw = geo[6 * p.slab_cap] * (6.283185307179586f * ix * iy);
        } else {
          a_raw = expf(geo[0] * px2 + geo[1 * p.slab_cap] * pxy
                       + geo[2 * p.slab_cap] * py2
                       + geo[3 * p.slab_cap] * px
                       + geo[4 * p.slab_cap] * py + geo[5 * p.slab_cap]);
        }
        a = a_raw > p.alpha_threshold ? fminf(a_raw, p.clamp_max_alpha)
                                      : 0.0f;
      }
      const float lt_j = acc_l + lt_in;
      if (p.blending) {
        if (lt_j > p.lcut) {
          const float wgt = a * expf(lt_j);
          if constexpr (kRegs) {
#pragma unroll
            for (int c = 0; c < MAXF; ++c)
              if (c < p.f) acc[c] += wgt * s_feat[c * p.slab_cap + slot];
          } else {
            for (int c = 0; c < p.f; ++c)
              s_acc[c * nthr] += wgt * s_feat[c * p.slab_cap + slot];
          }
          acc_w += wgt;
          acc_l += log1pf(-a);
        }
        done = acc_l + lt_in <= p.lcut;
      } else {
        // quantile: the first row whose inclusive transmittance crosses
        // the threshold selects its features
        const float t = expf(lt_j);
        const float t_incl = t * (1.0f - a);
        if (t_incl <= p.quantile_thr && t > p.quantile_thr) {
          if constexpr (kRegs) {
#pragma unroll
            for (int c = 0; c < MAXF; ++c)
              if (c < p.f) acc[c] += s_feat[c * p.slab_cap + slot];
          } else {
            for (int c = 0; c < p.f; ++c)
              s_acc[c * nthr] += s_feat[c * p.slab_cap + slot];
          }
        }
        acc_l += log1pf(-a);
        const float lt_next = acc_l + lt_in;
        done = lt_next <= p.lcut && lt_next < 0.0f;
      }
    }
    lt = acc_l + lt_in;
    __syncthreads();   // shared buffers are rewritten by the next slab
  }

  if constexpr (kCounts) {
    int* cnt = p.counts + 3 * g;
    if (tid == 0) {
      atomicAdd(cnt, c_iters);
      atomicAdd(cnt + 1, c_rows);
    }
    if (kWalk && lane == 0) atomicAdd(cnt + 2, c_pairs);
  }
  if (!inside) return;
  if constexpr (!kWalk) acc[0] = floor_v;
  float* o = p.out + static_cast<size_t>(tile) * (p.f + 1) * pix + pixel;
  if constexpr (kRegs) {
#pragma unroll
    for (int c = 0; c < MAXF; ++c)
      if (c < p.f) o[c * pix] = acc[c];
  } else {
    for (int c = 0; c < p.f; ++c) o[c * pix] = s_acc[c * nthr];
  }
  o[p.f * pix] = p.blending ? acc_w : (lt < 0.0f ? 1.0f : 0.0f);
}

// register instantiations: no launch bounds, so the compiler keeps its
// own register choice (blocks of up to 256 threads)
template <int MAXF>
__global__ void stream_forward_kernel(Params p) {
  stream_forward_body<MAXF, true>(p);
}

// the headline's instantiation (4 features) and its floor probe, held to
// 48 registers: 5 blocks of 256 threads an SM
template <int MAXF, bool kWalk>
__global__ void __launch_bounds__(256, 5)
stream_forward_headline_kernel(Params p) {
  stream_forward_body<MAXF, kWalk>(p);
}

// the profiling modes of the headline's instantiation, under its bounds
template <bool kWalk, int kMode, bool kCounts>
__global__ void __launch_bounds__(256, 5)
stream_forward_profile_kernel(Params p) {
  stream_forward_body<4, kWalk, kMode, kCounts>(p);
}

// the generic instantiation, for blocks of up to 1024 threads
template <int MAXF>
__global__ void __launch_bounds__(1024)
stream_forward_generic_kernel(Params p) {
  stream_forward_body<MAXF, true>(p);
}

// an ablation of the walking <4> (`counts`: its counting variant)
template <int kMode>
const void* ablation_kernel(int counts) {
  return counts ? (const void*)&stream_forward_profile_kernel<true, kMode,
                                                              true>
                : (const void*)&stream_forward_profile_kernel<true, kMode,
                                                              false>;
}

// a profiling mode of <4> (`mode`, with `counts` the counting variant;
// with `walk` 0 the floor probe's), or null
const void* profile_kernel_for(int walk, int mode, int counts) {
  if (mode == kComposite) {
    if (!counts) return nullptr;
    return walk ? (const void*)&stream_forward_profile_kernel<true,
                                                              kComposite, true>
                : (const void*)&stream_forward_profile_kernel<false,
                                                              kComposite,
                                                              true>;
  }
  if (!walk) return nullptr;
  switch (mode) {
    case kNoAssemble: return ablation_kernel<kNoAssemble>(counts);
    case kNoSort: return ablation_kernel<kNoSort>(counts);
    case kNoAlpha: return ablation_kernel<kNoAlpha>(counts);
    default: return nullptr;
  }
}

// the instantiation that keeps `max_features` accumulators in registers,
// or the generic one for 0; with `walk` 0, the floor probe (<4> only);
// a profiling `mode` or `counts`: <4> only; null for any other value
const void* kernel_for(int max_features, int walk = 1, int mode = 0,
                       int counts = 0) {
  if (mode != kComposite || counts)
    return max_features == 4 ? profile_kernel_for(walk, mode, counts)
                             : nullptr;
  if (!walk)
    return max_features == 4
               ? (const void*)&stream_forward_headline_kernel<4, false>
               : nullptr;
  switch (max_features) {
    case 4: return (const void*)&stream_forward_headline_kernel<4, true>;
    case 8: return (const void*)&stream_forward_kernel<8>;
    case 24: return (const void*)&stream_forward_kernel<24>;
    case 56: return (const void*)&stream_forward_kernel<56>;
    case 0: return (const void*)&stream_forward_generic_kernel<0>;
    default: return nullptr;
  }
}

}  // namespace

// Dynamic shared memory of one block, in bytes: per-slot footprints (4
// floats), rank keys, per-row coefficients and features, window
// descriptors, (generic instantiation, max_features 0) every thread's
// feature accumulators, and one 16-bit row list a warp.
extern "C" long long tpu_splat_stream_forward_smem(int slab_cap, int w_max,
                                                   int feature_size,
                                                   int max_features,
                                                   int threads) {
  int sort_cap = 1;
  while (sort_cap < slab_cap) sort_cap <<= 1;
  return 4LL * (sort_cap
                + static_cast<long long>(4 + kGeo + feature_size) * slab_cap
                + 7 * w_max + 2
                + (max_features == 0
                       ? static_cast<long long>(feature_size) * threads : 0))
         + 2LL * (threads / 32) * slab_cap;
}

// {resident blocks per SM, registers, local bytes} of an instantiation.
extern "C" int tpu_splat_stream_forward_occupancy(int max_features,
                                                  int threads,
                                                  long long smem, int* out) {
  return kernel_occupancy(kernel_for(max_features), threads,
                          static_cast<size_t>(smem), out);
}

// Launch the instantiation `max_features` (4, 8, 24, 56, or 0: generic;
// with `walk` 0 the floor probe) with `threads` threads a block (the
// tile's pixels in whole warps) on `stream`.  `band0` is the absolute
// tile band of the mapping's first band: 0 unless the mapping is one
// shard of a band-sharded image.  `mode` (kNoAssemble, kNoSort, kNoAlpha)
// and a non-null `counts` (zeroed (G, 3) ints) select a profiling mode of
// <4>; `n_rows` is the table's rows.  Returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue where no
// instantiation matches.
extern "C" int tpu_splat_stream_forward(
    const float* table, const int* desc, const int* strip_blk, float* out,
    int* counts, int num_tiles, int tiles_wide, int group_width,
    int num_slabs, int w_max, int strip_cap, int slab_cap, int rpb,
    int w_pad, int feature_size, int tile_size, int antialias, int blending,
    int max_features, int threads, int walk, int band0, int mode,
    int n_rows, float alpha_threshold, float clamp_max_alpha, float lcut,
    float quantile_thr, void* stream) {
  Params p;
  p.table = table;
  p.desc = desc;
  p.strip_blk = strip_blk;
  p.out = out;
  p.counts = counts;
  p.n_rows = n_rows;
  p.tiles_wide = tiles_wide;
  p.group_width = group_width;
  p.num_slabs = num_slabs;
  p.w_max = w_max;
  p.strip_cap = strip_cap;
  p.slab_cap = slab_cap;
  p.sort_cap = 1;
  while (p.sort_cap < slab_cap) p.sort_cap <<= 1;
  p.rpb = rpb;
  p.w_pad = w_pad;
  p.f = feature_size;
  p.tile_size = tile_size;
  p.antialias = antialias;
  p.blending = blending;
  p.band0 = band0;
  p.alpha_threshold = alpha_threshold;
  p.log_thr = log(static_cast<double>(alpha_threshold));
  p.clamp_max_alpha = clamp_max_alpha;
  p.lcut = lcut;
  p.quantile_thr = quantile_thr;
  if (max_features > 0 && feature_size > max_features)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(tpu_splat_stream_forward_smem(
      slab_cap, w_max, feature_size, max_features, threads));
  return launch_kernel(kernel_for(max_features, walk, mode, counts != nullptr),
                       p, num_tiles, threads, smem,
                       static_cast<cudaStream_t>(stream));
}
