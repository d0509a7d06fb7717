// Stream backward rasterization kernel for NVIDIA Hopper (sm_90a).
//
// Replaces: tpu_splatting/rasterizer/stream_kernels.py:_bwd_kernel (:697,
// the Pallas TPU kernel behind stream_backward) and, fused into it,
// :_merge_kernel (:996, behind merge_grad_slabs).  Per tile, per depth
// slab it recomputes the forward compositing exactly as
// stream_forward.cu does (same window assembly, rank-key sort, alpha
// formula, log transmittance and freeze), then walks the rows front to
// back once more carrying the backward's state — the remaining-feature
// sum s_i = s_total - (prefix of w * g_f + carry) — and forms each
// (row, pixel)'s gradient terms: the 7 packed-gaussian terms, the F
// feature gradients, and optionally visibility (sum of w), prune cost
// (pa^2 * sum alpha_grad^2) and split score.
//
// Without antialias, as the reference's _bwd_kernel (:773-784, :869-914):
// alpha is pa * exp(-(u^2 + v^2) / 2), u and v the sigma-scaled rotated
// coordinates as linear forms of the tile-centred pixel coordinates, and
// the 7 terms are the pixel moments z0 u px, z0 u py, z0 u, z0 v px,
// z0 v py, z0 v and z0.  The flush turns a row's summed moments into its
// six geometry gradients with this tile's mean offsets before it adds
// them to the buffer.  The forward's quadratic form, and per-pixel terms,
// cancel large f32 terms for splats thinner than ~0.1 px (ROADMAP F16);
// the two alpha formulas agree to rounding (F1).  With antialias the
// terms are the closed forms per pixel, as in the reference.
//
// The TPU writes each row's gradient into one of 9 per-class slab
// buffers and sums them in a second kernel only because it has no
// atomics.  Here each block adds its rows' gradients with atomicAdd
// straight into the home-major (T * run_cap + 1, slabw) buffer that
// merge_grad_slabs returns column by column: sorted table row j lands at
// row home(j) * run_cap + (j - run_starts[home(j)]), derived per window
// from the descriptor's gbuf_dst and class.  The last row is the zero
// row that grad_src's sentinel points at.
//
// What bounds it on this card: the per-(row, pixel) arithmetic (one exp
// for alpha, one for the transmittance, one log1p, the gradient chain)
// and, per row and warp, the reduction of the gradient terms over the
// warp's pixels.  Bytes are few (the table rows, the image and its
// cotangent, the buffer).  Every per-row gradient stays out of device
// memory: a warp reduces its pixels' terms, adds them to a shared
// accumulator (slabw x chunk), and the rows are flushed to the buffer
// with one global atomicAdd per nonzero value.  Warps with no live pixel
// for a row skip the reduction.
//
// The walk is bound by latency (exp, log1p, the reduce-scatter, shared
// atomics, a block vote every 32 rows), so it needs warps resident to hide
// it.  Shared memory is sized to a chunk of the slab, not to the slab:
// each (tile, slab) stages its rows' rank keys only (the row's depth
// column), sorts them, then walks the sorted order in chunks of `chunk`
// rows, each staged in rank order (the row found from its slot through the
// window list), walked and flushed before the next.  The walk's state runs
// on across the chunks of a slab, so the walk and the freeze decisions are
// the whole slab's; each row lies in one chunk, so its flush is the same.
// The plan (stream_kernels.stream_backward_plan) takes the largest chunk
// that holds three blocks an SM, the whole slab where it fits: the
// headline's 512-row slabs in one chunk, the heavy scene's 1792 in four
// of 576 rows (74,620 B against 210,812 for the whole slab: 24 warps an
// SM instead of 8).
//
// The reduction is a reduce-scatter (a transposed butterfly).  A thread's
// terms sit in V slots: the 7 packed-gaussian terms, visibility, prune and
// split at slots 7-9, feature c at slot 10 + c; features past V - 10 go
// in further batches of V.  At each butterfly offset a lane sends its
// partner the half of its slots the partner keeps and adds the partner's
// half into its own: V/2 + V/4 + ... shuffles (16 at V = 16, 31 at V = 32)
// in place of 5 per column.  Then lane l holds the warp's sum of slot l
// (V = 32) or of slot l / 2 (V = 16), and the lanes that own a column add
// it to the shared accumulator in one atomicAdd instruction.  The
// accumulator's column stride is the chunk rounded up to 32, plus one, so
// the columns of one row fall in different banks.
//
// Design: one block per tile, one thread per pixel (a tile that is not whole
// warps runs in the generic instantiation, padded with frozen lanes:
// kernel_common.cuh).  The log transmittance and the remaining-feature carry
// stay in registers across slabs; a block stops once every pixel is frozen
// and skips the remaining slabs, as the forward does.
//
// Band sharding (parallel/stream_sharded.py): a shard runs K2 on its own
// bands with `band0`, the absolute band of its first tile, and in halo mode
// adds into a buffer of th_local + 2 bands of homes, its own bands with one
// halo band above and one below: every home its windows reach.  Home band
// b of local tile band ty is then ty + b, not ty + b - 1.  With
// halo_merge_kernel below this replaces the reference's halo mode of
// _merge_kernel (:996, merge_grad_slabs(..., halo=True), :1099): the
// reference trades its neighbours' source slab blocks and merges them;
// here a shard sends its two halo bands of finished home-major rows, and
// halo_merge_kernel adds the two it receives into its first and last own
// bands.
//
// Instantiations <most features, V>: <6, 16>, <22, 32> and <56, 32> keep a
// pixel's image cotangent in registers; stream_backward_generic_kernel<16>
// (V = 16) keeps it in shared memory ([feature][thread]) and takes any F
// and any tile up to 1024 pixels.  The wrapper
// (rasterizer/stream_kernels.py, stream_backward_plan) picks one and the C
// entry launches it.
//
// Profiling modes (stream_kernels.stream_backward(..., ablate=)), the
// counterparts of the reference _bwd_kernel's `ablate` (:697), compiled
// only for <6, 16> (stream_backward_profile_kernel<kMode>): each takes one
// phase out, so that the time saved measures it.
// * kSkeleton: staging, sort and flush only, no walk; each staged row's
//   accumulator entries hold 1e-20 x the sum of its table values;
// * kNoSort: no rank sort; the walk goes in fetch-slot order (the
//   reference's no_mask: its compositing order);
// * kNoGrad: the walk runs up to alpha_grad, with no per-row terms and no
//   reduce-scatter; every accumulator entry of the slab holds 1e-20 x the
//   tile's sum of alpha_grad, and is flushed;
// * kNoCopyback: everything but the flush; each block adds 1e-20 x the sum
//   of its accumulators into the buffer's row 0, column 0.
// The default mode is the code above.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_common.cuh"

namespace {

constexpr int kStripSlack = 512;        // rasterizer/stream.py STRIP_SLACK
constexpr int kKeyInvalid = 0x7fffffff;  // invalid slots sort last
constexpr int kGeo = 12;                 // per-row coefficients in smem
constexpr int kLead = 10;                // slots before the features
constexpr float kTau = 6.283185307179586f;

// profiling modes (stream_kernels.BWD_ABLATIONS)
constexpr int kComposite = 0, kSkeleton = 1, kNoSort = 2, kNoGrad = 3,
              kNoCopyback = 4;

struct Params {
  const float* table;      // (n_pad, w_pad) row-major
  const int* desc;         // (T, S, w_max, 4) [lo_flat, len, dst, class]
  const int* strip_blk;    // (G, 3)
  const float* img;        // (T, F+1, tile_area) forward image
  const float* gimg;       // (T, F+1, tile_area) its cotangent
  float* out;              // (T * run_cap + 1, slabw) zero-initialised
  int num_tiles, tiles_wide, group_width, num_slabs, w_max, strip_cap;
  int slab_cap, sort_cap, chunk, rpb, w_pad, f, tile_size, antialias;
  int run_cap;
  int slabw, with_vis, heur;
  // band sharding: the absolute band of the first tile, and 1 where `out`
  // holds a halo band of homes above (and below) the mapping's own
  int band0, halo;
  float alpha_threshold, clamp_max_alpha, lcut;
};

__device__ __forceinline__ float s_sig(float x, float s) {
  float z = x / s;
  return 1.0f / (1.0f + expf(-1.6f * z - 0.07f * z * z * z));
}

// s_sig(x, sig), d s / dx and d s / dx * -z (reference _antialias_grads)
__device__ __forceinline__ void s_grads(float x, float sig, float& s_val,
                                        float& d_dx, float& d_dxs) {
  const float z = x / sig;
  s_val = 1.0f / (1.0f + expf(-1.6f * z - 0.07f * z * z * z));
  const float ds_dx = (1.6f + 0.21f * z * z) * s_val * (1.0f - s_val);
  d_dx = ds_dx / sig;
  d_dxs = d_dx * -z;
}

// buffer column of reduction slot k (7 packed-gaussian terms, visibility,
// prune, split, features), or -1 where the slot holds no column
__device__ __forceinline__ int slot_column(int k, int f, int with_vis,
                                           int heur) {
  const int c_vis = 7 + f;               // visibility, prune, split columns
  if (k < 7) return k;
  if (k == 7) return with_vis ? c_vis : -1;
  if (k < kLead) return heur ? c_vis + k - 7 : -1;
  return k - kLead < f ? 7 + k - kLead : -1;
}

// the block's sum of x (every thread's), in `tid` 0; `scratch` holds a
// float a warp, and the block is synchronised before and after
__device__ __forceinline__ float block_sum(float x, float* scratch, int tid,
                                           int nthr) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  __syncthreads();
  if ((tid & 31) == 0) scratch[tid >> 5] = x;
  __syncthreads();
  float total = 0.0f;
  for (int w = 0; w < nthr / 32; ++w) total += scratch[w];
  __syncthreads();
  return total;
}

// The window of assembly slot `slot`: the last of the w_max windows whose
// first slot is at most `slot` (an empty window sits at the cursor, so the
// first slots ascend and a staged slot's window is the last at or below
// it).
__device__ __forceinline__ int window_of(const int* s_win, int w_max,
                                         int slot) {
  int lo = 0, hi = w_max - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (s_win[4 * mid] <= slot) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// Add one row's accumulated terms (column c at acc[c * stride]) into its
// buffer row `o`; without antialias the moments become the six geometry
// gradients with this tile's mean offsets (stream_kernels._flush_rows, the
// reference's :882-893), the linear forms recomputed from the table row
// as the staging computes them.  The z0 column is divided by pa and the
// prune column multiplied by pa^2.
__device__ __forceinline__ void flush_row(const Params& p, const float* row,
                                          float* o, const float* acc,
                                          int stride, float ox, float oy) {
  const float pa = row[6];
  float g6[6];
  if (p.antialias) {
#pragma unroll
    for (int c = 0; c < 6; ++c) g6[c] = acc[c * stride];
  } else {
    const float mlx = row[0] - ox, mly = row[1] - oy;
    const float ax = row[2], ay = row[3];
    const float isx = 1.0f / fmaxf(row[4], 1e-12f);
    const float isy = 1.0f / fmaxf(row[5], 1e-12f);
    const float su_px = acc[0], su_py = acc[1 * stride];
    const float su = acc[2 * stride];
    const float sv_px = acc[3 * stride], sv_py = acc[4 * stride];
    const float sv = acc[5 * stride];
    const float su_dx = su_px - mlx * su, su_dy = su_py - mly * su;
    const float sv_dx = sv_px - mlx * sv, sv_dy = sv_py - mly * sv;
    const float suu = ax * isx * su_px + ay * isx * su_py
                      + -(mlx * ax + mly * ay) * isx * su;
    const float svv = -ay * isy * sv_px + ax * isy * sv_py
                      + (mlx * ay - mly * ax) * isy * sv;
    g6[0] = ax * isx * su - ay * isy * sv;
    g6[1] = ay * isx * su + ax * isy * sv;
    g6[2] = -isx * su_dx - isy * sv_dy;
    g6[3] = -isx * su_dy + isy * sv_dx;
    g6[4] = isx * suu;
    g6[5] = isy * svv;
  }
#pragma unroll
  for (int c = 0; c < 6; ++c)
    if (g6[c] != 0.0f) atomicAdd(o + c, g6[c]);
  const int c_prune = 7 + p.f + 1;
  for (int c = 6; c < p.slabw; ++c) {
    float x = acc[c * stride];
    if (c == 6) x = x / fmaxf(pa, 1e-20f);
    if (p.heur && c == c_prune) x = x * (pa * pa);
    if (x != 0.0f) atomicAdd(o + c, x);
  }
}

template <int MAXF, int V, int kMode = kComposite>
__device__ __forceinline__ void stream_backward_body(const Params& p) {
  constexpr bool kRegs = MAXF > 0;       // image cotangent in registers
  constexpr int NB = (kLead + MAXF + V - 1) / V;   // reduction batches
  extern __shared__ __align__(16) unsigned char smem[];
  const int cc = p.chunk;                // rows staged at once
  const int sa = acc_stride(cc);
  int* s_key = reinterpret_cast<int*>(smem);       // the slab's rank keys
  float* s_geo = reinterpret_cast<float*>(s_key + p.sort_cap);  // [k][row]
  float* s_feat = s_geo + kGeo * cc;     // [feature][row]
  float* s_acc = s_feat + p.f * cc;      // [column][row], stride sa
  int* s_desc = reinterpret_cast<int*>(s_acc + p.slabw * sa);
  int* s_win = s_desc + 4 * p.w_max;     // [slot0, len, row0, grad row0]
  int* s_cnt = s_win + 4 * p.w_max;      // [slots used, valid rows]
  float* s_gi = reinterpret_cast<float*>(s_cnt + 2);  // generic: [c][tid]

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;           // tile_area in whole warps
  const int lane = tid & 31;
  const int ts = p.tile_size;
  const int pix = ts * ts;
  // register instantiations run whole-warp tiles only; the generic one
  // pads a tile to whole warps (kernel_common.cuh)
  const bool inside = kRegs || tid < pix;
  const int g = tile / p.group_width;
  const int ti = tile % p.group_width;
  const int tx = tile % p.tiles_wide, ty = tile / p.tiles_wide;
  const float half = ts * 0.5f;
  const float ox = static_cast<float>(tx * ts) + half;
  const float oy = static_cast<float>((p.band0 + ty) * ts) + half;
  const int band_stride = 2 * p.strip_cap + kStripSlack;
  const int r_rows = (p.num_tiles + 2 * p.halo * p.tiles_wide) * p.run_cap;
  const int c_vis = 7 + p.f;             // visibility, prune, split columns

  // the buffer column this lane adds after each batch's reduction, or -1
  // (slot_column's map, computed once for the register instantiations)
  int dst[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const int k = b * V + (V == 16 ? lane >> 1 : lane);
    int c = -1;
    if (V == 16 && (lane & 1)) c = -1;
    else if (k < 7) c = k;
    else if (k == 7) c = p.with_vis ? c_vis : -1;
    else if (k < kLead) c = p.heur ? c_vis + k - 7 : -1;
    else if (k - kLead < p.f) c = 7 + k - kLead;
    dst[b] = c;
  }

  // per pixel: its coordinates, image cotangent, and s_total = sum_c
  // g_image * image over all F+1 channels (the weight channel included)
  const float px = static_cast<float>(tid % ts) + 0.5f - half;
  const float py = static_cast<float>(tid / ts) + 0.5f - half;
  const size_t ib = static_cast<size_t>(tile) * (p.f + 1) * pix + tid;
  float gi[kRegs ? MAXF : 1];
  float s_total = 0.0f, gi_w = 0.0f;
  if constexpr (kRegs) {
#pragma unroll
    for (int c = 0; c < MAXF; ++c) {
      gi[c] = 0.0f;
      if (c < p.f && inside) {
        gi[c] = p.gimg[ib + static_cast<size_t>(c) * pix];
        s_total += gi[c] * p.img[ib + static_cast<size_t>(c) * pix];
      }
    }
  } else {
    for (int c = 0; c < p.f; ++c) {
      float gc = 0.0f;
      if (inside) {
        gc = p.gimg[ib + static_cast<size_t>(c) * pix];
        s_total += gc * p.img[ib + static_cast<size_t>(c) * pix];
      }
      s_gi[c * nthr + tid] = gc;
    }
  }
  if (inside) {
    gi_w = p.gimg[ib + static_cast<size_t>(p.f) * pix];
    s_total += gi_w * p.img[ib + static_cast<size_t>(p.f) * pix];
  }
  // log transmittance, carried across slabs
  float lt = inside ? 0.0f : frozen_lt();
  float s_prev = 0.0f;   // sum of w * g_f over earlier slabs
  float acc_sum = 0.0f;  // kNoCopyback: this thread's share of the sums

  for (int s = 0; s < p.num_slabs; ++s) {
    const int* d = p.desc + (static_cast<size_t>(tile) * p.num_slabs + s)
                                * p.w_max * 4;
    if (s > 0) {
      if (__syncthreads_and(lt <= p.lcut)) break;
      if (d[1] <= 0) continue;
    }
    for (int i = tid; i < 4 * p.w_max; i += nthr) s_desc[i] = d[i];
    __syncthreads();
    if (tid == 0) {
      int cur = 0, valid = 0;
      for (int w = 0; w < p.w_max; ++w) {
        const int lo = s_desc[4 * w], len = s_desc[4 * w + 1];
        const int dst_off = s_desc[4 * w + 2], cls = s_desc[4 * w + 3];
        const int b = cls / 3, k = cls % 3;
        const int head = lo % p.rpb;
        const int ln = max(min(len, p.slab_cap - (cur + head)), 0);
        s_win[4 * w] = ln > 0 ? cur + head : cur;   // window_of's order
        s_win[4 * w + 1] = ln;
        s_win[4 * w + 2] = p.strip_blk[g * 3 + b] * p.strip_cap
                           + (lo - b * band_stride);
        // home (band y+b-1, column x+k-1; in halo mode the buffer's bands
        // start one above the shard's); dst = run offset + (i+k)*run_cap
        const int home = (ty + b - 1 + p.halo) * p.tiles_wide + tx + k - 1;
        s_win[4 * w + 3] = (home - ti - k) * p.run_cap + dst_off;
        if (ln > 0) cur += ((head + ln + p.rpb - 1) / p.rpb) * p.rpb;
        valid += ln;
      }
      s_cnt[0] = cur;
      s_cnt[1] = valid;
    }
    __syncthreads();
    const int n_slots = s_cnt[0];
    const int n_valid = s_cnt[1];
    int n_sort = 1;
    while (n_sort < n_slots) n_sort <<= 1;
    for (int i = tid; i < n_sort; i += nthr) s_key[i] = kKeyInvalid;
    __syncthreads();

    // the slab's rank keys, from each row's depth column
    for (int w = 0; w < p.w_max; ++w) {
      const int slot0 = s_win[4 * w], ln = s_win[4 * w + 1];
      const int row0 = s_win[4 * w + 2];
      for (int r = tid; r < ln; r += nthr) {
        const float* row = p.table + static_cast<size_t>(row0 + r) * p.w_pad;
        s_key[slot0 + r] = (static_cast<int>(row[7 + p.f]) << 11)
                           | (slot0 + r);
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

    // front-to-back walk in rank order, the forward's association of the
    // log transmittance (carry + sequential slab sum), in chunks: each
    // staged in walk order, walked, then flushed
    const float lt_in = lt;
    float acc_l = 0.0f, acc_wgf = 0.0f, ag_sum = 0.0f;
    bool done = lt <= p.lcut;
    const int n_rows = kMode == kNoSort ? n_slots : n_valid;
    const int n_walk = kMode == kSkeleton ? 0 : n_rows;
    bool stop = false;
    for (int j0 = 0; j0 < n_rows && !stop; j0 += cc) {
      const int cn = min(cc, n_rows - j0);

      // the chunk's rows -> per-row coefficients and features
      if constexpr (kMode != kSkeleton) {
        for (int i = tid; i < p.slabw * cn; i += nthr)
          s_acc[(i / cn) * sa + i % cn] = 0.0f;
      }
      for (int i = tid; i < cn; i += nthr) {
        const int key = s_key[j0 + i];
        if (kMode == kNoSort && key == kKeyInvalid) continue;  // a gap
        const int slot = key & 2047;
        const int w = window_of(s_win, p.w_max, slot);
        const float* row = p.table + static_cast<size_t>(
            s_win[4 * w + 2] + slot - s_win[4 * w]) * p.w_pad;
        const float mlx = row[0] - ox, mly = row[1] - oy;
        const float ax = row[2], ay = row[3];
        const float sx = row[4], sy = row[5], pa = row[6];
        float* geo = s_geo + i;
        if (p.antialias) {
          geo[0] = ax;
          geo[1 * cc] = ay;
          geo[2 * cc] = -(mlx * ax + mly * ay);
          geo[3 * cc] = mlx * ay - mly * ax;
          geo[4 * cc] = fmaxf(sx, 1e-12f);
          geo[5 * cc] = fmaxf(sy, 1e-12f);
          geo[10 * cc] = mlx;
          geo[11 * cc] = mly;
        } else {
          // the linear forms u = lu . [px, py, 1], v = lv . [px, py, 1]
          // (stream_kernels._backward_alpha_raw)
          const float isx = 1.0f / fmaxf(sx, 1e-12f);
          const float isy = 1.0f / fmaxf(sy, 1e-12f);
          geo[0] = ax * isx;
          geo[1 * cc] = ay * isx;
          geo[2 * cc] = -(mlx * ax + mly * ay) * isx;
          geo[3 * cc] = -ay * isy;
          geo[4 * cc] = ax * isy;
          geo[5 * cc] = (mlx * ay - mly * ax) * isy;
        }
        geo[6 * cc] = pa;
        for (int c = 0; c < p.f; ++c)
          s_feat[c * cc + i] = row[7 + c];
        if constexpr (kMode == kSkeleton) {
          float sum = 0.0f;
          for (int c = 0; c < 8 + p.f; ++c) sum += row[c];
          for (int c = 0; c < p.slabw; ++c) s_acc[c * sa + i] = 1e-20f * sum;
        }
      }
      __syncthreads();

      for (int j = j0; j < min(j0 + cn, n_walk); ++j) {
        if ((j & 31) == 0 && __syncthreads_and(done)) {
          stop = true;
          break;
        }
        if constexpr (kMode == kNoSort) {
          if (s_key[j] == kKeyInvalid) continue;   // a slot between windows
        }
        const int i = j - j0;
        const float* geo = s_geo + i;

        // slots 0-6 the packed-gaussian terms, then w, ag^2 and the split
        // term; the features' terms are w * gi
        float a_raw, u = 0.0f, v = 0.0f;
        if (p.antialias) {
          const float ax = geo[0], ay = geo[1 * cc];
          const float sx = geo[4 * cc], sy = geo[5 * cc];
          const float tu = ax * px + ay * py + geo[2 * cc];
          const float tv = -ay * px + ax * py + geo[3 * cc];
          const float ix = sx * (s_sig(tu + 0.5f, sx) - s_sig(tu - 0.5f, sx));
          const float iy = sy * (s_sig(tv + 0.5f, sy) - s_sig(tv - 0.5f, sy));
          a_raw = geo[6 * cc] * (kTau * ix * iy);
        } else {
          u = geo[0] * px + geo[1 * cc] * py + geo[2 * cc];
          v = geo[3 * cc] * px + geo[4 * cc] * py + geo[5 * cc];
          a_raw = geo[6 * cc] * expf(-0.5f * (u * u + v * v));
        }
        const float a = a_raw > p.alpha_threshold
                            ? fminf(a_raw, p.clamp_max_alpha) : 0.0f;
        const float lt_j = acc_l + lt_in;
        const bool live = lt_j > p.lcut && a > 0.0f;

        float t7[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        float tw = 0.0f, tprune = 0.0f, tsplit = 0.0f;
        if (live) {
          const float t = expf(lt_j);
          const float w = a * t;
          float gf = 0.0f;
          if constexpr (kRegs) {
#pragma unroll
            for (int c = 0; c < MAXF; ++c)
              if (c < p.f) gf += s_feat[c * cc + i] * gi[c];
          } else {
            for (int c = 0; c < p.f; ++c)
              gf += s_feat[c * cc + i] * s_gi[c * nthr + tid];
          }
          gf += gi_w;
          const float wgf = w * gf;
          acc_wgf += wgf;
          const float s_i = s_total - (acc_wgf + s_prev);
          const float ag = t * gf - s_i / (1.0f - a);
          acc_l += log1pf(-a);
          if constexpr (kMode == kNoGrad) {
            ag_sum += ag;
          } else {
            const float z0 = a_raw < p.clamp_max_alpha ? ag * a_raw : 0.0f;
            if (p.antialias) {
              const float dx = px - geo[10 * cc], dy = py - geo[11 * cc];
              const float ax = geo[0], ay = geo[1 * cc];
              const float sx = geo[4 * cc], sy = geo[5 * cc];
              const float pa = geo[6 * cc];
              const float tu = ax * px + ay * py + geo[2 * cc];
              const float tv = -ay * px + ax * py + geo[3 * cc];
              float sx1, dx1, dx1s, sx2, dx2, dx2s;
              float sy1, dy1, dy1s, sy2, dy2, dy2s;
              s_grads(tu + 0.5f, sx, sx1, dx1, dx1s);
              s_grads(tu - 0.5f, sx, sx2, dx2, dx2s);
              s_grads(tv + 0.5f, sy, sy1, dy1, dy1s);
              s_grads(tv - 0.5f, sy, sy2, dy2, dy2s);
              const float ix = sx * (sx1 - sx2);
              const float iy = sy * (sy1 - sy2);
              const float dsx_t = iy * sx * (dx1 - dx2);
              const float dsy_t = ix * sy * (dy1 - dy2);
              const float aag = a_raw < p.clamp_max_alpha ? pa * ag : 0.0f;
              t7[0] = aag * (kTau * (-dsx_t * ax + dsy_t * ay));
              t7[1] = aag * (kTau * (-dsx_t * ay - dsy_t * ax));
              t7[2] = aag * (kTau * (dsx_t * dx + dsy_t * dy));
              t7[3] = aag * (kTau * (dsx_t * dy - dsy_t * dx));
              t7[4] = aag * (kTau * iy * (sx1 - sx2 + (dx1s - dx2s) * sx));
              t7[5] = aag * (kTau * ix * (sy1 - sy2 + (dy1s - dy2s) * sy));
              tsplit = fabsf(t7[0]) + fabsf(t7[1]);
            } else {
              // the pixel moments; the flush makes them gradients
              const float zu = z0 * u, zv = z0 * v;
              t7[0] = zu * px;
              t7[1] = zu * py;
              t7[2] = zu;
              t7[3] = zv * px;
              t7[4] = zv * py;
              t7[5] = zv;
              tsplit = fabsf(zu * geo[0] + zv * geo[3 * cc])
                       + fabsf(zu * geo[1 * cc] + zv * geo[4 * cc]);
            }
            t7[6] = z0;                            // / pa at the flush
            tw = w;
            tprune = ag * ag;                      // * pa^2 at the flush
          }
        }
        done = acc_l + lt_in <= p.lcut;

        if (kMode != kNoGrad && __any_sync(kFull, live)) {
          float* acc = s_acc + i;
          if constexpr (kRegs) {
#pragma unroll
            for (int b = 0; b < NB; ++b) {
              if (b > 0 && b * V >= kLead + p.f) break;
              float v[V];
#pragma unroll
              for (int k = 0; k < V; ++k) {
                const int q = b * V + k;          // slot
                const int c = q - kLead;          // feature of the slot
                float x = 0.0f;
                if (q < 7) x = t7[q < 7 ? q : 0];
                else if (q == 7) x = tw;
                else if (q == 8) x = tprune;
                else if (q == 9) x = tsplit;
                else if (c < MAXF) x = tw * gi[c >= 0 && c < MAXF ? c : 0];
                v[k] = x;
              }
              const float x = reduce_scatter<V>(v, lane);
              if (dst[b] >= 0 && x != 0.0f) atomicAdd(acc + dst[b] * sa, x);
            }
          } else {
            // batch 0 holds the lead slots (index k, compile-time), every
            // batch the features from shared memory
            const float lead[kLead] = {t7[0], t7[1], t7[2], t7[3], t7[4],
                                       t7[5], t7[6], tw, tprune, tsplit};
            for (int b = 0; b * V < kLead + p.f; ++b) {
              float v[V];
#pragma unroll
              for (int k = 0; k < V; ++k) {
                const int c = b * V + k - kLead;
                float x = 0.0f;
                if (b == 0 && k < kLead) x = lead[k < kLead ? k : 0];
                else if (c < p.f) x = tw * s_gi[c * nthr + tid];
                v[k] = x;
              }
              const float x = reduce_scatter<V>(v, lane);
              const int slot = scatter_slot<V>(lane);
              const int col = slot < 0 ? -1 : slot_column(b * V + slot, p.f,
                                                          p.with_vis, p.heur);
              if (col >= 0 && x != 0.0f) atomicAdd(acc + col * sa, x);
            }
          }
        }
      }
      __syncthreads();

      // the chunk's rows into the home-major buffer (kNoCopyback: into
      // this thread's sum; kNoGrad: after the slab)
      if constexpr (kMode == kNoCopyback) {
        for (int i = tid; i < p.slabw * cn; i += nthr)
          acc_sum += s_acc[(i / cn) * sa + i % cn];
      } else if constexpr (kMode != kNoGrad) {
        for (int i = tid; i < cn; i += nthr) {
          const int key = s_key[j0 + i];
          if (kMode == kNoSort && key == kKeyInvalid) continue;
          const int slot = key & 2047;
          const int w = window_of(s_win, p.w_max, slot);
          const int r = slot - s_win[4 * w];
          const int grow = s_win[4 * w + 3] + r;
          if (grow < 0 || grow >= r_rows) continue;
          flush_row(p, p.table + static_cast<size_t>(s_win[4 * w + 2] + r)
                           * p.w_pad,
                    p.out + static_cast<size_t>(grow) * p.slabw, s_acc + i,
                    sa, ox, oy);
        }
      }
      __syncthreads();   // shared buffers are rewritten by the next chunk
    }
    lt = acc_l + lt_in;
    s_prev += acc_wgf;
    if constexpr (kMode == kNoGrad) {
      // every row of the slab gets 1e-20 x the tile's sum of alpha_grad
      const float x[1] = {1e-20f * block_sum(ag_sum, s_acc, tid, nthr)};
      for (int w = 0; w < p.w_max; ++w) {
        const int ln = s_win[4 * w + 1];
        const int row0 = s_win[4 * w + 2], grow0 = s_win[4 * w + 3];
        for (int r = tid; r < ln; r += nthr) {
          const int grow = grow0 + r;
          if (grow < 0 || grow >= r_rows) continue;
          flush_row(p, p.table + static_cast<size_t>(row0 + r) * p.w_pad,
                    p.out + static_cast<size_t>(grow) * p.slabw, x, 0, ox,
                    oy);
        }
      }
      __syncthreads();
    }
  }
  if constexpr (kMode == kNoCopyback) {
    const float total = block_sum(acc_sum, s_acc, tid, nthr);
    if (tid == 0) atomicAdd(p.out, 1e-20f * total);
  }
}

// register instantiations: no launch bounds, so the compiler keeps its
// own register choice (blocks of up to 256 threads)
template <int MAXF, int V>
__global__ void stream_backward_kernel(Params p) {
  stream_backward_body<MAXF, V>(p);
}

// the profiling modes of <6, 16>
template <int kMode>
__global__ void stream_backward_profile_kernel(Params p) {
  stream_backward_body<6, 16, kMode>(p);
}

// the generic instantiation, for blocks of up to 1024 threads
template <int V>
__global__ void __launch_bounds__(1024)
stream_backward_generic_kernel(Params p) {
  stream_backward_body<0, V>(p);
}

// the instantiation that keeps `max_features` features in registers, or
// the generic one for 0; a profiling `mode`: <6, 16> only; null for any
// other value
const void* kernel_for(int max_features, int mode = kComposite) {
  if (mode != kComposite) {
    if (max_features != 6) return nullptr;
    switch (mode) {
      case kSkeleton: return (const void*)&stream_backward_profile_kernel<
          kSkeleton>;
      case kNoSort: return (const void*)&stream_backward_profile_kernel<
          kNoSort>;
      case kNoGrad: return (const void*)&stream_backward_profile_kernel<
          kNoGrad>;
      case kNoCopyback: return (const void*)&stream_backward_profile_kernel<
          kNoCopyback>;
      default: return nullptr;
    }
  }
  switch (max_features) {
    case 6: return (const void*)&stream_backward_kernel<6, 16>;
    case 22: return (const void*)&stream_backward_kernel<22, 32>;
    case 56: return (const void*)&stream_backward_kernel<56, 32>;
    case 0: return (const void*)&stream_backward_generic_kernel<16>;
    default: return nullptr;
  }
}

// The halo merge of band-sharded K2: adds the band received from the
// shard above (its bottom halo band) into this shard's first own band and
// the band received from the shard below (its top halo band) into its last
// own band, in place; a missing peer (null) adds nothing.  `n` is the
// floats of one band, `last` the offset of the last own band from the
// first (0 for a shard of one band, which takes both adds in the twin's
// order).  Bound by bytes: it reads four bands and writes two, one float a
// thread, neighbouring threads on neighbouring floats.
__global__ void __launch_bounds__(256)
halo_merge_kernel(float* own, const float* above, const float* below,
                  long long n, long long last) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) {
    if (last == 0) {
      float x = own[i];
      if (above != nullptr) x = x + above[i];
      if (below != nullptr) x = x + below[i];
      own[i] = x;
    } else {
      if (above != nullptr) own[i] = own[i] + above[i];
      if (below != nullptr) own[last + i] = own[last + i] + below[i];
    }
  }
}

constexpr int kMergeThreads = 256;

}  // namespace

// Dynamic shared memory of one block, in bytes: the slab's rank keys, per
// row of a chunk of `chunk` rows its coefficients and features and the
// [column][row] accumulator, window descriptors, and (generic
// instantiation, max_features 0) the image cotangent of every thread.
extern "C" long long tpu_splat_stream_backward_smem(int slab_cap, int chunk,
                                                    int w_max,
                                                    int feature_size,
                                                    int slabw,
                                                    int max_features,
                                                    int threads) {
  int sort_cap = 1;
  while (sort_cap < slab_cap) sort_cap <<= 1;
  return 4LL * (sort_cap
                + static_cast<long long>(kGeo + feature_size) * chunk
                + static_cast<long long>(slabw) * acc_stride(chunk)
                + 8 * w_max + 2
                + (max_features == 0
                       ? static_cast<long long>(feature_size) * threads : 0));
}

// {resident blocks per SM, registers, local bytes} of an instantiation.
extern "C" int tpu_splat_stream_backward_occupancy(int max_features,
                                                   int threads,
                                                   long long smem, int* out) {
  return kernel_occupancy(kernel_for(max_features), threads,
                          static_cast<size_t>(smem), out);
}

// Launch on `stream` the instantiation `max_features` (6, 22, 56, or 0:
// generic) with `threads` threads a block: the 10 + F gradient terms of a
// thread in batches of V slots.  `band0` is the absolute tile band of the
// mapping's first band; with `halo` 1 `out` holds (tiles_high + 2) bands of
// homes, a halo band above and below the mapping's own.  `mode`
// (kSkeleton, kNoSort, kNoGrad, kNoCopyback) selects a profiling mode of
// <6, 16>.  A block stages `chunk` rows of a slab at once (0 < chunk <=
// slab_cap).  Returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue where no instantiation matches or the chunk is out
// of range.
// `out` must be zero-initialised: the kernel only adds to it.
extern "C" int tpu_splat_stream_backward(
    const float* table, const int* desc, const int* strip_blk,
    const float* img, const float* gimg, float* out, int num_tiles,
    int tiles_wide, int group_width, int num_slabs, int w_max, int strip_cap,
    int slab_cap, int chunk, int rpb, int w_pad, int feature_size,
    int tile_size, int antialias, int run_cap, int slabw, int with_vis,
    int heur, int max_features, int threads, int band0, int halo, int mode,
    float alpha_threshold, float clamp_max_alpha, float lcut, void* stream) {
  Params p;
  p.table = table;
  p.desc = desc;
  p.strip_blk = strip_blk;
  p.img = img;
  p.gimg = gimg;
  p.out = out;
  p.num_tiles = num_tiles;
  p.tiles_wide = tiles_wide;
  p.group_width = group_width;
  p.num_slabs = num_slabs;
  p.w_max = w_max;
  p.strip_cap = strip_cap;
  p.slab_cap = slab_cap;
  p.sort_cap = 1;
  while (p.sort_cap < slab_cap) p.sort_cap <<= 1;
  p.chunk = chunk;
  p.rpb = rpb;
  p.w_pad = w_pad;
  p.f = feature_size;
  p.tile_size = tile_size;
  p.antialias = antialias;
  p.run_cap = run_cap;
  p.slabw = slabw;
  p.with_vis = with_vis;
  p.heur = heur;
  p.band0 = band0;
  p.halo = halo ? 1 : 0;
  p.alpha_threshold = alpha_threshold;
  p.clamp_max_alpha = clamp_max_alpha;
  p.lcut = lcut;
  if ((max_features > 0 && feature_size > max_features) || chunk <= 0
      || chunk > slab_cap)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(tpu_splat_stream_backward_smem(
      slab_cap, chunk, w_max, feature_size, slabw, max_features, threads));
  return launch_kernel(kernel_for(max_features, mode), p, num_tiles, threads,
                       smem, static_cast<cudaStream_t>(stream));
}

// {resident blocks per SM, registers, local bytes} of the halo merge.
extern "C" int tpu_splat_halo_merge_occupancy(int* out) {
  return kernel_occupancy((const void*)&halo_merge_kernel, kMergeThreads, 0,
                          out);
}

// Launch the halo merge on `stream` over bands of `band_floats` floats:
// `own` points at the first own band, `tiles_high` own bands follow it;
// `above` / `below` may be null.  Returns cudaGetLastError().
extern "C" int tpu_splat_halo_merge(float* own, const float* above,
                                    const float* below,
                                    long long band_floats, int tiles_high,
                                    void* stream) {
  if (band_floats <= 0 || tiles_high <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks =
      static_cast<int>((band_floats + kMergeThreads - 1) / kMergeThreads);
  halo_merge_kernel<<<blocks, kMergeThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      own, above, below, band_floats,
      static_cast<long long>(tiles_high - 1) * band_floats);
  return static_cast<int>(cudaGetLastError());
}
