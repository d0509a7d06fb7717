// Sorted-pipeline backward rasterization kernel for NVIDIA Hopper (sm_90a).
//
// Replaces: tpu_splatting/rasterizer/kernels.py:_backward_kernel (K5, the
// Pallas TPU kernel behind kernels.backward, blending mode).  It computes
// what that kernel computes: per tile it replays the forward's
// compositing chunk by chunk (the same alpha, threshold, clamp and freeze)
// and writes each overlap row's gradient row gout[k*g + r] =
// [d mean, d axis, d sigma, d alpha, d features(, prune_cost,
// split_score)].  The "remaining feature" trick keeps one running scalar
// per pixel, s = sum_c g_image * remaining, seeded at the tile's first
// chunk with sum_c g_image * image over the F+1 channels; then
// alpha_grad = (T * gf - s / (1 - a)) * mask with gf = f . g_image +
// g_alpha.  The geometry gradients go through the pixel moments of z0*u
// and z0*v (z0 = alpha_grad * pa * pdf), as the reference, or through the
// antialias closed forms; prune is sum (pa * alpha_grad)^2 and split sum
// |z0 d mean|.  Rows beyond a chunk's valid count and rows of saturated
// chunks stay zero (the caller zero-fills gout).
//
// What bounds it on this card: operations.  Every live (row, pixel) pair
// costs the forward's alpha, the gradient chain (four more exps in
// antialias mode) and its share of the warp reduction of 9 + F terms.
//
// Design: one block per tile, one thread per pixel (a tile that is not whole
// warps runs in the generic instantiation, padded with frozen lanes:
// kernel_common.cuh), the tile's chunks in order with the log transmittance
// and s in registers across chunks.  Each chunk's rows become per-row
// coefficients in shared memory (alpha's six and the linear forms of u and
// v), and every thread walks the rows in order.  For each row each warp
// reduces its 32 pixels' terms with a reduce-scatter (a transposed
// butterfly, as the stream backward does): a thread's terms sit in V slots —
// the 7 geometry moments, prune, split, then the features, in further
// batches of V past V - 9 — and at each butterfly offset a lane sends its
// partner the half of its slots the partner keeps.  That is V/2 + V/4 + ...
// shuffles a batch (16 at V = 16: the headline's 12 terms), after which each
// lane holds one slot's warp sum and the lanes that own a column add it to
// one shared [column][row] accumulator in a single atomicAdd instruction.
// Warps with no live pixel for a row skip the reduction (its terms are
// exactly zero).  After the chunk one thread per row reads its row's column
// sums, turns the moments into the row's gradients and writes the row to its
// own slot of gout.  The shared atomics make the sum order over the warps
// vary from run to run (a few ulps).  The transmittance and s use the
// association of the plain twin's cumsums (carry + sequential sum), so
// freeze decisions agree bit for bit.
//
// Instantiations <most features, V>: <7, 16>, <23, 32> and <56, 32> keep a
// pixel's image cotangent in registers; sorted_backward_generic_kernel<16>
// (V = 16) keeps it in shared memory ([feature][thread]) and takes any F
// and any tile up to 1024 pixels.  The wrapper (rasterizer/kernels.py,
// sorted_backward_plan) picks one and the C entry launches it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_common.cuh"

namespace {

constexpr int kGeo = 13;         // per-row coefficients in shared memory
constexpr int kLead = 9;         // slots before the features

struct Params {
  const float* rows;     // (M, width): [mean, axis, sigma, alpha, F]
  const int* src;        // (K,)
  const int* cnt;        // (K,)
  const int* first;      // (T+1,)
  const float* image;    // (T+1, F+1, tile_area)
  const float* gimage;   // (T+1, F+1, tile_area)
  float* gout;           // (K*g, out_w), zero-filled by the caller
  int tiles_wide, width, f, g, tile_size, antialias, heur, out_w;
  float alpha_threshold, clamp_max_alpha, lcut;
};

__device__ __forceinline__ float s_sig(float x, float s) {
  float z = x / s;
  return 1.0f / (1.0f + expf(-1.6f * z - 0.07f * z * z * z));
}

// s_grads of the reference's _antialias_grads: (s, d s/dx, d s/d sigma)
__device__ __forceinline__ void s_grads(float x, float sig, float& s_val,
                                        float& d_dx, float& d_ds) {
  const float z = x / sig;
  s_val = 1.0f / (1.0f + expf(-1.6f * z - 0.07f * z * z * z));
  const float ds_dx = (1.6f + 0.21f * z * z) * s_val * (1.0f - s_val);
  d_dx = ds_dx / sig;
  d_ds = d_dx * -z;
}

// gout column of reduction slot k (7 moments, prune, split, features), or
// -1 where the slot holds no column
__device__ __forceinline__ int slot_column(int k, int f, int heur) {
  if (k < 7) return k;
  if (k < kLead) return heur ? f + k : -1;
  return k - kLead < f ? 7 + k - kLead : -1;
}

template <int MAXF, int V>
__device__ __forceinline__ void sorted_backward_body(const Params& p) {
  constexpr bool kRegs = MAXF > 0;      // image cotangent in registers
  constexpr int NB = (kLead + (kRegs ? MAXF : 0) + V - 1) / V;
  extern __shared__ __align__(16) float smem[];
  const int g = p.g;
  const int ncol = p.out_w;
  const int sa = acc_stride(g);
  float* s_geo = smem;                       // kGeo * g
  float* s_feat = s_geo + kGeo * g;          // f * g
  float* s_acc = s_feat + p.f * g;           // [column][row], stride sa
  float* s_gim = s_acc + ncol * sa;          // generic: [feature][thread]

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int lane = tid & 31;
  const int ts = p.tile_size;
  const int pix = ts * ts;
  // register instantiations run whole-warp tiles only; the generic one
  // pads a tile to whole warps (kernel_common.cuh)
  const bool inside = kRegs || tid < pix;
  const int f = p.f;
  const float ox = static_cast<float>((tile % p.tiles_wide) * ts);
  const float oy = static_cast<float>((tile / p.tiles_wide) * ts);
  const float px = static_cast<float>(tid % ts) + 0.5f;
  const float py = static_cast<float>(tid / ts) + 0.5f;
  const float pxx = px * px, pxy = px * py, pyy = py * py;
  const float tau = 6.283185307179586f;

  // the gout column this lane adds after each batch's reduction, or -1
  int dst[kRegs ? NB : 1];
  if constexpr (kRegs) {
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const int slot = scatter_slot<V>(lane);
      dst[b] = slot < 0 ? -1 : slot_column(b * V + slot, f, p.heur);
    }
  }

  // this pixel's image cotangent (F+1 channels) and s at the first chunk
  float gim[kRegs ? MAXF : 1];
  const size_t base = static_cast<size_t>(tile) * (f + 1) * pix + tid;
  float s_in = 0.0f, g_alpha = 0.0f;
  if constexpr (kRegs) {
#pragma unroll
    for (int c = 0; c < MAXF; ++c) {
      gim[c] = 0.0f;
      if (c < f && inside) {
        gim[c] = p.gimage[base + static_cast<size_t>(c) * pix];
        s_in += gim[c] * p.image[base + static_cast<size_t>(c) * pix];
      }
    }
  } else {
    for (int c = 0; c < f; ++c) {
      float gc = 0.0f;
      if (inside) {
        gc = p.gimage[base + static_cast<size_t>(c) * pix];
        s_in += gc * p.image[base + static_cast<size_t>(c) * pix];
      }
      s_gim[c * nthr + tid] = gc;
    }
  }
  if (inside) {
    g_alpha = p.gimage[base + static_cast<size_t>(f) * pix];
    s_in += g_alpha * p.image[base + static_cast<size_t>(f) * pix];
  }
  float lt = inside ? 0.0f : frozen_lt();

  const int k0 = p.first[tile], k1 = p.first[tile + 1];
  for (int k = k0; k < k1; ++k) {
    if (k > k0 && __syncthreads_and(lt <= p.lcut)) break;
    const int cnt = p.cnt[k];
    const float* rows = p.rows + static_cast<size_t>(p.src[k]) * p.width;
    for (int r = tid; r < cnt; r += nthr) {
      const float* row = rows + static_cast<size_t>(r) * p.width;
      const float mlx = row[0] - ox, mly = row[1] - oy;
      const float ax = row[2], ay = row[3];
      const float sx = row[4], sy = row[5], pa = row[6];
      float* geo = s_geo + r;
      if (p.antialias) {
        geo[0] = ax;
        geo[1 * g] = ay;
        geo[2 * g] = -(mlx * ax + mly * ay);
        geo[3 * g] = mlx * ay - mly * ax;
        geo[4 * g] = sx;
        geo[5 * g] = sy;
        geo[6 * g] = pa;
        geo[7 * g] = mlx;
        geo[8 * g] = mly;
      } else {
        const float isx2 = 1.0f / fmaxf(sx * sx, 1e-24f);
        const float isy2 = 1.0f / fmaxf(sy * sy, 1e-24f);
        const float a2 = ax * ax, b2 = ay * ay;
        const float cxx = -0.5f * (a2 * isx2 + b2 * isy2);
        const float cyy = -0.5f * (b2 * isx2 + a2 * isy2);
        const float cxy = -(ax * ay * (isx2 - isy2));
        geo[0] = cxx;
        geo[1 * g] = cxy;
        geo[2 * g] = cyy;
        geo[3 * g] = -(2.0f * cxx * mlx + cxy * mly);
        geo[4 * g] = -(2.0f * cyy * mly + cxy * mlx);
        geo[5 * g] = cxx * mlx * mlx + cxy * mlx * mly + cyy * mly * mly
                     + logf(fmaxf(pa, 1e-30f));
        const float isx = 1.0f / fmaxf(sx, 1e-12f);
        const float isy = 1.0f / fmaxf(sy, 1e-12f);
        geo[6 * g] = ax * isx;                       // u's linear form
        geo[7 * g] = ay * isx;
        geo[8 * g] = -(mlx * ax + mly * ay) * isx;
        geo[9 * g] = -ay * isy;                      // v's linear form
        geo[10 * g] = ax * isy;
        geo[11 * g] = (mlx * ay - mly * ax) * isy;
        geo[12 * g] = pa;
      }
      for (int c = 0; c < f; ++c) s_feat[c * g + r] = row[7 + c];
    }
    for (int i = tid; i < ncol * sa; i += nthr) s_acc[i] = 0.0f;
    __syncthreads();

    const float lt_in = lt;
    float acc_l = 0.0f;     // sequential sum of log1p(-a) of this chunk
    float acc_s = 0.0f;     // sequential sum of w * gf of this chunk
    bool done = lt <= p.lcut;
    for (int j = 0; j < cnt; ++j) {
      if ((j & 31) == 0 && __syncthreads_and(done)) break;
      const float* geo = s_geo + j;
      float a_raw, tu = 0.0f, tv = 0.0f;
      if (p.antialias) {
        const float ax = geo[0], ay = geo[1 * g];
        const float sx = geo[4 * g], sy = geo[5 * g];
        tu = ax * px + ay * py + geo[2 * g];
        tv = -ay * px + ax * py + geo[3 * g];
        const float ix = sx * (s_sig(tu + 0.5f, sx) - s_sig(tu - 0.5f, sx));
        const float iy = sy * (s_sig(tv + 0.5f, sy) - s_sig(tv - 0.5f, sy));
        a_raw = geo[6 * g] * (tau * ix * iy);
      } else {
        a_raw = expf(geo[0] * pxx + geo[1 * g] * pxy + geo[2 * g] * pyy
                     + geo[3 * g] * px + geo[4 * g] * py + geo[5 * g]);
      }
      const float a = a_raw > p.alpha_threshold
                          ? fminf(a_raw, p.clamp_max_alpha) : 0.0f;
      const float lt_j = acc_l + lt_in;
      const bool unfrozen = lt_j > p.lcut;
      const bool live = unfrozen && a > 0.0f;
      float w = 0.0f, alpha_grad = 0.0f;
      if (live) {
        const float t = expf(lt_j);
        w = a * t;
        float gf = 0.0f;
        if constexpr (kRegs) {
#pragma unroll
          for (int c = 0; c < MAXF; ++c)
            if (c < f) gf += s_feat[c * g + j] * gim[c];
        } else {
          for (int c = 0; c < f; ++c)
            gf += s_feat[c * g + j] * s_gim[c * nthr + tid];
        }
        gf += g_alpha;
        acc_s += w * gf;
        const float s_i = s_in - acc_s;   // inclusive of this row
        alpha_grad = t * gf - s_i / (1.0f - a);
      }
      if (unfrozen) acc_l += log1pf(-a);
      done = acc_l + lt_in <= p.lcut;

      if (!__any_sync(kFull, live)) continue;   // every term is zero

      // slots 0-6 the geometry moments, 7 prune, 8 split
      float lead[kLead];
      const float clamp_live = a_raw < p.clamp_max_alpha ? 1.0f : 0.0f;
      const float z0 = live ? alpha_grad * clamp_live * a_raw : 0.0f;
      const float pa = p.antialias ? geo[6 * g] : geo[12 * g];
      float split = 0.0f;
      if (p.antialias) {
        float dmx = 0.0f, dmy = 0.0f, dax = 0.0f, day = 0.0f, dsx = 0.0f,
              dsy = 0.0f;
        const float aag = pa * alpha_grad * clamp_live;
        if (live) {
          const float ax = geo[0], ay = geo[1 * g];
          const float sx = fmaxf(geo[4 * g], 1e-12f);
          const float sy = fmaxf(geo[5 * g], 1e-12f);
          const float dx = px - geo[7 * g], dy = py - geo[8 * g];
          float sx1, dx1, dx1s, sx2, dx2, dx2s, sy1, dy1, dy1s, sy2, dy2,
              dy2s;
          s_grads(tu + 0.5f, sx, sx1, dx1, dx1s);
          s_grads(tu - 0.5f, sx, sx2, dx2, dx2s);
          s_grads(tv + 0.5f, sy, sy1, dy1, dy1s);
          s_grads(tv - 0.5f, sy, sy2, dy2, dy2s);
          const float ix = sx * (sx1 - sx2);
          const float iy = sy * (sy1 - sy2);
          const float dsx_t = iy * sx * (dx1 - dx2);
          const float dsy_t = ix * sy * (dy1 - dy2);
          dmx = aag * (tau * (-dsx_t * ax + dsy_t * ay));
          dmy = aag * (tau * (-dsx_t * ay - dsy_t * ax));
          dax = aag * (tau * (dsx_t * dx + dsy_t * dy));
          day = aag * (tau * (dsx_t * dy - dsy_t * dx));
          dsx = aag * (tau * iy * (sx1 - sx2 + (dx1s - dx2s) * sx));
          dsy = aag * (tau * ix * (sy1 - sy2 + (dy1s - dy2s) * sy));
          split = fabsf(dmx) + fabsf(dmy);
        }
        lead[0] = dmx;
        lead[1] = dmy;
        lead[2] = dax;
        lead[3] = day;
        lead[4] = dsx;
        lead[5] = dsy;
      } else {
        const float u = geo[6 * g] * px + geo[7 * g] * py + geo[8 * g];
        const float v = geo[9 * g] * px + geo[10 * g] * py + geo[11 * g];
        const float zu = z0 * u, zv = z0 * v;
        lead[0] = zu * px;
        lead[1] = zu * py;
        lead[2] = zu;
        lead[3] = zv * px;
        lead[4] = zv * py;
        lead[5] = zv;
        if (p.heur) {
          // d mean / d pdf per pixel: u isx ax - v isy ay, u isx ay + v isy ax
          const float dmx_u = u * geo[6 * g] + v * geo[9 * g];
          const float dmy_u = u * geo[7 * g] + v * geo[10 * g];
          split = fabsf(z0 * dmx_u) + fabsf(z0 * dmy_u);
        }
      }
      lead[6] = z0;
      const float aag_h = pa * alpha_grad;
      lead[7] = aag_h * aag_h;
      lead[8] = split;

      // the features' terms are w * g_image; reduce in batches of V
      float* acc = s_acc + j;
      auto batch = [&](int b) {
        float v[V];
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const int c = b * V + i - kLead;   // feature of the slot
          float x = 0.0f;
          if (b == 0 && i < kLead) {
            x = lead[i < kLead ? i : 0];
          } else if constexpr (kRegs) {
            if (c < MAXF) x = w * gim[c >= 0 && c < MAXF ? c : 0];
          } else {
            if (c < f) x = w * s_gim[c * nthr + tid];
          }
          v[i] = x;
        }
        const float x = reduce_scatter<V>(v, lane);
        int col;
        if constexpr (kRegs) {
          col = dst[b];
        } else {
          const int slot = scatter_slot<V>(lane);
          col = slot < 0 ? -1 : slot_column(b * V + slot, f, p.heur);
        }
        if (col >= 0 && x != 0.0f) atomicAdd(acc + col * sa, x);
      };
      if constexpr (kRegs) {
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          if (b > 0 && b * V >= kLead + f) break;
          batch(b);
        }
      } else {
        for (int b = 0; b * V < kLead + f; ++b) batch(b);
      }
    }
    lt = acc_l + lt_in;
    s_in = s_in - acc_s;
    __syncthreads();

    // one thread per row: its column sums, moments -> gradients
    for (int r = tid; r < cnt; r += nthr) {
      const float* m = s_acc + r;
      const float* row = rows + static_cast<size_t>(r) * p.width;
      float* out = p.gout + (static_cast<size_t>(k) * g + r) * ncol;
      if (p.antialias) {
        for (int c = 0; c < 6; ++c) out[c] = m[c * sa];
      } else {
        const float mlx = row[0] - ox, mly = row[1] - oy;
        const float ax = row[2], ay = row[3];
        const float isx = 1.0f / fmaxf(row[4], 1e-12f);
        const float isy = 1.0f / fmaxf(row[5], 1e-12f);
        const float su_px = m[0], su_py = m[1 * sa], su = m[2 * sa];
        const float sv_px = m[3 * sa], sv_py = m[4 * sa], sv = m[5 * sa];
        const float su_dx = su_px - mlx * su, su_dy = su_py - mly * su;
        const float sv_dx = sv_px - mlx * sv, sv_dy = sv_py - mly * sv;
        const float* geo = s_geo + r;
        const float suu = geo[6 * g] * su_px + geo[7 * g] * su_py
                          + geo[8 * g] * su;
        const float svv = geo[9 * g] * sv_px + geo[10 * g] * sv_py
                          + geo[11 * g] * sv;
        out[0] = ax * isx * su - ay * isy * sv;
        out[1] = ay * isx * su + ax * isy * sv;
        out[2] = -isx * su_dx - isy * sv_dy;
        out[3] = -isx * su_dy + isy * sv_dx;
        out[4] = isx * suu;
        out[5] = isy * svv;
      }
      out[6] = m[6 * sa] / fmaxf(row[6], 1e-20f);
      for (int c = 7; c < ncol; ++c) out[c] = m[c * sa];
    }
    __syncthreads();   // shared buffers are rewritten by the next chunk
  }
}

// register instantiations, for blocks of up to 256 threads; the
// headline's <7, 16> is held to 64 registers (4 blocks an SM)
template <int MAXF, int V>
__global__ void __launch_bounds__(256, MAXF <= 7 ? 4 : 1)
sorted_backward_kernel(Params p) {
  sorted_backward_body<MAXF, V>(p);
}

// the generic instantiation, for blocks of up to 1024 threads
template <int V>
__global__ void __launch_bounds__(1024)
sorted_backward_generic_kernel(Params p) {
  sorted_backward_body<0, V>(p);
}

// the instantiation that keeps `max_features` features in registers, or
// the generic one for 0; null for any other value
const void* kernel_for(int max_features) {
  switch (max_features) {
    case 7: return (const void*)&sorted_backward_kernel<7, 16>;
    case 23: return (const void*)&sorted_backward_kernel<23, 32>;
    case 56: return (const void*)&sorted_backward_kernel<56, 32>;
    case 0: return (const void*)&sorted_backward_generic_kernel<16>;
    default: return nullptr;
  }
}

}  // namespace

// Dynamic shared memory of one block, in bytes: per-row coefficients and
// features, the [column][row] accumulator, and (generic instantiation,
// max_features 0) the image cotangent of every thread.
extern "C" long long tpu_splat_sorted_backward_smem(int chunk_size,
                                                    int feature_size,
                                                    int out_width,
                                                    int max_features,
                                                    int threads) {
  return 4LL * (static_cast<long long>(chunk_size) * (kGeo + feature_size)
                + static_cast<long long>(out_width) * acc_stride(chunk_size)
                + (max_features == 0
                       ? static_cast<long long>(feature_size) * threads : 0));
}

// {resident blocks per SM, registers, local bytes} of an instantiation.
extern "C" int tpu_splat_sorted_backward_occupancy(int max_features,
                                                   int threads,
                                                   long long smem, int* out) {
  return kernel_occupancy(kernel_for(max_features), threads,
                          static_cast<size_t>(smem), out);
}

// Launch the instantiation `max_features` (7, 23, 56, or 0: generic) with
// `threads` threads a block on `stream`; returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue where no instantiation matches.
extern "C" int tpu_splat_sorted_backward(
    const float* rows, const int* src, const int* cnt, const int* first,
    const float* image, const float* gimage, float* gout, int num_tiles,
    int tiles_wide, int width, int feature_size, int chunk_size,
    int tile_size, int antialias, int heur, int max_features, int threads,
    float alpha_threshold, float clamp_max_alpha, float lcut, void* stream) {
  Params p;
  p.rows = rows;
  p.src = src;
  p.cnt = cnt;
  p.first = first;
  p.image = image;
  p.gimage = gimage;
  p.gout = gout;
  p.tiles_wide = tiles_wide;
  p.width = width;
  p.f = feature_size;
  p.g = chunk_size;
  p.tile_size = tile_size;
  p.antialias = antialias;
  p.heur = heur;
  p.out_w = 7 + feature_size + (heur ? 2 : 0);
  p.alpha_threshold = alpha_threshold;
  p.clamp_max_alpha = clamp_max_alpha;
  p.lcut = lcut;
  if (max_features > 0 && feature_size > max_features)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(tpu_splat_sorted_backward_smem(
      chunk_size, feature_size, p.out_w, max_features, threads));
  return launch_kernel(kernel_for(max_features), p, num_tiles, threads, smem,
                       static_cast<cudaStream_t>(stream));
}
