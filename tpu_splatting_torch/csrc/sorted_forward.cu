// Sorted-pipeline forward rasterization kernel for NVIDIA Hopper (sm_90a).
//
// Replaces: tpu_splatting/rasterizer/kernels.py:_forward_kernel (K4, the
// Pallas TPU kernel behind kernels.forward).  It computes what that kernel
// computes: per tile, its chunks of depth-sorted overlap rows
// (rows[src[k] + r], r < cnt[k]) front to back; alpha at every pixel (the
// quadratic form with log(point alpha) folded in, or the antialiased pixel
// integral), threshold and clamp; compositing in log-transmittance space
// with the saturation freeze carried across chunks; the alpha channel as
// the sum of weights; quantile (median) mode, which selects the features
// of the first row whose transmittance crosses saturate_threshold and
// never freezes; and per-row visibility, the sum over the tile's pixels of
// the row's weight.  None of the TPU mechanics are carried over (the
// triangular-matmul scan, the two-block window fetch, bf16 feature passes).
//
// What bounds it on this card: operations.  Every (row, pixel) pair of a
// tile costs one exp (quadratic) or four (antialias), the weight, the
// feature updates and, with visibility, a warp reduction of the weight;
// the rows themselves are read once per tile (7 + F floats each).
//
// Design: one block per tile, one thread per pixel.  For each of the
// tile's chunks the block turns the chunk's rows into per-row alpha
// coefficients in shared memory (once per row, not once per pixel), then
// every thread walks the rows in order with its log transmittance in a
// register, carried from chunk to chunk.  The transmittance is the carry
// plus the sequential sum of the chunk's log1p(-a), the association of
// the plain twin's exclusive cumsum, so threshold and freeze decisions
// agree bit for bit.  A block stops walking once every pixel is frozen
// (__syncthreads_and every 32 rows) and skips the tile's remaining chunks,
// except in quantile mode, as the reference does.  Visibility: each warp
// reduces a row's weight with shuffles (only where a lane has one) into a
// per-warp partial in shared memory, summed over the warps in a fixed
// order after the chunk, so the result is deterministic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGeo = 7;          // per-row alpha coefficients in shared memory
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const float* rows;   // (M, width) row-major: [mean, axis, sigma, alpha, F]
  const int* src;      // (K,) first row of each chunk's window
  const int* cnt;      // (K,) valid rows of each chunk
  const int* first;    // (T+1,) tile t owns chunks [first[t], first[t+1])
  float* image;        // (T+1, F+1, tile_area); row T is left to the caller
  float* vis;          // (K*g,) zero-filled by the caller, or null
  int tiles_wide, width, f, g, tile_size, antialias, blending;
  float alpha_threshold, clamp_max_alpha, lcut, quantile_thr;
};

__device__ __forceinline__ float s_sig(float x, float s) {
  float z = x / s;
  return 1.0f / (1.0f + expf(-1.6f * z - 0.07f * z * z * z));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <int MAXF>
__global__ void sorted_forward_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  float* s_geo = smem;                       // kGeo * g
  float* s_feat = s_geo + kGeo * p.g;        // f * g
  float* s_part = s_feat + p.f * p.g;        // nwarps * g

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const int ts = p.tile_size;
  const int g = p.g;
  const float ox = static_cast<float>((tile % p.tiles_wide) * ts);
  const float oy = static_cast<float>((tile / p.tiles_wide) * ts);
  // tile-local pixel centre (the reference's basis)
  const float px = static_cast<float>(tid % ts) + 0.5f;
  const float py = static_cast<float>(tid / ts) + 0.5f;
  const float pxx = px * px, pxy = px * py, pyy = py * py;
  const bool with_vis = p.vis != nullptr;

  float acc[MAXF];
#pragma unroll
  for (int c = 0; c < MAXF; ++c) acc[c] = 0.0f;
  float acc_w = 0.0f;
  float lt = 0.0f;          // log transmittance, carried across chunks

  const int k0 = p.first[tile], k1 = p.first[tile + 1];
  for (int k = k0; k < k1; ++k) {
    // every pixel frozen: the remaining chunks contribute exactly nothing
    if (p.blending && k > k0 && __syncthreads_and(lt <= p.lcut)) break;
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
      }
      for (int c = 0; c < p.f; ++c) s_feat[c * g + r] = row[7 + c];
    }
    if (with_vis)
      for (int i = tid; i < nwarps * g; i += nthr) s_part[i] = 0.0f;
    __syncthreads();

    const float lt_in = lt;
    float acc_l = 0.0f;
    bool done = p.blending && lt <= p.lcut;
    for (int j = 0; j < cnt; ++j) {
      if (p.blending && (j & 31) == 0 && __syncthreads_and(done)) break;
      const float* geo = s_geo + j;
      float a_raw;
      if (p.antialias) {
        const float ax = geo[0], ay = geo[1 * g];
        const float sx = geo[4 * g], sy = geo[5 * g];
        const float tu = ax * px + ay * py + geo[2 * g];
        const float tv = -ay * px + ax * py + geo[3 * g];
        const float ix = sx * (s_sig(tu + 0.5f, sx) - s_sig(tu - 0.5f, sx));
        const float iy = sy * (s_sig(tv + 0.5f, sy) - s_sig(tv - 0.5f, sy));
        a_raw = geo[6 * g] * (6.283185307179586f * ix * iy);
      } else {
        a_raw = expf(geo[0] * pxx + geo[1 * g] * pxy + geo[2 * g] * pyy
                     + geo[3 * g] * px + geo[4 * g] * py + geo[5 * g]);
      }
      const float a = a_raw > p.alpha_threshold
                          ? fminf(a_raw, p.clamp_max_alpha) : 0.0f;
      const float lt_j = acc_l + lt_in;
      float wgt = 0.0f;
      if (p.blending) {
        if (lt_j > p.lcut) {
          wgt = a * expf(lt_j);
#pragma unroll
          for (int c = 0; c < MAXF; ++c)
            if (c < p.f) acc[c] += wgt * s_feat[c * g + j];
          acc_w += wgt;
          acc_l += log1pf(-a);
        }
        done = acc_l + lt_in <= p.lcut;
      } else {
        const float t = expf(lt_j);
        if (t * (1.0f - a) <= p.quantile_thr && t > p.quantile_thr) {
#pragma unroll
          for (int c = 0; c < MAXF; ++c)
            if (c < p.f) acc[c] += s_feat[c * g + j];
        }
        wgt = a * t;
        acc_l += log1pf(-a);
      }
      if (with_vis && __any_sync(kFull, wgt != 0.0f)) {
        const float s = warp_sum(wgt);
        if (lane == 0) s_part[warp * g + j] = s;
      }
    }
    lt = acc_l + lt_in;
    if (with_vis) {
      __syncthreads();
      float* vis = p.vis + static_cast<size_t>(k) * g;
      for (int r = tid; r < cnt; r += nthr) {
        float s = 0.0f;
        for (int w = 0; w < nwarps; ++w) s += s_part[w * g + r];
        vis[r] = s;
      }
    }
    __syncthreads();   // shared buffers are rewritten by the next chunk
  }

  const int pix = ts * ts;
  float* o = p.image + static_cast<size_t>(tile) * (p.f + 1) * pix + tid;
#pragma unroll
  for (int c = 0; c < MAXF; ++c)
    if (c < p.f) o[c * pix] = acc[c];
  o[p.f * pix] = p.blending ? acc_w : (lt < 0.0f ? 1.0f : 0.0f);
}

template <int MAXF>
int launch(const Params& p, int num_tiles, size_t smem, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      sorted_forward_kernel<MAXF>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  sorted_forward_kernel<MAXF><<<num_tiles, p.tile_size * p.tile_size, smem,
                                st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory of one block, in bytes.
extern "C" long long tpu_splat_sorted_forward_smem(int chunk_size,
                                                   int feature_size,
                                                   int num_warps) {
  return 4LL * chunk_size * (kGeo + feature_size + num_warps);
}

// Launch on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int tpu_splat_sorted_forward(
    const float* rows, const int* src, const int* cnt, const int* first,
    float* image, float* vis, int num_tiles, int tiles_wide, int width,
    int feature_size, int chunk_size, int tile_size, int antialias,
    int blending, float alpha_threshold, float clamp_max_alpha, float lcut,
    float quantile_thr, void* stream) {
  Params p;
  p.rows = rows;
  p.src = src;
  p.cnt = cnt;
  p.first = first;
  p.image = image;
  p.vis = vis;
  p.tiles_wide = tiles_wide;
  p.width = width;
  p.f = feature_size;
  p.g = chunk_size;
  p.tile_size = tile_size;
  p.antialias = antialias;
  p.blending = blending;
  p.alpha_threshold = alpha_threshold;
  p.clamp_max_alpha = clamp_max_alpha;
  p.lcut = lcut;
  p.quantile_thr = quantile_thr;
  const size_t smem = static_cast<size_t>(tpu_splat_sorted_forward_smem(
      chunk_size, feature_size, tile_size * tile_size / 32));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (feature_size <= 8) return launch<8>(p, num_tiles, smem, st);
  if (feature_size <= 24) return launch<24>(p, num_tiles, smem, st);
  return launch<56>(p, num_tiles, smem, st);
}
