// Window descriptors of the tile-stream mapping for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference builds the descriptors with XLA
// ops (tpu_splatting/rasterizer/stream.py, stream_map's desc_pipeline,
// mapped over group chunks).  Its plain-torch counterpart,
// rasterizer/stream.py:_desc_pipeline, ran on the card as ~400 small ops
// and 3 host syncs per chunk of groups: at 2M heavy splats (32 slabs, 7
// chunks) 2,764 launches, 21 syncs and ~27 ms of device time.  This kernel
// computes the same outputs bit for bit in one launch:
//   desc (G, gw*S*w_max*4) int32: per (tile in group, slab) w_max slots
//     [lo_flat, len, gbuf_dst, class b*3+k], nonempty first, zeros after;
//   over (4,) int64: rows dropped by [run, chunk, window, slab] clamps.
// Its twin is stream.py:stream_descriptors_reference (the band-local edge
// slices, then _desc_pipeline over group chunks).
//
// What bounds it on this card: bytes.  It writes the descriptor table
// (365 MB at the heavy 2M mapping) and reads the cell-edge table (one
// int64 per (home, class, cell); each group reads its three band strips,
// neighbours overlap, so most re-reads hit L2).  The arithmetic is a few
// hundred integer instructions a (tile, slab).
//
// Design: one block per tile group, one warp per tile (at most 8 warps, a
// warp taking tiles i, i + 8, ... of a wider group; three blocks an SM at
// the heavy mapping's 72 KB of shared memory, so at most 85 registers).
//   1. The block stages the group's three band strips of cell edges into
//      shared memory as int32, relative to the strip's block and clamped to
//      [0, 2 * strip_cap] (stream.py's band mask and clamp): homes x0-1 ..
//      x0+gw of each band, 16 classes x S cells each, and one end edge.
//   2. Lane s sums cell s's rows over the 64 fetch windows whose home lies
//      in the image; lane 0 replays the greedy slab plan over the S cells
//      (0, the cut cells in order, then S).
//   3. Per slab each lane holds windows 2*lane and 2*lane+1 (key order) and
//      takes their edge span, the abutting-window merge as a segmented warp
//      scan (a chain's rows and its start's prefix), the run-cap clamp,
//      the split into pieces of at most STRIP_SLACK - rpb rows (or, for
//      the unbounded slab_cap > 2048 of calibration, one clamped piece),
//      and scatters its pieces to the slots given by a warp prefix sum over
//      pieces, clipped at w_max.  Every slot is written, empty ones as
//      zeros, so the output needs no fill.  A slab whose plan range is
//      empty is all zeros.
//   4. The slot row's quantized slab accounting (the rpb-aligned cursor)
//      is a warp prefix sum over the slots; then the row (w_max int4) is
//      stored, coalesced.
//   Overflow sums are integer atomics (exact in any order), one per
//   nonzero count and warp.
// Exactness: every operand of a division or modulo is non-negative (C
// truncation then equals torch's floor), or the divisor is rpb, a power of
// two, taken by mask.  Values the twin holds in int64 that can leave int32
// at calibration's 1 << 27 capacities (gbuf_dst, lo_flat, the prefix sums)
// are computed in 64 bits and cast to int32 at the store, as the twin's
// desc.to(torch.int32) wraps them.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "kernel_common.cuh"

namespace {

constexpr int kWindows = 64;
constexpr int kStripSlack = 512;   // stream.py STRIP_SLACK
constexpr int kMaxWarps = 8;       // warps a block

// The 64 fetch windows (band b, home k, ycls, xcls) in key order, as
// stream.py's _WLIST builds them from CLASS_RANGES; each packed as
// b | k << 2 | (ycls * 4 + xcls) << 4.
struct WindowTable {
  int code[kWindows];
};

constexpr WindowTable window_table() {
  constexpr int lo[3] = {1, 0, 2};   // CLASS_RANGES
  constexpr int hi[3] = {3, 4, 4};
  WindowTable t{};
  int n = 0;
  for (int b = 0; b < 3; ++b)
    for (int k = 0; k < 3; ++k)
      for (int yc = lo[b]; yc < hi[b]; ++yc)
        for (int xc = lo[k]; xc < hi[k]; ++xc)
          t.code[n++] = b | k << 2 | (yc * 4 + xc) << 4;
  return t;
}

__constant__ WindowTable kWin = window_table();

__device__ __forceinline__ int win_b(int code) { return code & 3; }
__device__ __forceinline__ int win_k(int code) { return (code >> 2) & 3; }
__device__ __forceinline__ int win_c0(int code) { return code >> 4; }

struct Params {
  const long long* edges;       // (k_tot + 1,) cell edges of the sorted rows
  const long long* strip_blk;   // (G, 3) strip_cap-block of each band strip
  int* desc;                    // (G, gw * S * w_max * 4)
  unsigned long long* over;     // (4,) zeroed: run, chunk, window, slab
  long long k_tot;              // num_tiles * 16 * S
  long long strip_cap, slab_cap, run_cap;
  int tiles_wide, tiles_high, group_width, groups_x, num_slabs, w_max, rpb;
  int per_home;                 // 16 * S
  int lw;                       // (gw + 2) * 16 * S + 1: a band strip
};

template <typename T>
__device__ __forceinline__ T warp_inclusive_sum(T v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T u = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

__device__ __forceinline__ long long warp_inclusive_max(long long v,
                                                        int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long u = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v = max(v, u);
  }
  return v;
}

__device__ __forceinline__ long long warp_total(long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__global__ void __launch_bounds__(kMaxWarps * 32, 3)
    stream_descriptors_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int S = p.num_slabs;
  const int W = p.w_max;
  int4* rows = reinterpret_cast<int4*>(smem);
  long long* counts_all = reinterpret_cast<long long*>(rows + warps * W);
  int* slice = reinterpret_cast<int*>(counts_all + warps * S);
  int4* row = rows + warp * W;
  long long* counts = counts_all + warp * S;
  int* plan = slice + 3 * p.lw + warp * (S + 1);

  const int g = blockIdx.x;
  const int gy = g / p.groups_x;
  const int gx = (g - gy * p.groups_x) * p.group_width;

  // 1. the group's band strips: entry r of band b is cell r % per_home of
  // home x0 - 1 + r / per_home (clamped to the band's row; the last entry,
  // home x0 + gw + 1, is the strip's end edge)
  for (int e = threadIdx.x; e < 3 * p.lw; e += blockDim.x) {
    const int b = e / p.lw;
    const int r = e - b * p.lw;
    const int band = gy + b - 1;
    int v = 0;
    if (band >= 0 && band < p.tiles_high) {
      const int h = r / p.per_home;
      const int hx = min(max(gx - 1 + h, 0), p.tiles_wide);
      const long long idx = min(
          (static_cast<long long>(band) * p.tiles_wide + hx) * p.per_home +
              (r - h * p.per_home),
          p.k_tot);
      const long long x = p.edges[idx] - p.strip_blk[3 * g + b] * p.strip_cap;
      v = static_cast<int>(min(max(x, 0LL), 2 * p.strip_cap));
    }
    slice[e] = v;
  }
  __syncthreads();

  const int code[2] = {kWin.code[2 * lane], kWin.code[2 * lane + 1]};
  const int bk_prev = lane > 0 ? win_b(kWin.code[2 * lane - 1]) * 3 +
                                     win_k(kWin.code[2 * lane - 1])
                               : -1;
  const long long stride = 2 * p.strip_cap + kStripSlack;
  const int chunk = kStripSlack - p.rpb;
  const bool bounded = p.slab_cap <= 2048;
  const long long piece_cap =
      bounded ? max(1LL, (p.slab_cap + chunk - 1) / chunk) * chunk : 0;
  const long long greedy_cap = p.slab_cap - 16LL * p.rpb;
  long long run_over = 0, chunk_over = 0, win_over = 0, slab_over = 0;

  for (int i = warp; i < p.group_width; i += warps) {
    // 2. rows per depth cell, then the greedy plan
    for (int s = lane; s < S; s += 32) {
      long long sum = 0;
      for (int w = 0; w < kWindows; ++w) {
        const int c = kWin.code[w];
        const int hx = gx + i - 1 + win_k(c);
        if (hx < 0 || hx >= p.tiles_wide) continue;
        const int* ce = slice + win_b(c) * p.lw +
                        (win_k(c) + i) * p.per_home + win_c0(c) * S + s;
        sum += ce[1] - ce[0];
      }
      counts[s] = sum;
    }
    __syncwarp();
    if (lane == 0) {
      int n = 0;
      plan[n++] = 0;
      long long acc = counts[0];
      for (int cell = 1; cell < S; ++cell) {
        const long long c = counts[cell];
        if (acc + c > greedy_cap) {
          plan[n++] = cell;
          acc = c;
        } else {
          acc += c;
        }
      }
      while (n <= S) plan[n++] = S;
    }
    __syncwarp();

    // this lane's two windows for tile i
    int cbase[2], bk[2];
    long long bias[2], lof_base[2], run_hi[2];
    bool valid[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int b = win_b(code[h]), k = win_k(code[h]);
      const int home = b * p.lw + (k + i) * p.per_home;
      cbase[h] = home + win_c0(code[h]) * S;
      bias[h] = static_cast<long long>(i + k) * p.run_cap - slice[home];
      lof_base[h] = b * stride;
      run_hi[h] = static_cast<long long>(k + i + 1) * p.run_cap;
      const int hx = gx + i - 1 + k;
      valid[h] = hx >= 0 && hx < p.tiles_wide;
      bk[h] = b * 3 + k;
    }

    for (int j = 0; j < S; ++j) {
      const int lo_c = plan[j], hi_c = plan[j + 1];
      int4* out = reinterpret_cast<int4*>(p.desc) +
                  ((static_cast<long long>(g) * p.group_width + i) * S + j) * W;
      if (lo_c == hi_c) {   // every window empty: a zero row
        for (int o = lane; o < W; o += 32) out[o] = make_int4(0, 0, 0, 0);
        continue;
      }
      // 3. window spans
      int len[2];
      long long lof[2], dst[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int lo = slice[cbase[h] + lo_c];
        const int hi = slice[cbase[h] + hi_c];
        len[h] = valid[h] ? max(hi - lo, 0) : 0;
        lof[h] = lo + lof_base[h];
        dst[h] = lo + bias[h];
      }
      // merge windows of one (b, k) whose strip intervals abut: a chain's
      // last window takes the chain's rows from the chain's first row
      const long long prev_lof = __shfl_up_sync(kFull, lof[1], 1);
      const int prev_len = __shfl_up_sync(kFull, len[1], 1);
      const bool cont0 =
          lane > 0 && bk_prev == bk[0] && lof[0] == prev_lof + prev_len;
      const bool cont1 = bk[1] == bk[0] && lof[1] == lof[0] + len[0];
      const long long lane_len = static_cast<long long>(len[0]) + len[1];
      const long long incl = warp_inclusive_sum(lane_len, lane);
      const long long ex[2] = {incl - lane_len, incl - len[1]};
      const long long start0 = cont0 ? -1 : ex[0];
      const long long start1 = cont1 ? -1 : ex[1];
      long long before = __shfl_up_sync(
          kFull, warp_inclusive_max(max(start0, start1), lane), 1);
      if (lane == 0) before = -1;
      const long long seg[2] = {max(before, start0),
                                max(max(before, start0), start1)};
      const bool next_cont0 = __shfl_down_sync(kFull, cont0 ? 1 : 0, 1) != 0;
      const bool ended[2] = {!cont1, lane == 31 || !next_cont0};
      long long mlen[2], mlof[2], mdst[2];
      int pieces[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long rel = ex[h] - seg[h];
        mlen[h] = ended[h] ? ex[h] + len[h] - seg[h] : 0;
        mlof[h] = ended[h] ? lof[h] - rel : 0;
        mdst[h] = ended[h] ? dst[h] - rel : 0;
        // run_cap clamp
        const long long len_run = max(run_hi[h] - mdst[h], 0LL);
        run_over += max(mlen[h] - len_run, 0LL);
        mlen[h] = min(mlen[h], len_run);
        // pieces of at most `chunk` rows
        if (bounded) {
          chunk_over += max(mlen[h] - piece_cap, 0LL);
          mlen[h] = min(mlen[h], piece_cap);
          pieces[h] = static_cast<int>((mlen[h] + chunk - 1) / chunk);
        } else {
          pieces[h] = mlen[h] > 0 ? 1 : 0;
        }
      }
      // compaction: window pieces to slots [cum_ex, cum_in), clipped
      const int lane_pieces = pieces[0] + pieces[1];
      const int cin = warp_inclusive_sum(lane_pieces, lane);
      int slot = cin - lane_pieces;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        win_over += mlen[h];
        for (int t = 0; t < pieces[h] && slot + t < W; ++t) {
          const long long step = static_cast<long long>(t) * chunk;
          const int dl = static_cast<int>(
              min(max(mlen[h] - step, 0LL), static_cast<long long>(chunk)));
          row[slot + t] =
              make_int4(static_cast<int>(mlof[h] + step), dl,
                        static_cast<int>(mdst[h] + step), bk[h]);
          win_over -= dl;
        }
        slot += pieces[h];
      }
      const int total = __shfl_sync(kFull, cin, 31);
      for (int o = total + lane; o < W; o += 32)
        row[o] = make_int4(0, 0, 0, 0);
      __syncwarp();
      // 4. quantized slab accounting (window copies take whole packed rows),
      // then the row's store
      long long cursor = 0;
      for (int o0 = 0; o0 < W; o0 += 32) {
        const int o = o0 + lane;
        const int4 d = o < W ? row[o] : make_int4(0, 0, 0, 0);
        const int head = d.x & (p.rpb - 1);
        const int len_q =
            d.y > 0 ? (head + d.y + p.rpb - 1) / p.rpb * p.rpb : 0;
        const int incl_q = warp_inclusive_sum(len_q, lane);
        const long long avail =
            max(p.slab_cap - (cursor + incl_q - len_q + head), 0LL);
        slab_over += max(d.y - avail, 0LL);
        cursor += __shfl_sync(kFull, incl_q, 31);
        if (o < W) out[o] = d;
      }
      __syncwarp();
    }
  }

  const long long sums[4] = {warp_total(run_over), warp_total(chunk_over),
                             warp_total(win_over), warp_total(slab_over)};
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (sums[c] != 0)
        atomicAdd(p.over + c, static_cast<unsigned long long>(sums[c]));
  }
}

}  // namespace

// Dynamic shared memory of one block: per warp a descriptor row (w_max
// int4), the cell counts (S int64) and the slab plan (S + 1 ints); the
// group's three band strips, (gw + 2) * 16 * S + 1 ints each.
extern "C" long long tpu_splat_stream_descriptors_smem(int group_width,
                                                       int num_slabs,
                                                       int w_max) {
  const long long warps = std::min(group_width, kMaxWarps);
  const long long lw = (group_width + 2LL) * 16 * num_slabs + 1;
  return warps * (16LL * w_max + 8LL * num_slabs + 4LL * (num_slabs + 1)) +
         12 * lw;
}

// {resident blocks per SM, registers, local bytes} at `threads` threads and
// `smem` bytes (the first argument is unused: the kernel has one
// instantiation).
extern "C" int tpu_splat_stream_descriptors_occupancy(int, int threads,
                                                      long long smem,
                                                      int* out) {
  return kernel_occupancy((const void*)&stream_descriptors_kernel, threads,
                          static_cast<size_t>(smem), out);
}

// edges: (tiles_high * tiles_wide * 16 * num_slabs + 1) int64 cell edges;
// strip_blk: (G, 3) int64; desc: (G, gw * S * w_max * 4) int32, written
// whole; over: (4,) int64, zeroed, added to.  G = tiles_high * tiles_wide
// / group_width blocks of min(group_width, 8) warps.  Returns
// cudaGetLastError() (0 on success).
extern "C" int tpu_splat_stream_descriptors(
    const long long* edges, const long long* strip_blk, int* desc,
    long long* over, int tiles_wide, int tiles_high, int group_width,
    int num_slabs, int w_max, int rpb, long long strip_cap,
    long long slab_cap, long long run_cap, void* stream) {
  Params p;
  p.edges = edges;
  p.strip_blk = strip_blk;
  p.desc = desc;
  p.over = reinterpret_cast<unsigned long long*>(over);
  p.k_tot = static_cast<long long>(tiles_wide) * tiles_high * 16 * num_slabs;
  p.strip_cap = strip_cap;
  p.slab_cap = slab_cap;
  p.run_cap = run_cap;
  p.tiles_wide = tiles_wide;
  p.tiles_high = tiles_high;
  p.group_width = group_width;
  p.groups_x = tiles_wide / group_width;
  p.num_slabs = num_slabs;
  p.w_max = w_max;
  p.rpb = rpb;
  p.per_home = 16 * num_slabs;
  p.lw = (group_width + 2) * 16 * num_slabs + 1;
  const int threads = 32 * std::min(group_width, kMaxWarps);
  const size_t smem = static_cast<size_t>(
      tpu_splat_stream_descriptors_smem(group_width, num_slabs, w_max));
  return launch_kernel((const void*)&stream_descriptors_kernel, p,
                       tiles_high * p.groups_x, threads, smem,
                       static_cast<cudaStream_t>(stream));
}
