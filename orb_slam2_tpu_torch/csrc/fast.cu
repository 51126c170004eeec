// FAST-9/16 score + 3x3 NMS + border mask + per-cell threshold fallback,
// for all pyramid levels of one image in one launch.
//
// Replaces the Pallas TPU kernel orb_slam2_tpu/ops/fast_pallas.py
// (nms_score_map, `_kernel`, and the per-cell fallback of its wrapper
// detect_with_fallback).  Held exactly equal to the plain PyTorch version
// orb_slam2_tpu_torch/ops/fast.py::detect_with_fallback, level by level:
// every step is a subtraction, a min/max or a comparison, so there is no
// rounding to differ.
//
// What bounds it on an H100: device-memory bytes.  The 8 levels of a
// 376x1240 image are 1,442,870 px, 11.5 MB to read once and write once
// (3.4 us at 3.35 TB/s).  With the early exit below, a rendered KITTI
// level needs ~38 min/max/sub/compare a pixel plus ~175 more at the ~5%
// of pixels that pass the compass test, ~7e7 in all (~1 us at 67
// TFLOP/s); without it, ~195 a pixel (4.2 us).
//
// The design:
//   - one launch per image: the levels travel as a small table passed by
//     value (a kernel parameter, baked into a CUDA graph node); the 30x30
//     fallback cells of all levels form one grid (1,744 cells at KITTI's
//     shape), and each block finds its level from the table's cell
//     offsets.  Cells never cross levels;
//   - a block of 256 threads owns one cell: it stages the cell plus a 4-px
//     halo (38x38 floats, edge-clamped like jnp.pad(mode="edge")) in
//     shared memory, scores the 32x32 score tile (0 outside the image, as
//     nms3x3's constant padding) into shared memory, then takes the
//     cell's pixels through the NMS with the raster tie-break and the
//     border mask, and one __syncthreads_or decides the cell's threshold
//     fallback.  Lane x of warp y takes column x of rows y, y + 8, y + 16
//     and y + 24 in every step: rows are contiguous across a warp, and no
//     thread divides to find its pixel;
//   - the arc score takes each polarity's 9-arc minima by doubling, as the
//     plain version does (fast.py raw_score_map): minima over 2, 4, 8 and
//     then 9 ring positions, 64 min a polarity in place of 144.  The
//     bright polarity's minima of -d are the negated maxima of d: min and
//     max do not round, so the map stays bit-equal;
//   - an exact early exit: every 9-arc holds two cyclically adjacent
//     compass points (ring positions 0/4/8/12), so when no such pair
//     clears the low threshold in either polarity the score is 0, and the
//     other 12 ring pixels are never read.  ~95% of the pixels of a
//     rendered KITTI level exit there, but at random places: most warps
//     would still hold one candidate and run the full score.  So the
//     block first lists its candidates in shared memory and then scores
//     the list densely.  chip_smoke.py times the kernel beside the same
//     launch with min_th far below any score, where every pixel is a
//     candidate: the exit's gain on the run's frames.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kMaxCell = 30;
constexpr int kHalo = 4;                      // 3 (ring radius) + 1 (NMS)
constexpr int kTile = kMaxCell + 2 * kHalo;   // 38
constexpr int kScore = kMaxCell + 2;          // 32
constexpr int kThreads = 256;
constexpr int kRows = kThreads / 32;          // 8 warps, one row each
constexpr int kPerThread = kScore / kRows;    // 4 rows of the tile a warp
constexpr int kStageRows = (kTile + kRows - 1) / kRows;   // 5
constexpr int kMaxLevels = 16;

struct FastLevel {
  const float* img;
  float* out;
  int h, w;
  int cells_x;     // cells across the level
  int cell0;       // the level's first cell in the grid
};

struct FastTable {
  FastLevel lv[kMaxLevels];
  int n_levels;
};

// The level that holds grid cell `b`: the last level whose first cell is
// <= b.  Constant indices after unrolling, so the by-value table is read
// from the parameter bank and never copied to local memory.
__device__ __forceinline__ FastLevel find_level(const FastTable& t, int b) {
  FastLevel out = t.lv[0];
#pragma unroll
  for (int i = 1; i < kMaxLevels; ++i) {
    if (i < t.n_levels && b >= t.lv[i].cell0) out = t.lv[i];
  }
  return out;
}

// Whether the pixel at tile[r][c] can score >= min_th.  Every 9-arc holds
// two cyclically adjacent compass points (ring positions 0/4/8/12), so no
// arc minimum exceeds the best adjacent pair's minimum, and x - 1 rounds
// monotonically: false here means a thresholded score of 0.
__device__ __forceinline__ bool passes_compass(float (*tile)[kTile + 1],
                                               int r, int c, float min_th) {
  const float center = tile[r][c];
  const float d0 = tile[r - 3][c] - center;
  const float d4 = tile[r][c + 3] - center;
  const float d8 = tile[r + 3][c] - center;
  const float d12 = tile[r][c - 3] - center;
  const float dark = fmaxf(fmaxf(fminf(d0, d4), fminf(d4, d8)),
                           fmaxf(fminf(d8, d12), fminf(d12, d0)));
  const float bright = -fminf(fminf(fmaxf(d0, d4), fmaxf(d4, d8)),
                              fminf(fmaxf(d8, d12), fmaxf(d12, d0)));
  return fmaxf(dark, bright) - 1.0f >= min_th;
}

// The thresholded FAST score of the pixel at tile[r][c]: the max over the
// 16 circular 9-arcs of the arc minimum, for dark (ring above centre: d)
// and bright (centre above ring: -d) corners, minus 1; 0 below min_th.
__device__ __forceinline__ float arc_score(float (*tile)[kTile + 1],
                                           int r, int c, float min_th) {
  const float center = tile[r][c];
  float d[16];
  // Bresenham circle of radius 3, clockwise from 12 o'clock (fast.py CIRCLE)
  d[0] = tile[r - 3][c] - center;
  d[1] = tile[r - 3][c + 1] - center;
  d[2] = tile[r - 2][c + 2] - center;
  d[3] = tile[r - 1][c + 3] - center;
  d[4] = tile[r][c + 3] - center;
  d[5] = tile[r + 1][c + 3] - center;
  d[6] = tile[r + 2][c + 2] - center;
  d[7] = tile[r + 3][c + 1] - center;
  d[8] = tile[r + 3][c] - center;
  d[9] = tile[r + 3][c - 1] - center;
  d[10] = tile[r + 2][c - 2] - center;
  d[11] = tile[r + 1][c - 3] - center;
  d[12] = tile[r][c - 3] - center;
  d[13] = tile[r - 1][c - 3] - center;
  d[14] = tile[r - 2][c - 2] - center;
  d[15] = tile[r - 3][c - 1] - center;

  // mn*: minima of d over 2, 4, 8 ring positions from k (dark);
  // mx*: maxima of d, whose negation is the minima of -d (bright)
  float mn2[16], mx2[16], mn4[16], mx4[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    mn2[k] = fminf(d[k], d[(k + 1) & 15]);
    mx2[k] = fmaxf(d[k], d[(k + 1) & 15]);
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    mn4[k] = fminf(mn2[k], mn2[(k + 2) & 15]);
    mx4[k] = fmaxf(mx2[k], mx2[(k + 2) & 15]);
  }
  float v_dark = -INFINITY;
  float v_bright_neg = INFINITY;      // min over arcs of the arc maximum
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const float mn9 = fminf(fminf(mn4[k], mn4[(k + 4) & 15]), d[(k + 8) & 15]);
    const float mx9 = fmaxf(fmaxf(mx4[k], mx4[(k + 4) & 15]), d[(k + 8) & 15]);
    v_dark = fmaxf(v_dark, mn9);
    v_bright_neg = fminf(v_bright_neg, mx9);
  }
  const float raw = fmaxf(-v_bright_neg, v_dark) - 1.0f;
  return raw >= min_th ? raw : 0.f;
}

__global__ void __launch_bounds__(kThreads, 4)
fast_levels_kernel(const FastTable t, float ini_th, float min_th, int border,
                   int cell) {
  __shared__ float tile[kTile][kTile + 1];
  __shared__ float score[kScore][kScore + 1];
  __shared__ int candidates[kScore * kScore];   // score-tile indices
  __shared__ int n_candidates;

  const FastLevel L = find_level(t, blockIdx.x);
  const int h = L.h;
  const int w = L.w;
  const int local = blockIdx.x - L.cell0;
  const int cell_y = local / L.cells_x;
  const int y0 = cell_y * cell;
  const int x0 = (local - cell_y * L.cells_x) * cell;
  // thread (ty, tx) takes column tx of rows ty, ty + 8, ...: no division
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const int tdim = cell + 2 * kHalo;
  const int sdim = cell + 2;

  if (threadIdx.x == 0) n_candidates = 0;
  // tile[r][c] = image pixel (y0 - 4 + r, x0 - 4 + c), clamped to the edge;
  // all of a thread's loads are issued before any is stored
  float staged[kStageRows][2];
#pragma unroll
  for (int k = 0; k < kStageRows; ++k) {
    const int r = ty + k * kRows;
    const float* src = L.img + min(max(y0 - kHalo + r, 0), h - 1) * w;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = tx + 32 * j;
      staged[k][j] = (r < tdim && c < tdim)
                         ? src[min(max(x0 - kHalo + c, 0), w - 1)] : 0.f;
    }
  }
#pragma unroll
  for (int k = 0; k < kStageRows; ++k) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = ty + k * kRows;
      const int c = tx + 32 * j;
      if (r < tdim && c < tdim) tile[r][c] = staged[k][j];
    }
  }
  __syncthreads();

  // score[sy][sx]: thresholded score of pixel (y0 - 1 + sy, x0 - 1 + sx);
  // 0 outside the image, as nms3x3's constant padding.  First every pixel
  // takes the compass test, and the few that pass are appended to a list
  // (one shared atomic a warp); then the block's threads share the list,
  // so the full arc score runs densely instead of in every warp that
  // holds one candidate.
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int sy = ty + k * kRows;
    const int sx = tx;
    bool pass = false;
    if (sy < sdim && sx < sdim) {
      const int py = y0 - 1 + sy;
      const int px = x0 - 1 + sx;
      pass = py >= 0 && py < h && px >= 0 && px < w &&
             passes_compass(tile, sy + kHalo - 1, sx + kHalo - 1, min_th);
      score[sy][sx] = 0.f;
    }
    const unsigned int ballot = __ballot_sync(0xffffffffu, pass);
    if (ballot != 0u) {                             // uniform across the warp
      int base = 0;
      if (tx == 0) base = atomicAdd(&n_candidates, __popc(ballot));
      base = __shfl_sync(0xffffffffu, base, 0);
      if (pass) {
        candidates[base + __popc(ballot & ((1u << tx) - 1u))] =
            sy * kScore + sx;
      }
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < n_candidates; j += kThreads) {
    const int sy = candidates[j] / kScore;
    const int sx = candidates[j] % kScore;
    score[sy][sx] = arc_score(tile, sy + kHalo - 1, sx + kHalo - 1, min_th);
  }
  __syncthreads();

  // NMS with the raster tie-break and the border mask; the cell keeps its
  // high-threshold corners if it has any, else its low-threshold ones
  float lo[kPerThread];
  bool any_hi = false;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int cy = ty + k * kRows;
    const int cx = tx;
    const int py = y0 + cy;
    const int px = x0 + cx;
    lo[k] = 0.f;
    if (cy < cell && cx < cell && py < h && px < w) {
      const int r = cy + 1;
      const int c = cx + 1;
      const float s = score[r][c];
      const float earlier = fmaxf(fmaxf(score[r - 1][c - 1], score[r - 1][c]),
                                  fmaxf(score[r - 1][c + 1], score[r][c - 1]));
      const float later = fmaxf(fmaxf(score[r][c + 1], score[r + 1][c - 1]),
                                fmaxf(score[r + 1][c], score[r + 1][c + 1]));
      const bool keep = s > earlier && s >= later && s > 0.f;
      const bool in_border = py >= border && py < h - border &&
                             px >= border && px < w - border;
      lo[k] = (keep && in_border) ? s : 0.f;
      any_hi = any_hi || (lo[k] >= ini_th && lo[k] > 0.f);
    }
  }
  const int cell_has_hi = __syncthreads_or(any_hi);
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int cy = ty + k * kRows;
    const int cx = tx;
    const int py = y0 + cy;
    const int px = x0 + cx;
    if (cy < cell && cx < cell && py < h && px < w) {
      const float hi = lo[k] >= ini_th ? lo[k] : 0.f;
      L.out[py * w + px] = cell_has_hi ? hi : lo[k];
    }
  }
}

}  // namespace

// One image's levels.  ptrs: host array of 2 device pointers a level (img,
// out: (h, w) float32); ints: host array of 4 ints a level (h, w, cells_x,
// cell0), cell0 ascending from 0; n_cells: the cells of all levels;
// cell in [1, 30].
extern "C" int orb_fast_levels(int n_levels, const void* const* ptrs,
                               const int* ints, int n_cells, float ini_th,
                               float min_th, int border, int cell,
                               cudaStream_t stream) {
  if (cell < 1 || cell > kMaxCell || n_levels < 1 ||
      n_levels > kMaxLevels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_cells == 0) return 0;
  FastTable t = {};
  t.n_levels = n_levels;
  for (int i = 0; i < n_levels; ++i) {
    t.lv[i].img = static_cast<const float*>(ptrs[2 * i]);
    t.lv[i].out = static_cast<float*>(const_cast<void*>(ptrs[2 * i + 1]));
    t.lv[i].h = ints[4 * i];
    t.lv[i].w = ints[4 * i + 1];
    t.lv[i].cells_x = ints[4 * i + 2];
    t.lv[i].cell0 = ints[4 * i + 3];
  }
  fast_levels_kernel<<<n_cells, kThreads, 0, stream>>>(t, ini_th, min_th,
                                                       border, cell);
  return static_cast<int>(cudaGetLastError());
}
