// FAST-9/16 score + 3x3 NMS + border mask + per-cell threshold fallback.
//
// Replaces the Pallas TPU kernel orb_slam2_tpu/ops/fast_pallas.py
// (nms_score_map, `_kernel`, and the per-cell fallback of its wrapper
// detect_with_fallback).  Held exactly equal to the plain PyTorch version
// orb_slam2_tpu_torch/ops/fast.py::detect_with_fallback: every step is a
// subtraction, a min/max or a comparison, so there is no rounding to differ.
//
// What bounds it on an H100: memory.  Per pixel the work is 16 ring
// differences, 2 x 16 nine-wide arc minima and a 3x3 NMS -- a few hundred
// ALU operations on data already in shared memory -- against one 4-byte read
// and one 4-byte write of device memory.  The design keeps everything
// between those two in on-chip memory: one block per 30x30 fallback cell
// stages the cell plus a 4-px halo (38x38 floats, edge-clamped like
// jnp.pad(mode="edge")) in shared memory, scores the (30+2)^2 tile in
// registers, keeps the scores in shared memory for the NMS, and decides the
// cell's threshold fallback with one block-wide __syncthreads_or.  The
// halo makes each block read 1.6x its cell; the rest comes from L2.
//
// Note the 30-px fallback cell here is not the 24-px cell of the
// frontend's grid top-K selection.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kMaxCell = 30;
constexpr int kHalo = 4;                      // 3 (ring radius) + 1 (NMS)
constexpr int kTile = kMaxCell + 2 * kHalo;   // 38
constexpr int kScore = kMaxCell + 2;          // 32

// Bresenham circle of radius 3, clockwise from 12 o'clock (fast.py CIRCLE)
__device__ __constant__ int kRingDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3,
                                           3, 3, 2, 1, 0, -1, -2, -3};
__device__ __constant__ int kRingDx[16] = {0, 1, 2, 3, 3, 3, 2, 1,
                                           0, -1, -2, -3, -3, -3, -2, -1};

__global__ void __launch_bounds__(1024)
fast_cell_kernel(const float* __restrict__ img, float* __restrict__ out,
                 int h, int w, float ini_th, float min_th, int border,
                 int cell) {
  __shared__ float tile[kTile][kTile + 1];
  __shared__ float score[kScore][kScore + 1];

  const int y0 = blockIdx.y * cell;
  const int x0 = blockIdx.x * cell;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * blockDim.x + tx;
  const int tdim = cell + 2 * kHalo;

  // tile[r][c] = image pixel (y0 - 4 + r, x0 - 4 + c), clamped to the edge
  for (int i = tid; i < tdim * tdim; i += blockDim.x * blockDim.y) {
    const int r = i / tdim;
    const int c = i - r * tdim;
    const int yy = min(max(y0 - kHalo + r, 0), h - 1);
    const int xx = min(max(x0 - kHalo + c, 0), w - 1);
    tile[r][c] = img[yy * w + xx];
  }
  __syncthreads();

  // thresholded score of pixel (y0 - 1 + ty, x0 - 1 + tx); 0 outside the
  // image, as nms3x3's constant padding
  if (ty < cell + 2 && tx < cell + 2) {
    const int py = y0 - 1 + ty;
    const int px = x0 - 1 + tx;
    float s = 0.f;
    if (py >= 0 && py < h && px >= 0 && px < w) {
      const int r = ty + kHalo - 1;
      const int c = tx + kHalo - 1;
      const float center = tile[r][c];
      float d[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        d[k] = tile[r + kRingDy[k]][c + kRingDx[k]] - center;
      }
      // max over the 16 circular 9-arcs of the arc minimum, for dark
      // (ring above centre: d) and bright (centre above ring: -d) corners
      float v_dark = -INFINITY;
      float v_bright = -INFINITY;
#pragma unroll
      for (int s0 = 0; s0 < 16; ++s0) {
        float mn_dark = INFINITY;
        float mn_bright = INFINITY;
#pragma unroll
        for (int j = 0; j < 9; ++j) {
          const float v = d[(s0 + j) & 15];
          mn_dark = fminf(mn_dark, v);
          mn_bright = fminf(mn_bright, -v);
        }
        v_dark = fmaxf(v_dark, mn_dark);
        v_bright = fmaxf(v_bright, mn_bright);
      }
      const float raw = fmaxf(v_bright, v_dark) - 1.0f;
      s = raw >= min_th ? raw : 0.f;
    }
    score[ty][tx] = s;
  }
  __syncthreads();

  // NMS with the raster tie-break, border mask, then the cell's fallback
  const int py = y0 + ty;
  const int px = x0 + tx;
  const bool inside = ty < cell && tx < cell && py < h && px < w;
  float lo = 0.f;
  if (inside) {
    const int r = ty + 1;
    const int c = tx + 1;
    const float s = score[r][c];
    const float earlier = fmaxf(fmaxf(score[r - 1][c - 1], score[r - 1][c]),
                                fmaxf(score[r - 1][c + 1], score[r][c - 1]));
    const float later = fmaxf(fmaxf(score[r][c + 1], score[r + 1][c - 1]),
                              fmaxf(score[r + 1][c], score[r + 1][c + 1]));
    const bool keep = s > earlier && s >= later && s > 0.f;
    const bool in_border = py >= border && py < h - border &&
                           px >= border && px < w - border;
    lo = (keep && in_border) ? s : 0.f;
  }
  const float hi = lo >= ini_th ? lo : 0.f;
  const int cell_has_hi = __syncthreads_or(hi > 0.f);
  if (inside) out[py * w + px] = cell_has_hi ? hi : lo;
}

}  // namespace

// img, out: (h, w) float32 on the device; cell in [1, 30].
extern "C" int orb_fast_detect(const float* img, float* out, int h, int w,
                               float ini_th, float min_th, int border,
                               int cell, cudaStream_t stream) {
  if (cell < 1 || cell > kMaxCell) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((w + cell - 1) / cell, (h + cell - 1) / cell);
  const dim3 block(kScore, kScore);
  fast_cell_kernel<<<grid, block, 0, stream>>>(img, out, h, w, ini_th, min_th,
                                               border, cell);
  return static_cast<int>(cudaGetLastError());
}
