// 11x11 centre-normalised SAD of a left window against 11 right windows.
//
// Replaces the Pallas TPU kernel orb_slam2_tpu/ops/stereo_pallas.py
// (sad_strips, `_make_kernel`): for each keypoint, the sum over the 11x11
// window of |(L - L_centre) - (R_s - R_s,centre)| for the right window
// shifted by s = -5..+5 around xr (ref: Frame::ComputeStereoMatches,
// src/Frame.cc:551-622).  Output (N, 11) float32, as the TPU kernel's.
// On the integer-valued level-0 images of the main path every term and
// every partial sum is an integer below 2^24, so the result equals the
// plain PyTorch version (orb_slam2_tpu_torch/ops/stereo_cuda.py::
// sad_strips_plain) exactly, whatever the order of summation.
//
// What bounds it on an H100: latency of scattered reads.  N = 2048
// keypoints each read a 11x11 and an 11x21 patch (352 floats, 1.4 KB) at
// random places of two 1.9 MB images that sit in L2; the arithmetic is
// 11 x 121 absolute differences per keypoint.  The design gives each
// keypoint one warp: the warp stages both patches in shared memory with
// row-contiguous reads, then lanes 0..10 each own one shift and sum their
// window from shared memory.  The caller's argmin, parabola and depth
// stay in PyTorch for now.

#include <cuda_runtime.h>

namespace {

constexpr int kW = 5;                    // SAD half-window (Frame.cc:557)
constexpr int kL = 5;                    // search range +/-5 (Frame.cc:563)
constexpr int kWin = 2 * kW + 1;         // 11
constexpr int kStrip = 2 * (kW + kL) + 1;  // 21
constexpr int kShifts = 2 * kL + 1;      // 11
constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sad_strips_kernel(const float* __restrict__ left,
                  const float* __restrict__ right, int h, int w,
                  const int* __restrict__ yc, const int* __restrict__ xl,
                  const int* __restrict__ xr, int n,
                  float* __restrict__ out) {
  __shared__ float s_left[kWarpsPerBlock][kWin][kWin];
  __shared__ float s_right[kWarpsPerBlock][kWin][kStrip];
  const int wib = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int kp = blockIdx.x * kWarpsPerBlock + wib;
  if (kp >= n) return;                 // uniform across the warp

  // The caller pre-clips the centres so both patches are in bounds; the
  // clamps below only keep a bad index from reading outside the images.
  const int y = yc[kp];
  const int cl = xl[kp];
  const int cr = xr[kp];
  for (int i = lane; i < kWin * kWin; i += 32) {
    const int dy = i / kWin;
    const int dx = i - dy * kWin;
    const int yy = min(max(y - kW + dy, 0), h - 1);
    const int xx = min(max(cl - kW + dx, 0), w - 1);
    s_left[wib][dy][dx] = left[yy * w + xx];
  }
  for (int i = lane; i < kWin * kStrip; i += 32) {
    const int dy = i / kStrip;
    const int dx = i - dy * kStrip;
    const int yy = min(max(y - kW + dy, 0), h - 1);
    const int xx = min(max(cr - kW - kL + dx, 0), w - 1);
    s_right[wib][dy][dx] = right[yy * w + xx];
  }
  __syncwarp();

  if (lane < kShifts) {
    const float lc = s_left[wib][kW][kW];
    const float rc = s_right[wib][kW][lane + kW];
    float acc = 0.f;
    for (int dy = 0; dy < kWin; ++dy) {
#pragma unroll
      for (int dx = 0; dx < kWin; ++dx) {
        acc += fabsf((s_left[wib][dy][dx] - lc) -
                     (s_right[wib][dy][lane + dx] - rc));
      }
    }
    out[kp * kShifts + lane] = acc;
  }
}

}  // namespace

// left, right: (h, w) float32; yc, xl, xr: (n,) int32.  Writes out (n, 11).
extern "C" int orb_sad_strips(const float* left, const float* right, int h,
                              int w, const int* yc, const int* xl,
                              const int* xr, int n, float* out,
                              cudaStream_t stream) {
  if (n == 0) return 0;
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  sad_strips_kernel<<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      left, right, h, w, yc, xl, xr, n, out);
  return static_cast<int>(cudaGetLastError());
}
