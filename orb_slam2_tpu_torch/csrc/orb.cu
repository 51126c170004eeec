// Fused IC angle + rotated BRIEF for one pyramid level's keypoints.
//
// Replaces the Pallas TPU kernel orb_slam2_tpu/ops/orb_pallas.py
// (describe_oriented, `_make_kernel`).  Computes what the plain PyTorch
// path computes (orb_slam2_tpu_torch/ops/orientation.py::ic_angles, then
// brief.py::describe), not what the TPU kernel's layout tricks compute:
//   - centre clipped to [15, size-16] for the moments, each tap clipped to
//     the image on its own (the TPU kernel clips centres to [19, w-20]);
//   - the angle is degrees(atan2f(m01, m10)) wrapped into [0, 360), and
//     the taps are rotated by cosf/sinf of radians(angle), as the plain
//     path does -- not by m10/r and m01/r as the TPU kernel does, which
//     moves taps that round at .5;
//   - taps rounded half-to-even (rintf).
// The moments are summed in double, like the plain path, so both round the
// same exact sum to float.  The library is compiled with --fmad=false: a
// fused x*cos - y*sin would round differently from the plain path's
// separate multiply and subtract, and so would move taps at .5.
//
// What bounds it on an H100: neither bytes nor FLOPs at the main path's
// sizes (122..434 keypoints a level) but latency -- each keypoint needs 961
// moment pixels and then 512 dependent random taps.  The design gives each
// keypoint one warp: lane j reads column j-15 of the 31x31 circle (rows are
// coalesced across lanes), the moments are reduced with warp shuffles, and
// lane j of round k takes pair 32k+j, so one __ballot_sync per round yields
// exactly the little-endian descriptor word k.  The 256x4 pattern and the
// circle's umax table sit in __constant__ memory; taps read the blurred
// level through the L1/L2 caches.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kHalfPatch = 15;
constexpr int kBits = 256;
constexpr int kWarpsPerBlock = 8;

__constant__ int c_pattern[kBits * 4];      // rows (x0, y0, x1, y1)
__constant__ int c_umax[kHalfPatch + 1];

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
orb_describe_kernel(const float* __restrict__ img,
                    const float* __restrict__ blur, int h, int w,
                    const int* __restrict__ xy,
                    const bool* __restrict__ valid, int n,
                    float* __restrict__ angle, int* __restrict__ desc) {
  const int kp = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (kp >= n) return;                 // uniform across the warp
  if (!valid[kp]) {
    if (lane < 8) desc[kp * 8 + lane] = 0;
    if (lane == 0) angle[kp] = 0.f;
    return;
  }
  const int kx = xy[2 * kp];
  const int ky = xy[2 * kp + 1];
  const int cx = min(max(kx, kHalfPatch), w - 1 - kHalfPatch);
  const int cy = min(max(ky, kHalfPatch), h - 1 - kHalfPatch);

  // intensity-centroid moments over the discrete circle (IC_Angle)
  double m10 = 0.0;
  double m01 = 0.0;
  if (lane < 2 * kHalfPatch + 1) {
    const int u = lane - kHalfPatch;
    const int au = abs(u);
    const float* col = img + cx + u;
    for (int v = -kHalfPatch; v <= kHalfPatch; ++v) {
      if (au <= c_umax[abs(v)]) {
        const double p = static_cast<double>(col[(cy + v) * w]);
        m10 += u * p;
        m01 += v * p;
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m10 += __shfl_xor_sync(0xffffffffu, m10, off);
    m01 += __shfl_xor_sync(0xffffffffu, m01, off);
  }
  const float deg = static_cast<float>(180.0 / M_PI);   // jnp.degrees
  const float rad = static_cast<float>(M_PI / 180.0);   // jnp.radians
  float ang = atan2f(static_cast<float>(m01), static_cast<float>(m10)) * deg;
  if (ang < 0.f) ang += 360.f;
  const float a = cosf(ang * rad);
  const float b = sinf(ang * rad);

  // 8 rounds x 32 lanes: lane j of round k compares pair 32k + j
  unsigned int my_word = 0;
#pragma unroll
  for (int k = 0; k < kBits / 32; ++k) {
    const int* p = c_pattern + 4 * (32 * k + lane);
    const float x0 = static_cast<float>(p[0]);
    const float y0 = static_cast<float>(p[1]);
    const float x1 = static_cast<float>(p[2]);
    const float y1 = static_cast<float>(p[3]);
    const int rx0 = static_cast<int>(rintf(x0 * a - y0 * b));
    const int ry0 = static_cast<int>(rintf(x0 * b + y0 * a));
    const int rx1 = static_cast<int>(rintf(x1 * a - y1 * b));
    const int ry1 = static_cast<int>(rintf(x1 * b + y1 * a));
    const int r0 = min(max(ky + ry0, 0), h - 1);
    const int c0 = min(max(kx + rx0, 0), w - 1);
    const int r1 = min(max(ky + ry1, 0), h - 1);
    const int c1 = min(max(kx + rx1, 0), w - 1);
    const bool bit = blur[r0 * w + c0] < blur[r1 * w + c1];
    const unsigned int word = __ballot_sync(0xffffffffu, bit);
    if (lane == k) my_word = word;
  }
  if (lane < 8) desc[kp * 8 + lane] = static_cast<int>(my_word);
  if (lane == 0) angle[kp] = ang;
}

}  // namespace

// pattern: host (256, 4) int32; umax: host (16,) int32.  Stream-ordered
// copies into __constant__ memory of the current device.
extern "C" int orb_set_tables(const int* pattern, const int* umax,
                              cudaStream_t stream) {
  cudaError_t err = cudaMemcpyToSymbolAsync(
      c_pattern, pattern, sizeof(int) * kBits * 4, 0,
      cudaMemcpyHostToDevice, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemcpyToSymbolAsync(c_umax, umax, sizeof(int) * (kHalfPatch + 1),
                                0, cudaMemcpyHostToDevice, stream);
  return static_cast<int>(err);
}

// img, blur: (h, w) float32; xy: (n, 2) int32 level coords; valid: (n,)
// bool.  Writes angle (n,) float32 degrees and desc (n, 8) int32.
extern "C" int orb_describe(const float* img, const float* blur, int h, int w,
                            const int* xy, const bool* valid, int n,
                            float* angle, int* desc, cudaStream_t stream) {
  if (n == 0) return 0;
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  orb_describe_kernel<<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      img, blur, h, w, xy, valid, n, angle, desc);
  return static_cast<int>(cudaGetLastError());
}
