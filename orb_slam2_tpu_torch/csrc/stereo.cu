// Stereo refinement of the row matches, one launch: for each left keypoint
// the 11 centre-normalised 11x11 SADs, the best shift, the parabola fit and
// the depth.
//
// Replaces the Pallas TPU kernel orb_slam2_tpu/ops/stereo_pallas.py
// (sad_strips, `_make_kernel`) and, on a CUDA device, the whole of
// stereo.match's step 3 around it (ref: Frame::ComputeStereoMatches,
// src/Frame.cc:551-622).  It takes the Hamming match's output (best_idx,
// best_dist) and writes the pre-sweep u_right, depth and SAD.  What it
// computes is orb_slam2_tpu_torch/ops/stereo_cuda.py::refine_plain, step by
// step and in float32:
//   - matched = best_dist < th_orb; the centres yc, xl, xr truncated to int
//     (torch's .int()) and clamped as the plain path clamps them;
//   - SAD_s = sum over the window of |(L - L_centre) - (R_s - R_s,centre)|
//     for the right window shifted by s - 5, s = 0..10;
//   - best_s the FIRST minimum (torch.argmin's tie rule), the parabola
//     denom = (im1 + ip1) - 2*best, delta = 0.5*(im1 - ip1) / max(denom,
//     1e-6) (IEEE division) where interior and denom > 1e-6, clamped to +-1;
//   - u_right = ((float)xr + (float)(best_s - 5)) + delta, disparity
//     snapped to 0.01 where <= 0, depth = bf / disparity (IEEE division);
//     -1 / -1 / +inf where the match is not good.
// On the integer-valued level-0 images of the main path (uint8 cast to
// float32) every term and every partial sum of a SAD is an integer below
// 2^24, so the kernel's order of summation gives the plain path's sums
// exactly; the epilogue then repeats the plain path's float32 operations
// in its order, and the library is built with --fmad=false, so u_right,
// depth and SAD are bit-identical to refine_plain's.
//
// What bounds it on an H100: latency, not bytes.  N = 2048 keypoints read
// ~2 MB of distinct window pixels from two 1.9 MB images in L2, ~0.6 us
// at 3.35 TB/s; the arithmetic is 11 x 121 terms a keypoint, 0.16 us at 67
// TFLOP/s.  What a keypoint waits for is three dependent memory round
// trips: its inputs, then the right keypoint's x (xy_r[best_idx]), then
// the window pixels.  The design:
//   - one warp a keypoint, 4 warps a block: 2048 keypoints are 512 blocks,
//     ~16 warps on each of the 132 SMs, all resident in one wave;
//   - staging: a 21-px row of the right strip and an 11-px row of the left
//     window are 32 floats, one per lane, so the warp stages both patches
//     with 11 fully unrolled row loads into registers, all issued before
//     any is used (one round trip, no div/mod in the index), then stores
//     them to shared memory at a row stride of 43 floats;
//   - compute: lane j owns window pixels p = j, j+32, j+64, j+96 (p < 121),
//     and sums each pixel's term for all 11 shifts into 11 accumulators.
//     With the row stride of 43 (= 11 mod 32) the 32 lanes of one read hit
//     32 distinct banks for every shift.  A butterfly reduce-scatter (16
//     shuffles) leaves lane j with the full SAD of shift j >> 1;
//   - epilogue: the first minimum by two __reduce_min_sync (a non-negative
//     float orders as its bits), the neighbours by two shuffles, the
//     parabola and depth in registers; lane 0 writes 12 bytes.
//     All the sums are of integers below 2^24 on integer images, so any
//     partition and order of them is exact.

#include <cuda_runtime.h>

namespace {

constexpr int kW = 5;                      // SAD half-window (Frame.cc:557)
constexpr int kL = 5;                      // search range +/-5 (Frame.cc:563)
constexpr int kWin = 2 * kW + 1;           // 11
constexpr int kStrip = 2 * (kW + kL) + 1;  // 21: the window plus the search
constexpr int kShifts = 2 * kL + 1;        // 11
constexpr int kPixels = kWin * kWin;       // 121
constexpr int kRowStride = 43;             // = 11 mod 32: conflict-free reads
constexpr int kSlots = 16;                 // 11 shifts, padded to 2^4
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kStrip + kWin == 32, "a staged row is one float a lane");

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// One step of the butterfly reduce-scatter over 2 * kHalf slots: at lane
// offset 2 * kHalf a lane keeps the half of its slots that its lane bit
// selects and adds the partner's copy of that half.
template <int kHalf>
__device__ __forceinline__ void halve(float (&acc)[kSlots], int lane) {
  const bool upper = lane & (2 * kHalf);
#pragma unroll
  for (int j = 0; j < kHalf; ++j) {
    const float keep = upper ? acc[j + kHalf] : acc[j];
    const float send = upper ? acc[j] : acc[j + kHalf];
    acc[j] = keep + __shfl_xor_sync(kFull, send, 2 * kHalf);
  }
}

// The warp's SADs for the windows centred at (y, xl) on the left and
// (y, xr + s - 5) on the right.  `s_win` is the warp's 11 x 43 floats of
// shared memory.  Returns on lane j the SAD of shift j >> 1 (lanes 0..21;
// lanes 22..31 hold the zero padding slots).
__device__ __forceinline__ float warp_sads(const float* __restrict__ left,
                                           const float* __restrict__ right,
                                           int w, int y, int xl, int xr,
                                           float* s_win, int lane) {
  // row r of the staged window: columns 0..20 the right strip, 21..31 the
  // left window
  const float* src = lane < kStrip
                         ? right + (y - kW) * w + (xr - kW - kL + lane)
                         : left + (y - kW) * w + (xl - kW + lane - kStrip);
  float v[kWin];
#pragma unroll
  for (int r = 0; r < kWin; ++r) v[r] = __ldg(src + r * w);
#pragma unroll
  for (int r = 0; r < kWin; ++r) s_win[r * kRowStride + lane] = v[r];
  __syncwarp();

  const float* centre = s_win + kW * kRowStride;
  const float lc = centre[kStrip + kW];
  float rc[kShifts];
#pragma unroll
  for (int s = 0; s < kShifts; ++s) rc[s] = centre[kW + s];

  float acc[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) acc[s] = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int p = lane + 32 * k;
    if (p < kPixels) {
      const int dy = p / kWin;
      const float* row = s_win + dy * kRowStride + (p - dy * kWin);
      const float ln = row[kStrip] - lc;
#pragma unroll
      for (int s = 0; s < kShifts; ++s)
        acc[s] += fabsf(ln - (row[s] - rc[s]));
    }
  }

  // After offsets 16, 8, 4, 2 lane j holds slot j >> 1 summed over the
  // lanes that differ from it in bits 1..4; offset 1 adds the last partner.
  halve<8>(acc, lane);
  halve<4>(acc, lane);
  halve<2>(acc, lane);
  halve<1>(acc, lane);
  return acc[0] + __shfl_xor_sync(kFull, acc[0], 1);
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sad_strips_kernel(const float* __restrict__ left,
                  const float* __restrict__ right, int h, int w,
                  const int* __restrict__ yc, const int* __restrict__ xl,
                  const int* __restrict__ xr, int n,
                  float* __restrict__ scores) {
  __shared__ float s_win[kWarpsPerBlock][kWin * kRowStride];
  const int wib = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int kp = blockIdx.x * kWarpsPerBlock + wib;
  if (kp >= n) return;                 // uniform across the warp
  // the callers pre-clip the centres; the clamps keep a bad one in bounds
  const float sad = warp_sads(
      left, right, w, clampi(yc[kp], kW, h - 1 - kW),
      clampi(xl[kp], kW + kL, w - 1 - kW - kL),
      clampi(xr[kp], kW + kL, w - 1 - kW - kL), s_win[wib], lane);
  if (lane < 2 * kShifts && (lane & 1) == 0)
    scores[kp * kShifts + (lane >> 1)] = sad;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
stereo_refine_kernel(const float* __restrict__ left,
                     const float* __restrict__ right, int h, int w,
                     const float* __restrict__ xy_l,
                     const float* __restrict__ xy_r,
                     const long long* __restrict__ best_idx,
                     const int* __restrict__ best_dist, int th_orb,
                     const float* __restrict__ bf,
                     const float* __restrict__ min_disp,
                     const float* __restrict__ max_disp, int n,
                     float* __restrict__ u_right, float* __restrict__ depth,
                     float* __restrict__ sad_out, float* __restrict__ scores) {
  __shared__ float s_win[kWarpsPerBlock][kWin * kRowStride];
  const int wib = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int kp = blockIdx.x * kWarpsPerBlock + wib;
  if (kp >= n) return;                 // uniform across the warp

  // all independent loads first: one round trip
  const float u_l = xy_l[2 * kp];
  const float v_l = xy_l[2 * kp + 1];
  const long long j = best_idx[kp];
  const bool matched = best_dist[kp] < th_orb;
  const float bf_v = *bf, lo = *min_disp, hi = *max_disp;
  const float u_r0 = xy_r[2 * j];

  // centres: (int) truncates toward zero, as torch's .int() does
  const int yc = clampi(static_cast<int>(v_l), kW, h - 1 - kW);
  const int xl = clampi(static_cast<int>(u_l), kW + kL, w - 1 - kW - kL);
  const int xr = clampi(static_cast<int>(u_r0), kW + kL, w - 1 - kW - kL);
  const float sad = warp_sads(left, right, w, yc, xl, xr, s_win[wib], lane);
  const bool holds = lane < 2 * kShifts;
  if (scores != nullptr && holds && (lane & 1) == 0)
    scores[kp * kShifts + (lane >> 1)] = sad;

  // the first minimum: a SAD is a sum of absolute values, so >= +0, and a
  // non-negative float orders as its bits
  const unsigned key = holds ? __float_as_uint(sad) : 0xffffffffu;
  const unsigned best_key = __reduce_min_sync(kFull, key);
  const unsigned shift = key == best_key ? lane >> 1 : 0xffffffffu;
  const int best_s = static_cast<int>(__reduce_min_sync(kFull, shift));
  const float best = __uint_as_float(best_key);
  const float im1 = __shfl_sync(kFull, sad, 2 * max(best_s - 1, 0));
  const float ip1 = __shfl_sync(kFull, sad, 2 * min(best_s + 1, 2 * kL));
  if (lane != 0) return;

  const bool interior = best_s > 0 && best_s < 2 * kL;
  const float denom = (im1 + ip1) - 2.0f * best;
  float delta = 0.f;
  if (interior && denom > 1e-6f)
    delta = __fdiv_rn(0.5f * (im1 - ip1), fmaxf(denom, 1e-6f));
  delta = fminf(fmaxf(delta, -1.f), 1.f);
  const float u = (static_cast<float>(xr) + static_cast<float>(best_s - kL))
                  + delta;
  float disparity = u_l - u;
  const bool good = matched && disparity >= lo && disparity < hi;
  if (disparity <= 0.f) disparity = 0.01f;   // Frame.cc:609-612
  u_right[kp] = good ? u : -1.f;
  depth[kp] = good ? __fdiv_rn(bf_v, disparity) : -1.f;
  sad_out[kp] = good ? best : __uint_as_float(0x7f800000u);   // +inf
}

int blocks_for(int n) { return (n + kWarpsPerBlock - 1) / kWarpsPerBlock; }

}  // namespace

// left, right: (h, w) float32; yc, xl, xr: (n,) int32.  Writes scores
// (n, 11).  The scores-only entry: the SAD search of the TPU kernel.
extern "C" int orb_sad_strips(const float* left, const float* right, int h,
                              int w, const int* yc, const int* xl,
                              const int* xr, int n, float* scores,
                              cudaStream_t stream) {
  if (n == 0) return 0;
  sad_strips_kernel<<<blocks_for(n), kWarpsPerBlock * 32, 0, stream>>>(
      left, right, h, w, yc, xl, xr, n, scores);
  return static_cast<int>(cudaGetLastError());
}

// left, right: (h, w) float32 level-0 images; xy_l (n, 2), xy_r (m, 2)
// float32 level-0 keypoints; best_idx (n,) int64 into xy_r's rows;
// best_dist (n,) int32; bf, min_disp, max_disp: device pointers to one
// float32 each.  Writes u_right, depth, sad (n,) and, unless it is null,
// scores (n, 11).
extern "C" int orb_stereo_refine(const float* left, const float* right,
                                 int h, int w, const float* xy_l,
                                 const float* xy_r, const long long* best_idx,
                                 const int* best_dist, int th_orb,
                                 const float* bf, const float* min_disp,
                                 const float* max_disp, int n,
                                 float* u_right, float* depth, float* sad,
                                 float* scores, cudaStream_t stream) {
  if (n == 0) return 0;
  stereo_refine_kernel<<<blocks_for(n), kWarpsPerBlock * 32, 0, stream>>>(
      left, right, h, w, xy_l, xy_r, best_idx, best_dist, th_orb, bf,
      min_disp, max_disp, n, u_right, depth, sad, scores);
  return static_cast<int>(cudaGetLastError());
}
