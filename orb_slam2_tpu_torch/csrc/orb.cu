// Fused IC angle + rotated BRIEF for all pyramid levels of one image, in
// one launch.
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
// The moments are summed in double, like the plain path.  The double sum
// is exact in any order when every circle pixel is 0 or >= 2^-8; where a
// resized level holds smaller pixels the two orders can differ in the
// last bits of the double, and their float roundings agreed at every
// keypoint of a rendered KITTI frame (tests/test_torch_kernel_levels.py).
// The library is compiled with --fmad=false: a
// fused x*cos - y*sin would round differently from the plain path's
// separate multiply and subtract, and so would move taps at .5.
//
// What bounds it on an H100: device-memory bytes.  At the main path's size
// (2000 keypoints over 8 levels of a 376x1240 image, padded to 2048 rows)
// the pixels it must read -- the 749-px circles of `img` and the 512 taps
// of `blur`, each distinct pixel once -- are at most 10.1 MB, ~3 us at
// 3.35 TB/s, and 3.5 MB (~1.0 us) at a rendered KITTI frame's keypoints,
// whose windows overlap; the float64 moments are 6 MFLOP, 0.18 us at 34
// TFLOP/s.  chip_smoke.py computes the bound from the run's own keypoints.
//
// The design:
//   - one launch per image: the levels travel as a small table passed by
//     value (a kernel parameter, baked into a CUDA graph node), and each
//     warp finds its keypoint's level from the table's row offsets, so the
//     angles and descriptors land straight in the image's padded rows;
//   - one warp per keypoint, 4 warps a block: 2048 rows are 512 blocks,
//     ~4 resident on each of the 132 SMs at once (40 KB of shared memory a
//     block), one wave;
//   - each warp first stages its keypoint's windows in shared memory with
//     row-contiguous loads, all issued before any is used: the 31x31
//     moment window of `img` and the 39x39 tap window of `blur` (taps
//     reach +-19), the latter with every row and column clamped to the
//     image, so that staged[ry+19][rx+19] == blur[clamp(ky+ry)][clamp(kx+rx)]
//     -- the plain path's per-tap clipping, bit for bit;
//   - the BRIEF pattern lives in global memory, and lane j holds pairs
//     j, 32+j, ..., 224+j in registers (one coalesced 16-byte load each),
//     so no lane reads a divergent __constant__ address; the circle's umax
//     table stays in __constant__ memory, read at warp-uniform indices;
//   - lane j sums column j-15 of the circle in float64, the warp reduces
//     with shuffles, then every lane issues its 16 shared-memory taps
//     before the 8 __ballot_sync rounds: lane j of round k compares pair
//     32k+j, so round k's ballot is the little-endian descriptor word k.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kHalfPatch = 15;
constexpr int kPatch = 2 * kHalfPatch + 1;        // 31
constexpr int kTapReach = 19;                     // max |rotated offset|
constexpr int kTapWin = 2 * kTapReach + 1;        // 39
constexpr int kBits = 256;
constexpr int kWarpsPerBlock = 4;
constexpr int kMaxLevels = 16;

__constant__ int c_umax[kHalfPatch + 1];
__device__ int4 g_pattern[kBits];                 // rows (x0, y0, x1, y1)

struct DescribeLevel {
  const float* img;
  const float* blur;
  const int* xy;          // (count, 2) level coords
  const bool* valid;      // (count,)
  int h, w;
  int row0, count;        // the level's rows of the image's outputs
};

struct DescribeTable {
  DescribeLevel lv[kMaxLevels];
  int n_levels;
};

// The level whose rows hold `row`; a padding row gets a level of count 0.
// Every index into the by-value table is a constant after unrolling, so
// the fields are read from the parameter bank and never copied to local
// memory.
__device__ __forceinline__ DescribeLevel find_level(const DescribeTable& t,
                                                    int row) {
  DescribeLevel out = t.lv[0];
  out.count = 0;
#pragma unroll
  for (int i = 0; i < kMaxLevels; ++i) {
    if (i < t.n_levels && row >= t.lv[i].row0 &&
        row < t.lv[i].row0 + t.lv[i].count) {
      out = t.lv[i];
    }
  }
  return out;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
orb_describe_levels_kernel(const DescribeTable t, int n_rows,
                           float* __restrict__ angle,
                           int* __restrict__ desc) {
  __shared__ float s_img[kWarpsPerBlock][kPatch][kPatch + 1];
  __shared__ float s_blur[kWarpsPerBlock][kTapWin][kTapWin];
  const int wib = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + wib;
  if (row >= n_rows) return;                      // uniform across the warp

  const DescribeLevel L = find_level(t, row);
  const int kp = row - L.row0;
  if (kp >= L.count || !L.valid[kp]) {            // padding or invalid row
    if (lane < 8) desc[row * 8 + lane] = 0;
    if (lane == 0) angle[row] = 0.f;
    return;
  }
  const int h = L.h;
  const int w = L.w;
  const int kx = L.xy[2 * kp];
  const int ky = L.xy[2 * kp + 1];
  const int cx = min(max(kx, kHalfPatch), w - 1 - kHalfPatch);
  const int cy = min(max(ky, kHalfPatch), h - 1 - kHalfPatch);

  // this lane's 8 pattern pairs, in flight while the windows load
  int4 pat[kBits / 32];
#pragma unroll
  for (int k = 0; k < kBits / 32; ++k) pat[k] = __ldg(&g_pattern[32 * k + lane]);

  // stage the moment window (in bounds: the centre is clipped) and the
  // clamped tap window; rows are contiguous across lanes
  float (*simg)[kPatch + 1] = s_img[wib];
  float (*sblur)[kTapWin] = s_blur[wib];
  if (lane < kPatch) {
    const float* src = L.img + (cy - kHalfPatch) * w + (cx - kHalfPatch) + lane;
#pragma unroll
    for (int r = 0; r < kPatch; ++r) simg[r][lane] = src[r * w];
  }
  const int c_lo = min(max(kx - kTapReach + lane, 0), w - 1);
  const int c_hi = min(max(kx - kTapReach + 32 + lane, 0), w - 1);
#pragma unroll 13
  for (int r = 0; r < kTapWin; ++r) {
    const float* src = L.blur + min(max(ky - kTapReach + r, 0), h - 1) * w;
    sblur[r][lane] = src[c_lo];
    if (lane < kTapWin - 32) sblur[r][32 + lane] = src[c_hi];
  }
  __syncwarp();

  // intensity-centroid moments over the discrete circle (IC_Angle): lane
  // j sums column u = j - 15 over the rows in order, then the warp adds
  double m10 = 0.0;
  double m01 = 0.0;
  if (lane < kPatch) {
    const int u = lane - kHalfPatch;
    const int au = abs(u);
#pragma unroll
    for (int r = 0; r < kPatch; ++r) {
      const int v = r - kHalfPatch;
      if (au <= c_umax[v < 0 ? -v : v]) {
        const double p = static_cast<double>(simg[r][lane]);
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

  // all 16 taps of this lane, then the 8 ballots
  float t0[kBits / 32];
  float t1[kBits / 32];
#pragma unroll
  for (int k = 0; k < kBits / 32; ++k) {
    const float x0 = static_cast<float>(pat[k].x);
    const float y0 = static_cast<float>(pat[k].y);
    const float x1 = static_cast<float>(pat[k].z);
    const float y1 = static_cast<float>(pat[k].w);
    const int rx0 = static_cast<int>(rintf(x0 * a - y0 * b));
    const int ry0 = static_cast<int>(rintf(x0 * b + y0 * a));
    const int rx1 = static_cast<int>(rintf(x1 * a - y1 * b));
    const int ry1 = static_cast<int>(rintf(x1 * b + y1 * a));
    t0[k] = sblur[ry0 + kTapReach][rx0 + kTapReach];
    t1[k] = sblur[ry1 + kTapReach][rx1 + kTapReach];
  }
  unsigned int my_word = 0;
#pragma unroll
  for (int k = 0; k < kBits / 32; ++k) {
    const unsigned int word = __ballot_sync(0xffffffffu, t0[k] < t1[k]);
    if (lane == k) my_word = word;
  }
  if (lane < 8) desc[row * 8 + lane] = static_cast<int>(my_word);
  if (lane == 0) angle[row] = ang;
}

}  // namespace

// pattern: host (256, 4) int32; umax: host (16,) int32.  Stream-ordered
// copies into the device's pattern and __constant__ umax tables.
extern "C" int orb_set_tables(const int* pattern, const int* umax,
                              cudaStream_t stream) {
  cudaError_t err = cudaMemcpyToSymbolAsync(
      g_pattern, pattern, sizeof(int4) * kBits, 0, cudaMemcpyHostToDevice,
      stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemcpyToSymbolAsync(c_umax, umax, sizeof(int) * (kHalfPatch + 1),
                                0, cudaMemcpyHostToDevice, stream);
  return static_cast<int>(err);
}

// One image's levels.  ptrs: host array of 4 device pointers a level (img,
// blur: (h, w) float32; xy: (count, 2) int32 level coords; valid: (count,)
// bool); ints: host array of 4 ints a level (h, w, row0, count).  Writes
// angle (n_rows,) float32 degrees and desc (n_rows, 8) int32; a row that
// no level holds, or whose keypoint is invalid, gets zeros.
extern "C" int orb_describe_levels(int n_levels, const void* const* ptrs,
                                   const int* ints, int n_rows, float* angle,
                                   int* desc, cudaStream_t stream) {
  if (n_levels < 1 || n_levels > kMaxLevels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rows == 0) return 0;
  DescribeTable t = {};
  t.n_levels = n_levels;
  for (int i = 0; i < n_levels; ++i) {
    t.lv[i].img = static_cast<const float*>(ptrs[4 * i]);
    t.lv[i].blur = static_cast<const float*>(ptrs[4 * i + 1]);
    t.lv[i].xy = static_cast<const int*>(ptrs[4 * i + 2]);
    t.lv[i].valid = static_cast<const bool*>(ptrs[4 * i + 3]);
    t.lv[i].h = ints[4 * i];
    t.lv[i].w = ints[4 * i + 1];
    t.lv[i].row0 = ints[4 * i + 2];
    t.lv[i].count = ints[4 * i + 3];
  }
  const int blocks = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  orb_describe_levels_kernel<<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      t, n_rows, angle, desc);
  return static_cast<int>(cudaGetLastError());
}
