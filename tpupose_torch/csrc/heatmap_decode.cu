// Fused heatmap -> keypoint decode (K1) for Hopper.
//
// Replaces the Pallas TPU kernel `_decode_kernel` under
// `decode_heatmaps_pallas` (tpupose/ops/pallas_heatmap.py), and with it the
// XLA decode `decode_heatmaps` (tpupose/ops/heatmap.py), whose three
// refinement modes it implements: raw argmax, the quarter-offset toward the
// stronger neighbour, and the clipped parabola vertex.
//
// What it computes, per (crop n, joint j) plane of an (N, J, H, W) f32
// heatmap tensor:
//   * score = max over the H x W plane;
//   * the argmax with ties to the first row-major index (NaN counts as the
//     largest value, like torch.argmax and jnp.argmax);
//   * for a peak strictly inside on both axes, the refinement from its four
//     neighbours;
//   * the image coordinates x0 + px / W * bw and y0 + py / H * bh through
//     the (N, 4) crop box.
// It writes (N, J, 3) f32 (x, y, score).
//
// Bound: bytes. The heatmaps are read once and nothing else is large. At
// the main path's shape (640, 17, 96, 72) that is 640*17*96*72*4 B =
// 300.8 MB, about 90 us at the H100 SXM's 3.35 TB/s; the ~3 ops per element
// are far below any compute limit.
//
// Design: one warp per plane, 8 warps per block. Each lane scans a strided
// share of the plane (16-byte loads when the plane allows them, so a warp
// moves 512 contiguous bytes per load) keeping (value, smallest index); a
// butterfly shuffle reduction breaks equal values to the smaller index, so
// the result is exactly the first row-major argmax whatever the order of
// the scan. Lane 0 reads the four neighbours and maps through the box with
// round-to-nearest intrinsics in the plain version's order, so nvcc cannot
// contract the mapping into an FMA and the coordinates agree bit for bit
// with the torch version.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

// (v, i) is better than (bv, bi): larger value, NaN above every number,
// equal values to the smaller index.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  const bool vn = isnan(v), bn = isnan(bv);
  if (vn != bn) return vn;
  if (vn) return i < bi;
  return v > bv || (v == bv && i < bi);
}

// jnp.sign: -1, +-0 or 1, and NaN for NaN (a peak between two -inf or two
// +inf neighbours gives inf - inf).
__device__ __forceinline__ float sign_of(float d) {
  if (isnan(d)) return d;
  return d > 0.f ? 1.f : (d < 0.f ? -1.f : d);
}

__device__ __forceinline__ float refine_offset(float c, float hi, float lo,
                                               int mode) {
  if (mode == 1) return __fmul_rn(0.25f, sign_of(__fsub_rn(hi, lo)));
  // parabolic: (hi - lo) / (2 * max(2c - hi - lo, 1e-6)), clipped to 0.5;
  // the max and the clip keep NaN, as jnp.maximum and jnp.clip do (fmaxf
  // and fminf would drop it)
  float den = __fsub_rn(__fsub_rn(__fmul_rn(2.f, c), hi), lo);
  if (!isnan(den)) den = fmaxf(den, 1e-6f);
  const float d = __fdiv_rn(__fsub_rn(hi, lo), __fmul_rn(2.f, den));
  return isnan(d) ? d : fminf(fmaxf(d, -0.5f), 0.5f);
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
heatmap_decode_kernel(const float* __restrict__ heat,
                      const float* __restrict__ boxes,
                      float* __restrict__ out, int n, int j, int h, int w,
                      int refine, int vec4) {
  const long long plane_id =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (plane_id >= (long long)n * j) return;
  const int hw = h * w;
  const float* plane = heat + plane_id * hw;

  float best = -INFINITY;
  int best_idx = 0x7fffffff;
  if (vec4) {
    const float4* p4 = reinterpret_cast<const float4*>(plane);
    const int n4 = hw >> 2;
#pragma unroll 4
    for (int k = lane; k < n4; k += 32) {
      const float4 q = __ldg(p4 + k);
      const int i = k << 2;
      if (better(q.x, i, best, best_idx)) { best = q.x; best_idx = i; }
      if (better(q.y, i + 1, best, best_idx)) { best = q.y; best_idx = i + 1; }
      if (better(q.z, i + 2, best, best_idx)) { best = q.z; best_idx = i + 2; }
      if (better(q.w, i + 3, best, best_idx)) { best = q.w; best_idx = i + 3; }
    }
  } else {
#pragma unroll 4
    for (int i = lane; i < hw; i += 32) {
      const float v = __ldg(plane + i);
      if (better(v, i, best, best_idx)) { best = v; best_idx = i; }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, best_idx, off);
    if (better(ov, oi, best, best_idx)) { best = ov; best_idx = oi; }
  }
  if (lane != 0) return;

  const int yi = best_idx / w;
  const int xi = best_idx - yi * w;
  float px = (float)xi;
  float py = (float)yi;
  if (refine != 0 && xi >= 1 && xi < w - 1 && yi >= 1 && yi < h - 1) {
    const float right = plane[best_idx + 1];
    const float left = plane[best_idx - 1];
    const float up = plane[best_idx + w];
    const float down = plane[best_idx - w];
    px = __fadd_rn(px, refine_offset(best, right, left, refine));
    py = __fadd_rn(py, refine_offset(best, up, down, refine));
  }
  const long long crop = plane_id / j;
  const float* box = boxes + crop * 4;
  const float bw = __fsub_rn(box[2], box[0]);
  const float bh = __fsub_rn(box[3], box[1]);
  float* o = out + plane_id * 3;
  o[0] = __fadd_rn(box[0], __fmul_rn(__fdiv_rn(px, (float)w), bw));
  o[1] = __fadd_rn(box[1], __fmul_rn(__fdiv_rn(py, (float)h), bh));
  o[2] = best;
}

}  // namespace

// heat: (n, j, h, w) f32 contiguous; boxes: (n, 4) f32 contiguous;
// out: (n, j, 3) f32 contiguous; refine: 0 raw, 1 quarter, 2 parabolic.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int tpupose_heatmap_decode(const float* heat, const float* boxes,
                                      float* out, int n, int j, int h, int w,
                                      int refine, void* stream) {
  const long long planes = (long long)n * j;
  if (planes == 0) return 0;
  const int vec4 =
      ((h * w) % 4 == 0) && ((reinterpret_cast<uintptr_t>(heat) & 15) == 0);
  const long long blocks = (planes + kWarpsPerBlock - 1) / kWarpsPerBlock;
  heatmap_decode_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      heat, boxes, out, n, j, h, w, refine, vec4);
  return (int)cudaGetLastError();
}
