// One pass after a conv on channels-last tensors: bias, nearest upsample,
// residual and activation (the stage-A epilogue).
//
// Replaces no TPU kernel: on the TPU, XLA fused a conv's bias, activation and
// residual add into the conv's output fusion (tpupose/models/layers.py
// `conv_apply`, hrnet.py, yolov3.py leave them to it). PyTorch runs each as a
// pass of its own after cuDNN's conv: the bias add (`_convolution`'s
// `output.add_(bias)`, a broadcast kernel that is not vectorized), ReLU as
// `clamp_min`, leaky ReLU, the residual or fuse-sum add and, in HRNet's fuse
// layers, a nearest upsample that writes the coarse term at full size. This
// kernel is those passes as one, read once and written once.
//
// What it computes, for an (N, H, W, C) output, in f32 from bf16 (or f32)
// operands, where C % 8 == 0 or, without an upsample, where the output holds
// a multiple of 8 elements (HRFormer's 78- and 156-wide branches):
//   t = src[n, h >> u, w >> u, c]                  (u = 0..3: nearest upsample)
//   t = rn(t + bias[c])                            (where there is a bias)
//   t = act(t)                                     (where the activation is first)
//   t = rn(t + skip[n, h, w, c])                   (where there is a skip)
//   t = act(t)                                     (otherwise)
//   act: none; ReLU `isnan(t) ? t : fmaxf(t, 0)`, exact; leaky ReLU
//   `t > 0 ? t : rn(t * 0.1f)`; GELU `rn(t * 0.5f * (1 + erff(t * M_SQRT1_2)))`,
//   exact erf in f32, ATen's `GeluCUDAKernelImpl` (approximate "none") term
//   for term.
// rn rounds to the output's type: bf16 (round to nearest even) or f32. Each
// step is the arithmetic of the PyTorch kernel it replaces (ATen's add with
// alpha 1 on opmath floats, `launch_clamp_scalar`'s min clamp,
// `leaky_relu_kernel`), rounded where that kernel writes bf16, with
// round-to-nearest intrinsics so that nvcc cannot contract a product into
// an add (and erff from the same CUDA math library as ATen's): the output
// is bit-equal to the composed ops
// (tpupose_torch/ops/epilogue.py `bias_act_plain`). A bias added before a
// nearest upsample or after it gives the same values, so the coarse term's
// bias is added on the fly.
//
// Bound: bytes. One output element moves 2 bytes in (4 with a skip, less for
// an upsampled src, which is read 4^u times from L2) and 2 out, for at most
// four flops. HRNet-W48's branch-0 output at 640 crops of 96x72x48 (212 M
// elements) with a skip moves 1.27 GB: 0.380 ms at 3.35 TB/s.
//
// Design: each thread moves 8 channels of one pixel (16-byte loads and
// stores of bf16, two of f32) and walks a grid-strided loop over the whole
// output, no atomics. The grid is 64 blocks of 256 threads an SM, eight
// times what the SMs hold at once, and a multiple of lcm(256, C / 8)
// threads, so that a thread's 8 channels are the same at every step: its 8
// bias values are loaded into registers once. Measured on an H100 80GB HBM3
// at 700 W over seven main-path shapes, 64 blocks an SM ran 9-19% faster
// than 8 (one wave of resident blocks) and as fast as 128; two or four
// vectors a thread an iteration, loaded before any is computed, were no
// faster than one. An upsampled src is addressed from the pixel's (n, h, w),
// found with 32-bit divisions (the wrapper keeps every index below 2^31).
// The wrapper checks that every tensor is 16-byte aligned.
//
// Flat mode (C % 8 != 0, no upsample): the tensors are read as one flat
// array of 8-element vectors, a vector's elements lying in one pixel or two.
// Element e's channel is e % C, and vector v's first channel (8 v) % C
// repeats with a period of C / gcd(C, 8) vectors; the grid is a multiple of
// that period too, so a thread's 8 bias values are again loaded once. For C
// % 8 == 0 the period is C / 8 and the grid the one above. The flat mode and
// GELU are instantiations of their own (FLAT, GELU), so that the other
// modes run the code they had.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 64;
constexpr int kMaxDevices = 64;

enum { kF32 = 0, kBF16 = 1 };
enum { kNone = 0, kRelu = 1, kLeaky = 2, kGelu = 3 };

// 8 consecutive elements of type T at element offset e, as floats.
template <int T>
__device__ __forceinline__ void load8(const void* p, long long e, float (&v)[8]) {
  if constexpr (T == kBF16) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(
        static_cast<const unsigned short*>(p) + e));
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = __uint_as_float(w[k] << 16);
      v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  } else {
    const float4* f = reinterpret_cast<const float4*>(static_cast<const float*>(p) + e);
    const float4 a = __ldg(f), b = __ldg(f + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
}

// The bf16 bits of v: rounded to nearest even, but a NaN keeps the upper
// half of its bits, as a bf16 NaN that ReLU's clamp passes through keeps
// its own. A NaN that an add or a product made went through rn, whose
// __float2bfloat16_rn wrote it as 0x7fff, as PyTorch's conversion does.
__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return isnan(v) ? __float_as_uint(v) >> 16 : __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

template <int T>
__device__ __forceinline__ void store8(void* p, long long e, const float (&v)[8]) {
  if constexpr (T == kBF16) {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = bf16_bits(v[2 * k]) | (bf16_bits(v[2 * k + 1]) << 16);
    *reinterpret_cast<uint4*>(static_cast<unsigned short*>(p) + e) =
        make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    float4* f = reinterpret_cast<float4*>(static_cast<float*>(p) + e);
    f[0] = make_float4(v[0], v[1], v[2], v[3]);
    f[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// v rounded to the output's type and back.
template <int T>
__device__ __forceinline__ float rn(float v) {
  if constexpr (T == kBF16) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

// GELU has an instantiation of its own, so that erff's code does not weigh
// on the other activations' registers.
template <int T, bool GELU>
__device__ __forceinline__ float activate(float v, int act) {
  if constexpr (GELU) {
    // x * 0.5 * (1 + erf(x * M_SQRT1_2)), left to right, as ATen writes it
    const float e = erff(__fmul_rn(v, 0.70710678118654752440f));
    return rn<T>(__fmul_rn(__fmul_rn(v, 0.5f), __fadd_rn(1.f, e)));
  }
  if (act == kRelu) return isnan(v) ? v : fmaxf(v, 0.f);
  if (act == kLeaky) return v > 0.f ? v : rn<T>(__fmul_rn(v, 0.1f));
  return v;
}

struct Args {
  const void* src;
  const void* bias;  // (C,) of the output's type, or null
  const void* skip;  // the output's shape, or null
  void* out;
  unsigned vecs;     // output elements / 8
  unsigned cv;       // C / 8 (C % 8 == 0 where there is an upsample)
  unsigned pv;       // vectors a period of the channels: C / gcd(C, 8)
  unsigned c;        // C
  unsigned w, h;     // the output's width and height
  unsigned ws, hs;   // src's (w >> up, h >> up)
  int up, act, act_first;
};

template <int T, bool UP, bool FLAT, bool GELU>
__global__ void __launch_bounds__(kThreads) bias_act_nhwc_kernel(const Args a) {
  const unsigned stride = gridDim.x * kThreads;  // a multiple of pv
  unsigned v = blockIdx.x * kThreads + threadIdx.x;
  if (v >= a.vecs) return;
  const unsigned c8 = v % a.cv;
  float b[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) b[k] = 0.f;
  if (a.bias != nullptr) {
    const unsigned c0 = (FLAT ? v % a.pv : c8) * 8;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const unsigned ch = FLAT ? (c0 + k) % a.c : c0 + k;
      if constexpr (T == kBF16) {
        b[k] = __bfloat162float(static_cast<const __nv_bfloat16*>(a.bias)[ch]);
      } else {
        b[k] = static_cast<const float*>(a.bias)[ch];
      }
    }
  }
  const unsigned pstride = stride / a.cv;
  unsigned p = v / a.cv;  // the output pixel
  for (; v < a.vecs; v += stride, p += pstride) {
    long long so = static_cast<long long>(v) * 8;
    if constexpr (UP) {
      const unsigned x = p % a.w, r = p / a.w, y = r % a.h, n = r / a.h;
      const unsigned sp = (n * a.hs + (y >> a.up)) * a.ws + (x >> a.up);
      so = (static_cast<long long>(sp) * a.cv + c8) * 8;
    }
    float t[8], s[8];
    load8<T>(a.src, so, t);
    if (a.skip != nullptr) load8<T>(a.skip, static_cast<long long>(v) * 8, s);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float o = t[k];
      if (a.bias != nullptr) o = rn<T>(__fadd_rn(o, b[k]));
      if (a.act_first) o = activate<T, GELU>(o, a.act);
      if (a.skip != nullptr) o = rn<T>(__fadd_rn(o, s[k]));
      if (!a.act_first) o = activate<T, GELU>(o, a.act);
      t[k] = o;
    }
    store8<T>(a.out, static_cast<long long>(v) * 8, t);
  }
}

unsigned gcd(unsigned a, unsigned b) {
  while (b != 0) {
    const unsigned r = a % b;
    a = b;
    b = r;
  }
  return a;
}

// kBlocksPerSM blocks an SM, no more than the output needs, rounded up to a
// multiple of lcm(kThreads, pv) / kThreads.
int grid_for(unsigned vecs, unsigned pv, unsigned* blocks) {
  static int sms[kMaxDevices] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned unit = pv / gcd(pv, kThreads);  // blocks a grid is a multiple of
  const unsigned long long need = (vecs + kThreads - 1) / kThreads;
  unsigned long long want = static_cast<unsigned long long>(sms[dev]) * kBlocksPerSM;
  if (want > need) want = need;
  want = (want + unit - 1) / unit * unit;
  if (want * kThreads >= (1ull << 31)) return static_cast<int>(cudaErrorInvalidConfiguration);
  *blocks = static_cast<unsigned>(want);
  return 0;
}

template <int T, bool UP, bool FLAT>
void launch_act(const Args& a, unsigned blocks, cudaStream_t stream) {
  if (a.act == kGelu) {
    bias_act_nhwc_kernel<T, UP, FLAT, true><<<blocks, kThreads, 0, stream>>>(a);
  } else {
    bias_act_nhwc_kernel<T, UP, FLAT, false><<<blocks, kThreads, 0, stream>>>(a);
  }
}

template <int T>
int launch(const Args& a, cudaStream_t stream) {
  unsigned blocks = 0;
  const int rc = grid_for(a.vecs, a.pv, &blocks);
  if (rc != 0) return rc;
  if (a.up > 0) {
    launch_act<T, true, false>(a, blocks, stream);
  } else if (a.c % 8 != 0) {
    launch_act<T, false, true>(a, blocks, stream);
  } else {
    launch_act<T, false, false>(a, blocks, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (n, h, w, c) = the epilogue above of src (n, h >> up, w >> up, c),
// bias (c,) (or null) and skip (n, h, w, c) (or null), all contiguous in
// that order (channels-last), of one type: dtype 0 f32 / 1 bf16. c % 8 == 0,
// or up 0 and n*h*w*c % 8 == 0 (flat mode); h and w multiples of 2^up, up in
// 0..3, act 0 none / 1 ReLU / 2 leaky ReLU at 0.1 / 3 GELU (erf), act_first
// nonzero for act(t) + skip. src, skip and out 16-byte aligned; n*h*w*c / 8
// below 2^31. Launches on `stream` and returns cudaGetLastError() (0 on
// success).
extern "C" int tpupose_bias_act_nhwc(const void* src, const void* bias, const void* skip,
                                     void* out, int dtype, int n, int h, int w, int c,
                                     int up, int act, int act_first, void* stream) {
  if (n < 0 || h < 0 || w < 0 || c <= 0 || up < 0 || up > 3 ||
      act < kNone || act > kGelu || h % (1 << up) != 0 || w % (1 << up) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned long long elems = static_cast<unsigned long long>(n) * h * w * c;
  if (c % 8 != 0 && (up != 0 || elems % 8 != 0)) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned long long vecs = elems / 8;
  if (vecs == 0) return 0;
  if (vecs >= (1ull << 31)) return static_cast<int>(cudaErrorInvalidValue);
  for (const void* p : {src, skip, static_cast<const void*>(out)})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned cu = static_cast<unsigned>(c);
  const Args a{src, bias, skip, out, static_cast<unsigned>(vecs),
               c % 8 == 0 ? cu / 8 : 1u, cu / gcd(cu, 8), cu,
               static_cast<unsigned>(w), static_cast<unsigned>(h),
               static_cast<unsigned>(w >> up), static_cast<unsigned>(h >> up),
               up, act, act_first != 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch<kF32>(a, st);
    case kBF16: return launch<kBF16>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
