// int8 x int8 -> int32 convolution with fused input quantization and a fused
// epilogue (K2) for Hopper.
//
// Replaces, in one launch per conv, what the JAX package runs as separate XLA
// ops (tpupose/models/quantize.py): `_quant_input` (per-tensor symmetric
// quantization of the conv input), `_int8_conv` (the int8 x int8 -> int32
// `conv_general_dilated`), and either the dequantize-plus-bias epilogue of
// `quantized_conv_apply` or the requantize-relu epilogue `_requant_relu`.
// It is not a port of a Pallas kernel: the JAX package left this op to XLA,
// and PyTorch has no int8 convolution with int32 accumulators.
//
// What it computes, as an implicit GEMM with M = N*Ho*Wo output pixels,
// N = Cout and K = Cin*kh*kw (k = (ci*kh + r)*kw + c, OIHW order):
//   acc[n, co, oh, ow] = sum_k q(x[n, ci, oh*s - ph + r*d, ow*s - pw + c*d])
//                              * wq[co, k]                       (int32)
//   q(v) = clamp(rint(v * inv), -127, 127) for a float input (bf16 or f32),
//          0 where v * inv is NaN (XLA's convert of NaN to int8),
//   q(v) = v for an int8 input (the int8-resident blocks).
// Padding is k//2 with zero-point 0, so an out-of-range tap is exactly 0.
// Epilogue, per output channel co, with vectors the wrapper computes in the
// JAX package's order:
//   dequantize (f32 / bf16 out):  rn(float(acc) * mul[co] + add[co])
//   requant-relu (int8 out):      clamp(rint(float(acc) * mul[co] + add[co]), 0, 127)
// Each step uses a round-to-nearest intrinsic (__fmul_rn, __fadd_rn,
// __int2float_rn, __float2bfloat16_rn) so nvcc cannot contract a*b+c into an
// FMA: the output is bit-equal to the plain torch version
// (tpupose_torch/ops/int8_conv.py), which rounds after every operation.
//
// Bound: bytes, at the shapes that take the time. The heaviest conv of the
// main path, HRNet-W48 branch 0's 3x3 48->48 at 96x72 on 640 crops, reads
// and writes 849 MB of bf16 (0.254 ms at 3.35 TB/s) for 0.183 T int-ops
// (0.093 ms at 1,979 TOPS); the 1x1 convs are more byte-bound still.
//
// Design (simple first; the speed work is queued): one block of 4 warps
// computes a 128 x 64 output tile, stepping K by 32.
//   * A (activations) is gathered by each thread for its own output pixel,
//     so neighbouring threads read neighbouring addresses of the NCHW input.
//     The k -> (input offset, dh, dw) table of each K step is computed once
//     per block into shared memory, so the gather does no division. The
//     values are quantized as they are stored to shared memory as int8.
//   * B (weights) is read as 16-byte vectors from a [Cout_pad][K_pad] int8
//     copy made once at quantize time (Cout padded to 64, K to 32, zeros),
//     so it needs no bounds checks.
//   * Each warp owns a 64 x 32 sub-tile: 4 x 4 `mma.sync.m16n8k32` s8 tensor
//     core products per K step, int32 accumulators in registers. Shared rows
//     are 48 bytes apart, which makes the fragment loads conflict-free.
//   * Two shared buffers: the global loads of step k+1 are in flight while
//     the tensor cores work on step k, and one barrier separates the steps.
//   * The epilogue writes NCHW directly from the accumulators.
// What this leaves on the table, against the byte bound: the float input is
// re-read and re-quantized once per tap (9x for a 3x3) and once per 64
// output channels, and outputs are stored 8 elements per segment. Fixes
// (a quantized int8 activation layout between convs, TMA tiles, wgmma) are
// later work.
//
// Traps, and what the code does about them:
//   * Ragged K (27 for the RGB stems, 432, 576, 4,608): the weight copy is
//     zero-padded to 32 and a tap with k >= K reads nothing (its table entry
//     fails the row bounds check), so the padding adds exact zeros.
//   * Ragged Cout (48, 96, 192, 384 are not multiples of 64): padded weight
//     rows are zero and the epilogue stores only co < Cout.
//   * Ragged M: a thread past M loads zeros and stores nothing.
//   * 64-bit offsets: a stem output holds 1.13e9 elements and M*K reaches
//     2.5e9 > 2^31, so pixel and image offsets are 64-bit; one image's Cin*H*W
//     and Cout*Ho*Wo must fit in 31 bits (the wrapper checks).
//   * A launch that is refused never runs: the C entry returns
//     cudaGetLastError() and the wrapper raises on anything but 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;      // output pixels per block
constexpr int kBN = 64;       // output channels per block
constexpr int kBK = 32;       // K per step (one m16n8k32)
constexpr int kThreads = 128; // 4 warps, 2 x 2, each 64 x 32
constexpr int kRow = kBK + 16;  // shared row stride in bytes

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

struct Shape {
  int n, cin, h, w, cout, kh, kw, stride, pad_h, pad_w, dil, ho, wo, k, kpad;
};

template <int IN> struct Src;
template <> struct Src<kF32> {
  using T = float;
  static __device__ __forceinline__ T load(const void* p, long long i) {
    return __ldg(static_cast<const float*>(p) + i);
  }
};
template <> struct Src<kBF16> {
  using T = unsigned short;
  static __device__ __forceinline__ T load(const void* p, long long i) {
    return __ldg(static_cast<const unsigned short*>(p) + i);
  }
};
template <> struct Src<kI8> {
  using T = signed char;
  static __device__ __forceinline__ T load(const void* p, long long i) {
    return __ldg(static_cast<const signed char*>(p) + i);
  }
};

// A NaN input quantizes to 0, as XLA's float -> int8 convert gives it (fmaxf
// would drop the NaN and give -127).
__device__ __forceinline__ int quantize(float v, float inv) {
  const float p = __fmul_rn(v, inv);
  if (isnan(p)) return 0;
  const float q = fminf(fmaxf(rintf(p), -127.f), 127.f);
  return static_cast<int>(q);
}

template <int IN>
__device__ __forceinline__ int code(typename Src<IN>::T raw, float inv) {
  if constexpr (IN == kI8) {
    return static_cast<int>(raw);
  } else if constexpr (IN == kBF16) {
    return quantize(__uint_as_float(static_cast<unsigned>(raw) << 16), inv);
  } else {
    return quantize(raw, inv);
  }
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Table of one K step: for tap k0 + i, the input offset (ci*H + dh)*W + dw
// and dh, dw packed as two int16 halves. A tap past K gets dh = -32768, which
// fails every row bounds check.
__device__ __forceinline__ void fill_table(int2* table, const Shape& s,
                                           int k0) {
  const int i = threadIdx.x;
  if (i >= kBK) return;
  const int k = k0 + i;
  if (k < s.k) {
    const int taps = s.kh * s.kw;
    const int ci = k / taps;
    const int rs = k - ci * taps;
    const int r = rs / s.kw;
    const int c = rs - r * s.kw;
    const int dh = r * s.dil, dw = c * s.dil;
    table[i] = make_int2((ci * s.h + dh) * s.w + dw,
                         (dh << 16) | (dw & 0xffff));
  } else {
    table[i] = make_int2(0, static_cast<int>(0x80000000u));
  }
}

template <int IN, int OUT>
__global__ void __launch_bounds__(kThreads)
int8_conv_kernel(const void* __restrict__ x, const int8_t* __restrict__ wk,
                 const float* __restrict__ inv_p,
                 const float* __restrict__ mul, const float* __restrict__ add,
                 void* __restrict__ y, const Shape s) {
  using Raw = typename Src<IN>::T;
  __shared__ __align__(16) int8_t a_s[2][kBM * kRow];
  __shared__ __align__(16) int8_t b_s[2][kBN * kRow];
  __shared__ int2 table[2][kBK];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, t = lane & 3;
  const long long hw_out = static_cast<long long>(s.ho) * s.wo;
  const long long m_total = static_cast<long long>(s.n) * hw_out;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;
  float inv = 1.f;
  if constexpr (IN != kI8) inv = __ldg(inv_p);

  // This thread's output pixel for the A gather.
  const long long m = m0 + tid;
  const bool m_ok = m < m_total;
  int ih0 = 0, iw0 = 0;
  long long pix = 0;
  if (m_ok) {
    const long long img = m / hw_out;
    const int p = static_cast<int>(m - img * hw_out);
    const int oh = p / s.wo;
    const int ow = p - oh * s.wo;
    ih0 = oh * s.stride - s.pad_h;
    iw0 = ow * s.stride - s.pad_w;
    pix = img * (static_cast<long long>(s.cin) * s.h * s.w) +
          static_cast<long long>(ih0) * s.w + iw0;
  }

  Raw raw[kBK];
  uint4 b_raw;
  const int b_row = tid >> 1, b_col = (tid & 1) * 16;

  auto load = [&](int buf, int k0) {
#pragma unroll
    for (int i = 0; i < kBK; ++i) {
      const int2 e = table[buf][i];
      const int ih = ih0 + (e.y >> 16);
      const int iw = iw0 + static_cast<short>(e.y & 0xffff);
      const bool ok = m_ok && static_cast<unsigned>(ih) < static_cast<unsigned>(s.h) &&
                      static_cast<unsigned>(iw) < static_cast<unsigned>(s.w);
      raw[i] = ok ? Src<IN>::load(x, pix + e.x) : Raw(0);
    }
    b_raw = __ldg(reinterpret_cast<const uint4*>(
        wk + static_cast<long long>(n0 + b_row) * s.kpad + k0 + b_col));
  };

  auto store = [&](int buf) {
    uint32_t packed[kBK / 4];
#pragma unroll
    for (int j = 0; j < kBK / 4; ++j) {
      uint32_t v = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        v |= (static_cast<uint32_t>(code<IN>(raw[4 * j + b], inv)) & 0xffu) << (8 * b);
      }
      packed[j] = v;
    }
    uint4* dst = reinterpret_cast<uint4*>(&a_s[buf][tid * kRow]);
    dst[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
    dst[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
    *reinterpret_cast<uint4*>(&b_s[buf][b_row * kRow + b_col]) = b_raw;
  };

  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;

  auto compute = [&](int buf) {
    uint32_t af[4][4], bf[4][2];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const int8_t* a = &a_s[buf][(wm * 64 + mi * 16 + g) * kRow + t * 4];
      af[mi][0] = *reinterpret_cast<const uint32_t*>(a);
      af[mi][1] = *reinterpret_cast<const uint32_t*>(a + 8 * kRow);
      af[mi][2] = *reinterpret_cast<const uint32_t*>(a + 16);
      af[mi][3] = *reinterpret_cast<const uint32_t*>(a + 8 * kRow + 16);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int8_t* b = &b_s[buf][(wn * 32 + ni * 8 + g) * kRow + t * 4];
      bf[ni][0] = *reinterpret_cast<const uint32_t*>(b);
      bf[ni][1] = *reinterpret_cast<const uint32_t*>(b + 16);
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
  };

  const int steps = s.kpad / kBK;
  fill_table(table[0], s, 0);
  __syncthreads();
  load(0, 0);
  store(0);
  if (steps > 1) fill_table(table[1], s, kBK);
  __syncthreads();
  for (int step = 0; step < steps; ++step) {
    const int cur = step & 1;
    if (step + 1 < steps) load(cur ^ 1, (step + 1) * kBK);
    compute(cur);
    if (step + 1 < steps) store(cur ^ 1);
    if (step + 2 < steps) fill_table(table[cur], s, (step + 2) * kBK);
    __syncthreads();
  }

  // Epilogue: accumulator (mi, ni, r) is row wm*64 + mi*16 + g + 8*(r >> 1),
  // column wn*32 + ni*8 + 2t + (r & 1).
  float cmul[4][2], cadd[4][2];
  bool cok[4][2];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int co = n0 + wn * 32 + ni * 8 + 2 * t + j;
      cok[ni][j] = co < s.cout;
      cmul[ni][j] = cok[ni][j] ? __ldg(mul + co) : 0.f;
      cadd[ni][j] = (cok[ni][j] && add != nullptr) ? __ldg(add + co) : 0.f;
    }
  const long long out_img = static_cast<long long>(s.cout) * hw_out;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long mm = m0 + wm * 64 + mi * 16 + g + 8 * half;
      if (mm >= m_total) continue;
      const long long img = mm / hw_out;
      const long long base = img * out_img + (mm - img * hw_out);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (!cok[ni][j]) continue;
          const int co = n0 + wn * 32 + ni * 8 + 2 * t + j;
          const long long o = base + static_cast<long long>(co) * hw_out;
          float v = __fmul_rn(__int2float_rn(acc[mi][ni][2 * half + j]), cmul[ni][j]);
          if (add != nullptr) v = __fadd_rn(v, cadd[ni][j]);
          if constexpr (OUT == kI8) {
            v = fminf(fmaxf(rintf(v), 0.f), 127.f);
            static_cast<int8_t*>(y)[o] = static_cast<int8_t>(static_cast<int>(v));
          } else if constexpr (OUT == kBF16) {
            static_cast<__nv_bfloat16*>(y)[o] = __float2bfloat16_rn(v);
          } else {
            static_cast<float*>(y)[o] = v;
          }
        }
    }
}

template <int IN, int OUT>
int launch(const void* x, const int8_t* wk, const float* inv, const float* mul,
           const float* add, void* y, const Shape& s, cudaStream_t stream) {
  const long long m_total = static_cast<long long>(s.n) * s.ho * s.wo;
  const dim3 grid(static_cast<unsigned>((m_total + kBM - 1) / kBM),
                  static_cast<unsigned>((s.cout + kBN - 1) / kBN));
  int8_conv_kernel<IN, OUT><<<grid, kThreads, 0, stream>>>(x, wk, inv, mul,
                                                           add, y, s);
  return static_cast<int>(cudaGetLastError());
}

template <int IN>
int dispatch_out(int out_type, const void* x, const int8_t* wk,
                 const float* inv, const float* mul, const float* add, void* y,
                 const Shape& s, cudaStream_t stream) {
  switch (out_type) {
    case kF32: return launch<IN, kF32>(x, wk, inv, mul, add, y, s, stream);
    case kBF16: return launch<IN, kBF16>(x, wk, inv, mul, add, y, s, stream);
    case kI8: return launch<IN, kI8>(x, wk, inv, mul, add, y, s, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x: (n, cin, h, w) contiguous, in_type 0 f32 / 1 bf16 (quantized on load
// with *inv) / 2 int8 (used as is; inv may be null).
// wk: (ceil(cout/64)*64, kpad) int8 contiguous, kpad = ceil(cin*kh*kw/32)*32,
// row co holding weight_q[co] flattened in (ci, r, c) order, zeros elsewhere.
// mul, add: (cout,) f32; add may be null (no bias).
// y: (n, cout, ho, wo) contiguous, out_type 0 f32 / 1 bf16 (dequantize) or
// 2 int8 (requantize-relu).
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int tpupose_int8_conv(const void* x, int in_type, const int8_t* wk,
                                 const float* inv, const float* mul,
                                 const float* add, void* y, int out_type,
                                 int n, int cin, int h, int w, int cout,
                                 int kh, int kw, int stride, int pad_h,
                                 int pad_w, int dil, int ho, int wo, int kpad,
                                 void* stream) {
  const Shape s{n, cin, h, w, cout, kh, kw, stride, pad_h, pad_w, dil, ho, wo,
                cin * kh * kw, kpad};
  if (static_cast<long long>(n) * ho * wo == 0 || cout == 0) return 0;
  if (kpad % kBK != 0 || kpad < s.k) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (in_type) {
    case kF32: return dispatch_out<kF32>(out_type, x, wk, inv, mul, add, y, s, st);
    case kBF16: return dispatch_out<kBF16>(out_type, x, wk, inv, mul, add, y, s, st);
    case kI8: return dispatch_out<kI8>(out_type, x, wk, inv, mul, add, y, s, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
