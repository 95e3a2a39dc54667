// int8 x int8 -> int32 convolution with its input quantization and a fused
// epilogue (K2) for Hopper.
//
// Replaces what the JAX package runs as separate XLA ops
// (tpupose/models/quantize.py:210-272): `_quant_input` (per-tensor symmetric
// quantization of the conv input), `_int8_conv` (the int8 x int8 -> int32
// `conv_general_dilated`), and either the dequantize-plus-bias epilogue of
// `quantized_conv_apply` or the requantize-relu epilogue `_requant_relu`.
// It is not a port of a Pallas kernel: the JAX package left this op to XLA,
// and PyTorch has no int8 convolution with int32 accumulators.
//
// What it computes, with M = N*Ho*Wo output pixels and K = Cin*kh*kw:
//   acc[n, co, oh, ow] = sum_{r, c, ci} q(x[n, ci, oh*s - ph + r*d, ow*s - pw + c*d])
//                                       * wq[co, ci, r, c]              (int32)
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
// (tpupose_torch/ops/int8_conv.py), which rounds after every operation. Any
// order of the int32 sums gives the same result, so the two paths below
// agree with it and with each other.
//
// Bound: bytes, at the shapes that take the time. HRNet-W48 branch 0's 3x3
// 48->48 at 96x72 on 640 crops, the heaviest conv of the main path, must
// read and write 849.4 MB of bf16 if quantization and epilogue are fused
// into one pass (0.2535 ms at 3.35 TB/s), for 0.183 T int-ops (0.093 ms at
// 1,979 TOPS); the 1x1 convs are more byte-bound still.
//
// Three paths, chosen by Cin, kh and kw (the wrapper decides), each for the
// activation's layout: NCHW, or channels-last (an (N, C, H, W) tensor with
// NHWC strides, the layout the served path and the JAX package compute in),
// whose output is channels-last again.
//
// Cin % 16 == 0, every conv of the main path but the two RGB stems: two
// launches (one for an int8 channels-last input).
//   K2a `quantize_nhwc_kernel` quantizes x once into an (N, H, W, Cp) int8
//   copy (Cp = Cin rounded up to 16, pad channels 0; an int8 x is copied
//   through). A block moves 64 channels x 64 pixels through shared memory:
//   loads run along W (4 pixels a thread), each pixel's channels leave as
//   16-byte stores.
//   K2b `int8_conv_nhwc_kernel` is an implicit GEMM over that copy, with K
//   in (r, c, ci) order (the HWIO order of `_int8_conv`; `pack_weight`
//   writes the weights so). A 16-byte segment of a K step is 16 channels of
//   one tap of one pixel, copied by one `cp.async.cg` of 16 bytes, zero-
//   filled (src-size 0) for taps outside the image, pixels past M and K past
//   its end. Each thread keeps the (r, c, ci) of its own segment column and
//   steps it with the K loop, so no division runs in the loop. A block of 4
//   warps computes 128 pixels x 64 channels over a ring of 4 shared-memory
//   stages of 64 K (`cp.async.commit_group` / `wait_group`, 48 KB), whose
//   16-byte chunks are XOR-swizzled by row so that `ldmatrix` reads them
//   without bank conflicts into the fragments of `mma.sync.m16n8k32` s8
//   (each warp 64 x 32, int32 accumulators in registers). Consecutive
//   blocks share their 128 pixels, so the A rows of the later ones come
//   from L2. Measured on an H100 80GB HBM3 at 700 W, 128 x 128 and
//   256 x 64 blocks, 64 x 64 warp tiles and 3 stages were no faster summed
//   over the main path's convs. The epilogue stages the output tile through shared memory,
//   so a warp writes runs of consecutive pixels of one channel (NCHW) as
//   16-byte stores; a run that leaves its image or its alignment stores
//   scalars.
//   This design moves more than the fused bound: at branch 0 the quantize
//   pass reads 424.7 MB of bf16 and writes 212.3 MB of int8, the GEMM reads
//   212.3 MB and writes 424.7 MB, about 1,274 MB (0.380 ms at 3.35 TB/s).
//   Channels-last: K2a's elementwise mode `quantize_nhwc_cl_kernel` reads a
//   run of 16 channels of one pixel (16-byte loads) and writes its 16 codes
//   as one 16-byte store, with no shared memory (the same bytes as the
//   transposing mode); an int8 channels-last input (the int8-resident
//   blocks' inter-conv tensors) is K2b's operand as it is, and K2a does not
//   run. K2b's NHWC template stages its tile as o_s[m][co] and writes each
//   pixel's channels n0.. as 16-byte runs (the output's rows are a pixel's
//   Cout channels), scalars where a run passes Cout or its alignment; the
//   loads, the mma pipeline and the epilogue arithmetic are the NCHW
//   template's.
//   Left for later: `wgmma` with TMA; a 48-wide N tile for branch 0, whose
//   Cout of 48 wastes a quarter of a 64-wide tile.
//
// Cin * kh * kw <= 32, the two RGB stems (3 x 3 x 3 = 27 at Cin 3): one
// launch of the stem kernel `int8_stem_kernel`. Bound: bytes, and 84% of
// them the output: HRNet's stem 3x3 s2 3->64 at 384x288 on 640 crops reads
// 424.7 MB of bf16 and writes 2,265 MB (0.8029 ms at 3.35 TB/s, for 0.05 T
// int-ops); YOLO's 3x3 3->32 at 416x416 on 160 images 1.938 GB (0.5786
// ms). One block a tile of `rows` x `cols` output pixels of one image
// (runs of at most 512 columns, as many whole rows as fit in 256 pixels,
// at least one: HRNet 1 x 144, YOLO 1 x 416), for 64 output channels; the
// grid is images x tiles x Cout / 64.
// The block loads its raw input halo in one round of 16-byte cp.async
// copies along W (zero-filled outside the image; scalar loads where W or x
// is not 16-byte aligned), quantizes each element once, one chunk a lane,
// and keeps the codes as int8 in shared memory; all of K is one m16n8k32
// step. The mma's rows are the output channels (A: the 64 weight rows in
// `pack_weight`'s (ci, r, c) order, in registers for the whole block) and
// its columns 8 pixels (B: fragment words of four taps of one pixel,
// gathered from the halo at offsets the host computes), so an accumulator
// pair is one channel at two neighbouring pixels and leaves as one store
// into a stage in shared memory, one row of pixels per channel (the stage
// has a row for every channel of the 16-channel tiles the block computes,
// Cout rounded up to 16, at most 64). One thread a channel's run (its
// tile row, or all the tile's rows where they are whole output rows) sends
// the run to its NCHW plane as one TMA bulk copy (`cp.async.bulk`, off the
// warps' load / store pipe), or element by element where the run or its
// destination is not 16-byte aligned. Measured on an H100 80GB HBM3 at
// 700 W, persistent blocks that prefetched the next tile's halo into a
// second buffer, and tiles of more than one row at the stems' widths,
// were slower. Channels-last output (NHWC template): the stage holds a row
// of channels per pixel, and the block's threads copy each pixel's
// channels n0.. to the output as 16-byte runs, consecutive in memory where
// the block's channels are all of Cout (both stems). The input stays NCHW:
// the wrapper copies a channels-last 3-channel input to NCHW first.
//
// Any other Cin: one launch of the gather kernel `int8_conv_kernel` (once the
// kernel of every Cin; on the main path it now runs no conv), which reads
// NCHW and quantizes as it loads. Its K is in (ci, r, c) order. Each thread
// gathers the 32 K values of its own output pixel per step through a
// per-block table k -> (input offset, dh, dw), so neighbouring threads read
// neighbouring addresses; B comes as 16-byte vectors; two shared buffers;
// each warp 64 x 32 of `mma.sync.m16n8k32`. It re-quantizes each input
// element once per tap and per 64 output channels, and writes one scalar a
// thread a channel (half a 32-byte sector per warp store): 3.2 ms at the
// HRNet stem on an H100 80GB HBM3 at 700 W, 25% of its bound.
//
// Traps, and what the code does about them:
//   * Ragged K (27 for the RGB stems, 432, 576, 4,608): the weight operand
//     is zero-padded to 32; a K position past K loads zeros on the A side
//     (the stem kernel gives it a halo offset of -1, read as code 0).
//   * Ragged Cout (48, 96, 192, 384 are not multiples of 64): padded weight
//     rows are zero and the epilogue stores only co < Cout.
//   * Ragged M: a pixel past M loads zeros and stores nothing.
//   * 64-bit offsets: a stem output holds 1.13e9 elements and M*K reaches
//     2.5e9 > 2^31, so image and pixel offsets (NCHW and NHWC) are 64-bit;
//     one image's Cin*H*W and Cout*Ho*Wo must fit in 31 bits (the wrapper
//     checks).
//   * A launch that is refused never runs: each C entry returns
//     cudaGetLastError() (0 on success), and the wrapper raises on
//     anything else.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Gather kernel (Cin % 16 != 0).
constexpr int kBM = 128;      // output pixels per block
constexpr int kBN = 64;       // output channels per block
constexpr int kBK = 32;       // K per step (one m16n8k32)
constexpr int kThreads = 128; // 4 warps, 2 x 2, each 64 x 32
constexpr int kRow = kBK + 16;  // shared row stride in bytes

// K2a, the quantize-to-channels-last pass.
constexpr int kQP = 64;          // pixels per block
constexpr int kQC = 64;          // channels per block
constexpr int kQThreads = 256;   // 16 pixel quads x 16 channel quads
constexpr int kQWords = kQC / 4 + 1;  // shared words per pixel row (+1: banks)

// K2b, the implicit GEMM on the channels-last copy.
constexpr int kGM = 128;         // output pixels per block
constexpr int kGN = 64;          // output channels per block
constexpr int kGK = 64;          // K bytes per stage: 4 segments of 16
constexpr int kStages = 4;       // cp.async ring
constexpr int kGThreads = 128;   // 4 warps, 2 x 2, each 64 x 32
constexpr int kGRows = kGThreads / 4;  // rows a pass of 16-byte copies covers

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


// ---------------------------------------------------------------------------
// K2a: (N, C, H, W) f32 / bf16 / int8 -> (N, H, W, Cp) int8.

// Four consecutive elements of one channel plane, quantized. VEC: one
// aligned vector load (the plane length is a multiple of 4 and x is
// aligned); else four scalar loads, each checked against the plane's end.
template <int IN, bool VEC>
__device__ __forceinline__ void load_quad(const void* x, long long i, int left,
                                          float inv, int (&q)[4]) {
  if constexpr (VEC) {
    if constexpr (IN == kF32) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(x) + i));
      q[0] = quantize(v.x, inv); q[1] = quantize(v.y, inv);
      q[2] = quantize(v.z, inv); q[3] = quantize(v.w, inv);
    } else if constexpr (IN == kBF16) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(
          static_cast<const unsigned short*>(x) + i));
      q[0] = quantize(__uint_as_float(v.x << 16), inv);
      q[1] = quantize(__uint_as_float(v.x & 0xffff0000u), inv);
      q[2] = quantize(__uint_as_float(v.y << 16), inv);
      q[3] = quantize(__uint_as_float(v.y & 0xffff0000u), inv);
    } else {
      const unsigned v = __ldg(reinterpret_cast<const unsigned*>(
          static_cast<const signed char*>(x) + i));
#pragma unroll
      for (int j = 0; j < 4; ++j) q[j] = static_cast<signed char>(v >> (8 * j));
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      q[j] = j < left ? code<IN>(Src<IN>::load(x, i + j), inv) : 0;
  }
}

template <int IN, bool VEC>
__global__ void __launch_bounds__(kQThreads)
quantize_nhwc_kernel(const void* __restrict__ x, const float* __restrict__ inv_p,
                     int8_t* __restrict__ y, int c, int plane, int cp) {
  __shared__ uint32_t tile[kQP * kQWords];
  const int tid = threadIdx.x;
  const int pq = tid & 15, cq = tid >> 4;
  const int p0 = blockIdx.x * kQP;
  const int c0 = blockIdx.y * kQC;
  const long long img = blockIdx.z;
  float inv = 1.f;
  if constexpr (IN != kI8) inv = __ldg(inv_p);

  // Load: channel c0 + 4*cq + j, pixels p0 + 4*pq .. + 3; a warp reads
  // 16 quads of pixels of each of two channels.
  const int p = p0 + 4 * pq;
  int q[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int ch = c0 + 4 * cq + j;
#pragma unroll
    for (int i = 0; i < 4; ++i) q[j][i] = 0;
    if (ch < c && p < plane)
      load_quad<IN, VEC>(x, (img * c + ch) * plane + p, plane - p, inv, q[j]);
  }
  // Transpose: pixel p0 + 4*pq + i gets its four channels as one word.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t word = (static_cast<uint32_t>(q[0][i]) & 0xffu) |
                          ((static_cast<uint32_t>(q[1][i]) & 0xffu) << 8) |
                          ((static_cast<uint32_t>(q[2][i]) & 0xffu) << 16) |
                          (static_cast<uint32_t>(q[3][i]) << 24);
    tile[(4 * pq + i) * kQWords + cq] = word;
  }
  __syncthreads();

  // Store: 16 channels of one pixel per thread, 16 bytes, four threads per
  // pixel row of the tile.
  const int chunks = min(kQC, cp - c0) / 16;
  const int px = tid >> 2, ck = tid & 3;
  if (ck < chunks && p0 + px < plane) {
    const uint32_t* src = &tile[px * kQWords + 4 * ck];
    *reinterpret_cast<uint4*>(y + (img * plane + p0 + px) * cp + c0 + 16 * ck) =
        make_uint4(src[0], src[1], src[2], src[3]);
  }
}

template <int IN>
int launch_quantize(const void* x, const float* inv, int8_t* y, int n, int c,
                    int plane, int cp, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((plane + kQP - 1) / kQP),
                  static_cast<unsigned>((cp + kQC - 1) / kQC), static_cast<unsigned>(n));
  constexpr int kSize = IN == kF32 ? 4 : IN == kBF16 ? 2 : 1;
  if (plane % 4 == 0 && reinterpret_cast<uintptr_t>(x) % (4 * kSize) == 0) {
    quantize_nhwc_kernel<IN, true><<<grid, kQThreads, 0, stream>>>(x, inv, y, c, plane, cp);
  } else {
    quantize_nhwc_kernel<IN, false><<<grid, kQThreads, 0, stream>>>(x, inv, y, c, plane, cp);
  }
  return static_cast<int>(cudaGetLastError());
}

// K2a on a channels-last input: (N, H, W, C) f32 / bf16 / int8 with
// C % 16 == 0 -> the same (N, H, W, C) int8, element for element. One thread
// a run of 16 channels of one pixel: 16-byte loads where VEC (x 16-byte
// aligned), scalar loads else, and one 16-byte store. No transpose, so no
// shared memory.
constexpr int kQLThreads = 256;

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (static_cast<uint32_t>(a) & 0xffu) | ((static_cast<uint32_t>(b) & 0xffu) << 8) |
         ((static_cast<uint32_t>(c) & 0xffu) << 16) | (static_cast<uint32_t>(d) << 24);
}

template <int IN, bool VEC>
__global__ void __launch_bounds__(kQLThreads)
quantize_nhwc_cl_kernel(const void* __restrict__ x, const float* __restrict__ inv_p,
                        int8_t* __restrict__ y, long long runs) {
  const long long r = static_cast<long long>(blockIdx.x) * kQLThreads + threadIdx.x;
  if (r >= runs) return;
  const long long e = r * 16;
  float inv = 1.f;
  if constexpr (IN != kI8) inv = __ldg(inv_p);
  uint4 out;
  if constexpr (VEC && IN == kI8) {
    out = __ldg(reinterpret_cast<const uint4*>(static_cast<const int8_t*>(x) + e));
  } else if constexpr (VEC && IN == kF32) {
    const float4* p = reinterpret_cast<const float4*>(static_cast<const float*>(x) + e);
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 v = __ldg(p + j);
      w[j] = pack4(quantize(v.x, inv), quantize(v.y, inv), quantize(v.z, inv),
                   quantize(v.w, inv));
    }
    out = make_uint4(w[0], w[1], w[2], w[3]);
  } else if constexpr (VEC && IN == kBF16) {
    const uint4* p = reinterpret_cast<const uint4*>(static_cast<const unsigned short*>(x) + e);
    uint32_t w[4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint4 v = __ldg(p + h);
      const uint32_t b[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int k = 0; k < 2; ++k)
        w[2 * h + k] = pack4(quantize(__uint_as_float(b[2 * k] << 16), inv),
                             quantize(__uint_as_float(b[2 * k] & 0xffff0000u), inv),
                             quantize(__uint_as_float(b[2 * k + 1] << 16), inv),
                             quantize(__uint_as_float(b[2 * k + 1] & 0xffff0000u), inv));
    }
    out = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    int q[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) q[j] = code<IN>(Src<IN>::load(x, e + j), inv);
    out = make_uint4(pack4(q[0], q[1], q[2], q[3]), pack4(q[4], q[5], q[6], q[7]),
                     pack4(q[8], q[9], q[10], q[11]), pack4(q[12], q[13], q[14], q[15]));
  }
  *reinterpret_cast<uint4*>(y + e) = out;
}

template <int IN>
int launch_quantize_cl(const void* x, const float* inv, int8_t* y, long long runs,
                       cudaStream_t stream) {
  const long long blocks = (runs + kQLThreads - 1) / kQLThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (reinterpret_cast<uintptr_t>(x) % 16 == 0) {
    quantize_nhwc_cl_kernel<IN, true><<<grid, kQLThreads, 0, stream>>>(x, inv, y, runs);
  } else {
    quantize_nhwc_cl_kernel<IN, false><<<grid, kQLThreads, 0, stream>>>(x, inv, y, runs);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// K2b: implicit GEMM over the (N, H, W, Cp) int8 copy.

template <int OUT> struct Out;
template <> struct Out<kF32> { using T = float; };
template <> struct Out<kBF16> { using T = __nv_bfloat16; };
template <> struct Out<kI8> { using T = int8_t; };

template <int OUT>
__device__ __forceinline__ typename Out<OUT>::T finish(int acc, float mul, float add,
                                                       bool has_add) {
  float v = __fmul_rn(__int2float_rn(acc), mul);
  if (has_add) v = __fadd_rn(v, add);
  if constexpr (OUT == kI8) {
    return static_cast<int8_t>(static_cast<int>(fminf(fmaxf(rintf(v), 0.f), 127.f)));
  } else if constexpr (OUT == kBF16) {
    return __float2bfloat16_rn(v);
  } else {
    return v;
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled (nothing read) where !ok.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// Byte offset of 16-byte chunk `chunk` (0..3) of row `row` in a stage whose
// rows are 64 bytes: the chunk index is XORed with bits 1-2 of the row, so
// the eight rows an `ldmatrix` phase reads fall on eight distinct 16-byte
// bank groups.
__device__ __forceinline__ int swizzle(int row, int chunk) {
  return row * kGK + ((chunk ^ ((row >> 1) & 3)) << 4);
}

// Image and pixel of output row m0 + r (r >= 0) from those of m0, with a
// 32-bit division only where the row lies in a later image. hw < 2^31.
__device__ __forceinline__ void locate(long long img0, int p0, int r, int hw,
                                       long long& img, int& p) {
  const unsigned q = static_cast<unsigned>(p0) + static_cast<unsigned>(r);
  if (q < static_cast<unsigned>(hw)) {
    img = img0;
    p = static_cast<int>(q);
  } else {
    const unsigned d = q / static_cast<unsigned>(hw);
    img = img0 + d;
    p = static_cast<int>(q - d * static_cast<unsigned>(hw));
  }
}

// Dynamic shared memory: the cp.async ring, reused by the epilogue's
// output tile (NCHW: kGN rows of kGM outputs; NHWC: kGM rows of kGN
// outputs; each row padded by 16 bytes).
template <int OUT, bool NHWC>
constexpr int gemm_smem() {
  constexpr int pipe = kStages * (kGM + kGN) * kGK;
  constexpr int size = static_cast<int>(sizeof(typename Out<OUT>::T));
  constexpr int tile = NHWC ? kGM * (kGN * size + 16) : kGN * (kGM * size + 16);
  return pipe > tile ? pipe : tile;
}

// 4 blocks an SM: at most 128 registers a thread (64 accumulators). s.cin is
// the channel count of the copy (a multiple of 16), s.k = kh*kw*s.cin.
// NHWC: the output is (N, Ho, Wo, Cout) (a channels-last (N, Cout, Ho, Wo)
// tensor) instead of NCHW; only the epilogue's staging and stores differ.
template <int OUT, bool NHWC>
__global__ void __launch_bounds__(kGThreads, 4)
int8_conv_nhwc_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wk,
                      const float* __restrict__ mul, const float* __restrict__ add,
                      void* __restrict__ y, const Shape s) {
  using O = typename Out<OUT>::T;
  constexpr int kAPass = kGM / kGRows, kBPass = kGN / kGRows;
  constexpr int kAStage = kGM * kGK, kBStage = kGN * kGK;
  extern __shared__ __align__(128) int8_t smem[];
  int8_t* const a_s = smem;
  int8_t* const b_s = smem + kStages * kAStage;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, t = lane & 3;
  const int n_tiles = (s.cout + kGN - 1) / kGN;
  // Consecutive blocks share their pixels and walk the channel tiles, so
  // the A rows they read come from L2.
  const long long m0 = static_cast<long long>(blockIdx.x / n_tiles) * kGM;
  const int n0 = static_cast<int>(blockIdx.x % n_tiles) * kGN;
  const int hw_out = s.ho * s.wo;
  const long long m_total = static_cast<long long>(s.n) * hw_out;
  const long long img0 = m0 / hw_out;  // the block's one 64-bit division
  const int p0 = static_cast<int>(m0 - img0 * hw_out);

  // This thread copies segment `seg` (16 K bytes) of rows row0 + i*kGRows.
  const int seg = tid & 3, row0 = tid >> 2;
  long long a_pix[kAPass];
  int a_ih[kAPass], a_iw[kAPass];
#pragma unroll
  for (int i = 0; i < kAPass; ++i) {
    const long long m = m0 + row0 + i * kGRows;
    a_pix[i] = 0;
    a_ih[i] = -(1 << 29);  // fails every bounds check: a pixel past M
    a_iw[i] = 0;
    if (m < m_total) {
      long long img;
      int p;
      locate(img0, p0, row0 + i * kGRows, hw_out, img, p);
      const int oh = p / s.wo, ow = p - oh * s.wo;
      a_ih[i] = oh * s.stride - s.pad_h;
      a_iw[i] = ow * s.stride - s.pad_w;
      a_pix[i] = ((img * s.h + a_ih[i]) * s.w + a_iw[i]) * s.cin;
    }
  }
  // K position of this thread's segment: tap (kr, kc), channel kci.
  int kr = 0, kc = 0, kci = seg * 16;
  auto settle = [&]() {
    while (kci >= s.cin) {
      kci -= s.cin;
      if (++kc == s.kw) { kc = 0; ++kr; }
    }
  };
  settle();

  auto load_stage = [&](int slot, int step) {
    const bool k_ok = kr < s.kh;
    const int dh = kr * s.dil, dw = kc * s.dil;
    const int tap = (dh * s.w + dw) * s.cin + kci;
    const uint32_t a_dst = smem_addr(a_s + slot * kAStage);
#pragma unroll
    for (int i = 0; i < kAPass; ++i) {
      const int ih = a_ih[i] + dh, iw = a_iw[i] + dw;
      const bool ok = k_ok && static_cast<unsigned>(ih) < static_cast<unsigned>(s.h) &&
                      static_cast<unsigned>(iw) < static_cast<unsigned>(s.w);
      cp_async16(a_dst + swizzle(row0 + i * kGRows, seg), ok ? xq + (a_pix[i] + tap) : xq, ok);
    }
    kci += kGK;
    settle();
    const int kb = step * kGK + seg * 16;
    const uint32_t b_dst = smem_addr(b_s + slot * kBStage);
#pragma unroll
    for (int i = 0; i < kBPass; ++i) {
      const int n = n0 + row0 + i * kGRows;  // < Cout padded to 64: a weight row
      const bool ok = kb < s.kpad;
      cp_async16(b_dst + swizzle(row0 + i * kGRows, seg),
                 ok ? wk + static_cast<long long>(n) * s.kpad + kb : wk, ok);
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;

  auto compute = [&](int slot) {
    const uint32_t a_base = smem_addr(a_s + slot * kAStage);
    const uint32_t b_base = smem_addr(b_s + slot * kBStage);
#pragma unroll
    for (int kk = 0; kk < kGK / 32; ++kk) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(af[mi], a_base + swizzle(wm * 64 + mi * 16 + (lane & 15),
                                             2 * kk + (lane >> 4)));
#pragma unroll
      for (int pair = 0; pair < 2; ++pair) {
        uint32_t r[4];
        ldmatrix_x4(r, b_base + swizzle(wn * 32 + pair * 16 + ((lane >> 4) << 3) + (lane & 7),
                                        2 * kk + ((lane >> 3) & 1)));
        bf[2 * pair][0] = r[0];
        bf[2 * pair][1] = r[1];
        bf[2 * pair + 1][0] = r[2];
        bf[2 * pair + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
  };

  const int steps = (s.k + kGK - 1) / kGK;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < steps) load_stage(st, st);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage `step` has landed; stage step-1 is consumed
    const int next = step + kStages - 1;
    if (next < steps) load_stage(next % kStages, next);
    cp_async_commit();
    compute(step % kStages);
  }
  cp_async_wait<0>();
  __syncthreads();

  int8_t* const o_s = smem;
  const bool has_add = add != nullptr;
  if constexpr (NHWC) {
    // Epilogue, staged: o_s[m][co], each pixel's kGN outputs a row padded by
    // 16 bytes (bf16 and int8 fragment writes conflict-free, f32 two-way).
    constexpr int kORowN = kGN * static_cast<int>(sizeof(O)) + 16;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = wn * 32 + ni * 8 + 2 * t + j;
        const int co = n0 + col;
        const float cm = co < s.cout ? __ldg(mul + co) : 0.f;
        const float ca = (co < s.cout && has_add) ? __ldg(add + co) : 0.f;
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = wm * 64 + mi * 16 + g + 8 * half;
            *reinterpret_cast<O*>(o_s + row * kORowN + col * static_cast<int>(sizeof(O))) =
                finish<OUT>(acc[mi][ni][2 * half + j], cm, ca, has_add);
          }
      }
    __syncthreads();

    // Store: pixel m's outputs n0.. are consecutive in the output, so each
    // tile row leaves as 16-byte runs of E channels; a run past Cout or off
    // the 16-byte alignment stores scalars.
    constexpr int E = 16 / static_cast<int>(sizeof(O));
    constexpr int kRunsN = kGN / E;
    const int cols = min(kGN, s.cout - n0);
    O* const out = static_cast<O*>(y);
    for (int e = tid; e < kGM * kRunsN; e += kGThreads) {
      const int row = e / kRunsN, c0 = (e % kRunsN) * E;
      const long long m = m0 + row;
      if (c0 >= cols || m >= m_total) continue;
      const long long o = m * s.cout + n0 + c0;
      const int8_t* src = o_s + row * kORowN + c0 * static_cast<int>(sizeof(O));
      if (c0 + E <= cols && o % E == 0) {
        *reinterpret_cast<uint4*>(out + o) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int i = 0; i < E && c0 + i < cols; ++i)
          out[o + i] = reinterpret_cast<const O*>(src)[i];
      }
    }
    return;
  }

  // Epilogue, staged: o_s[co][m] in the output type, rows padded by 16 bytes
  // (conflict-free fragment writes). Accumulator (mi, ni, r) is row
  // wm*64 + mi*16 + g + 8*(r >> 1), column wn*32 + ni*8 + 2t + (r & 1).
  constexpr int kORow = kGM * static_cast<int>(sizeof(O)) + 16;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = wn * 32 + ni * 8 + 2 * t + j;
      const int co = n0 + col;
      const float cm = co < s.cout ? __ldg(mul + co) : 0.f;
      const float ca = (co < s.cout && has_add) ? __ldg(add + co) : 0.f;
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = wm * 64 + mi * 16 + g + 8 * half;
          *reinterpret_cast<O*>(o_s + col * kORow + row * static_cast<int>(sizeof(O))) =
              finish<OUT>(acc[mi][ni][2 * half + j], cm, ca, has_add);
        }
    }
  __syncthreads();

  // Store: each channel row of the tile as 16-byte runs of E consecutive
  // pixels; a run that crosses an image or is misaligned stores scalars.
  constexpr int E = 16 / static_cast<int>(sizeof(O));
  constexpr int kRuns = kGM / E;
  const int rows = min(kGN, s.cout - n0);
  O* const out = static_cast<O*>(y);
  for (int e = tid; e < rows * kRuns; e += kGThreads) {
    const int col = e / kRuns, run = e % kRuns;
    if (m0 + run * E >= m_total) continue;
    long long img;
    int p;
    locate(img0, p0, run * E, hw_out, img, p);
    const int co = n0 + col;
    const long long o = (img * s.cout + co) * hw_out + p;
    const int8_t* src = o_s + col * kORow + run * 16;
    if (p + E <= hw_out && o % E == 0) {
      *reinterpret_cast<uint4*>(out + o) = *reinterpret_cast<const uint4*>(src);
    } else {
#pragma unroll
      for (int i = 0; i < E; ++i) {
        if (m0 + run * E + i >= m_total) break;
        locate(img0, p0, run * E + i, hw_out, img, p);
        out[(img * s.cout + co) * hw_out + p] = reinterpret_cast<const O*>(src)[i];
      }
    }
  }
}

template <int OUT, bool NHWC>
int launch_gemm(const int8_t* xq, const int8_t* wk, const float* mul,
                const float* add, void* y, const Shape& s, cudaStream_t stream) {
  constexpr int kSmem = gemm_smem<OUT, NHWC>();
  // More would need cudaFuncSetAttribute(MaxDynamicSharedMemorySize) first.
  static_assert(kSmem <= 48 * 1024, "K2b's shared memory passes the default 48 KB");
  const long long m_tiles = (static_cast<long long>(s.n) * s.ho * s.wo + kGM - 1) / kGM;
  const long long blocks = m_tiles * ((s.cout + kGN - 1) / kGN);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  int8_conv_nhwc_kernel<OUT, NHWC><<<static_cast<unsigned>(blocks), kGThreads, kSmem,
                                     stream>>>(xq, wk, mul, add, y, s);
  return static_cast<int>(cudaGetLastError());
}

template <int OUT>
int launch_gemm_layout(bool nhwc_out, const int8_t* xq, const int8_t* wk, const float* mul,
                       const float* add, void* y, const Shape& s, cudaStream_t stream) {
  return nhwc_out ? launch_gemm<OUT, true>(xq, wk, mul, add, y, s, stream)
                  : launch_gemm<OUT, false>(xq, wk, mul, add, y, s, stream);
}

// ---------------------------------------------------------------------------
// The stem kernel: NCHW input with Cin * kh * kw <= 32 (one K step of
// m16n8k32; the RGB stems' 3 x 3 x 3 = 27), quantized once into a halo in
// shared memory.

constexpr int kSThreads = 128;  // 4 warps
constexpr int kSWarps = kSThreads / 32;
constexpr int kSN = 64;         // output channels per block (4 m16 tiles)

// Shared-memory layout of one stem block, computed on the host.
struct StemTile {
  int rows, cols;            // output rows x columns of the tile (cols % 16 == 0)
  int halo_rows;             // input rows the tile's taps reach
  int raw_chunks;            // 16-byte input chunks a halo row: the columns the
                             // taps reach, from the chunk boundary at or below
  int halo_stride;           // bytes a halo row: raw_chunks codes a chunk
  int halo_bytes;            // its rows (cin * halo_rows for NCHW) * halo_stride,
                             // rounded up to 16
  int raw_bytes;             // one raw halo buffer: its rows * raw_chunks * 16
  int stage_stride;          // bytes a row of the stage: one output channel's
                             // pixels (NCHW) or one pixel's channels (NHWC)
  int stage_bytes;           // every channel row the block's 16-channel mma tiles
                             // write, min(64, Cout rounded up to 16) (NCHW), or
                             // every pixel row, as wide as that (NHWC)
  int off[32];               // K position -> halo offset from its pixel; -1 past K
};

template <int IN, int OUT, bool NHWC>
StemTile stem_tile(const Shape& s, int rows, int cols) {
  constexpr int E = 16 / static_cast<int>(sizeof(typename Src<IN>::T));
  StemTile t;
  t.rows = rows;
  t.cols = cols;
  t.halo_rows = (rows - 1) * s.stride + (s.kh - 1) * s.dil + 1;
  // a halo row: one channel's columns (NCHW) or every channel of each
  // column (NHWC); as many rows as input rows the taps reach, times Cin
  // for NCHW
  const int halo_cols = ((cols - 1) * s.stride + (s.kw - 1) * s.dil + 1) * (NHWC ? s.cin : 1);
  const int halo_rows = NHWC ? t.halo_rows : s.cin * t.halo_rows;
  t.raw_chunks = (halo_cols + 2 * E - 2) / E;  // any start within a chunk
  t.halo_stride = t.raw_chunks * E;
  t.halo_bytes = (halo_rows * t.halo_stride + 15) / 16 * 16;
  t.raw_bytes = halo_rows * t.raw_chunks * 16;
  constexpr int size = static_cast<int>(sizeof(typename Out<OUT>::T));
  const int channels = min(kSN, (s.cout + 15) / 16 * 16);
  if (NHWC) {
    t.stage_stride = channels * size + 16;
    t.stage_bytes = rows * cols * t.stage_stride;
  } else {
    t.stage_stride = rows * cols * size + 16;
    t.stage_bytes = channels * t.stage_stride;
  }
  const int taps = s.kh * s.kw;
  for (int k = 0; k < 32; ++k) {
    const int ci = k / taps, r = (k - ci * taps) / s.kw, c = k - ci * taps - r * s.kw;
    t.off[k] = k >= s.k ? -1
               : NHWC ? r * s.dil * t.halo_stride + c * s.dil * s.cin + ci
                      : (ci * t.halo_rows + r * s.dil) * t.halo_stride + c * s.dil;
  }
  return t;
}

// Dynamic shared memory: the int8 halo, and the stage, whose space first
// holds the raw input halo.
inline int stem_smem(const StemTile& t) {
  return t.halo_bytes + (t.raw_bytes > t.stage_bytes ? t.raw_bytes : t.stage_bytes);
}

// Bulk copies of shared memory to global memory by the TMA unit, off the
// warps' load / store pipe (sm_90): `bytes` and both addresses multiples
// of 16.
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(dst), "r"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void bulk_commit_and_wait_read() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// Orders this thread's shared-memory writes before later bulk copies.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Four codes of the halo at offsets base + off[first + i] (off < 0: a K
// position past K, code 0), as one fragment word.
__device__ __forceinline__ uint32_t gather4(const int8_t* halo, int base, const int (&off)[8],
                                            int first) {
  uint32_t w = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int o = off[first + i];
    const uint32_t b = o >= 0 ? static_cast<uint8_t>(halo[base + o]) : 0u;
    w |= b << (8 * i);
  }
  return w;
}

// Two outputs of one channel at neighbouring pixels, finished as `finish`
// does each, stored together at p (aligned to the pair).
template <int OUT>
__device__ __forceinline__ void store_pair(int8_t* p, int a0, int a1, float mul, float add,
                                           bool has_add) {
  float v0 = __fmul_rn(__int2float_rn(a0), mul), v1 = __fmul_rn(__int2float_rn(a1), mul);
  if (has_add) {
    v0 = __fadd_rn(v0, add);
    v1 = __fadd_rn(v1, add);
  }
  if constexpr (OUT == kBF16) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
  } else if constexpr (OUT == kF32) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  } else {
    const int q0 = static_cast<int>(fminf(fmaxf(rintf(v0), 0.f), 127.f));
    const int q1 = static_cast<int>(fminf(fmaxf(rintf(v1), 0.f), 127.f));
    *reinterpret_cast<uint16_t*>(p) = static_cast<uint16_t>(q0 | (q1 << 8));
  }
}

// Two outputs of one pixel at neighbouring channels (their mul and add),
// finished as `finish` does each, stored together at p (aligned to the
// pair).
template <int OUT>
__device__ __forceinline__ void store_channel_pair(int8_t* p, int a0, int a1,
                                                   const float (&mul)[2],
                                                   const float (&add)[2], bool has_add) {
  float v0 = __fmul_rn(__int2float_rn(a0), mul[0]), v1 = __fmul_rn(__int2float_rn(a1), mul[1]);
  if (has_add) {
    v0 = __fadd_rn(v0, add[0]);
    v1 = __fadd_rn(v1, add[1]);
  }
  if constexpr (OUT == kBF16) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
  } else if constexpr (OUT == kF32) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  } else {
    const int q0 = static_cast<int>(fminf(fmaxf(rintf(v0), 0.f), 127.f));
    const int q1 = static_cast<int>(fminf(fmaxf(rintf(v1), 0.f), 127.f));
    *reinterpret_cast<uint16_t*>(p) = static_cast<uint16_t>(q0 | (q1 << 8));
  }
}

// The E codes of one raw chunk, stored at dst (aligned to E bytes).
template <int IN>
__device__ __forceinline__ void quantize_chunk(const void* src, int8_t* dst, float inv) {
  if constexpr (IN == kI8) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  } else if constexpr (IN == kBF16) {
    const uint4 v = *reinterpret_cast<const uint4*>(src);
    const uint32_t w4[4] = {v.x, v.y, v.z, v.w};
    uint32_t q[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t lo = quantize(__uint_as_float(w4[j] << 16), inv) & 0xffu;
      const uint32_t hi = quantize(__uint_as_float(w4[j] & 0xffff0000u), inv) & 0xffu;
      q[j >> 1] |= (lo | (hi << 8)) << (16 * (j & 1));
    }
    *reinterpret_cast<uint2*>(dst) = make_uint2(q[0], q[1]);
  } else {
    const float4 v = *reinterpret_cast<const float4*>(src);
    *reinterpret_cast<uint32_t*>(dst) = (quantize(v.x, inv) & 0xffu) |
                                         ((quantize(v.y, inv) & 0xffu) << 8) |
                                         ((quantize(v.z, inv) & 0xffu) << 16) |
                                         (static_cast<uint32_t>(quantize(v.w, inv)) << 24);
  }
}

// One block: image img, output rows oh0.. (t.rows), columns ow0.. (t.cols),
// channels n0..n0+63.
//   1. The raw input halo (rows oh0*s - ph .., the 16-byte input chunks
//      that hold columns ow0*s - pw .. that the tile's taps reach, every
//      input channel), all in flight at once (cp.async, zero-filled outside
//      the image, where VEC: W a multiple of the chunk and x aligned; else
//      scalar loads), while the weights and the epilogue vectors load.
//   2. Each element quantized once (K2a's arithmetic) into an int8 halo
//      laid out as the raw one, one chunk a lane.
//   3. The mma's rows are output channels and its columns pixels: A, the
//      block's 64 x 32-byte weight rows, sits in registers (4 fragments of
//      16 channels); each warp takes 8-pixel runs of the tile's rows in turn
//      and gathers its B fragment words (four taps of one pixel, (ci, r, c)
//      order, at the offsets of t.off) from the halo; one mma.sync.m16n8k32
//      per 16 channels. An accumulator pair is one channel at two
//      neighbouring pixels, finished with that lane's channel's mul and add
//      (registers) into one store to the stage, one row of pixels per
//      channel (NCHW), or two stores, one row of channels per pixel (NHWC).
//   4. NCHW: one thread a run of a channel's plane (one per tile row, or
//      one for all its rows where they are whole output rows) copies it from
//      the stage by one bulk copy, or, where the run is not 16-byte aligned,
//      element by element. NHWC: a pixel's channels n0.. are consecutive in
//      the (N, Ho, Wo, Cout) output, so threads copy the stage's pixel rows
//      as 16-byte runs of channels, scalars where a run passes Cout or its
//      alignment.
template <int IN, int OUT, bool VEC, bool NHWC>
__global__ void __launch_bounds__(kSThreads)
int8_stem_kernel(const void* __restrict__ x, const int8_t* __restrict__ wk,
                 const float* __restrict__ inv_p, const float* __restrict__ mul,
                 const float* __restrict__ add, void* __restrict__ y, const Shape s,
                 const StemTile t, int tiles_h, int tiles_w) {
  using Raw = typename Src<IN>::T;
  using O = typename Out<OUT>::T;
  constexpr int E = 16 / static_cast<int>(sizeof(Raw));  // input elements a chunk
  constexpr int kO = static_cast<int>(sizeof(O));
  extern __shared__ __align__(128) int8_t smem[];
  int8_t* const halo = smem;
  int8_t* const stage = halo + t.halo_bytes;
  Raw* const raw = reinterpret_cast<Raw*>(stage);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q4 = lane & 3;
  const int per_img = tiles_h * tiles_w;
  const long long img = blockIdx.x / per_img;
  const int tile = static_cast<int>(blockIdx.x - img * per_img);
  const int th = tile / tiles_w;
  const int oh0 = th * t.rows, ow0 = (tile - th * tiles_w) * t.cols;
  const int n0 = blockIdx.y * kSN;
  const int ih0 = oh0 * s.stride - s.pad_h, iw0 = ow0 * s.stride - s.pad_w;
  // a halo row: one channel's input row (NCHW), or one input row of every
  // channel, its elements (w, ci) (NHWC); its first element and length
  const int row_start = NHWC ? iw0 * s.cin : iw0;
  const int row_len = NHWC ? s.w * s.cin : s.w;
  const int c_first = (row_start >= 0 ? row_start / E : -((-row_start + E - 1) / E)) * E;
  const int halo_rows = NHWC ? t.halo_rows : s.cin * t.halo_rows;

  // 1. The raw halo, one warp a row.
  for (int row = warp; row < halo_rows; row += kSWarps) {
    const int ci = NHWC ? 0 : row / t.halo_rows, ih = ih0 + row - ci * t.halo_rows;
    const bool row_ok = static_cast<unsigned>(ih) < static_cast<unsigned>(s.h);
    const long long src = NHWC ? (img * s.h + ih) * static_cast<long long>(row_len)
                               : ((img * s.cin + ci) * s.h + ih) * static_cast<long long>(s.w);
    for (int ch = lane; ch < t.raw_chunks; ch += 32) {
      const int gc = c_first + ch * E;
      Raw* dst = raw + (row * t.raw_chunks + ch) * E;
      if constexpr (VEC) {
        const bool ok = row_ok && gc >= 0 && gc + E <= row_len;
        cp_async16(smem_addr(dst), ok ? static_cast<const Raw*>(x) + src + gc : x, ok);
      } else {
#pragma unroll
        for (int j = 0; j < E; ++j)
          dst[j] = row_ok && static_cast<unsigned>(gc + j) < static_cast<unsigned>(row_len)
                       ? Src<IN>::load(x, src + gc + j) : Raw(0);
      }
    }
  }
  if constexpr (VEC) cp_async_commit();

  // This lane's K positions 4*q4 + i (fragment word 0) and 16 + 4*q4 + i
  // (word 1) as halo offsets.
  const bool has_add = add != nullptr;
  int off[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) off[i] = t.off[(i < 4 ? 4 * q4 : 16 + 4 * q4) + (i & 3)];
  float inv = 1.f;
  if constexpr (IN != kI8) inv = __ldg(inv_p);
  const int channels = min(kSN, s.cout - n0);
  const int rows = min(t.rows, s.ho - oh0), cols = min(t.cols, s.wo - ow0);
  // halo offset of tile pixel (tr, tc)'s first tap
  auto pixel_base = [&](int tr, int tc) {
    return tr * s.stride * t.halo_stride + tc * s.stride * (NHWC ? s.cin : 1) +
           (row_start - c_first);
  };
  O* const out = static_cast<O*>(y);

  if constexpr (NHWC) {
    // The mma transposed: its rows are 16 pixels (A: fragment words of four
    // taps of one pixel, gathered from the halo) and its columns 8 output
    // channels (B: the weights, in registers for the whole block), so an
    // accumulator pair is two neighbouring channels of one pixel and
    // leaves as one store into the stage's pixel row.
    uint32_t wb[8][2];
    float cmul[8][2], cadd[8][2];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int8_t* w = wk + static_cast<long long>(n0 + 8 * j + g) * s.kpad + 4 * q4;
      wb[j][0] = __ldg(reinterpret_cast<const uint32_t*>(w));  // < Cout padded to 64
      wb[j][1] = __ldg(reinterpret_cast<const uint32_t*>(w + 16));
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int co = n0 + 8 * j + 2 * q4 + i;
        cmul[j][i] = co < s.cout ? __ldg(mul + co) : 0.f;
        cadd[j][i] = co < s.cout && has_add ? __ldg(add + co) : 0.f;
      }
    }
    if constexpr (VEC) cp_async_wait<0>();
    __syncthreads();

    // 2. The int8 halo, one chunk a lane.
    for (int i = tid; i < halo_rows * t.raw_chunks; i += kSThreads)
      quantize_chunk<IN>(raw + i * E, halo + i * E, inv);
    __syncthreads();  // the raw halo is consumed: the stage may be written

    // 3. 16-pixel runs of the tile's rows, one warp each in turn.
    const int ntiles = (channels + 7) / 8;
    int tr = 0, tc = 16 * warp;
    while (tc >= t.cols) {
      tc -= t.cols;
      ++tr;
    }
    while (tr < t.rows) {
      const int b0 = pixel_base(tr, tc + g), b1 = pixel_base(tr, tc + g + 8);
      const uint32_t afr[4] = {gather4(halo, b0, off, 0), gather4(halo, b1, off, 0),
                               gather4(halo, b0, off, 4), gather4(halo, b1, off, 4)};
      int8_t* const p0 = stage + (tr * t.cols + tc + g) * t.stage_stride + 2 * q4 * kO;
      int8_t* const p1 = p0 + 8 * t.stage_stride;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j >= ntiles) break;
        int acc[4] = {0, 0, 0, 0};
        mma_s8(acc, afr, wb[j]);
        store_channel_pair<OUT>(p0 + 8 * j * kO, acc[0], acc[1], cmul[j], cadd[j], has_add);
        store_channel_pair<OUT>(p1 + 8 * j * kO, acc[2], acc[3], cmul[j], cadd[j], has_add);
      }
      tc += 16 * kSWarps;
      while (tc >= t.cols) {
        tc -= t.cols;
        ++tr;
      }
    }
    __syncthreads();

    // 4. The stage's pixel rows to the (N, Ho, Wo, Cout) output: a pixel's
    // channels n0.. are consecutive there, 16-byte runs a thread.
    constexpr int EO = 16 / kO;
    const int runs = (channels + EO - 1) / EO;
    for (int e = tid; e < rows * cols * runs; e += kSThreads) {
      const int pix = e / runs, c0 = (e - pix * runs) * EO;
      const int rr = pix / cols, cc = pix - rr * cols;
      O* const dst = out + ((img * s.ho + oh0 + rr) * static_cast<long long>(s.wo) + ow0 + cc) *
                               s.cout + n0 + c0;
      const int8_t* src = stage + (rr * t.cols + cc) * t.stage_stride + c0 * kO;
      if (c0 + EO <= channels && reinterpret_cast<uintptr_t>(dst) % 16 == 0) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int i = 0; i < EO && c0 + i < channels; ++i)
          dst[i] = reinterpret_cast<const O*>(src)[i];
      }
    }
  } else {
    // The weights as A fragments of 4 channel tiles (rows n0 + 16*ct + g
    // and + 8), this lane's two channels' mul and add and stage rows in
    // each.
    uint32_t wa[4][4];
    float cmul[4][2], cadd[4][2];
    int crow[4][2];
#pragma unroll
    for (int ct = 0; ct < 4; ++ct) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int co = n0 + 16 * ct + g + 8 * h;  // < Cout padded to 64: a weight row
        const int8_t* w = wk + static_cast<long long>(co) * s.kpad + 4 * q4;
        wa[ct][h] = __ldg(reinterpret_cast<const uint32_t*>(w));
        wa[ct][2 + h] = __ldg(reinterpret_cast<const uint32_t*>(w + 16));
        cmul[ct][h] = co < s.cout ? __ldg(mul + co) : 0.f;
        cadd[ct][h] = co < s.cout && has_add ? __ldg(add + co) : 0.f;
        crow[ct][h] = (16 * ct + g + 8 * h) * t.stage_stride;
      }
    }
    if constexpr (VEC) cp_async_wait<0>();
    __syncthreads();

    // 2. The int8 halo, one chunk a lane.
    for (int i = tid; i < halo_rows * t.raw_chunks; i += kSThreads)
      quantize_chunk<IN>(raw + i * E, halo + i * E, inv);
    __syncthreads();  // the raw halo is consumed: the stage may be written

    // 3. 8-pixel runs of the tile's rows, one warp each in turn.
    const int ctiles = (channels + 15) / 16;
    int tr = 0, tc = 8 * warp;
    while (tc >= t.cols) {
      tc -= t.cols;
      ++tr;
    }
    while (tr < t.rows) {
      const int base = pixel_base(tr, tc + g);
      const uint32_t bfr[2] = {gather4(halo, base, off, 0), gather4(halo, base, off, 4)};
      // pixel of accumulator columns 2*q4, + 1
      const int m = (tr * t.cols + tc + 2 * q4) * kO;
#pragma unroll
      for (int ct = 0; ct < 4; ++ct) {
        if (ct >= ctiles) break;
        int acc[4] = {0, 0, 0, 0};
        mma_s8(acc, wa[ct], bfr);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          store_pair<OUT>(stage + crow[ct][h] + m, acc[2 * h], acc[2 * h + 1], cmul[ct][h],
                          cadd[ct][h], has_add);
      }
      tc += 8 * kSWarps;
      while (tc >= t.cols) {
        tc -= t.cols;
        ++tr;
      }
    }
    fence_proxy_async();
    __syncthreads();

    // 4. The stage to the NCHW planes, one thread a run.
    const bool whole = t.cols == s.wo;  // the tile's rows are one run of the plane
    const int runs = whole ? 1 : rows, len = whole ? rows * s.wo : cols;
    const int bytes = len * kO;
    const long long plane = static_cast<long long>(s.ho) * s.wo;
    bool bulk = false;
    for (int e = tid; e < channels * runs; e += kSThreads) {
      const int co_l = e / runs, rr = e - co_l * runs;
      O* const dst = out + (img * s.cout + n0 + co_l) * plane +
                     static_cast<long long>(oh0 + rr) * s.wo + ow0;
      const int8_t* src = stage + co_l * t.stage_stride + rr * t.cols * kO;
      if (bytes % 16 == 0 && reinterpret_cast<uintptr_t>(dst) % 16 == 0) {
        bulk_store(dst, smem_addr(src), bytes);
        bulk = true;
      } else {
        for (int i = 0; i < len; ++i) dst[i] = reinterpret_cast<const O*>(src)[i];
      }
    }
    // the stage must not be released before the copies have read it
    if (bulk) bulk_commit_and_wait_read();
  }
}

template <int IN, int OUT, bool NHWC>
int launch_stem(const void* x, const int8_t* wk, const float* inv, const float* mul,
                const float* add, void* y, const Shape& s, int rows, int cols,
                cudaStream_t stream) {
  const StemTile t = stem_tile<IN, OUT, NHWC>(s, rows, cols);
  const int smem = stem_smem(t);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_h = (s.ho + rows - 1) / rows, tiles_w = (s.wo + cols - 1) / cols;
  const long long blocks = static_cast<long long>(s.n) * tiles_h * tiles_w;
  if (blocks > 0x7fffffffLL || (s.cout + kSN - 1) / kSN > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>((s.cout + kSN - 1) / kSN));
  constexpr int kSize = static_cast<int>(sizeof(typename Src<IN>::T));
  // an input row (of one channel, NCHW; of every channel, NHWC) in whole chunks
  const bool vec = s.w * (NHWC ? s.cin : 1) % (16 / kSize) == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  auto kernel = vec ? int8_stem_kernel<IN, OUT, true, NHWC>
                     : int8_stem_kernel<IN, OUT, false, NHWC>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, kSThreads, smem, stream>>>(x, wk, inv, mul, add, y, s, t, tiles_h, tiles_w);
  return static_cast<int>(cudaGetLastError());
}

template <int IN, bool NHWC>
int dispatch_stem(int out_type, const void* x, const int8_t* wk, const float* inv,
                  const float* mul, const float* add, void* y, const Shape& s, int rows,
                  int cols, cudaStream_t stream) {
  switch (out_type) {
    case kF32:
      return launch_stem<IN, kF32, NHWC>(x, wk, inv, mul, add, y, s, rows, cols, stream);
    case kBF16:
      return launch_stem<IN, kBF16, NHWC>(x, wk, inv, mul, add, y, s, rows, cols, stream);
    case kI8:
      return launch_stem<IN, kI8, NHWC>(x, wk, inv, mul, add, y, s, rows, cols, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int IN>
int dispatch_stem_layout(bool nhwc, int out_type, const void* x, const int8_t* wk,
                         const float* inv, const float* mul, const float* add, void* y,
                         const Shape& s, int rows, int cols, cudaStream_t stream) {
  return nhwc
      ? dispatch_stem<IN, true>(out_type, x, wk, inv, mul, add, y, s, rows, cols, stream)
      : dispatch_stem<IN, false>(out_type, x, wk, inv, mul, add, y, s, rows, cols, stream);
}

}  // namespace

// The gather kernel (Cin % 16 != 0).
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

// K2a. x: (n, c, h, w) contiguous, in_type 0 f32 / 1 bf16 (quantized with
// *inv) / 2 int8 (copied; inv may be null). y: (n, h, w, cp) int8, cp the
// multiple of 16 at or above c; channels c..cp-1 are written as 0.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int tpupose_quantize_nhwc(const void* x, int in_type, const float* inv,
                                     int8_t* y, int n, int c, int h, int w, int cp,
                                     void* stream) {
  if (static_cast<long long>(n) * h * w == 0 || cp == 0) return 0;
  if (cp % 16 != 0 || cp < c || reinterpret_cast<uintptr_t>(y) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (in_type) {
    case kF32: return launch_quantize<kF32>(x, inv, y, n, c, h * w, cp, st);
    case kBF16: return launch_quantize<kBF16>(x, inv, y, n, c, h * w, cp, st);
    case kI8: return launch_quantize<kI8>(x, inv, y, n, c, h * w, cp, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K2a on a channels-last input. x: (n, h, w, c) contiguous, c % 16 == 0,
// in_type as tpupose_quantize_nhwc's. y: (n, h, w, c) int8, 16-byte aligned.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int tpupose_quantize_nhwc_cl(const void* x, int in_type, const float* inv,
                                        int8_t* y, long long elements, void* stream) {
  if (elements == 0) return 0;
  if (elements % 16 != 0 || reinterpret_cast<uintptr_t>(y) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (in_type) {
    case kF32: return launch_quantize_cl<kF32>(x, inv, y, elements / 16, st);
    case kBF16: return launch_quantize_cl<kBF16>(x, inv, y, elements / 16, st);
    case kI8: return launch_quantize_cl<kI8>(x, inv, y, elements / 16, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K2b. xq: (n, h, w, cp) int8 (K2a's output, or an int8 channels-last
// activation), cp % 16 == 0. wk: (ceil(cout/64)*64,
// kpad) int8 contiguous, kpad = ceil(cp*kh*kw/32)*32, row co holding
// weight_q[co] in (r, c, ci) order, zeros elsewhere. mul, add: (cout,) f32;
// add may be null. y: (n, cout, ho, wo) contiguous, or (n, ho, wo, cout)
// where nhwc_out, out_type 0 f32 / 1 bf16
// (dequantize) or 2 int8 (requantize-relu). xq, wk and y 16-byte aligned.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int tpupose_int8_conv_nhwc(const int8_t* xq, const int8_t* wk,
                                      const float* mul, const float* add, void* y,
                                      int out_type, int n, int cp, int h, int w,
                                      int cout, int kh, int kw, int stride,
                                      int pad_h, int pad_w, int dil, int ho, int wo,
                                      int kpad, int nhwc_out, void* stream) {
  const Shape s{n, cp, h, w, cout, kh, kw, stride, pad_h, pad_w, dil, ho, wo,
                    cp * kh * kw, kpad};
  if (static_cast<long long>(n) * ho * wo == 0 || cout == 0) return 0;
  if (cp % 16 != 0 || kpad % kBK != 0 || kpad < s.k)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(xq) | reinterpret_cast<uintptr_t>(wk) |
       reinterpret_cast<uintptr_t>(y)) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (out_type) {
    case kF32: return launch_gemm_layout<kF32>(nhwc_out, xq, wk, mul, add, y, s, st);
    case kBF16: return launch_gemm_layout<kBF16>(nhwc_out, xq, wk, mul, add, y, s, st);
    case kI8: return launch_gemm_layout<kI8>(nhwc_out, xq, wk, mul, add, y, s, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The stem kernel (Cin % 16 != 0 and cin*kh*kw <= 32). Arguments as the
// gather kernel's (kpad == 32), plus the tile: `rows` output rows by `cols`
// output columns (cols % 16 == 0) per block, for 64 output channels; and
// nhwc: x is (n, h, w, cin) and y (n, ho, wo, cout), channels-last, instead
// of (n, cin, h, w) and (n, cout, ho, wo).
// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// an error without launching where the tile's shared memory passes 227 KB.
extern "C" int tpupose_int8_stem(const void* x, int in_type, const int8_t* wk,
                                 const float* inv, const float* mul,
                                 const float* add, void* y, int out_type,
                                 int n, int cin, int h, int w, int cout,
                                 int kh, int kw, int stride, int pad_h,
                                 int pad_w, int dil, int ho, int wo, int kpad,
                                 int rows, int cols, int nhwc, void* stream) {
  const Shape s{n, cin, h, w, cout, kh, kw, stride, pad_h, pad_w, dil, ho, wo,
                cin * kh * kw, kpad};
  if (static_cast<long long>(n) * ho * wo == 0 || cout == 0) return 0;
  if (kpad != kBK || s.k > kBK || rows < 1 || cols < 16 || cols % 16 != 0 ||
      reinterpret_cast<uintptr_t>(y) % 16 != 0 || reinterpret_cast<uintptr_t>(wk) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (in_type) {
    case kF32:
      return dispatch_stem_layout<kF32>(nhwc, out_type, x, wk, inv, mul, add, y, s, rows,
                                        cols, st);
    case kBF16:
      return dispatch_stem_layout<kBF16>(nhwc, out_type, x, wk, inv, mul, add, y, s, rows,
                                         cols, st);
    case kI8:
      return dispatch_stem_layout<kI8>(nhwc, out_type, x, wk, inv, mul, add, y, s, rows,
                                       cols, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
