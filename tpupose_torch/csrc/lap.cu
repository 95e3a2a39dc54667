// Batched masked linear assignment (K3) for Hopper.
//
// Replaces `jax.vmap(masked_lap)` of the JAX package (tpupose/ops/lap.py:
// `masked_lap`, with `solve_lap`'s Jonker-Volgenant `lax.while_loop`s;
// vmapped over cameras at tpupose/tracking/tracker.py:224-235). That is an
// XLA loop, not a Pallas kernel. One launch solves B independent problems
// of one (R, C) shape and does all of `masked_lap` for each
// (tpupose_torch/ops/lap.py, `_masked_lap_one`):
//   * negate the costs when maximizing;
//   * cmax / cmin over the valid entries (rows and columns both valid), 0
//     when there are none, and pad = cmax + (cmax - cmin) * min(R, C) + 1
//     on every other entry;
//   * orient the problem with the smaller dimension as rows (transposing
//     when R > C);
//   * the shortest augmenting path JV of `solve_lap`, row after row;
//   * keep an assignment only from a valid row to a valid column.
// It writes (B, R) int64: the column of each row, -1 for none.
//
// Bit-equal to the plain version, ties included: the same f32 expressions
// in the same order with round-to-nearest intrinsics (nvcc cannot contract
// them into FMAs), the argmin to the first column of equal reach (as
// torch.argmin), and rows in order. Costs must be finite at valid entries.
//
// Bound: latency. A (16, 40) problem is 2.6 KB, read once; the work is a
// chain of dependent Dijkstra steps, at most i + 1 for row i of the
// oriented problem (136 for 16 rows), that no parallelism inside a problem
// shortens. The floor under one step is a shared load, a warp reduction and
// a select (`step_chain_kernel` below measures it), so the latency bound of
// a batch is its longest problem's step count times that.
//
// Design: one warp per problem, so a step costs no block barrier. Lanes own
// columns (column j on lane j % 32, at most 8 a lane, so C <= 256 after
// orientation) and keep their minv, used and v in registers; the oriented
// costs, u, p and way sit in the warp's slice of shared memory. One step:
//   i0 = p[j0] -> u[i0] and the lane's columns of cost row i0 (one round of
//   shared loads) -> cur, minv, way, the lane's first best reach ->
//   __reduce_min_sync over an order-preserving key of (reach + 0.0f) ->
//   __reduce_min_sync over the column indices of the lanes at that key ->
//   (p[j0] for the exit test || delta, the winner's own reach, by one
//   shuffle) -> v -= delta on used columns, minv -= delta on the others.
// The key rounds -0.0 to +0.0, so columns of reach -0.0 and +0.0 tie as
// torch.argmin ties them (maximize negates zero scores into -0.0), and
// delta keeps the winner's own sign of zero. The update u += delta * bump
// of the plain version is taken off the step: it adds +-0 to every row
// outside the tree, which leaves u unchanged (u starts at +0.0 and a sum
// that comes out exactly zero is +0.0, so u is never -0.0), and a row's u
// is read only in the step in which it enters the tree. So the lane
// (step % 32) that sees a row enter keeps u[i0] in a register and adds each
// later step's delta to it, in step order; the sums go back to u after the
// augmentation. The same holds for v - delta * 0 on unused columns. The
// load folds negation, orientation and the extremes into one division-free
// pass (element indices stepped, loads issued 8 a lane at once); a second
// pass writes the pad.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kInf = 3e38f;   // the plain version's INF
constexpr int kMaxCols = 256;   // columns after orientation: 8 a lane
constexpr int kMaxWarpsPerBlock = 4;
constexpr int kMaxSharedBytes = 48 * 1024;
constexpr int kLoadUnroll = 8;  // cost loads in flight per lane
constexpr unsigned kFull = 0xffffffffu;

// 32-bit words of shared memory one problem takes: the oriented costs, u,
// p, way, and the R + C validity bytes.
__host__ __device__ inline int words_per_problem(int rs, int cs) {
  return rs * cs + (rs + 1) + 2 * (cs + 1) + (rs + cs + 3) / 4;
}

// Order-preserving unsigned key of a float (no NaN): a < b iff key(a) <
// key(b); -0.0 keys below +0.0, so callers add 0.0f first where they tie.
__device__ __forceinline__ unsigned key(float x) {
  const unsigned b = __float_as_uint(x);
  return b ^ ((unsigned)((int)b >> 31) | 0x80000000u);
}
__device__ __forceinline__ float unkey(unsigned k) {
  return __uint_as_float(k ^ ((k >> 31) ? 0x80000000u : kFull));
}

template <int K>
__global__ void masked_lap_kernel(const float* __restrict__ cost,
                                  const unsigned char* __restrict__ row_valid,
                                  const unsigned char* __restrict__ col_valid,
                                  long long* __restrict__ out, int batch,
                                  int R, int C, int maximize, int warps) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * warps + warp;
  if (b >= batch) return;  // the whole warp leaves together

  const bool trans = R > C;
  const int rs = trans ? C : R, cs = trans ? R : C;
  float* cmat = smem + (long long)warp * words_per_problem(rs, cs);
  float* u = cmat + rs * cs;                       // rs + 1
  int* p = reinterpret_cast<int*>(u + rs + 1);     // cs + 1: row of column
  int* way = p + cs + 1;                           // cs + 1
  unsigned char* valid = reinterpret_cast<unsigned char*>(way + cs + 1);  // R rows, C cols

  const float* cb = cost + b * R * C;
  const int rc = R * C;

  // The first costs in flight before the validity bytes are waited for.
  float xs[kLoadUnroll];
#pragma unroll
  for (int q = 0; q < kLoadUnroll; ++q) {
    const int e = lane + 32 * q;
    xs[q] = e < rc ? __ldg(cb + e) : 0.f;
  }
  for (int e = lane; e < R; e += 32) valid[e] = row_valid[b * R + e];
  for (int e = lane; e < C; e += 32) valid[R + e] = col_valid[b * C + e];
  __syncwarp();

  // Load (oriented), negate, and the extremes over the valid entries, as
  // order keys. Element e = lane + 32 * n sits at (r, c), stepped by
  // (dr, dc) per 32 elements: no division per element.
  const int dr = 32 / C, dc = 32 - dr * C;
  int r = lane / C, c = lane - (lane / C) * C;
  unsigned kmax = 0u, kmin = kFull;
  for (int e0 = 0; e0 < rc; e0 += 32 * kLoadUnroll) {
    float nx[kLoadUnroll];
#pragma unroll
    for (int q = 0; q < kLoadUnroll; ++q) {
      const int e = e0 + 32 * kLoadUnroll + lane + 32 * q;
      nx[q] = e < rc ? __ldg(cb + e) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < kLoadUnroll; ++q) {
      const int e = e0 + lane + 32 * q;
      if (e < rc) {
        const float x = maximize ? -xs[q] : xs[q];
        if (valid[r] && valid[R + c]) {
          kmax = max(kmax, key(x));
          kmin = min(kmin, key(x));
        }
        cmat[trans ? c * cs + r : e] = x;
        r += dr;
        c += dc;
        if (c >= C) {
          c -= C;
          ++r;
        }
      }
      xs[q] = nx[q];
    }
  }
  kmax = __reduce_max_sync(kFull, kmax);
  kmin = __reduce_min_sync(kFull, kmin);
  // a finite x keys above 0, so kmax == 0 means no valid entry
  const float cmax = kmax ? unkey(kmax) : 0.f, cmin = kmax ? unkey(kmin) : 0.f;
  const float pad = __fadd_rn(
      __fadd_rn(cmax, __fmul_rn(__fsub_rn(cmax, cmin), (float)rs)), 1.0f);

  // Validity of the lane's oriented columns; the pad on invalid entries.
  bool col_ok[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = lane + 32 * k;
    col_ok[k] = j < cs && valid[trans ? j : R + j];
  }
  __syncwarp();
  for (int i = 0; i < rs; ++i) {
    const bool row_ok = valid[trans ? R + i : i];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = lane + 32 * k;
      if (j < cs && !(row_ok && col_ok[k])) cmat[i * cs + j] = pad;
    }
  }
  for (int j = lane; j <= cs; j += 32) p[j] = -1;
  for (int i = lane; i <= rs; i += 32) u[i] = 0.f;

  float v[K];
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = 0.f;
  __syncwarp();

  for (int i = 0; i < rs; ++i) {
    float minv[K];
    bool used[K];
    // tree rows this lane follows: the row entering at step 32 * q + lane,
    // and its u plus the deltas since (steps <= i + 1 <= rs <= 32 * K)
    int tree_row[K];
    float tree_u[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      minv[k] = kInf;
      used[k] = false;
      tree_row[k] = -1;
      const int j = lane + 32 * k;
      if (j < cs) way[j] = cs;
    }
    if (lane == 0) p[cs] = i;
    __syncwarp();

    int j0 = cs, i0 = i;  // the virtual start column, matched to row i
    for (int step = 0;; ++step) {
      const float ui0 = u[i0];
      const float* crow = cmat + i0 * cs;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (lane + 32 * k == j0) used[k] = true;
        if (32 * k + lane == step) {
          tree_row[k] = i0;
          tree_u[k] = ui0;
        }
      }

      // cur = cost[i0] - u[i0] - v; relax minv / way; the lane's first best
      float best = INFINITY;
      int bj = 0x7fffffff;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = lane + 32 * k;
        if (j < cs) {
          const float cur = __fsub_rn(__fsub_rn(crow[j], ui0), v[k]);
          if (!used[k] && cur < minv[k]) {
            minv[k] = cur;
            way[j] = j0;
          }
          const float reach = used[k] ? kInf : minv[k];
          if (reach < best) {
            best = reach;
            bj = j;
          }
        }
      }
      // the first column of least reach over the warp: keys, then indices
      const unsigned kb = key(__fadd_rn(best, 0.f));
      const unsigned kw = __reduce_min_sync(kFull, kb);
      j0 = (int)__reduce_min_sync(kFull, kb == kw ? (unsigned)bj : kFull);
      const float delta = __shfl_sync(kFull, best, j0 & 31);
      i0 = p[j0];

      // v -= delta on used columns, minv -= delta on the others (the plain
      // version's v - delta * used leaves unused columns as they are)
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (used[k])
          v[k] = __fsub_rn(v[k], delta);
        else
          minv[k] = __fsub_rn(minv[k], delta);
        if (tree_row[k] >= 0) tree_u[k] = __fadd_rn(tree_u[k], delta);
      }
      if (i0 == -1) break;
    }
    __syncwarp();  // way is seen by lane 0
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (tree_row[k] >= 0) u[tree_row[k]] = tree_u[k];
    // Augment along the alternating path back to the virtual column.
    if (lane == 0) {
      while (j0 != cs) {
        const int j1 = way[j0];
        p[j0] = p[j1];
        j0 = j1;
      }
    }
    __syncwarp();
  }

  // col_of_row, kept only from a valid row to a valid column.
  long long* o = out + b * R;
  if (trans) {
    for (int j = lane; j < cs; j += 32) {  // oriented column j = row j
      const int col = p[j];
      o[j] = (col >= 0 && valid[j] && valid[R + col]) ? col : -1;
    }
  } else {
    for (int r2 = lane; r2 < R; r2 += 32) o[r2] = -1;
    __syncwarp();
    for (int j = lane; j < cs; j += 32) {
      const int r2 = p[j];
      if (r2 >= 0 && valid[r2] && valid[R + j]) o[r2] = j;
    }
  }
}

__global__ void empty_kernel() {}

// One warp runs n dependent minimal Dijkstra steps: a shared load whose
// address is the previous step's result, a __reduce_min_sync over the warp,
// and a select. Its time per step is the card's floor under one K3 step.
__global__ void step_chain_kernel(int n, unsigned* out) {
  __shared__ unsigned s[32];
  const unsigned lane = threadIdx.x;
  s[lane] = (lane * 13u + 7u) & 31u;
  __syncwarp();
  unsigned j = lane;
#pragma unroll 8
  for (int i = 0; i < n; ++i) {
    const unsigned x = s[j] ^ lane;
    const unsigned m = __reduce_min_sync(kFull, x);
    j = x == m ? lane : m & 31u;
  }
  out[lane] = j;
}

}  // namespace

// One launch of step_chain_kernel with n steps; out: 32 unsigned on the card.
extern "C" int tpupose_step_chain(int n, unsigned* out, void* stream) {
  step_chain_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(n, out);
  return (int)cudaGetLastError();
}

// One launch of an empty kernel: the card's launch cost, the floor under
// K3's time at small batches.
extern "C" int tpupose_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

// Problems one block holds for an (R, C) shape, 0 if one does not fit.
extern "C" int tpupose_masked_lap_warps(int R, int C) {
  const int rs = R < C ? R : C, cs = R < C ? C : R;
  if (cs > kMaxCols) return 0;
  const int bytes = 4 * words_per_problem(rs, cs);
  const int warps = kMaxSharedBytes / bytes;
  return warps < kMaxWarpsPerBlock ? warps : kMaxWarpsPerBlock;
}

extern "C" int tpupose_masked_lap(const float* cost,
                                  const unsigned char* row_valid,
                                  const unsigned char* col_valid,
                                  long long* out, int batch, int R, int C,
                                  int maximize, void* stream) {
  if (batch == 0 || R == 0) return 0;
  const int warps = tpupose_masked_lap_warps(R, C);
  if (warps == 0) return (int)cudaErrorInvalidValue;
  const int rs = R < C ? R : C, cs = R < C ? C : R;
  const int smem = warps * 4 * words_per_problem(rs, cs);
  const int blocks = (batch + warps - 1) / warps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int k = (cs + 31) / 32;
  if (k <= 1)
    masked_lap_kernel<1><<<blocks, warps * 32, smem, s>>>(
        cost, row_valid, col_valid, out, batch, R, C, maximize, warps);
  else if (k <= 2)
    masked_lap_kernel<2><<<blocks, warps * 32, smem, s>>>(
        cost, row_valid, col_valid, out, batch, R, C, maximize, warps);
  else if (k <= 4)
    masked_lap_kernel<4><<<blocks, warps * 32, smem, s>>>(
        cost, row_valid, col_valid, out, batch, R, C, maximize, warps);
  else
    masked_lap_kernel<8><<<blocks, warps * 32, smem, s>>>(
        cost, row_valid, col_valid, out, batch, R, C, maximize, warps);
  return (int)cudaGetLastError();
}
