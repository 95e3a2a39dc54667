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
// Bound: latency, not bytes. A (16, 40) problem is 2.6 KB, read once; the
// work is a chain of dependent Dijkstra steps (at most C + 1 per row, each
// a pass over the columns, an argmin and a potential update) that no
// parallelism inside a problem shortens. Design: one warp per problem, so
// a step costs a few shuffles and no block barrier; lanes own columns
// (column j on lane j % 32, at most 8 a lane, so C <= 256 after
// orientation) and keep their minv, used and v in registers; the costs,
// u, p, way and the rows of the current tree sit in the warp's slice of
// shared memory; the argmin is a butterfly shuffle reduction over (value,
// index). Several problems share a block and the grid covers B, so the
// C cameras (or S streams) of a tracker phase are one launch.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kInf = 3e38f;   // the plain version's INF
constexpr int kMaxCols = 256;   // columns after orientation: 8 a lane
constexpr int kMaxWarpsPerBlock = 4;
constexpr int kMaxSharedBytes = 48 * 1024;
constexpr unsigned kFull = 0xffffffffu;

// 32-bit words of shared memory one problem takes.
__host__ __device__ inline int words_per_problem(int rs, int cs) {
  return rs * cs + (rs + 1) + 2 * (cs + 1) + (rs + 1);
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
  int* tree = way + cs + 1;                        // rs + 1: rows visited

  const float* cb = cost + b * R * C;
  const unsigned char* rv = row_valid + b * R;
  const unsigned char* cv = col_valid + b * C;

  // Load (oriented), negate, and the extremes over the valid entries.
  float vmax = -INFINITY, vmin = INFINITY;
  int has = 0;
  for (int e = lane; e < R * C; e += 32) {
    const int r = e / C, c = e - (e / C) * C;
    float x = cb[e];
    if (maximize) x = -x;
    if (rv[r] && cv[c]) {
      vmax = fmaxf(vmax, x);
      vmin = fminf(vmin, x);
      has = 1;
    }
    cmat[trans ? c * cs + r : r * cs + c] = x;
  }
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    vmax = fmaxf(vmax, __shfl_xor_sync(kFull, vmax, off));
    vmin = fminf(vmin, __shfl_xor_sync(kFull, vmin, off));
    has |= __shfl_xor_sync(kFull, has, off);
  }
  const float cmax = has ? vmax : 0.f, cmin = has ? vmin : 0.f;
  const float pad = __fadd_rn(
      __fadd_rn(cmax, __fmul_rn(__fsub_rn(cmax, cmin), (float)rs)), 1.0f);
  __syncwarp();
  for (int e = lane; e < rs * cs; e += 32) {
    const int i = e / cs, j = e - (e / cs) * cs;
    const int r = trans ? j : i, c = trans ? i : j;
    if (!(rv[r] && cv[c])) cmat[e] = pad;
  }
  for (int j = lane; j <= cs; j += 32) p[j] = -1;
  for (int r = lane; r <= rs; r += 32) u[r] = 0.f;

  float v[K];
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = 0.f;
  __syncwarp();

  for (int i = 0; i < rs; ++i) {
    float minv[K];
    bool used[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      minv[k] = kInf;
      used[k] = false;
      const int j = lane + 32 * k;
      if (j < cs) way[j] = cs;
    }
    for (int r = lane; r <= rs; r += 32) tree[r] = 0;
    if (lane == 0) p[cs] = i;
    __syncwarp();

    int j0 = cs;  // the virtual start column
    while (true) {
      const int i0 = p[j0];
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (lane + 32 * k == j0) used[k] = true;
      if (lane == 0) tree[i0] = 1;
      const float ui0 = u[i0];
      const float* crow = cmat + i0 * cs;

      // cur = cost[i0] - u[i0] - v; relax minv / way; reach and its argmin
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
#pragma unroll
      for (int off = 16; off; off >>= 1) {
        const float ob = __shfl_xor_sync(kFull, best, off);
        const int oj = __shfl_xor_sync(kFull, bj, off);
        if (ob < best || (ob == best && oj < bj)) {
          best = ob;
          bj = oj;
        }
      }
      const float delta = best;
      __syncwarp();  // tree[i0] is seen by every lane

      // u += delta * bump (bump 1 on the tree's rows), v -= delta * used,
      // minv -= delta where unused: the plain version's products and sums.
      for (int r = lane; r < rs; r += 32)
        u[r] = __fadd_rn(u[r], __fmul_rn(delta, tree[r] ? 1.f : 0.f));
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (lane + 32 * k < cs) {
          v[k] = __fsub_rn(v[k], __fmul_rn(delta, used[k] ? 1.f : 0.f));
          if (!used[k]) minv[k] = __fsub_rn(minv[k], delta);
        }
      }
      __syncwarp();  // u is settled before the next step reads it
      j0 = bj;
      if (p[j0] == -1) break;
    }
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
      o[j] = (col >= 0 && rv[j] && cv[col]) ? col : -1;
    }
  } else {
    for (int r = lane; r < R; r += 32) o[r] = -1;
    __syncwarp();
    for (int j = lane; j < cs; j += 32) {
      const int r = p[j];
      if (r >= 0 && rv[r] && cv[j]) o[r] = j;
    }
  }
}

__global__ void empty_kernel() {}

}  // namespace

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
