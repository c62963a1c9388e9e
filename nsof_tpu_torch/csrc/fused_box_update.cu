// K4: one Farnebäck iteration, fused: box sum → 2×2 solve → warp → M'.
//
// Replaces nsof_tpu/ops/farneback_fast.py::_fused_box_update_kernel
// (called through _fused_box_update_cm): box-sum the system M (bfloat16,
// or float32 for kernel_mode='fused_f32') over (2m+1)² in float32, solve
// the 2×2 system (+1e-3 on the determinant) on the tile's rows and, for
// emit = matrices, on its ±(r+1) halo rows too; then warp r1 by that flow
// and write M' in M's type (emit = matrices) or write the float32 flow
// (emit = flow).  The intermediate flow never leaves shared memory.
//
// Bound: per canvas pixel it must read M (10 bytes in bf16), r0 (20), r1
// (20 and its ring) and write M' (10): ~64 bytes (~84 with f32 M).  With
// every intermediate computed once the work is ~330 flops a pixel, below
// the float32 ridge, so the bytes bound it.  Between the memory phases the
// block works from shared memory, whose bandwidth (128 bytes a cycle an
// SM) is what the on-chip phases spend: the design reads each staged value
// as few times as it can.
//
// Design: one block of 256 threads per (sample, 32-row canvas block,
// 32-column tile); registers are capped so that three blocks fit an SM
// (four for the flow emit, which holds less shared memory).  The rows are
// the canvas's 32-row blocks, because the vertical window sum is the TPU
// kernel's running recurrence
// S(r) = (S(r-1) + M(r+2m)) - M(r-1), started afresh at each block's first
// row, and the rounding of those sums is part of the function.  Shared
// memory holds a row of all five channels together ([row][channel]
// [column]).  Each intermediate is computed once, in the plain version's
// order:
//  1. M's slab (rows Y0-ext-m … Y0+31+ext+m, columns X0-m … X0+31+m, read
//     through clamped indices: the edge padding needs no copy) is staged as
//     float32: bf16 M through registers (16 loads a lane in flight), f32 M
//     with cp.async;
//  2. one thread per slab column runs the recurrence down it, its loads
//     four rows ahead, and leaves the column sums in place;
//  3. row sums in the order of _win_sum_tree (the top level of the
//     doubling table P_k(p) = P_{k-1}(p) + P_{k-1}(p + 2^{k-1}), then the
//     lower pieces, largest set bit of win first), then the 2×2 solve:
//     for the presets' windows (15, 5) a lane takes 4 adjacent pixels of a
//     row, loads the 3 + win column sums they read once and builds their
//     table in registers (a template on the window, two instances); any
//     other window takes a per-warp table of whole rows in shared memory;
//  4. r1's tile (32+2r+1 rows × 32+2r+1 columns × 5 channels) is staged
//     with cp.async over the dead slab;
//  5. warp pass 1 once per (source row, column) into T, pass 2 down T at
//     each pixel's dy, then build_store writes M'.  In both a lane takes 4
//     adjacent pixels and slides its window along them, so it reads each
//     staged value once, not once a tap.
// The flow emit is steps 1–3 with the float32 flow write.
//
// Build facts (ptxas -v, sm_90a, --fmad=false): the design before this one
// used 56 registers with no stack frame for both M types; this one uses 80
// registers in the matrices instances (capped for three blocks an SM) and
// 64 in the flow instances (four), with no stack frame but in the bf16
// flow instance (8 bytes, 4 of them spilled).  nvcc takes ≈ 6.5 s for this
// source on the H100's host (PERF.md §6).

#include <stdint.h>

#include "farneback_common.cuh"

namespace {

constexpr int kBlk = 32;  // canvas row block (the TPU kernel's row tile)
constexpr int kTX = 32;   // tile columns: one lane per column
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStageRowsM = 2;    // bf16 M rows a warp loads before it stores
constexpr int kStageElems = 8;    // elements of a staged row a lane loads
constexpr int kMaxWin = 63;
constexpr int kMaxLevel = 5;      // ⌊log2 kMaxWin⌋
constexpr int kLevelUnroll = 8;   // table entries a lane loads before it stores
constexpr int kG = 4;             // adjacent pixels a lane takes (float4 access)
constexpr int kGroups = kTX / kG;     // pixel groups of a 32-column row
constexpr int kGRows = 32 / kGroups;  // rows a warp takes at once, kG pixels a lane
static_assert(kBlk == kWarps * kG, "pass 2: each warp takes kG rows");
constexpr int kMaxSmemFloats = 232448 / 4;  // dynamic shared memory of a block

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Shared-memory plan, in floats.  Region A holds the M slab (summed in
// place) and the warps' doubling tables (steps 1–3), then the r1 tile and
// T (steps 4–5); the clamped flow follows it.  Where the tables of all
// eight warps do not fit (the widest windows), fewer warps build row sums.
struct Plan {
  int mm, win, levels, ext, rows, slab_rows, vc, row_len, row_st, nr, nc;
  int reg_rows, slab, tab_levels, tab_warps, region_a, fdx, total;
};

__host__ __device__ inline Plan plan(int winsize, int radius, bool emit_flow) {
  Plan p;
  p.mm = winsize / 2;
  p.win = 2 * p.mm + 1;
  p.levels = 0;
  while ((2 << p.levels) <= p.win) ++p.levels;  // K = ⌊log2 win⌋
  p.ext = emit_flow ? 0 : radius + 1;
  p.rows = kBlk + 2 * p.ext;            // flow rows of this block
  p.slab_rows = p.rows + 2 * p.mm;      // M rows of the slab
  p.vc = kTX + 2 * p.mm;                // M columns of the slab
  p.row_len = 5 * p.vc;                 // one slab row, five channels
  p.row_st = p.row_len | 1;  // odd row stride: rows a warp reads together hit distinct banks
  p.nr = kBlk + 2 * radius + 1;         // r1 rows of the tile
  p.nc = kTX + 2 * radius + 1;          // r1 columns of the tile
  p.slab = p.slab_rows * p.row_st;
  // the presets' windows sum rows in registers; others need the tables
  p.reg_rows = p.win == 15 || p.win == 5;
  p.tab_levels = p.levels > 1 ? p.levels - 1 : 1;  // P1 … P_{K-1}
  p.fdx = emit_flow ? 0 : p.rows * kTX;
  const int fdy = emit_flow ? 0 : kBlk * kTX;
  const int tab_room = kMaxSmemFloats - p.slab - p.fdx - fdy;
  const int fit = tab_room > 0 ? tab_room / (p.tab_levels * p.row_len) : 0;
  p.tab_warps = fit < kWarps ? fit : kWarps;
  const int a_box = p.slab + (p.reg_rows ? 0 : p.tab_warps * p.tab_levels * p.row_len);
  const int a_warp = round4(p.nr * 5 * p.nc) + p.nr * 5 * kTX;
  p.region_a = round4((emit_flow || a_box > a_warp) ? a_box : a_warp);
  p.total = p.region_a + p.fdx + fdy;
  return p;
}

// One level of the doubling table, in place: v[i] = v[i] + v[i + S].
template <int S, int N>
__device__ __forceinline__ void level_up(float (&v)[N]) {
#pragma unroll
  for (int i = 0; i + S < N; ++i) v[i] = v[i] + v[i + S];
}

// The window sums of kG adjacent outputs from v = P_k at positions 0 … N-1
// (P_0: the column sums they read): while a level above P_k fits in WIN,
// take the piece of bit k of WIN (at offset pos_k, WIN's bits above k)
// before P_k is overwritten by P_{k+1}, recurse, and add the piece on the
// way back.  So out = P_K + the pieces, largest first: the order of
// _win_sum_tree.  Every index is a constant, so v stays in registers.
template <int WIN, int K, int N>
__device__ __forceinline__ void window_sums(float (&v)[N], float (&out)[kG]) {
  if constexpr ((2 << K) <= WIN) {
    constexpr bool has = (WIN >> K) & 1;
    constexpr int pos = WIN & ~((2 << K) - 1);
    float piece[kG];
    if constexpr (has) {
#pragma unroll
      for (int q = 0; q < kG; ++q) piece[q] = v[q + pos];
    }
    level_up<(1 << K)>(v);
    window_sums<WIN, K + 1>(v, out);
    if constexpr (has) {
#pragma unroll
      for (int q = 0; q < kG; ++q) out[q] = out[q] + piece[q];
    }
  } else {
#pragma unroll
    for (int q = 0; q < kG; ++q) out[q] = v[q];
  }
}

// The box sums of kG adjacent flow pixels (x0 … x0+kG-1, every channel),
// in registers; `row` points at column x0 of the row's column sums, whose
// kG + WIN - 1 values the pixels read are loaded once.
template <int WIN>
__device__ __forceinline__ void row_sums_reg(const float* row, int vc, float scale,
                                             float (&g)[kG][5]) {
  constexpr int N = kG + WIN - 1;
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    float v[N], out[kG];
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = row[c * vc + i];
    window_sums<WIN, 0>(v, out);
#pragma unroll
    for (int q = 0; q < kG; ++q) g[q][c] = out[q] * scale;
  }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Stage n_rows rows of five channels into shared memory as float32,
// [row][channel][column] with `width` columns a channel and rows dst_stride
// apart.  Element e of a row is channel e / width, column e % width, read
// at row_ptr(i)[c * plane + col(j)].  Each lane takes elements lane + 32k.
// A bfloat16 source is widened in registers, ROWS rows × kStageElems loads
// in flight before the lane stores; ROWS = 0 copies a float32 source with
// cp.async instead (no registers held; the caller waits with
// cp_async_wait_all).
template <int ROWS, typename ColFn, typename RowFn>
__device__ __forceinline__ void stage_rows(float* dst, int n_rows, int width, int dst_stride,
                                           int plane, int warp, int lane, ColFn col,
                                           RowFn row_ptr) {
  const int row_len = 5 * width;
  for (int e0 = lane; e0 < row_len; e0 += 32 * kStageElems) {
    int off[kStageElems];
#pragma unroll
    for (int k = 0; k < kStageElems; ++k) {
      const int e = min(e0 + 32 * k, row_len - 1);
      const int c = e / width;
      off[k] = c * plane + col(e - c * width);
    }
    if constexpr (ROWS == 0) {
      for (int i = warp; i < n_rows; i += kWarps) {
        const float* row = row_ptr(i);
        float* d = dst + i * dst_stride + e0;
#pragma unroll
        for (int k = 0; k < kStageElems; ++k)
          if (e0 + 32 * k < row_len) cp_async4(d + 32 * k, row + off[k]);
      }
    } else {
      for (int i0 = warp * ROWS; i0 < n_rows; i0 += kWarps * ROWS) {
        float v[ROWS][kStageElems];
#pragma unroll
        for (int u = 0; u < ROWS; ++u) {
          const auto* row = row_ptr(min(i0 + u, n_rows - 1));
#pragma unroll
          for (int k = 0; k < kStageElems; ++k) v[u][k] = __bfloat162float(__ldg(row + off[k]));
        }
#pragma unroll
        for (int u = 0; u < ROWS; ++u) {
          if (i0 + u >= n_rows) break;
#pragma unroll
          for (int k = 0; k < kStageElems; ++k)
            if (e0 + 32 * k < row_len) dst[(i0 + u) * dst_stride + e0 + 32 * k] = v[u][k];
        }
      }
    }
  }
}

// The running column sums of one staged column, in place: S(0) =
// Σ_{u<win} M(u), then S(r) = (S(r-1) + M(r+win-1)) - M(r-1) for r < rows,
// M(i) read at col[i * st] and S(r) written over M(r) once M(r) is read;
// the loads run four rows ahead of the stores.
__device__ __forceinline__ void column_sums(float* col, int st, int win, int rows) {
  float s = col[0];
  for (int u = 1; u < win; ++u) s = s + col[u * st];
  int r = 1;
  for (; r + 3 < rows; r += 4) {
    float in[4], outv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) in[u] = col[(r + u + win - 1) * st];
#pragma unroll
    for (int u = 0; u < 4; ++u) outv[u] = col[(r + u - 1) * st];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float next = s + in[u] - outv[u];
      col[(r + u - 1) * st] = s;
      s = next;
    }
  }
  for (; r < rows; ++r) {
    const float next = s + col[(r + win - 1) * st] - col[(r - 1) * st];
    col[(r - 1) * st] = s;
    s = next;
  }
  col[(rows - 1) * st] = s;
}

template <typename MT, bool FLOW>
__global__ void __launch_bounds__(kThreads, FLOW ? 4 : 3) fused_box_update_kernel(
    const MT* __restrict__ m, const float* __restrict__ r0,
    const float* __restrict__ r1, const float* __restrict__ bsc,
    void* __restrict__ out, int hk, int wk, int hp, int wp, int mr, int mc,
    int winsize, int radius) {
  extern __shared__ float smem[];
  const Plan p = plan(winsize, radius, FLOW);
  const int b = blockIdx.z;
  const int Y0 = blockIdx.y * kBlk;
  const int X0 = blockIdx.x * kTX;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int e = radius + 1;
  const float scale = (float)(1.0 / ((double)winsize * winsize));
  const float rad = (float)radius;
  const long long plane = (long long)hp * wp;

  float* sums = smem;                   // [slab_rows][5][vc], row stride row_st
  float* fdx = smem + p.region_a;       // [rows][kTX] clamped dx
  float* fdy = fdx + p.fdx;             // [kBlk][kTX] clamped dy

  // 1. stage M's slab: slab row i is canvas row Y0 - ext - mm + i, column j
  //    canvas column X0 - mm + j (clamped indices stand for the edge pad).
  //    float32 M is copied with cp.async, bfloat16 M widened in registers.
  {
    const MT* mb = m + (long long)b * 5 * plane;
    stage_rows<sizeof(MT) == 4 ? 0 : kStageRowsM>(
        sums, p.slab_rows, p.vc, p.row_st, (int)plane, warp, lane,
        [&](int j) { return min(max(X0 - p.mm + j, 0), wp - 1); },
        [&](int i) { return mb + (long long)min(max(Y0 - p.ext - p.mm + i, 0), hp - 1) * wp; });
    cp_async_wait_all();
  }
  __syncthreads();

  // 2. column sums, one thread a column, in place
  for (int t = threadIdx.x; t < p.row_len; t += kThreads)
    column_sums(sums + t, p.row_st, p.win, p.rows);
  __syncthreads();

  // 3. row sums and the 2×2 solve.  solve() turns the five box sums of
  //    flow pixel (ri, xi) into its flow (by value: an array passed by
  //    address would go to local memory): written out for emit = flow, else
  //    kept clamped in fdx (and fdy on the block's own rows).
  auto solve = [&](int ri, int xi, float g11, float g12, float g22, float h1, float h2) {
    const float idet = 1.0f / (g11 * g22 - g12 * g12 + 1e-3f);
    const float dx = (g11 * h2 - g12 * h1) * idet;
    const float dy = (g22 * h1 - g12 * h2) * idet;
    if constexpr (FLOW) {
      const int y = Y0 + ri, x = X0 + xi;
      if (y < hp && x < wp) {
        float* fo = (float*)out + (long long)b * 2 * plane;
        const long long pix = (long long)y * wp + x;
        fo[pix] = dx;
        fo[plane + pix] = dy;
      }
    } else {
      fdx[ri * kTX + xi] = nsof::clampf(dx, rad);
      if (ri >= e && ri < e + kBlk) fdy[(ri - e) * kTX + xi] = nsof::clampf(dy, rad);
    }
  };
  if (p.reg_rows) {
    // the bundled presets' windows (grasp 15, tabletennis 5): a lane takes
    // kG adjacent pixels of a flow row and builds their table in registers
    const int x0 = (lane % kGroups) * kG;
    for (int ri = warp * kGRows + lane / kGroups; ri < p.rows; ri += kWarps * kGRows) {
      float g[kG][5];
      const float* row = sums + ri * p.row_st + x0;
      if (p.win == 15)
        row_sums_reg<15>(row, p.vc, scale, g);
      else
        row_sums_reg<5>(row, p.vc, scale, g);
#pragma unroll
      for (int q = 0; q < kG; ++q) solve(ri, x0 + q, g[q][0], g[q][1], g[q][2], g[q][3], g[q][4]);
    }
  } else if (warp < p.tab_warps) {
    // any other window: each warp builds the table P1 … P_{K-1} of a whole
    // flow row in its shared scratch, then lane x forms P_K(x) (used once,
    // not stored) and adds the lower pieces, largest first
    float* tab = smem + p.slab + warp * p.tab_levels * p.row_len;
    for (int ri = warp; ri < p.rows; ri += p.tab_warps) {
      const float* p0 = sums + ri * p.row_st;
      const float* prev = p0;  // ends as P_{K-1}
      for (int k = 1; k < p.levels; ++k) {
        const int s = 1 << (k - 1);
        float* cur = tab + (k - 1) * p.row_len;
        const int len = p.row_len - (2 * s - 1);
        for (int q0 = lane; q0 < len; q0 += 32 * kLevelUnroll) {
          float lo[kLevelUnroll], hi[kLevelUnroll];
#pragma unroll
          for (int u = 0; u < kLevelUnroll; ++u) {
            const int q = min(q0 + 32 * u, len - 1);
            lo[u] = prev[q];
            hi[u] = prev[q + s];
          }
#pragma unroll
          for (int u = 0; u < kLevelUnroll; ++u)
            if (q0 + 32 * u < len) cur[q0 + 32 * u] = lo[u] + hi[u];
        }
        __syncwarp();
        prev = cur;
      }
      float gsum[5];
      const int top = p.levels > 0 ? 1 << (p.levels - 1) : 0;
#pragma unroll
      for (int c = 0; c < 5; ++c) {
        const int x = c * p.vc + lane;
        gsum[c] = p.levels > 0 ? prev[x] + prev[x + top] : p0[x];
      }
      int pos = 2 * top > 0 ? 2 * top : 1;
#pragma unroll
      for (int k = kMaxLevel - 1; k >= 0; --k) {
        if (k >= p.levels || !(p.win & (1 << k))) continue;
        const float* piece = (k == 0 ? p0 : tab + (k - 1) * p.row_len) + pos + lane;
#pragma unroll
        for (int c = 0; c < 5; ++c) gsum[c] = gsum[c] + piece[c * p.vc];
        pos += 1 << k;
      }
#pragma unroll
      for (int c = 0; c < 5; ++c) gsum[c] = gsum[c] * scale;
      __syncwarp();  // every lane has read the table before it is rebuilt
      solve(ri, lane, gsum[0], gsum[1], gsum[2], gsum[3], gsum[4]);
    }
  }
  if constexpr (FLOW) return;
  __syncthreads();

  // 4. stage r1's tile over the dead slab: tile row i is canvas row
  //    Y0 - r + i, tile column j canvas column X0 - r + j
  const int h1p = hp + 2 * mr;
  const int w1p = wp + 2 * mc;
  const int tile_len = 5 * p.nc;
  float* tile = smem;                   // [nr][5][nc]
  float* tpass = smem + round4(p.nr * tile_len);  // [nr][5][kTX], warp pass 1
  {
    const long long plane1 = (long long)h1p * w1p;
    const float* rb = r1 + (long long)b * 5 * plane1;
    // columns past the canvas's right edge + r feed no output pixel
    stage_rows<0>(
        tile, p.nr, p.nc, tile_len, (int)plane1, warp, lane,
        [&](int j) { return min(X0 - radius + j, wp + radius) + mc; },
        [&](int i) { return rb + (long long)(Y0 - radius + i + mr) * w1p; });
    cp_async_wait_all();
  }
  __syncthreads();

  // 5a. warp pass 1 once per (source row, column): row i at its own dx
  //     (flow row i + 1), kx from -r to r + 1.  A lane takes kG adjacent
  //     columns of a row and slides its window of r1 along them, so it
  //     reads each tile value once instead of once a tap.
  {
    const int x0 = (lane % kGroups) * kG;
    for (int i = warp * kGRows + lane / kGroups; i < p.nr; i += kWarps * kGRows) {
      const float4 d4 = *reinterpret_cast<const float4*>(fdx + (i + 1) * kTX + x0);
      const float dxr[kG] = {d4.x, d4.y, d4.z, d4.w};
      const float* src = tile + i * tile_len + x0 + radius;
      float t[5][kG], win[5][kG], w[kG];
#pragma unroll
      for (int q = 0; q < kG; ++q) w[q] = nsof::hat(dxr[q], -radius);
#pragma unroll
      for (int c = 0; c < 5; ++c)
#pragma unroll
        for (int q = 0; q < kG; ++q) {
          win[c][q] = src[c * p.nc - radius + q];
          t[c][q] = win[c][q] * w[q];
        }
      for (int kx = -radius + 1; kx <= radius + 1; ++kx) {
#pragma unroll
        for (int q = 0; q < kG; ++q) w[q] = nsof::hat(dxr[q], kx);
#pragma unroll
        for (int c = 0; c < 5; ++c) {
#pragma unroll
          for (int q = 0; q + 1 < kG; ++q) win[c][q] = win[c][q + 1];
          win[c][kG - 1] = src[c * p.nc + kx + kG - 1];
#pragma unroll
          for (int q = 0; q < kG; ++q) t[c][q] = t[c][q] + win[c][q] * w[q];
        }
      }
#pragma unroll
      for (int c = 0; c < 5; ++c)
        *reinterpret_cast<float4*>(tpass + (i * 5 + c) * kTX + x0) =
            make_float4(t[c][0], t[c][1], t[c][2], t[c][3]);
    }
  }
  __syncthreads();

  // 5b. pass 2 down the column at the pixel's dy (ky from -r to r + 1),
  //     and the rebuild of M'.  A lane takes kG adjacent rows of a column
  //     (the warp's share of the block's rows) and slides its window of T
  //     down them.
  const int x = X0 + lane;
  if (x >= wp) return;
  const int j0 = warp * kG;
  float dy[kG], acc[5][kG], win[5][kG], w[kG];
#pragma unroll
  for (int q = 0; q < kG; ++q) {
    dy[q] = fdy[(j0 + q) * kTX + lane];
    w[q] = nsof::hat(dy[q], -radius);
  }
  const float* src = tpass + (j0 + radius) * 5 * kTX + lane;  // T row j0 + r
#pragma unroll
  for (int c = 0; c < 5; ++c)
#pragma unroll
    for (int q = 0; q < kG; ++q) {
      win[c][q] = src[((q - radius) * 5 + c) * kTX];
      acc[c][q] = win[c][q] * w[q];
    }
  for (int ky = -radius + 1; ky <= radius + 1; ++ky) {
#pragma unroll
    for (int q = 0; q < kG; ++q) w[q] = nsof::hat(dy[q], ky);
#pragma unroll
    for (int c = 0; c < 5; ++c) {
#pragma unroll
      for (int q = 0; q + 1 < kG; ++q) win[c][q] = win[c][q + 1];
      win[c][kG - 1] = src[((ky + kG - 1) * 5 + c) * kTX];
#pragma unroll
      for (int q = 0; q < kG; ++q) acc[c][q] = acc[c][q] + win[c][q] * w[q];
    }
  }
#pragma unroll
  for (int q = 0; q < kG; ++q) {
    const int y = Y0 + j0 + q;
    const float a[5] = {acc[0][q], acc[1][q], acc[2][q], acc[3][q], acc[4][q]};
    const float sc = bsc[(long long)min(y, hk - 1) * wk + min(x, wk - 1)];
    nsof::build_store(a, r0 + (long long)b * 5 * plane, plane, (long long)y * wp + x,
                      fdx[(j0 + q + e) * kTX + lane], dy[q], sc,
                      (MT*)out + (long long)b * 5 * plane);
  }
}

template <typename MT, bool FLOW>
int launch(const void* m, const void* r0, const void* r1, const void* bsc,
           void* out, int b, int hk, int wk, int hp, int wp, int mr, int mc,
           int winsize, int radius, void* stream) {
  if (b == 0) return 0;
  const Plan p = plan(winsize, radius, FLOW);
  // staged offsets within a sample are 32-bit
  const long long plane1 = (long long)(hp + 2 * mr) * (wp + 2 * mc);
  if (hp % kBlk != 0 || p.win > kMaxWin || 5 * plane1 >= (1LL << 31) ||
      (!p.reg_rows && p.tab_warps < 1) || p.total > kMaxSmemFloats)
    return (int)cudaErrorInvalidValue;
  const int bytes = (int)sizeof(float) * p.total;
  cudaError_t err = cudaFuncSetAttribute(
      fused_box_update_kernel<MT, FLOW>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((wp + kTX - 1) / kTX, hp / kBlk, b);
  fused_box_update_kernel<MT, FLOW><<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
      (const MT*)m, (const float*)r0, (const float*)r1, (const float*)bsc, out,
      hk, wk, hp, wp, mr, mc, winsize, radius);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int nsof_fused_box_update(
    const void* m, const void* r0, const void* r1, const void* bsc, void* out,
    int b, int hk, int wk, int hp, int wp, int mr, int mc, int winsize,
    int radius, int emit_flow, void* stream) {
  return emit_flow ? launch<__nv_bfloat16, true>(m, r0, r1, bsc, out, b, hk, wk, hp, wp,
                                                 mr, mc, winsize, radius, stream)
                   : launch<__nv_bfloat16, false>(m, r0, r1, bsc, out, b, hk, wk, hp, wp,
                                                  mr, mc, winsize, radius, stream);
}

extern "C" int nsof_fused_box_update_f32(
    const void* m, const void* r0, const void* r1, const void* bsc, void* out,
    int b, int hk, int wk, int hp, int wp, int mr, int mc, int winsize,
    int radius, int emit_flow, void* stream) {
  return emit_flow ? launch<float, true>(m, r0, r1, bsc, out, b, hk, wk, hp, wp, mr, mc,
                                         winsize, radius, stream)
                   : launch<float, false>(m, r0, r1, bsc, out, b, hk, wk, hp, wp, mr, mc,
                                          winsize, radius, stream);
}
