// K4: one Farnebäck iteration, fused: box sum → 2×2 solve → warp → M'.
//
// Replaces nsof_tpu/ops/farneback_fast.py::_fused_box_update_kernel
// (called through _fused_box_update_cm): box-sum the system M (bfloat16,
// or float32 for kernel_mode='fused_f32') over (2m+1)² in float32, solve
// the 2×2 system (+1e-3 on the determinant) on each 32-row canvas block's
// rows and, for emit = matrices, on its ±(r+1) halo rows too; then warp r1
// by that flow and write M' in M's type (emit = matrices) or write the
// float32 flow (emit = flow).  The intermediate flow never leaves shared
// memory.
//
// Bound: per canvas pixel it must read M (10 bytes in bf16), r0 (20), r1
// (20 and its ring) and write M' (10): ~64 bytes (~84 with f32 M), ~330
// float32 operations with every intermediate computed once: the bytes bound
// it on paper.  On the H100 the instructions do: with --fmad=false every
// product and sum is one, and each phase between two barriers waits on
// its slowest warp.  The designs below cut instructions and barrier tails;
// the bytes are not what they wait on (PERF.md §6, K4).
//
// The arithmetic is the plain version's, whichever design runs: the
// vertical window sum is the TPU kernel's running recurrence
// S(r) = (S(r-1) + M(r+2m)) - M(r-1), started afresh at each 32-row
// block's first slab row; a block solves the flow of its own halo rows and
// never takes a neighbour's, whose sums round differently.  A block of a
// 32-row canvas block runs, in order:
//  2. the column sums: one thread per slab column runs the recurrence down
//     it (rows Y0-ext-m … Y0+31+ext+m, columns X0-m … X0+31+m, read
//     through clamped indices: the edge padding needs no copy);
//  3. row sums in the order of _win_sum_tree (the top level of the
//     doubling table P_k(p) = P_{k-1}(p) + P_{k-1}(p + 2^{k-1}), then the
//     lower pieces, largest set bit of win first), then the 2×2 solve:
//     for the presets' windows (15, 5) a lane takes 4 adjacent pixels of a
//     row, loads the 3 + win column sums they read once and builds their
//     table in registers (a template on the window); any other window takes
//     a per-warp table of whole rows in shared memory;
//  5. warp pass 1 once per (r1 row, column) into T, pass 2 down T at each
//     pixel's dy, then the build writes M'.  In both a lane takes 4
//     adjacent pixels and slides its window along them, so it reads each
//     staged value once.
// The flow emit is steps 2–3 with the float32 flow write.
//
// Strip design (fused_box_update_kernel_strip): the wrapper's choice for
// the presets' windows (5, 15) at radius 3 and 5 (the flow emit at any
// radius) where two blocks fit an SM: bfloat16 M, and float32 M's flow
// emit.  A block owns a 32-column strip of one sample and walks down
// `walk` of its 32-row blocks (the wrapper picks the walk from the canvas,
// B and the SM count).  Shared memory holds M's ring (the current slab's
// rows, in M's type), r1's ring (the warp's 32+2r+1 rows), the column sums
// and then T in one room, and the clamped flow.  Consecutive blocks share
// 2·ext+2m slab rows and 2r+1 r1 rows; they stay in the rings, so each M
// and r1 byte of a strip is loaded once.  The next block's 32 new M rows
// go out (cp.async, 16 bytes a copy) as soon as the column sums have read
// the ring rows they replace, and its r1 rows as soon as pass 1 has: each
// is in flight through the rest of the step.  Window and radius are
// template arguments, so the column recurrence runs in three stretches of
// fixed stride (no index arithmetic a load), the row sums and pass 1 load
// float4s, and every tap unrolls.  The next system's block has 10 warps:
// its 40 flow rows and 39 r1 rows take one round each; in pass 2 (32 rows,
// 8 warps) the other two issue the next r1 rows.  r0 and the border scale
// are read ahead of pass 2's window.
//
// Tile design (fused_box_update_kernel): every other case, such as windows
// other than 5 and 15 (63 at radius 7 would not fit the rings), float32
// M's next system (one strip block fills an SM's shared memory) and
// operands not 16-byte aligned.  One block of 256 threads per (sample,
// 32-row block, 32-column tile) stages M's slab (bf16 through registers,
// f32 with cp.async), sums the columns in place, solves, then stages r1's
// tile over the dead slab with cp.async, and warps; its phases run one
// after another.
//
// Build facts (ptxas -v, sm_90a, --fmad=false): the strip design's next
// system uses 93–96 registers (capped at 96 for two 320-thread blocks an
// SM), its flow emit 56–64, with no stack frame; the tile design 80 and
// 64, with a 16-byte frame (12 bytes spilled) in its next system and an
// 8-byte frame in its bf16 flow emit.  nvcc takes ≈ 22 s for this source
// (16 instances) on the H100's host.

#include <stdint.h>

#include "farneback_common.cuh"

namespace {

constexpr int kBlk = 32;  // canvas row block (the TPU kernel's row tile)
constexpr int kTX = 32;   // tile columns: one lane per column
constexpr int kThreads = 256;  // threads of a 32-column tile
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
constexpr int kMaxSmemBytes = 232448;  // dynamic shared memory of a block
constexpr int kMaxSmemFloats = kMaxSmemBytes / 4;

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Tile design's shared-memory plan, in floats.  Region A holds the M slab
// (summed in place) and the warps' doubling tables (steps 1–3), then the r1
// tile and T (steps 4–5); the clamped flow follows it.  Where the tables of
// all eight warps do not fit (the widest windows), fewer warps build row
// sums.
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

// The same from 16-byte aligned column sums (channel stride cs a multiple
// of 4): the values load as float4, four at a time.
template <int WIN>
__device__ __forceinline__ void row_sums_vec(const float* row, int cs, float scale,
                                             float (&g)[kG][5]) {
  constexpr int N = kG + WIN - 1;
  constexpr int N4 = (N + 3) / 4;
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    float4 w[N4];
#pragma unroll
    for (int i = 0; i < N4; ++i) w[i] = *reinterpret_cast<const float4*>(row + c * cs + 4 * i);
    float v[N], out[kG];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float4 q = w[i / 4];
      v[i] = i % 4 == 0 ? q.x : i % 4 == 1 ? q.y : i % 4 == 2 ? q.z : q.w;
    }
    window_sums<WIN, 0>(v, out);
#pragma unroll
    for (int q = 0; q < kG; ++q) g[q][c] = out[q] * scale;
  }
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// The same recurrence down one column of M's ring, S(r) to out[r * SST]:
// slab row i lies at ring row base + i, or base + i - SLAB once that passes
// the ring's end.  The ring rows each S(r) reads wrap at most once, so the
// rows run in three stretches (neither, the new row, both rows past the
// wrap), each at a fixed stride: no index arithmetic a load.
template <int WIN, int ROWS, int SLAB, int MROW, int SST, typename MT>
__device__ __forceinline__ void column_sums_ring(const MT* col, int base, float* out) {
  const int wrap = SLAB - base;             // the first slab row past the ring's end
  const MT* lo = col + base * MROW;         // slab row i < wrap at lo[i * MROW]
  const MT* hi = lo - SLAB * MROW;          // i >= wrap at hi[i * MROW]
  float s = nsof::load(lo);
#pragma unroll
  for (int u = 1; u < WIN; ++u) s = s + nsof::load((u < wrap ? lo : hi) + u * MROW);
  out[0] = s;
  auto stretch = [&](int ra, int rb, const MT* in, const MT* old) {
#pragma unroll 4
    for (int r = ra; r < rb; ++r) {
      s = s + nsof::load(in + (r + WIN - 1) * MROW) - nsof::load(old + (r - 1) * MROW);
      out[r * SST] = s;
    }
  };
  const int r_in = min(max(wrap - WIN + 1, 1), ROWS);  // from here the new row wraps
  const int r_old = min(max(wrap + 1, 1), ROWS);       // from here the old row wraps
  stretch(1, r_in, lo, lo);
  stretch(r_in, r_old, hi, lo);
  stretch(r_old, ROWS, hi, hi);
}

// The 2×2 solve of one pixel from its five box sums, +1e-3 on the
// determinant (by value: an array passed by address would go to local
// memory).
__device__ __forceinline__ void solve2x2(float g11, float g12, float g22, float h1, float h2,
                                         float& dx, float& dy) {
  const float idet = 1.0f / (g11 * g22 - g12 * g12 + 1e-3f);
  dx = (g11 * h2 - g12 * h1) * idet;
  dy = (g22 * h1 - g12 * h2) * idet;
}

// Step 5a of the tile design: warp pass 1 once per (source row, column),
// row i (at src_row(i): r1 row Y0 - r + i, column u canvas column
// X0 - r + u, channel stride nc) at its own dx (flow row i + 1), kx from -r
// to r + 1, into T [nr][5][32].  A lane takes kG adjacent columns of a row
// and slides its window of r1 along them, so it reads each value once
// instead of once a tap.
template <typename RowFn>
__device__ __forceinline__ void warp_pass1(int nr, int nc, const float* fdx, RowFn src_row,
                                           int radius, float* tpass, int warp, int lane) {
  const int x0 = (lane % kGroups) * kG;
  for (int i = warp * kGRows + lane / kGroups; i < nr; i += kWarps * kGRows) {
    const float4 d4 = *reinterpret_cast<const float4*>(fdx + (i + 1) * kTX + x0);
    const float dxr[kG] = {d4.x, d4.y, d4.z, d4.w};
    const float* src = src_row(i) + x0 + radius;
    float t[5][kG], win[5][kG], w[kG];
#pragma unroll
    for (int q = 0; q < kG; ++q) w[q] = nsof::hat(dxr[q], -radius);
#pragma unroll
    for (int c = 0; c < 5; ++c)
#pragma unroll
      for (int q = 0; q < kG; ++q) {
        win[c][q] = src[c * nc - radius + q];
        t[c][q] = win[c][q] * w[q];
      }
    for (int kx = -radius + 1; kx <= radius + 1; ++kx) {
#pragma unroll
      for (int q = 0; q < kG; ++q) w[q] = nsof::hat(dxr[q], kx);
#pragma unroll
      for (int c = 0; c < 5; ++c) {
#pragma unroll
        for (int q = 0; q + 1 < kG; ++q) win[c][q] = win[c][q + 1];
        win[c][kG - 1] = src[c * nc + kx + kG - 1];
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

// Step 5a of the strip design, by n_warps warps, on r1's ring (its column 0
// canvas column X0 - RA, RA = R rounded up to 4, channel stride w1, row i
// at src_row(i)): each lane's window of 2R + 5 values loads as float4s
// from the 16-byte aligned column x0; the taps, their order and their
// weights are warp_pass1's, every one unrolled.
template <int R, typename RowFn>
__device__ __forceinline__ void warp_pass1_vec(int nr, int w1, const float* fdx, RowFn src_row,
                                               float* tpass, int warp, int n_warps, int lane) {
  constexpr int kRA = (R + 3) & ~3;
  constexpr int kN = 2 * R + 5;                // the window: canvas columns x0 - R … x0 + 4 + R
  constexpr int kN4 = (kRA - R + kN + 3) / 4;  // float4s from ring column x0
  const int x0 = (lane % kGroups) * kG;
  for (int i = warp * kGRows + lane / kGroups; i < nr; i += n_warps * kGRows) {
    const float4 d4 = *reinterpret_cast<const float4*>(fdx + (i + 1) * kTX + x0);
    const float dxr[kG] = {d4.x, d4.y, d4.z, d4.w};
    float w[2 * R + 2][kG];
#pragma unroll
    for (int k = 0; k < 2 * R + 2; ++k)
#pragma unroll
      for (int q = 0; q < kG; ++q) w[k][q] = nsof::hat(dxr[q], k - R);
    const float* row = src_row(i) + x0;
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      float4 f[kN4];
#pragma unroll
      for (int n = 0; n < kN4; ++n) f[n] = *reinterpret_cast<const float4*>(row + c * w1 + 4 * n);
      float v[kN];
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        const int e = kRA - R + n;
        const float4 g = f[e / 4];
        v[n] = e % 4 == 0 ? g.x : e % 4 == 1 ? g.y : e % 4 == 2 ? g.z : g.w;
      }
      float t[kG];
#pragma unroll
      for (int q = 0; q < kG; ++q) t[q] = v[q] * w[0][q];
#pragma unroll
      for (int k = 1; k < 2 * R + 2; ++k)
#pragma unroll
        for (int q = 0; q < kG; ++q) t[q] = t[q] + v[q + k] * w[k][q];
      *reinterpret_cast<float4*>(tpass + (i * 5 + c) * kTX + x0) =
          make_float4(t[0], t[1], t[2], t[3]);
    }
  }
}

// Step 5b at column xs of the buffers (canvas column X0 + xs): pass 2 down
// T at the pixel's dy (ky from -r to r + 1) and the rebuild of M'.  Warp
// `warp` takes its kG adjacent rows and slides its window of T down them;
// r0 and the border scale are read before the window (AHEAD: their loads
// are in flight through it) or at each pixel's build.
template <bool AHEAD, typename MT>
__device__ __forceinline__ void warp_pass2_store(const float* tpass, int tw, const float* fdx,
                                                 const float* fdy, int radius, int e,
                                                 const float* __restrict__ r0b,
                                                 const float* __restrict__ bsc, int hk, int wk,
                                                 long long plane, int wp, int Y0, int X0, int xs,
                                                 int warp, MT* __restrict__ outb) {
  const int x = X0 + xs;
  if (x >= wp) return;
  const int j0 = warp * kG;
  float r0c[kG][5], sc[kG];
  auto read = [&](int q) {
    const int y = Y0 + j0 + q;
    const long long pix = (long long)y * wp + x;
#pragma unroll
    for (int c = 0; c < 5; ++c) r0c[q][c] = __ldg(r0b + c * plane + pix);
    sc[q] = __ldg(bsc + (long long)min(y, hk - 1) * wk + min(x, wk - 1));
  };
  if constexpr (AHEAD) {
#pragma unroll
    for (int q = 0; q < kG; ++q) read(q);
  }
  float dy[kG], acc[5][kG], win[5][kG], w[kG];
#pragma unroll
  for (int q = 0; q < kG; ++q) {
    dy[q] = fdy[(j0 + q) * tw + xs];
    w[q] = nsof::hat(dy[q], -radius);
  }
  const float* src = tpass + (j0 + radius) * 5 * tw + xs;  // T row j0 + r
#pragma unroll
  for (int c = 0; c < 5; ++c)
#pragma unroll
    for (int q = 0; q < kG; ++q) {
      win[c][q] = src[((q - radius) * 5 + c) * tw];
      acc[c][q] = win[c][q] * w[q];
    }
#pragma unroll
  for (int ky = -radius + 1; ky <= radius + 1; ++ky) {
#pragma unroll
    for (int q = 0; q < kG; ++q) w[q] = nsof::hat(dy[q], ky);
#pragma unroll
    for (int c = 0; c < 5; ++c) {
#pragma unroll
      for (int q = 0; q + 1 < kG; ++q) win[c][q] = win[c][q + 1];
      win[c][kG - 1] = src[((ky + kG - 1) * 5 + c) * tw];
#pragma unroll
      for (int q = 0; q < kG; ++q) acc[c][q] = acc[c][q] + win[c][q] * w[q];
    }
  }
#pragma unroll
  for (int q = 0; q < kG; ++q) {
    if constexpr (!AHEAD) read(q);
    const float a[5] = {acc[0][q], acc[1][q], acc[2][q], acc[3][q], acc[4][q]};
    nsof::build_store_r0(a, r0c[q], plane, (long long)(Y0 + j0 + q) * wp + x,
                         fdx[(j0 + q + e) * tw + xs], dy[q], sc[q], outb);
  }
}

// ── the tile design ────────────────────────────────────────────────────────

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
  //    flow pixel (ri, xi) into its flow: written out for emit = flow, else
  //    kept clamped in fdx (and fdy on the block's own rows).
  auto solve = [&](int ri, int xi, float g11, float g12, float g22, float h1, float h2) {
    float dx, dy;
    solve2x2(g11, g12, g22, h1, h2, dx, dy);
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

  // 5. the two warp passes and the rebuild of M'
  warp_pass1(p.nr, p.nc, fdx, [&](int i) { return tile + i * tile_len; }, radius, tpass, warp,
             lane);
  __syncthreads();
  warp_pass2_store<false>(tpass, kTX, fdx, fdy, radius, e, r0 + (long long)b * 5 * plane, bsc,
                          hk, wk, plane, wp, Y0, X0, lane, warp,
                          (MT*)out + (long long)b * 5 * plane);
}

// ── the strip design ───────────────────────────────────────────────────────

__host__ __device__ constexpr int round16c(int n) { return (n + 15) & ~15; }

// The strip design's geometry for M type MT, window WIN (5 or 15) and
// radius R (3 or 5; 0 for the flow emit, which warps nothing), in elements
// and bytes of shared memory (ops/farneback_fast.py's _k4_strip_layout
// mirrors it): M's ring [kSlab][5][kMW] in M's type, its column 0 canvas
// column X0 - m - kMOff, so its 16-byte chunks are the canvas's; r1's ring
// [kNR][5][kW1], its column 0 canvas column X0 - kRA (R rounded up to 4),
// so its 16-byte chunks are r1's and pass 1 loads each window as float4s;
// region C, the column sums [kRows][5][kCS] (16-byte rows: the row sums
// load float4s), then T [kNR][5][32]; the clamped dx [kRows][32] and dy
// [32][32].
template <typename MT, int WIN, int R, bool FLOW>
struct Strip {
  static constexpr int kMM = WIN / 2;
  static constexpr int kExt = FLOW ? 0 : R + 1;
  static constexpr int kRows = kBlk + 2 * kExt;   // flow rows of a row block
  static constexpr int kSlab = kRows + 2 * kMM;   // M rows of its slab: the ring
  static constexpr int kVC = kTX + 2 * kMM;       // slab columns
  static constexpr int kA = 16 / (int)sizeof(MT);  // elements of a 16-byte copy
  static constexpr int kMOff = (kA - kMM % kA) % kA;
  static constexpr int kMW = (kVC + kMOff + kA - 1) / kA * kA;
  static constexpr int kMRow = 5 * kMW;
  static constexpr int kCS = (kVC + 3) & ~3;
  static constexpr int kSST = 5 * kCS;
  static constexpr int kNR = kBlk + 2 * R + 1;  // r1 rows a block reads (none for the flow)
  static constexpr int kRA = (R + 3) & ~3;
  static constexpr int kW1 = (kTX + kRA + R + 1 + 3) & ~3;  // canvas columns X0-kRA … X0+31+R+1
  static constexpr int kRRow = 5 * kW1;
  static constexpr int kSums = kRows * kSST * 4;
  static constexpr int kT = FLOW ? 0 : kNR * 5 * kTX * 4;
  static constexpr int kOffR = round16c(kSlab * kMRow * (int)sizeof(MT));
  static constexpr int kOffC = kOffR + (FLOW ? 0 : round16c(kNR * kRRow * 4));
  static constexpr int kOffFdx = kOffC + round16c(kSums > kT ? kSums : kT);
  static constexpr int kOffFdy = kOffFdx + (FLOW ? 0 : kRows * kTX * 4);
  static constexpr int kBytes = kOffFdy + (FLOW ? 0 : kBlk * kTX * 4);
  static_assert(kBytes <= kMaxSmemBytes, "the rings fit a block's shared memory");
};

// Warps of a strip block: the flow emit's 8 take 4 of its 32 flow rows
// each; the next system's 10 take its 40 flow rows and 39 r1 rows in one
// round (grasp's radius), and in pass 2, whose 32 rows take 8 warps, the
// other two issue the next block's r1 rows.
template <bool FLOW>
constexpr int kStripWarps = FLOW ? kWarps : kWarps + 2;

template <typename MT, bool FLOW, int WIN, int R>
__global__ void __launch_bounds__(32 * kStripWarps<FLOW>, FLOW ? 4 : 2)
    fused_box_update_kernel_strip(
    const MT* __restrict__ m, const float* __restrict__ r0, const float* __restrict__ r1,
    const float* __restrict__ bsc, void* __restrict__ out, int hk, int wk, int hp, int wp,
    int mr, int mc, int winsize, int walk) {
  using G = Strip<MT, WIN, R, FLOW>;
  constexpr int kW = kStripWarps<FLOW>;
  extern __shared__ float4 strip_smem[];
  unsigned char* base = reinterpret_cast<unsigned char*>(strip_smem);
  MT* ring_m = reinterpret_cast<MT*>(base);
  float* ring_r = reinterpret_cast<float*>(base + G::kOffR);
  float* sums = reinterpret_cast<float*>(base + G::kOffC);  // column sums, then T
  float* fdx = reinterpret_cast<float*>(base + G::kOffFdx);
  float* fdy = reinterpret_cast<float*>(base + G::kOffFdy);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.z;
  const int X0 = blockIdx.x * kTX;
  const int k0 = blockIdx.y * walk;  // the walk's 32-row blocks k0 … k1-1
  const int k1 = min(k0 + walk, hp / kBlk);
  const int Yw = k0 * kBlk;
  const float scale = (float)(1.0 / ((double)winsize * winsize));
  const long long plane = (long long)hp * wp;
  const int w1p = wp + 2 * mc;
  const long long plane1 = (long long)(hp + 2 * mr) * w1p;
  const MT* mb = m + (long long)b * 5 * plane;

  // M's slab rows s0 … s0+n-1 of the walk (slab row s: canvas row
  // Yw - ext - m + s, clamped) into ring row s mod kSlab; a lane takes the
  // 16-byte chunks lane, lane + 32 of a row, a warp the rows warp,
  // warp + kW, …; a chunk across the canvas's left or right edge is filled
  // with clamped loads
  auto load_m = [&](int s0, int n) {
    constexpr int kCpc = G::kMW / G::kA;  // chunks a channel
#pragma unroll
    for (int u = 0; u < (5 * kCpc + 31) / 32; ++u) {
      const int q = lane + 32 * u;
      if (q < 5 * kCpc) {
        const int c = q / kCpc;
        const int x = X0 - G::kMM - G::kMOff + (q - c * kCpc) * G::kA;
        const bool inside = x >= 0 && x + G::kA <= wp;
        const MT* src_c = mb + c * plane;
        MT* dst_q = ring_m + q * G::kA;
        for (int s = s0 + warp; s < s0 + n; s += kW) {
          const MT* src = src_c + (long long)min(max(Yw - G::kExt - G::kMM + s, 0), hp - 1) * wp;
          MT* dst = dst_q + (s % G::kSlab) * G::kMRow;
          if (inside) {
            cp_async16(dst, src + x);
          } else {
#pragma unroll
            for (int e = 0; e < G::kA; ++e) dst[e] = src[min(max(x + e, 0), wp - 1)];
          }
        }
      }
    }
  };
  // r1's rows j0 … j0+n-1 of the walk (row j: canvas row Yw - R + j) into
  // ring row j mod kNR, 16 bytes a copy, by warps w0 … w0+nw-1, a warp every
  // nw-th row; a lane takes the chunks lane, lane + 32, … of a row.  A chunk
  // past r1's row (a canvas whose width no strip divides) is skipped: its
  // columns feed no output pixel.
  auto load_r1 = [&](int j0, int n, int w0, int nw) {
    constexpr int kCpc = G::kW1 / 4;  // chunks a channel
    const float* rb = r1 + (long long)b * 5 * plane1;
#pragma unroll
    for (int u = 0; u < (5 * kCpc + 31) / 32; ++u) {
      const int q = lane + 32 * u;
      const int c = q / kCpc;
      const int x = X0 - G::kRA + mc + (q - c * kCpc) * 4;  // r1's column
      if (q < 5 * kCpc && x + 4 <= w1p) {
        const float* src_c = rb + c * plane1 + x;
        float* dst_q = ring_r + q * 4;
        for (int j = j0 + warp - w0; j < j0 + n; j += nw)
          cp_async16(dst_q + (j % G::kNR) * G::kRRow, src_c + (long long)(Yw - R + j + mr) * w1p);
      }
    }
  };

  // the walk's first slab and r1 rows; then, each row block, the next
  // block's new rows go out as soon as their ring rows have been read
  load_m(0, G::kSlab);
  cp_async_commit();
  if constexpr (!FLOW) {
    load_r1(0, G::kNR, 0, kW);
    cp_async_commit();
  }
  for (int k = k0; k < k1; ++k) {
    const int kk = (k - k0) * kBlk;  // the block's first slab (and r1) row of the walk
    const int Y0 = k * kBlk;
    const bool more = k + 1 < k1;
    cp_async_wait<FLOW ? 0 : 1>();  // this block's M rows are in
    __syncthreads();

    // 2. column sums, one thread a column
    for (int t = threadIdx.x; t < 5 * G::kVC; t += 32 * kW) {
      const int c = t / G::kVC;
      const int j = t - c * G::kVC;
      column_sums_ring<WIN, G::kRows, G::kSlab, G::kMRow, G::kSST>(
          ring_m + c * G::kMW + G::kMOff + j, kk % G::kSlab, sums + c * G::kCS + j);
    }
    __syncthreads();
    if (more) load_m(kk + G::kSlab, kBlk);
    cp_async_commit();

    // 3. row sums and the 2×2 solve: a lane takes kG adjacent pixels of a
    //    flow row; the flow written out (emit = flow), else kept clamped
    {
      const int x0 = (lane % kGroups) * kG;
      for (int ri = warp * kGRows + lane / kGroups; ri < G::kRows; ri += kW * kGRows) {
        float g[kG][5];
        row_sums_vec<WIN>(sums + ri * G::kSST + x0, G::kCS, scale, g);
#pragma unroll
        for (int q = 0; q < kG; ++q) {
          float dx, dy;
          solve2x2(g[q][0], g[q][1], g[q][2], g[q][3], g[q][4], dx, dy);
          const int xi = x0 + q;
          if constexpr (FLOW) {
            if (X0 + xi < wp) {
              float* fo = (float*)out + (long long)b * 2 * plane;
              const long long pix = (long long)(Y0 + ri) * wp + X0 + xi;
              fo[pix] = dx;
              fo[plane + pix] = dy;
            }
          } else {
            fdx[ri * kTX + xi] = nsof::clampf(dx, (float)R);
            if (ri >= G::kExt && ri < G::kExt + kBlk)
              fdy[(ri - G::kExt) * kTX + xi] = nsof::clampf(dy, (float)R);
          }
        }
      }
    }

    if constexpr (!FLOW) {
      cp_async_wait<1>();  // this block's r1 rows are in
      __syncthreads();
      // 5. the two warp passes (T over the dead column sums) and M'
      const int rbase = kk % G::kNR;
      warp_pass1_vec<R>(G::kNR, G::kW1, fdx,
                        [&](int i) {
                          const int r = rbase + i;
                          return ring_r + (r < G::kNR ? r : r - G::kNR) * G::kRRow;
                        },
                        sums, warp, kW, lane);
      __syncthreads();
      // pass 2 on the block's 32 rows by warps 0-7; warps 8-9 meanwhile
      // issue the next block's r1 rows
      if (warp < kWarps)
        warp_pass2_store<true>(sums, kTX, fdx, fdy, R, G::kExt, r0 + (long long)b * 5 * plane,
                               bsc, hk, wk, plane, wp, Y0, X0, lane, warp,
                               (MT*)out + (long long)b * 5 * plane);
      else if (more)
        load_r1(kk + G::kNR, kBlk, kWarps, kW - kWarps);
      cp_async_commit();
    }
  }
}

template <typename MT, bool FLOW>
int launch(const void* m, const void* r0, const void* r1, const void* bsc,
           void* out, int b, int hk, int wk, int hp, int wp, int mr, int mc,
           int winsize, int radius, void* stream) {
  const Plan p = plan(winsize, radius, FLOW);
  if ((!p.reg_rows && p.tab_warps < 1) || p.total > kMaxSmemFloats)
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

template <typename MT, bool FLOW, int WIN, int R>
int launch_strip(const void* m, const void* r0, const void* r1, const void* bsc, void* out,
                 int b, int hk, int wk, int hp, int wp, int mr, int mc, int winsize, int walk,
                 void* stream) {
  using G = Strip<MT, WIN, R, FLOW>;
  // M's and r1's rows take 16-byte copies
  if (wp % G::kA != 0 || ((uintptr_t)m & 15) != 0 ||
      (!FLOW && (mc % 4 != 0 || ((uintptr_t)r1 & 15) != 0)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(fused_box_update_kernel_strip<MT, FLOW, WIN, R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, G::kBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((wp + kTX - 1) / kTX, (hp / kBlk + walk - 1) / walk, b);
  fused_box_update_kernel_strip<MT, FLOW, WIN, R><<<grid, 32 * kStripWarps<FLOW>, G::kBytes,
                                                    (cudaStream_t)stream>>>(
      (const MT*)m, (const float*)r0, (const float*)r1, (const float*)bsc, out, hk, wk, hp, wp,
      mr, mc, winsize, walk);
  return (int)cudaGetLastError();
}

// The strip design's instances: (window, radius) pairs (5, 3), (5, 5),
// (15, 3), (15, 5); the flow emit at any radius.  Returns the launch's
// status, or -1 where there is no instance.  With out null it launches
// nothing and returns the instance's shared memory in bytes.
template <typename MT>
int strip(const void* m, const void* r0, const void* r1, const void* bsc, void* out, int b,
          int hk, int wk, int hp, int wp, int mr, int mc, int winsize, int radius,
          int emit_flow, int walk, void* stream) {
#define NSOF_K4_STRIP(FLOW, WIN, R)                                                        \
  return out ? launch_strip<MT, FLOW, WIN, R>(m, r0, r1, bsc, out, b, hk, wk, hp, wp, mr, \
                                              mc, winsize, walk, stream)                  \
             : Strip<MT, WIN, R, FLOW>::kBytes
  const int win = 2 * (winsize / 2) + 1;
  if (emit_flow) {
    if (win == 15) NSOF_K4_STRIP(true, 15, 0);
    if (win == 5) NSOF_K4_STRIP(true, 5, 0);
  } else if (radius == 3) {
    if (win == 15) NSOF_K4_STRIP(false, 15, 3);
    if (win == 5) NSOF_K4_STRIP(false, 5, 3);
  } else if (radius == 5) {
    if (win == 15) NSOF_K4_STRIP(false, 15, 5);
    if (win == 5) NSOF_K4_STRIP(false, 5, 5);
  }
#undef NSOF_K4_STRIP
  return -1;
}

// walk 0: the tile design; walk ≥ 1: the strip design, each block walking
// `walk` row blocks
template <typename MT>
int dispatch(const void* m, const void* r0, const void* r1, const void* bsc, void* out, int b,
             int hk, int wk, int hp, int wp, int mr, int mc, int winsize, int radius,
             int emit_flow, int walk, void* stream) {
  if (b == 0) return 0;
  // staged offsets within a sample are 32-bit
  const long long plane1 = (long long)(hp + 2 * mr) * (wp + 2 * mc);
  if (hp % kBlk != 0 || 2 * (winsize / 2) + 1 > kMaxWin || 5 * plane1 >= (1LL << 31) ||
      walk < 0 || out == nullptr)
    return (int)cudaErrorInvalidValue;
  if (walk == 0)
    return emit_flow ? launch<MT, true>(m, r0, r1, bsc, out, b, hk, wk, hp, wp, mr, mc, winsize,
                                        radius, stream)
                     : launch<MT, false>(m, r0, r1, bsc, out, b, hk, wk, hp, wp, mr, mc,
                                         winsize, radius, stream);
  const int status = strip<MT>(m, r0, r1, bsc, out, b, hk, wk, hp, wp, mr, mc, winsize, radius,
                               emit_flow, walk, stream);
  return status < 0 ? (int)cudaErrorInvalidValue : status;
}

}  // namespace

extern "C" int nsof_fused_box_update(
    const void* m, const void* r0, const void* r1, const void* bsc, void* out,
    int b, int hk, int wk, int hp, int wp, int mr, int mc, int winsize,
    int radius, int emit_flow, int walk, void* stream) {
  return dispatch<__nv_bfloat16>(m, r0, r1, bsc, out, b, hk, wk, hp, wp, mr, mc, winsize,
                                 radius, emit_flow, walk, stream);
}

extern "C" int nsof_fused_box_update_f32(
    const void* m, const void* r0, const void* r1, const void* bsc, void* out,
    int b, int hk, int wk, int hp, int wp, int mr, int mc, int winsize,
    int radius, int emit_flow, int walk, void* stream) {
  return dispatch<float>(m, r0, r1, bsc, out, b, hk, wk, hp, wp, mr, mc, winsize, radius,
                         emit_flow, walk, stream);
}

// The strip design's shared memory in bytes for M elements of m_bytes, or
// -1 where it has no instance (the wrapper's picker mirrors it; the card
// test holds the two equal).
extern "C" int nsof_fused_box_update_strip_bytes(int winsize, int radius, int emit_flow,
                                                 int m_bytes) {
  return m_bytes == 2 ? strip<__nv_bfloat16>(nullptr, nullptr, nullptr, nullptr, nullptr, 0, 0,
                                             0, 0, 0, 0, 0, winsize, radius, emit_flow, 0,
                                             nullptr)
                      : strip<float>(nullptr, nullptr, nullptr, nullptr, nullptr, 0, 0, 0, 0,
                                     0, 0, 0, winsize, radius, emit_flow, 0, nullptr);
}
