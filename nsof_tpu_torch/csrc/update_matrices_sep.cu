// K3 and K5: a Farnebäck system from the separable warp.
//
// Replaces nsof_tpu/ops/farneback_fast.py::_update_matrices_sep_kernel in
// both of its drivers: _update_matrices_sep_cm, the first system of a
// level on the fused route (K3; M out in bfloat16, or float32 for
// kernel_mode='fused_f32'), and update_matrices_pallas(separable=True), the
// update of the pallas_sep route (K5; float32, on the level's own extent
// with r1 edge-padded by radius + 1).  Clamp the flow to ±r, warp r1 in two
// separable passes (horizontal at each row's own dx, then vertical at the
// output pixel's dy), build r2…r6, scale by the border table and store the
// five products.
//
// Bound: per output pixel it must read r0 and r1 (20 bytes each, r1 with
// its ring of r and r + 1), dx, dy and write 5 products (10 bytes in bf16,
// 20 in f32): ~58-68 bytes.  With warp pass 1 computed once per source row
// the work is ~260 flops a pixel, below the float32 ridge, so the bytes
// bound it.
//
// Design: K4's warp phase (fused_box_update.cu, steps 4–5) without its box
// sum and solve.  One block of 256 threads per (sample, block of R canvas
// rows, 32-column tile):
//  1. the clamped dx of canvas rows Y0-r … Y0+R+r and the clamped dy of the
//     block's rows go to shared memory (clamped indices stand for the
//     edge-extended flow);
//  2. r1's tile (R+2r+1 rows × 32+2r+1 columns × 5 channels) is staged with
//     cp.async; rows and columns past the canvas's edge + r feed no stored
//     pixel and are read clamped, inside the padded buffer;
//  3. warp pass 1 once per (source row, column) into T, kx from -r to r + 1;
//  4. pass 2 down each column at the pixel's dy, ky from -r to r + 1, then
//     build_store.
// In passes 1 and 2 a lane takes 4 adjacent pixels and slides its window
// along them, so it reads each staged value once, not once a tap; each sum
// adds the plain version's products in its order.  R is 32 where the tile,
// T and the flow fit the block's 227 KB of shared memory (radius ≤ 28;
// 64.5 KB at radius 3, three blocks an SM), else 16, 8 or 4: radius 37 is
// the widest that fits, and the launcher refuses a wider one.  The last
// row block and column tile may be ragged (K5 runs on the level's own
// extent): their stores are masked.  K4 keeps its own copy of steps 2–4:
// sharing this code changed its register allocation (PERF.md §6).
//
// Build facts (ptxas -v, sm_90a, --fmad=false): the design before this one
// (one thread a pixel, no shared memory, pass 1 recomputed for each of the
// 2r+2 rows: ~1,000 flops a pixel) used 37 (bf16 M) and 38 (f32 M)
// registers with no stack frame; see PERF.md §6 for this one's.

#include <stdint.h>

#include "farneback_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTX = 32;               // tile columns: one lane a column in pass 2
constexpr int kG = 4;                 // adjacent pixels a lane takes (float4 access)
constexpr int kGroups = kTX / kG;     // pixel groups of a tile row
constexpr int kGRows = 32 / kGroups;  // rows a warp takes at once in pass 1
constexpr int kStageElems = 8;        // elements of a staged row a lane copies at once
constexpr int kMaxSmemFloats = 232448 / 4;  // dynamic shared memory of a block

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Shared-memory plan of a block of `rows` rows, in floats: r1's tile
// [nr][5][nc], T [nr][5][kTX], the clamped dx [nr][kTX] and dy [rows][kTX].
struct Plan {
  int nr, nc, tpass, fdx, fdy, total;
};

__host__ __device__ inline Plan plan(int rows, int radius) {
  Plan p;
  p.nr = rows + 2 * radius + 1;
  p.nc = kTX + 2 * radius + 1;
  p.tpass = round4(p.nr * 5 * p.nc);
  p.fdx = p.tpass + p.nr * 5 * kTX;
  p.fdy = p.fdx + p.nr * kTX;
  p.total = p.fdy + rows * kTX;
  return p;
}

// The rows of a block: the most of 32, 16, 8, 4 that fit; 0 if none does.
inline int block_rows(int radius) {
  for (int rows = 32; rows >= 4; rows /= 2)
    if (plan(rows, radius).total <= kMaxSmemFloats) return rows;
  return 0;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads, 3) update_matrices_sep_kernel(
    const float* __restrict__ dx, const float* __restrict__ dy,
    const float* __restrict__ r0, const float* __restrict__ r1,
    const float* __restrict__ bsc, OutT* __restrict__ out, int hk, int wk,
    int hp, int wp, int mr, int mc, int rows, int radius) {
  extern __shared__ float smem[];
  const Plan p = plan(rows, radius);
  const int b = blockIdx.z;
  const int Y0 = blockIdx.y * rows;
  const int X0 = blockIdx.x * kTX;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float rad = (float)radius;
  float* tile = smem;              // [nr][5][nc]: row i is canvas row Y0 - r + i
  float* tpass = smem + p.tpass;   // [nr][5][kTX]
  float* fdx = smem + p.fdx;       // [nr][kTX]
  float* fdy = smem + p.fdy;       // [rows][kTX]

  // 1. the clamped flow
  {
    const long long flow_plane = (long long)hk * wk;
    const float* dxb = dx + b * flow_plane;
    const float* dyb = dy + b * flow_plane;
    for (int t = threadIdx.x; t < p.nr * kTX; t += kThreads) {
      const int y = min(max(Y0 - radius + t / kTX, 0), hk - 1);
      const int x = min(X0 + t % kTX, wk - 1);
      fdx[t] = nsof::clampf(dxb[(long long)y * wk + x], rad);
    }
    for (int t = threadIdx.x; t < rows * kTX; t += kThreads) {
      const int y = min(Y0 + t / kTX, hk - 1);
      const int x = min(X0 + t % kTX, wk - 1);
      fdy[t] = nsof::clampf(dyb[(long long)y * wk + x], rad);
    }
  }

  // 2. r1's tile: tile row i is canvas row Y0 - r + i, column j canvas
  //    column X0 - r + j; element e of a tile row is channel e / nc, column
  //    e % nc.  Each lane copies elements lane + 32k of its warp's rows.
  {
    const int w1 = wp + 2 * mc;
    const long long plane1 = (long long)(hp + 2 * mr) * w1;
    const float* rb = r1 + (long long)b * 5 * plane1;
    const int row_len = 5 * p.nc;
    for (int e0 = lane; e0 < row_len; e0 += 32 * kStageElems) {
      int off[kStageElems];
#pragma unroll
      for (int k = 0; k < kStageElems; ++k) {
        const int e = min(e0 + 32 * k, row_len - 1);
        const int c = e / p.nc;
        off[k] = c * (int)plane1 + min(X0 - radius + e - c * p.nc, wp + radius) + mc;
      }
      for (int i = warp; i < p.nr; i += kWarps) {
        const float* row = rb + (long long)(min(Y0 - radius + i, hp + radius) + mr) * w1;
        float* d = tile + i * row_len + e0;
#pragma unroll
        for (int k = 0; k < kStageElems; ++k)
          if (e0 + 32 * k < row_len) cp_async4(d + 32 * k, row + off[k]);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
  __syncthreads();

  // 3. pass 1: tile row i at its own dx
  {
    const int tile_len = 5 * p.nc;
    const int x0 = (lane % kGroups) * kG;
    for (int i = warp * kGRows + lane / kGroups; i < p.nr; i += kWarps * kGRows) {
      const float4 d4 = *reinterpret_cast<const float4*>(fdx + i * kTX + x0);
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

  // 4. pass 2 and the build: a lane takes column `lane` and kG adjacent
  //    rows of it, and slides its window of T down them
  const int x = X0 + lane;
  if (x >= wp) return;
  const long long plane = (long long)hp * wp;
  const float* r0b = r0 + (long long)b * 5 * plane;
  OutT* outb = out + (long long)b * 5 * plane;
  for (int j0 = warp * kG; j0 < rows; j0 += kWarps * kG) {
    float dyv[kG], acc[5][kG], win[5][kG], w[kG];
#pragma unroll
    for (int q = 0; q < kG; ++q) {
      dyv[q] = fdy[(j0 + q) * kTX + lane];
      w[q] = nsof::hat(dyv[q], -radius);
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
      for (int q = 0; q < kG; ++q) w[q] = nsof::hat(dyv[q], ky);
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
      if (y >= hp) break;
      const float a[5] = {acc[0][q], acc[1][q], acc[2][q], acc[3][q], acc[4][q]};
      const float sc = bsc[(long long)min(y, hk - 1) * wk + min(x, wk - 1)];
      nsof::build_store(a, r0b, plane, (long long)y * wp + x,
                        fdx[(j0 + q + radius) * kTX + lane], dyv[q], sc, outb);
    }
  }
}

template <typename OutT>
int launch(const void* dx, const void* dy, const void* r0, const void* r1,
           const void* bsc, void* out, int b, int hk, int wk, int hp, int wp,
           int mr, int mc, int radius, void* stream) {
  if (b == 0) return 0;
  const int rows = block_rows(radius);
  // staged offsets within a sample are 32-bit
  const long long plane1 = (long long)(hp + 2 * mr) * (wp + 2 * mc);
  if (rows == 0 || radius < 0 || mr <= radius || mc <= radius || 5 * plane1 >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int bytes = (int)sizeof(float) * plan(rows, radius).total;
  cudaError_t err = cudaFuncSetAttribute(
      update_matrices_sep_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((wp + kTX - 1) / kTX, (hp + rows - 1) / rows, b);
  update_matrices_sep_kernel<OutT><<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
      (const float*)dx, (const float*)dy, (const float*)r0, (const float*)r1,
      (const float*)bsc, (OutT*)out, hk, wk, hp, wp, mr, mc, rows, radius);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int nsof_update_matrices_sep(
    const void* dx, const void* dy, const void* r0, const void* r1,
    const void* bsc, void* out, int b, int hk, int wk, int hp, int wp, int mr,
    int mc, int radius, void* stream) {
  return launch<__nv_bfloat16>(dx, dy, r0, r1, bsc, out, b, hk, wk, hp, wp,
                               mr, mc, radius, stream);
}

extern "C" int nsof_update_matrices_sep_f32(
    const void* dx, const void* dy, const void* r0, const void* r1,
    const void* bsc, void* out, int b, int hk, int wk, int hp, int wp, int mr,
    int mc, int radius, void* stream) {
  return launch<float>(dx, dy, r0, r1, bsc, out, b, hk, wk, hp, wp, mr, mc,
                       radius, stream);
}
