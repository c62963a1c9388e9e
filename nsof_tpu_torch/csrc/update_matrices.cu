// K7: a Farnebäck system from the non-separable warp.
//
// Replaces nsof_tpu/ops/farneback_fast.py::_update_matrices_kernel (driver
// update_matrices_pallas(separable=False), the update of
// kernel_mode='pallas'): clamp the flow to ±r, sample r1 bilinearly at
// (x + dx, y + dy), build r2…r6, scale by the border table and store the
// five products in float32.  The function is the plain version's
// (ops/farneback_fast.py::_warp_full, bit for bit update_matrices_fast):
// the sum of r1's (2r+2)² taps, ky in [-r, r + 1] outer, kx inner, each
// added as acc[c] + tap·(wy·wx) from acc = 0, with wy = hat(dy, ky) =
// max(0, 1 - |dy - ky|) and wx alike.
//
// Why four taps give that sum bit for bit: for the clamped d, hat(d, k) is
// non-zero only for k = floor(d) and floor(d) + 1.  For every other k the
// exact |d - k| is ≥ 1, and since 1 is representable and rounding is
// monotone the rounded |d - k| is ≥ 1 too, so the weight is 0 and the
// product ±0 (r1 finite).  acc starts at +0 and a round-to-nearest sum is
// -0 only when both terms are, so acc is never -0, and acc + (±0) = acc.
// Dropping those terms leaves the four taps (ky0, kx0), (ky0, kx0 + 1),
// (ky0 + 1, kx0), (ky0 + 1, kx0 + 1), ky0 = floor(dy), kx0 = floor(dx),
// added in that order from acc = 0, each weight computed as before.  The
// sum keeps its 0 + first product (not acc = first product): it turns a -0
// product into +0 as the full sum does.  Built with --fmad=false, as every
// kernel here, so each product and sum rounds once.
//
// Bound: per pixel it reads dx, dy (8 bytes), r0 (20), r1's four taps (20
// bytes a pixel when neighbouring pixels share their lines) and the border
// scale (shared by the batch), and writes M (20): ~68 bytes, ~5.6 GB for
// B = 128 at 801×801, 1.68 ms at 3.35 TB/s.  The work is ~100 operations a
// pixel whatever the radius (4 hat weights, 4 weight products, 4 taps × 5
// products and sums, the build), far below the float32 ridge: the bytes
// bound it.  The previous design summed all (2r+2)² taps in every thread
// (~1,400 instructions and 320 loads a pixel at r = 3) and was bound by
// instruction issue and L1 load throughput at 5× the byte bound.
//
// Design: one thread per output pixel, a block of 32 columns × kRows rows,
// so that a warp covers 32 consecutive columns of one row: its dx, dy, r0
// and border-scale loads and its M stores are whole 128-byte lines, and its
// r1 gathers touch about two neighbouring lines a tap row.  Row ky0 + 1 of
// one warp is row ky0 of the next row's warp, so the block's warps share r1
// lines in L1.  Of 4, 8 and 16 block rows, 16 was the fastest, by ≤ 2 %
// (nsof_tpu_torch/time_k7.py; PERF.md §6).  Loads go through the read-only
// path.  r1 comes edge-padded by pad ≥ r + 1 on every side (one pad per
// pyramid level, shared by every update of the level): ky0, kx0 lie in
// [-r, r], so the taps need no clamping, and the kernel takes any radius.

#include <stdint.h>

#include "farneback_common.cuh"

namespace {

constexpr int kRows = 16;  // block rows; a block is 32 × kRows threads

__global__ void __launch_bounds__(32 * kRows) update_matrices_kernel(
    const float* __restrict__ dx, const float* __restrict__ dy,
    const float* __restrict__ r0, const float* __restrict__ r1p,
    const float* __restrict__ bsc, float* __restrict__ out, int h, int w,
    int pad, int radius) {
  const int x = blockIdx.x * 32 + threadIdx.x;
  const int y = blockIdx.y * kRows + threadIdx.y;
  const int b = blockIdx.z;
  if (x >= w || y >= h) return;
  const float rad = (float)radius;
  const long long plane = (long long)h * w;
  const long long pix = (long long)y * w + x;
  const float dxc = nsof::clampf(__ldg(dx + b * plane + pix), rad);
  const float dyc = nsof::clampf(__ldg(dy + b * plane + pix), rad);
  const int ky0 = (int)floorf(dyc);
  const int kx0 = (int)floorf(dxc);
  const float wy0 = nsof::hat(dyc, ky0), wy1 = nsof::hat(dyc, ky0 + 1);
  const float wx0 = nsof::hat(dxc, kx0), wx1 = nsof::hat(dxc, kx0 + 1);
  const float wgt[4] = {wy0 * wx0, wy0 * wx1, wy1 * wx0, wy1 * wx1};
  const int w1 = w + 2 * pad;
  const long long plane1 = (long long)(h + 2 * pad) * w1;
  const float* tap = r1p + (long long)b * 5 * plane1 +
                     (long long)(y + ky0 + pad) * w1 + (x + kx0 + pad);
  const long long off[4] = {0, 1, w1, w1 + 1};
  float acc[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    acc[c] = 0.0f;
#pragma unroll
    for (int t = 0; t < 4; ++t)
      acc[c] = acc[c] + __ldg(tap + c * plane1 + off[t]) * wgt[t];
  }
  nsof::build_store(acc, r0 + (long long)b * 5 * plane, plane, pix, dxc, dyc,
                    __ldg(bsc + pix), out + (long long)b * 5 * plane);
}

}  // namespace

extern "C" int nsof_update_matrices(const void* dx, const void* dy,
                                    const void* r0, const void* r1p,
                                    const void* bsc, void* out, int b, int h,
                                    int w, int pad, int radius, void* stream) {
  if (b == 0) return 0;
  if (pad < radius + 1) return (int)cudaErrorInvalidValue;
  dim3 block(32, kRows);
  dim3 grid((w + 31) / 32, (h + kRows - 1) / kRows, b);
  update_matrices_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)dx, (const float*)dy, (const float*)r0, (const float*)r1p,
      (const float*)bsc, (float*)out, h, w, pad, radius);
  return (int)cudaGetLastError();
}
