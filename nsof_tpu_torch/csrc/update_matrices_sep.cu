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
// Bound: per output pixel it must read r0 and r1 (20 bytes each), dx, dy
// and write 5 products (10 bytes in bf16, 20 in f32): ~58-68 bytes.  With
// warp pass 1 computed once per row the work is ~260 flops a pixel, below
// the float32 ridge, so the bytes bound it; this first version recomputes
// pass 1 for each of the 2r+2 output rows (~1,000 flops a pixel).  Design:
// one thread per canvas pixel, no shared memory.  The (2r+2)² r1 taps of
// neighbouring threads overlap, so they come from L1; the flow and border
// scale are read through clamped indices, which realises the edge-padded
// canvas without a pad copy.

#include <stdint.h>

#include "farneback_common.cuh"

namespace {

template <typename OutT>
__global__ void update_matrices_sep_kernel(
    const float* __restrict__ dx, const float* __restrict__ dy,
    const float* __restrict__ r0, const float* __restrict__ r1,
    const float* __restrict__ bsc, OutT* __restrict__ out, int hk, int wk,
    int hp, int wp, int mr, int mc, int radius) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int b = blockIdx.z;
  if (x >= wp || y >= hp) return;
  const float rad = (float)radius;
  const int cx = min(x, wk - 1);
  const int cy = min(y, hk - 1);
  const long long flow_plane = (long long)hk * wk;
  const float* dxb = dx + b * flow_plane;
  const float* dyb = dy + b * flow_plane;
  const float dxc = nsof::clampf(dxb[(long long)cy * wk + cx], rad);
  const float dyc = nsof::clampf(dyb[(long long)cy * wk + cx], rad);
  const int h1 = hp + 2 * mr;
  const int w1 = wp + 2 * mc;
  const long long plane = (long long)hp * wp;
  auto dx_row = [&](int ky) {
    const int yr = min(max(y + ky, 0), hk - 1);
    return nsof::clampf(dxb[(long long)yr * wk + cx], rad);
  };
  nsof::warp_build_store(
      dx_row, dxc, dyc, r1 + (long long)b * 5 * h1 * w1, h1, w1, mr, mc,
      r0 + (long long)b * 5 * plane, plane, (long long)y * wp + x,
      bsc[(long long)cy * wk + cx], y, x, radius,
      out + (long long)b * 5 * plane);
}

template <typename OutT>
int launch(const void* dx, const void* dy, const void* r0, const void* r1,
           const void* bsc, void* out, int b, int hk, int wk, int hp, int wp,
           int mr, int mc, int radius, void* stream) {
  if (b == 0) return 0;
  dim3 block(32, 8);
  dim3 grid((wp + 31) / 32, (hp + 7) / 8, b);
  update_matrices_sep_kernel<OutT><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)dx, (const float*)dy, (const float*)r0, (const float*)r1,
      (const float*)bsc, (OutT*)out, hk, wk, hp, wp, mr, mc, radius);
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
