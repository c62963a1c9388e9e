// K1: batched static-size window crop at per-sample origins.
//
// Replaces nsof_tpu/ops/roi.py::crop_windows_batch, the inner Pallas
// `kernel` (one DMA per sample, origins floored to the (32, 128) uint8
// tiling).  Here the origins are exact: a sample's window starts at its
// clamped (oy, ox), as the vmapped dynamic_slice does.
//
// Bound: pure data movement.  Each window byte is read once and written
// once, so the least time is 2 * B * wh * ww * bytes / 3.35 TB/s.
// Design: one block per (sample, band of rows); a block's threads walk the
// band's rows, neighbouring threads on neighbouring bytes, so every warp
// reads and writes whole 32-byte sectors even where the origin leaves the
// source rows unaligned.  Rows are copied as raw bytes, so any element
// type and any trailing channel count is one "element" of `elem_bytes`.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 8;

__global__ void crop_windows_kernel(
    const uint8_t* __restrict__ frames, const int32_t* __restrict__ oys,
    const int32_t* __restrict__ oxs, uint8_t* __restrict__ out,
    int h, int w, int wh, int ww, int elem_bytes) {
  const int b = blockIdx.y;
  int oy = oys[b];
  int ox = oxs[b];
  // dynamic_slice semantics: a negative start counts from the end, then
  // the start is clamped so the window fits
  if (oy < 0) oy += h;
  if (ox < 0) ox += w;
  oy = min(max(oy, 0), h - wh);
  ox = min(max(ox, 0), w - ww);
  const long long row_bytes = (long long)ww * elem_bytes;
  const long long src_stride = (long long)w * elem_bytes;
  const uint8_t* src = frames + ((long long)b * h + oy) * src_stride +
                       (long long)ox * elem_bytes;
  uint8_t* dst = out + (long long)b * wh * row_bytes;
  const int r0 = blockIdx.x * kRowsPerBlock;
  const int r1 = min(r0 + kRowsPerBlock, wh);
  for (int r = r0; r < r1; ++r) {
    const uint8_t* s = src + r * src_stride;
    uint8_t* d = dst + r * row_bytes;
    for (long long c = threadIdx.x; c < row_bytes; c += blockDim.x) {
      d[c] = s[c];
    }
  }
}

}  // namespace

extern "C" int nsof_crop_windows(
    const void* frames, const void* oys, const void* oxs, void* out,
    int b, int h, int w, int wh, int ww, int elem_bytes, void* stream) {
  if (b == 0 || wh == 0 || ww == 0) return 0;
  dim3 grid((wh + kRowsPerBlock - 1) / kRowsPerBlock, b);
  crop_windows_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)frames, (const int32_t*)oys, (const int32_t*)oxs,
      (uint8_t*)out, h, w, wh, ww, elem_bytes);
  return (int)cudaGetLastError();
}
