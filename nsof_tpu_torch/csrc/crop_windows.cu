// K1: batched static-size window crop at per-sample origins.
//
// Replaces nsof_tpu/ops/roi.py::crop_windows_batch, the inner Pallas
// `kernel` (one DMA per sample, origins floored to the (32, 128) uint8
// tiling).  Here the origins are exact: a sample's window starts at its
// clamped (oy, ox), as the vmapped dynamic_slice does.
//
// Bound: pure data movement.  Each window byte is read once and written
// once, so the least time is 2 * B * wh * ww * bytes / 3.35 TB/s.
// Design: one block per (sample, band of 32 rows); each thread moves 16
// bytes at a time and has up to four such moves in flight.  A destination
// row is written with aligned 16-byte stores.  Its source bytes start at
// any alignment (the origin is exact), so they are read as the one or two
// aligned 16-byte words that hold them and shifted into place with funnel
// shifts.  Where a destination row does not start on a 16-byte boundary
// (rows whose byte length is not a multiple of 16), the bytes before the
// first boundary and after the last whole 16-byte chunk are copied one by
// one.  Rows are raw bytes, so any element type and any trailing channel
// count is one "element" of `elem_bytes`.
//
// Build facts (ptxas -v, sm_90a): 46 registers, no stack frame, no spills
// (the byte-a-thread design before it: 22 registers); nvcc takes ≈ 3.3 s
// for this source on the H100's host (PERF.md §6).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 32;  // window rows a block copies
constexpr int kThreads = 256;
constexpr int kInFlight = 4;  // 16-byte moves a thread issues before storing

// The 16 bytes at s, any alignment: the aligned word that holds s[0] and,
// unless s is aligned, the next one, shifted right by s's misalignment.
// Both words hold bytes of the source row, so neither leaves its buffer.
__device__ __forceinline__ uint4 load16(const uint8_t* s) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(s);
  const int sh = (int)(a & 15);
  const uint4* p = reinterpret_cast<const uint4*>(a - sh);
  const uint4 lo = __ldg(p);
  if (sh == 0) return lo;
  const uint4 hi = __ldg(p + 1);
  const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const int q = sh >> 2;
  uint32_t v[5];
#pragma unroll
  for (int i = 0; i < 5; ++i)
    v[i] = q == 0 ? w[i] : q == 1 ? w[i + 1] : q == 2 ? w[i + 2] : w[i + 3];
  const unsigned bits = 8u * (unsigned)(sh & 3);
  return make_uint4(__funnelshift_r(v[0], v[1], bits), __funnelshift_r(v[1], v[2], bits),
                    __funnelshift_r(v[2], v[3], bits), __funnelshift_r(v[3], v[4], bits));
}

// Bytes of a destination row before its first 16-byte boundary.
__device__ __forceinline__ int head_bytes(const uint8_t* d, long long row_bytes) {
  const int head = (int)((16 - (reinterpret_cast<uintptr_t>(d) & 15)) & 15);
  return head < row_bytes ? head : (int)row_bytes;
}

__global__ void __launch_bounds__(kThreads) crop_windows_kernel(
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
  const int r0 = blockIdx.x * kRows;
  const int nr = min(kRows, wh - r0);

  // whole 16-byte chunks: a row has at most row_bytes / 16 of them
  const int per_row = (int)(row_bytes / 16);
  const int n = nr * per_row;
  for (int base = threadIdx.x; base < n; base += kThreads * kInFlight) {
    uint4 v[kInFlight];
    uint8_t* d[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int idx = base + u * kThreads;
      d[u] = nullptr;
      if (idx >= n) continue;
      const int r = r0 + idx / per_row;
      const int k = idx % per_row;
      uint8_t* drow = dst + r * row_bytes;
      const int head = head_bytes(drow, row_bytes);
      if (k >= (int)((row_bytes - head) / 16)) continue;
      const long long off = head + 16LL * k;
      d[u] = drow + off;
      v[u] = load16(src + r * src_stride + off);
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u)
      if (d[u]) *reinterpret_cast<uint4*>(d[u]) = v[u];
  }

  // the ragged ends, byte by byte: up to 15 bytes before a row's first
  // 16-byte boundary and up to 15 after its last whole chunk
  if (row_bytes % 16 == 0 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) return;
  for (int idx = threadIdx.x; idx < nr * 32; idx += kThreads) {
    const int r = r0 + (idx >> 5);
    const int t = idx & 31;
    uint8_t* drow = dst + r * row_bytes;
    const int head = head_bytes(drow, row_bytes);
    const long long body = (row_bytes - head) / 16 * 16;
    long long off = -1;
    if (t < 16) {
      if (t < head) off = t;
    } else if (head + body + (t - 16) < row_bytes) {
      off = head + body + (t - 16);
    }
    if (off >= 0) drow[off] = src[r * src_stride + off];
  }
}

}  // namespace

extern "C" int nsof_crop_windows(
    const void* frames, const void* oys, const void* oxs, void* out,
    int b, int h, int w, int wh, int ww, int elem_bytes, void* stream) {
  if (b == 0 || wh == 0 || ww == 0) return 0;
  dim3 grid((wh + kRows - 1) / kRows, b);
  crop_windows_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)frames, (const int32_t*)oys, (const int32_t*)oxs,
      (uint8_t*)out, h, w, wh, ww, elem_bytes);
  return (int)cudaGetLastError();
}
