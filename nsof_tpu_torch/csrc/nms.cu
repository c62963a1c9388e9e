// K9: batched greedy non-maximum suppression.
//
// Not a TPU kernel: it replaces the XLA program of
// nsof_tpu/ops/components.py::nms (a fori_loop of N steps, vmapped over the
// batch by nsof_tpu/models/yolov8.py::postprocess), which the JAX package
// compiles into one program.  Eager PyTorch runs the same loop as N steps of
// ~15 launches each (nsof_tpu_torch/ops/components.py::nms, the plain
// version): 4,500 launches for YOLO's 300 candidates.
//
// Per batch row, with alive = valid and keep = false, N times: pick i, the
// first index of the largest of (alive ? score : -inf), NaN counting as the
// largest (torch.argmax); if anything is alive, keep[i] = true and clear
// alive for i and every box whose IoU with box i is > thresh.  IoU with
// one = plus_one ? 1 : 0, each operation rounded once and in the plain
// version's order (built with --fmad=false): ww = clamp((min(x2i, x2) -
// max(x1i, x1)) + one, 0), hh alike, inter = ww * hh, area = ((y2 - y1) +
// one) * ((x2 - x1) + one), iou = inter / ((area_i + area) - inter).
// min, max and the clamp pass NaN through, as torch.minimum, maximum and
// clamp do.  The class offset of the YOLO post step (7680 px a class) puts
// coordinates near 6e5; they are used as given, never shifted.
//
// Bound: the bytes (N boxes and scores in, N flags out) and operations
// are tiny; what bounds it is the dependent chain of N steps, each a block
// argmax (two warp shuffle trees and two barriers) and one IoU a thread.
// Design: one block per batch row, one thread per box up to 1024 (a
// strided loop beyond), the alive flags in the [B, N] scratch the wrapper
// gives (a row's flags stay in L1 at YOLO's 300 boxes, and any N fits), the
// boxes and scores read through the read-only cache.  The loop ends early
// once nothing is alive: the plain loop changes nothing after that.

#include <math.h>
#include <stdint.h>

#include <cuda_runtime.h>

namespace {

constexpr int MAX_THREADS = 1024;

// torch.argmax's order: NaN above everything, then larger, then the lower
// index of equal values
__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  const bool na = isnan(a), nb = isnan(b);
  if (na != nb) return na;
  if (!na && a != b) return a > b;
  return ia < ib;
}

// torch.minimum / maximum: NaN if either is NaN
__device__ __forceinline__ float nan_min(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : fminf(a, b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : fmaxf(a, b);
}
// Tensor.clamp(min=0): NaN kept; a compare, so -0.0 stays -0.0 as in ATen
__device__ __forceinline__ float clamp0(float x) { return x < 0.0f ? 0.0f : x; }

__device__ __forceinline__ float box_area(const float4 b, float one) {
  return ((b.w - b.y) + one) * ((b.z - b.x) + one);
}

__global__ void nms_kernel(const float4* __restrict__ boxes,
                           const float* __restrict__ scores,
                           const uint8_t* __restrict__ valid,
                           uint8_t* __restrict__ keep,
                           uint8_t* __restrict__ alive, int n,
                           float iou_thresh, float one) {
  __shared__ float red_val[MAX_THREADS / 32];
  __shared__ int red_idx[MAX_THREADS / 32];
  __shared__ int pick_idx;

  const size_t row = blockIdx.x;
  boxes += row * n;
  scores += row * n;
  valid += row * n;
  keep += row * n;
  alive += row * n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;

  for (int i = tid; i < n; i += blockDim.x) {
    alive[i] = valid[i] != 0;
    keep[i] = 0;
  }
  __syncthreads();

  for (int step = 0; step < n; ++step) {
    // argmax of (alive ? score : -inf) over the row
    float best = -INFINITY;
    int best_i = n;
    int any = 0;
    for (int i = tid; i < n; i += blockDim.x) {
      const bool a = alive[i] != 0;
      any |= a;
      const float v = a ? __ldg(scores + i) : -INFINITY;
      if (better(v, i, best, best_i)) {
        best = v;
        best_i = i;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float v = __shfl_down_sync(0xffffffffu, best, off);
      const int vi = __shfl_down_sync(0xffffffffu, best_i, off);
      if (better(v, vi, best, best_i)) {
        best = v;
        best_i = vi;
      }
    }
    if (lane == 0) {
      red_val[warp] = best;
      red_idx[warp] = best_i;
    }
    any = __syncthreads_or(any);
    if (!any) break;  // nothing alive: every later step changes nothing
    if (warp == 0) {
      best = lane < n_warps ? red_val[lane] : -INFINITY;
      best_i = lane < n_warps ? red_idx[lane] : n;
      for (int off = 16; off > 0; off >>= 1) {
        const float v = __shfl_down_sync(0xffffffffu, best, off);
        const int vi = __shfl_down_sync(0xffffffffu, best_i, off);
        if (better(v, vi, best, best_i)) {
          best = v;
          best_i = vi;
        }
      }
      if (lane == 0) {
        pick_idx = best_i;
        keep[best_i] = 1;
      }
    }
    __syncthreads();
    const int p = pick_idx;
    const float4 bp = __ldg(boxes + p);
    const float area_p = box_area(bp, one);
    for (int i = tid; i < n; i += blockDim.x) {
      if (!alive[i]) continue;
      const float4 b = __ldg(boxes + i);
      const float ww = clamp0((nan_min(bp.z, b.z) - nan_max(bp.x, b.x)) + one);
      const float hh = clamp0((nan_min(bp.w, b.w) - nan_max(bp.y, b.y)) + one);
      const float inter = ww * hh;
      const float iou = inter / ((area_p + box_area(b, one)) - inter);
      if (iou > iou_thresh || i == p) alive[i] = 0;
    }
    __syncthreads();
  }
}

}  // namespace

// boxes [B, N, 4] float32, scores [B, N] float32, valid [B, N] bool →
// keep [B, N] bool; alive_scratch [B, N] bytes, the alive flags.  Returns
// cudaError_t.
extern "C" int nsof_nms(const void* boxes, const void* scores, const void* valid,
                        void* keep, void* alive_scratch, int b, int n,
                        int plus_one, float iou_thresh, void* stream) {
  if (b == 0 || n == 0) return 0;
  if (b < 0 || n < 0) return (int)cudaErrorInvalidValue;
  if (alive_scratch == nullptr) return (int)cudaErrorInvalidValue;
  int threads = ((n + 31) / 32) * 32;
  threads = threads > MAX_THREADS ? MAX_THREADS : threads;
  nms_kernel<<<b, threads, 0, (cudaStream_t)stream>>>(
      (const float4*)boxes, (const float*)scores, (const uint8_t*)valid,
      (uint8_t*)keep, (uint8_t*)alive_scratch, n, iou_thresh,
      plus_one ? 1.0f : 0.0f);
  return (int)cudaGetLastError();
}
