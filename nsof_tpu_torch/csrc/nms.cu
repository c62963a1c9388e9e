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
// are tiny; what bounds the greedy loop is its dependent chain of steps.
// Design: one block per batch row, the loop taken apart so that neither the
// argmax nor the IoUs lie on the chain:
// 1. Order.  Each valid box gets its rank in torch.argmax's order (NaN
//    first, then larger score, then lower index) by counting the valid
//    boxes ahead of it, on 64-bit keys in shared memory.  While no valid
//    score is -inf, the plain loop's pick is always the first alive box in
//    that order, and the boxes ahead of it are dead.
// 2. The suppression mask.  For ranks r < q, bit q of row r is set when
//    IoU(box r, box q) > thresh, box r as the pick; one thread a (row,
//    32-bit word), all in parallel; a pair that does not overlap is
//    decided without the division's slow path.  The mask lives in shared
//    memory where it fits (N up to ≈ 1,200 on the H100), else in the
//    wrapper's scratch; the boxes, keys and flags likewise (a kernel
//    instance per placement, so that shared arrays are read as shared
//    memory).
// 3. The walk.  One warp: for each word, the next rank not removed is kept
//    (__ffs), and its mask row is ORed into the removed bits, the current
//    word's through the row itself (a broadcast shared load), each later
//    word's by one lane into a register.  A step is a shared load and a
//    find-first-set: no barrier and no IoU on the chain, and only kept
//    boxes and one visit a word are serial.
// A row with a valid -inf score runs the greedy loop itself (a block
// argmax a step, the alive flags in the arena): there the plain loop's
// argmax can pick a dead box (every dead box ties the -inf score and the
// lowest index wins) and keep it, which the walk does not reproduce.  The
// kernel finds such a row with one block-wide OR; YOLO's scores (≥ conf)
// and the tracking head's areas never take it.

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

// the same order as one unsigned key, larger first: the score's bits made
// monotone (every NaN the largest, -0 as +0), then the complemented index
__device__ __forceinline__ unsigned long long rank_key(float s, int i) {
  unsigned u = 0xFFFFFFFFu;
  if (!isnan(s)) {
    u = __float_as_uint(s == 0.0f ? 0.0f : s);
    u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  }
  return ((unsigned long long)u << 32) | (unsigned)~(unsigned)i;
}

// torch.minimum / maximum: NaN if either is NaN
__device__ __forceinline__ float nan_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
// Tensor.clamp(min=0) of (a - b) + one: NaN kept.  ATen's compare keeps a
// -0.0, which max would make +0.0, but a sum (a - b) + one is never -0.0
// when one is +0.0 or 1 (an exact zero sum rounds to +0.0)
__device__ __forceinline__ float clamp0(float x) { return nan_max(x, 0.0f); }

__device__ __forceinline__ float box_area(const float4 b, float one) {
  return ((b.w - b.y) + one) * ((b.z - b.x) + one);
}

// the plain version's IoU > thresh, bp the pick.  Boxes that do not
// overlap give inter = ±0, and ±0 / den is ±0 (NaN for a zero or NaN den),
// which is decided without that division: its slow path takes a zero
// dividend, so such a lane divides 1 by 1 instead, and no lane branches.
__device__ __forceinline__ bool suppresses(const float4 bp, float area_p, const float4 b,
                                           float area, float one, float iou_thresh) {
  const float ww = clamp0((nan_min(bp.z, b.z) - nan_max(bp.x, b.x)) + one);
  const float hh = clamp0((nan_min(bp.w, b.w) - nan_max(bp.y, b.y)) + one);
  const float inter = ww * hh;
  const float den = (area_p + area) - inter;
  const bool none = inter == 0.0f;
  const bool over = (none ? 1.0f : inter) / (none ? 1.0f : den) > iou_thresh;
  return none ? den == den && den != 0.0f && 0.0f > iou_thresh : over;
}

// A row's arena: byte offsets of its arrays, each 16-byte aligned.  Where
// it lies is a kernel's template argument: all of it in shared memory, all
// but the mask (which then takes the row's part of the wrapper's scratch),
// or none of it (the row's part of the scratch holds the whole arena).
enum Placement { ARENA_SHARED, MASK_GLOBAL, ARENA_GLOBAL };

struct Layout {
  size_t key, box, area, order, removed, kept, alive, mask, total;
};

__host__ __device__ __forceinline__ size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

__host__ __device__ __forceinline__ Layout layout(int n) {
  const size_t nn = (size_t)n, words = (nn + 31) / 32;
  Layout l;
  size_t o = 0;
  l.key = o;      o = align16(o + 8 * nn);
  l.box = o;      o = align16(o + 16 * nn);
  l.area = o;     o = align16(o + 4 * nn);
  l.order = o;    o = align16(o + 4 * nn);
  l.removed = o;  o = align16(o + 4 * words);
  l.kept = o;     o = align16(o + 4 * words);
  l.alive = o;    o = align16(o + nn);
  l.mask = o;     o = align16(o + 4 * words * nn);
  l.total = o;
  return l;
}

// The plain loop itself, for a row with a valid -inf score: N steps of a
// block argmax of (alive ? score : -inf) and one IoU a thread.
__device__ void greedy_row(const float4* __restrict__ boxes, const float* __restrict__ scores,
                           const uint8_t* __restrict__ valid, uint8_t* __restrict__ keep,
                           uint8_t* alive, int n, float iou_thresh, float one) {
  __shared__ float red_val[MAX_THREADS / 32];
  __shared__ int red_idx[MAX_THREADS / 32];
  __shared__ int pick_idx;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;

  for (int i = tid; i < n; i += blockDim.x) alive[i] = valid[i] != 0;
  __syncthreads();
  for (int step = 0; step < n; ++step) {
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
      if (suppresses(bp, area_p, b, box_area(b, one), one, iou_thresh) || i == p) alive[i] = 0;
    }
    __syncthreads();
  }
}

template <int PLACE>
__global__ void __launch_bounds__(MAX_THREADS)
nms_kernel(const float4* __restrict__ boxes, const float* __restrict__ scores,
           const uint8_t* __restrict__ valid, uint8_t* __restrict__ keep,
           uint8_t* __restrict__ scratch, int n, float iou_thresh, float one) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int n_valid;

  const size_t row = blockIdx.x;
  boxes += row * n;
  scores += row * n;
  valid += row * n;
  keep += row * n;
  const Layout L = layout(n);
  // fixed at compile time, so that shared arrays are read as shared memory
  uint8_t* grow = scratch + row * (PLACE == ARENA_SHARED ? 0
                                   : PLACE == MASK_GLOBAL ? L.total - L.mask : L.total);
  uint8_t* base = PLACE == ARENA_GLOBAL ? grow : smem;
  unsigned long long* key = (unsigned long long*)(base + L.key);
  float4* sbox = (float4*)(base + L.box);
  float* sarea = (float*)(base + L.area);
  int* order = (int*)(base + L.order);
  unsigned* removed = (unsigned*)(base + L.removed);
  unsigned* kept = (unsigned*)(base + L.kept);
  unsigned* mask = (unsigned*)(PLACE == MASK_GLOBAL ? grow : base + L.mask);
  const int words = (n + 31) / 32;
  const int tid = threadIdx.x, lane = tid & 31;

  // keys, cleared flags, the valid count and whether a valid score is -inf
  if (tid == 0) n_valid = 0;
  __syncthreads();
  int ninf = 0, cnt = 0;
  for (int i = tid; i < n; i += blockDim.x) {
    const bool v = valid[i] != 0;
    const float s = __ldg(scores + i);
    keep[i] = 0;
    key[i] = v ? rank_key(s, i) : 0ull;
    ninf |= v && s == -INFINITY;
    cnt += v;
  }
  for (int x = tid; x < words; x += blockDim.x) {
    removed[x] = 0;
    kept[x] = 0;
  }
  if (cnt) atomicAdd(&n_valid, cnt);
  if (__syncthreads_or(ninf)) {
    greedy_row(boxes, scores, valid, keep, base + L.alive, n, iou_thresh, one);
    return;
  }
  const int nv = n_valid;

  // 1. order: a valid box's rank is the count of valid keys above its own
  //    (an invalid key is 0, below every valid one)
  for (int i = tid; i < n; i += blockDim.x) {
    const unsigned long long ki = key[i];
    if (ki == 0ull) continue;
    int r = 0;
    for (int j = 0; j < n; ++j) r += key[j] > ki;
    const float4 b = __ldg(boxes + i);
    order[r] = i;
    sbox[r] = b;
    sarea[r] = box_area(b, one);
  }
  __syncthreads();

  // 2. the suppression mask: rows r, words x ≥ r / 32, bits q > r; a warp's
  //    threads share x, so box q is one broadcast read
  const int vwords = (nv + 31) / 32;
  for (int k = tid; k < nv * vwords; k += blockDim.x) {
    const int x = k / nv, r = k - x * nv;
    if ((r >> 5) > x) continue;
    const float4 bp = sbox[r];
    const float area_p = sarea[r];
    unsigned bits = 0;
    const int q_end = min(32 * x + 32, nv);
    for (int q = max(32 * x, r + 1); q < q_end; ++q)
      bits |= (unsigned)suppresses(bp, area_p, sbox[q], sarea[q], one, iou_thresh)
              << (q & 31);
    mask[(size_t)r * words + x] = bits;
  }
  __syncthreads();

  // 3. the walk, one warp, 32 words at a time: lane l holds word 32g + l's
  //    removed bits in a register; words of later groups gather in
  //    `removed`, each written and read by one lane
  if (tid < 32) {
    for (int g = 0; 32 * g < vwords; ++g) {
      const int y = 32 * g + lane;
      unsigned rem = y < vwords ? removed[y] : 0u;
      for (int x = 32 * g; x < vwords && x < 32 * g + 32; ++x) {
        const unsigned live = (x == vwords - 1 && (nv & 31)) ? (1u << (nv & 31)) - 1 : ~0u;
        unsigned cur = ~__shfl_sync(0xffffffffu, rem, x & 31) & live;
        unsigned kw = 0;
        while (cur) {
          const int bit = __ffs(cur) - 1;
          const unsigned* mrow = mask + (size_t)(32 * x + bit) * words;
          kw |= 1u << bit;
          cur &= ~mrow[x] & ~((2u << bit) - 1u);  // (2u << 31) - 1 is every bit
          if (y > x && y < vwords) rem |= mrow[y];
          for (int z = y + 32; z < vwords; z += 32) removed[z] |= mrow[z];
        }
        if (lane == 0) kept[x] = kw;
      }
    }
  }
  __syncthreads();

  // the keep mask in the input's order
  for (int r = tid; r < nv; r += blockDim.x)
    if ((kept[r >> 5] >> (r & 31)) & 1u) keep[order[r]] = 1;
}

// What a launch needs of the device, read once per device: the dynamic
// shared memory a block may have (the opt-in limit less the kernel's static
// shared memory) and what each placement's kernel has been granted.
struct DeviceLimits {
  bool known = false;
  size_t cap = 0, granted[3] = {0, 0, 0};
};
constexpr int MAX_DEVICES = 64;
DeviceLimits limits[MAX_DEVICES];

int device_limits(DeviceLimits** out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  DeviceLimits& l = limits[dev];
  if (!l.known) {
    int optin = 0;
    cudaFuncAttributes attr;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, nms_kernel<ARENA_SHARED>);
    if (err != cudaSuccess) return (int)err;
    l.cap = (size_t)optin - attr.sharedSizeBytes;
    l.known = true;
  }
  *out = &l;
  return 0;
}

// Where a row's arena goes, and its bytes in shared memory and in scratch.
struct Plan {
  int place;
  size_t shared, global;
};

Plan plan(int n, size_t cap) {
  const Layout l = layout(n);
  if (l.total <= cap) return {ARENA_SHARED, l.total, 0};
  if (l.mask <= cap) return {MASK_GLOBAL, l.mask, l.total - l.mask};
  return {ARENA_GLOBAL, 0, l.total};
}

}  // namespace

// The bytes of scratch nsof_nms needs for b rows of n boxes (0 when a row's
// arena fits in shared memory), or -1 on a CUDA error.
extern "C" long long nsof_nms_scratch_bytes(int b, int n) {
  if (b <= 0 || n <= 0) return 0;
  DeviceLimits* lim = nullptr;
  if (device_limits(&lim) != 0) return -1;
  return (long long)b * (long long)plan(n, lim->cap).global;
}

// boxes [B, N, 4] float32 (16-byte aligned), scores [B, N] float32, valid
// [B, N] bool → keep [B, N] bool; scratch holds nsof_nms_scratch_bytes(B,
// N) bytes (null when that is 0).  Returns cudaError_t.
extern "C" int nsof_nms(const void* boxes, const void* scores, const void* valid,
                        void* keep, void* scratch, int b, int n,
                        int plus_one, float iou_thresh, void* stream) {
  if (b == 0 || n == 0) return 0;
  if (b < 0 || n < 0) return (int)cudaErrorInvalidValue;
  DeviceLimits* lim = nullptr;
  const int err = device_limits(&lim);
  if (err != 0) return err;
  const Plan pl = plan(n, lim->cap);
  if (pl.global > 0 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  void (*kernel)(const float4*, const float*, const uint8_t*, uint8_t*, uint8_t*, int, float,
                 float) = pl.place == ARENA_SHARED ? nms_kernel<ARENA_SHARED>
                          : pl.place == MASK_GLOBAL ? nms_kernel<MASK_GLOBAL>
                                                    : nms_kernel<ARENA_GLOBAL>;
  if (pl.shared > lim->granted[pl.place]) {  // beyond 48 KB a kernel must be granted it
    const cudaError_t set = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.shared);
    if (set != cudaSuccess) return (int)set;
    lim->granted[pl.place] = pl.shared;
  }
  int threads = ((n + 31) / 32) * 32 * 4;
  threads = threads > MAX_THREADS ? MAX_THREADS : threads;
  kernel<<<b, threads, pl.shared, (cudaStream_t)stream>>>(
      (const float4*)boxes, (const float*)scores, (const uint8_t*)valid, (uint8_t*)keep,
      (uint8_t*)scratch, n, iou_thresh, plus_one ? 1.0f : 0.0f);
  return (int)cudaGetLastError();
}
