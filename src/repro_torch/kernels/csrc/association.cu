// Batched greedy track <-> detection assignment, one CTA per frame.
//
// Replaces the JAX package's kernels/association.py:greedy_assign_pallas
// (_assoc_kernel, _plane_cost, _greedy_body).  Per frame:
//   cost[i, j] = IoU(track i, detection j) where both slots are live and
//                the classes agree, else -1;
//   then at most min(T, D) steps: take the largest cost, lowest flat index
//   i * D + j among equal maxima (the reference's row-major argmax; NaN
//   counts as the largest value, as jnp.argmax and torch.argmax have
//   it), stop if it is not >= iou_thr (so a NaN stops the frame), else
//   commit match[i] = j and retire row i and column j (set to -1).
// match[b, i] is the committed detection index or -1.
//
// Bound on the card: a frame reads T + D boxes and writes T ints (~2.7
// ns at the engine's B=4, T=64, D=32); what it takes is the chain of
// up to min(T, D) dependent argmax steps, so the design shortens a step.
//
// Design.  All threads build the (T, D) cost in shared memory and with
// it a row-best cache, each row's first maximum as an order key (below)
// and its column: G lanes a row (G = 16 at T = 64), each lane a strided
// share of the columns, then a shuffle argmax over the G lanes.  After
// one barrier a single warp runs the whole greedy loop with no block
// barrier; lane l owns rows l, l + 32, ... and keeps their cache entries
// in registers (up to 128 rows; shared memory above).  A step is
//   - a warp argmax over the cached row bests: the largest key, then the
//     lowest row among equal keys (two redux.sync), the column from the
//     winner's lane (a shuffle);
//   - commit (i, j), write -1 over row i and column j, as the reference;
//   - recompute the rows whose cached best column was j and whose cached
//     best is >= iou_thr (a ballot finds them; rare): lane k reads
//     columns k, k+32, ... of such a row, then two redux.sync.  Row i's
//     best becomes (-1, column 0).
// That is exact for any iou_thr.  A row's first maximum can change only
// where its best column is retired, since retiring writes -1 and no cost
// is below -1 (an IoU is >= 0 or NaN, and a frame that holds a NaN
// commits nothing, so no step ever sees one after the first).  A row
// whose cached best is below iou_thr is left stale: costs only fall, so
// its true best is below iou_thr too, and it can neither win a step nor
// hide one (a winner is >= iou_thr, above every stale value).  At the
// engine's 0.3 that spares the rows of tracks that overlap nothing,
// which share their first zero's column.
// The cost's row stride is D | 1 (odd), so the column retire hits 32
// banks.  IoU is common.cuh's box_iou (the reference's operation order,
// IEEE division, no contracted multiply-add, NaN carried).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kCostLimit = 48 * 1024;  // bytes of a (T, D) float cost

// A cost as a key whose unsigned order is the reference's argmax order:
// NaN above every number, -0.0 equal to 0.0, otherwise the float order.
// No cost maps to 0 (-inf maps to 0x007fffff): 0 is "no row".
__device__ __forceinline__ uint32_t order_key(float v) {
  if (isnan(v)) return 0xffffffffu;
  if (v == 0.0f) v = 0.0f;  // -0.0 ties 0.0
  const uint32_t b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// the cost an order key stands for (NaN for NaN's key)
__device__ __forceinline__ float key_value(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// The first maximum of one row (n entries at stride 1), the whole warp
// reading it: key and column, the same in every lane.
__device__ __forceinline__ void row_best(const float* row, int n, int lane,
                                         uint32_t& key, int& col) {
  uint32_t bk = 0;
  int bj = n;
  for (int k = lane; k < n; k += 32) {
    const uint32_t v = order_key(row[k]);
    if (v > bk) {  // ascending k: this lane's first maximum
      bk = v;
      bj = k;
    }
  }
  key = __reduce_max_sync(kFull, bk);
  col = __reduce_min_sync(kFull, bk == key ? bj : n);
}

// The row-best cache of a lane's rows lane + 32 m, m < rows(T): in
// registers for RPL > 0 (T <= 32 RPL), else in shared memory.
template <int RPL>
struct RowCache {
  uint32_t key_[RPL];
  int col_[RPL];
  __device__ __forceinline__ RowCache(const uint32_t* key, const int* col,
                                      int T, int lane) {
#pragma unroll
    for (int m = 0; m < RPL; ++m) {
      const int r = lane + 32 * m;
      key_[m] = r < T ? key[r] : 0u;
      col_[m] = r < T ? col[r] : -1;
    }
  }
  __device__ __forceinline__ int rows(int) const { return RPL; }
  __device__ __forceinline__ uint32_t& key(int m) { return key_[m]; }
  __device__ __forceinline__ int& col(int m) { return col_[m]; }
};

template <>
struct RowCache<0> {
  uint32_t* key_;
  int* col_;
  int lane_;
  __device__ __forceinline__ RowCache(uint32_t* key, int* col, int,
                                      int lane)
      : key_(key), col_(col), lane_(lane) {}
  __device__ __forceinline__ int rows(int T) const { return (T + 31) / 32; }
  __device__ __forceinline__ uint32_t& key(int m) {
    return key_[lane_ + 32 * m];
  }
  __device__ __forceinline__ int& col(int m) { return col_[lane_ + 32 * m]; }
};

template <int RPL>
__global__ void __launch_bounds__(kThreads, 1)
assign_kernel(const float4* __restrict__ t_boxes,
              const float4* __restrict__ d_boxes,
              const bool* __restrict__ t_mask,
              const bool* __restrict__ d_mask, const int* __restrict__ t_cls,
              const int* __restrict__ d_cls, int T, int D, float iou_thr,
              int* __restrict__ match) {
  extern __shared__ float smem[];
  const int ld = D | 1;
  float* cost = smem;                                               // [T][ld]
  uint32_t* best_key = reinterpret_cast<uint32_t*>(cost + T * ld);  // [T]
  int* best_col = reinterpret_cast<int*>(best_key + T);             // [T]

  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const float4* tb = t_boxes + static_cast<size_t>(b) * T;
  const float4* db = d_boxes + static_cast<size_t>(b) * D;
  const bool* tm = t_mask + static_cast<size_t>(b) * T;
  const bool* dm = d_mask + static_cast<size_t>(b) * D;
  const int* tc = t_cls + static_cast<size_t>(b) * T;
  const int* dc = d_cls + static_cast<size_t>(b) * D;
  int* fm = match + static_cast<size_t>(b) * T;

  // cost and row bests: G lanes a row (a power of two, G T <= kThreads
  // where T allows); lane q of a group takes columns q, q + G, ...
  int G = 32;
  while (G > 1 && G * T > kThreads) G >>= 1;
  const int q = threadIdx.x & (G - 1);
  for (int i0 = 0; i0 < T; i0 += kThreads / G) {  // uniform over the CTA
    const int i = i0 + threadIdx.x / G;
    uint32_t bk = 0;
    int bj = D;
    if (i < T) {
      const float4 t = tb[i];
      const float t_area = box_area(t);
      const bool t_live = tm[i];
      const int t_class = tc[i];
      for (int j = q; j < D; j += G) {
        const float4 d = db[j];
        const bool live = t_live & dm[j] & (t_class == dc[j]);
        const float v = box_iou(t, t_area, d, box_area(d));
        const float c = live ? v : -1.0f;
        cost[i * ld + j] = c;
        const uint32_t k = order_key(c);
        if (k > bk) {  // ascending j: this lane's first maximum
          bk = k;
          bj = j;
        }
      }
    }
    for (int o = G >> 1; o > 0; o >>= 1) {  // argmax over the row's lanes
      const uint32_t ok = __shfl_xor_sync(kFull, bk, o);
      const int oj = __shfl_xor_sync(kFull, bj, o);
      if (ok > bk || (ok == bk && oj < bj)) {
        bk = ok;
        bj = oj;
      }
    }
    if (i < T && q == 0) {
      best_key[i] = bk;
      best_col[i] = bj;
    }
  }
  for (int i = threadIdx.x; i < T; i += kThreads) fm[i] = -1;
  __syncthreads();
  if (threadIdx.x >= 32) return;

  RowCache<RPL> cache(best_key, best_col, T, lane);
  const int rpl = cache.rows(T);
  const uint32_t retired = order_key(-1.0f);
  const int steps = min(T, D);
  for (int it = 0; it < steps; ++it) {
    uint32_t bk = 0;
    int bi = T, bc = 0;
#pragma unroll
    for (int m = 0; m < rpl; ++m) {  // ascending rows: the first maximum
      const uint32_t k = lane + 32 * m < T ? cache.key(m) : 0u;
      if (k > bk) {
        bk = k;
        bi = lane + 32 * m;
        bc = cache.col(m);
      }
    }
    const uint32_t top = __reduce_max_sync(kFull, bk);
    if (!(key_value(top) >= iou_thr)) break;  // uniform: one value a warp
    const int i = __reduce_min_sync(kFull, bk == top ? bi : T);
    const int j = __shfl_sync(kFull, bc, i & 31);  // the owner's first max
    if (lane == 0) fm[i] = j;
    for (int k = lane; k < D; k += 32) cost[i * ld + k] = -1.0f;
    bool stale = false;  // a row of this lane's whose best column went
#pragma unroll
    for (int m = 0; m < rpl; ++m) {
      const int r = lane + 32 * m;
      if (r < T) {
        cost[r * ld + j] = -1.0f;
        if (r == i) {  // row i is -1 throughout: its best is at column 0
          cache.key(m) = retired;
          cache.col(m) = 0;
        } else {
          stale |= cache.col(m) == j && key_value(cache.key(m)) >= iou_thr;
        }
      }
    }
    __syncwarp();
    if (__any_sync(kFull, stale)) {  // rare
#pragma unroll
      for (int m = 0; m < rpl; ++m) {
        const int r = lane + 32 * m;
        uint32_t todo = __ballot_sync(
            kFull, r < T && r != i && cache.col(m) == j &&
                       key_value(cache.key(m)) >= iou_thr);
        while (todo) {
          const int owner = __ffs(todo) - 1;
          todo &= todo - 1;
          uint32_t key;
          int col;
          row_best(cost + (owner + 32 * m) * ld, D, lane, key, col);
          if (lane == owner) {
            cache.key(m) = key;
            cache.col(m) = col;
          }
        }
      }
    }
    __syncwarp();
  }
}

// rows a lane keeps in registers: 1, 2 or 4 (T <= 128), else 0 (shared)
int cache_rows(int T) { return T <= 32 ? 1 : T <= 64 ? 2 : T <= 128 ? 4 : 0; }

size_t smem_bytes(int T, int D) {
  return static_cast<size_t>(T) * (D | 1) * sizeof(float) +
         static_cast<size_t>(T) * (sizeof(uint32_t) + sizeof(int));
}

template <int RPL>
int launch(const void* t_boxes, const void* d_boxes, const void* t_mask,
           const void* d_mask, const void* t_cls, const void* d_cls, int B,
           int T, int D, float iou_thr, void* match, cudaStream_t stream) {
  const size_t smem = smem_bytes(T, D);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        assign_kernel<RPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  assign_kernel<RPL><<<B, kThreads, smem, stream>>>(
      static_cast<const float4*>(t_boxes), static_cast<const float4*>(d_boxes),
      static_cast<const bool*>(t_mask), static_cast<const bool*>(d_mask),
      static_cast<const int*>(t_cls), static_cast<const int*>(d_cls), T, D,
      iou_thr, static_cast<int*>(match));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// t_boxes (B, T, 4) f32 xyxy, d_boxes (B, D, 4) f32, t_mask (B, T) bool,
// d_mask (B, D) bool, t_cls (B, T) i32, d_cls (B, D) i32, all contiguous,
// the boxes on 16 bytes; match (B, T) i32 output.  A frame's cost matrix
// may take up to 48 KB as (T, D) floats (T * D <= 12288); a larger one is
// refused with cudaErrorInvalidValue before any launch.  The padded rows
// and the row-best cache can pass 48 KB inside that limit: the launcher
// then opts into more dynamic shared memory (at most 196 KB).  Returns
// the launch's CUDA error.
extern "C" int greedy_assign_launch(const void* t_boxes, const void* d_boxes,
                                    const void* t_mask, const void* d_mask,
                                    const void* t_cls, const void* d_cls,
                                    int B, int T, int D, float iou_thr,
                                    void* match, void* stream) {
  if (static_cast<size_t>(T) * D * sizeof(float) > kCostLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cache_rows(T)) {
    case 1:
      return launch<1>(t_boxes, d_boxes, t_mask, d_mask, t_cls, d_cls, B, T,
                       D, iou_thr, match, s);
    case 2:
      return launch<2>(t_boxes, d_boxes, t_mask, d_mask, t_cls, d_cls, B, T,
                       D, iou_thr, match, s);
    case 4:
      return launch<4>(t_boxes, d_boxes, t_mask, d_mask, t_cls, d_cls, B, T,
                       D, iou_thr, match, s);
    default:
      return launch<0>(t_boxes, d_boxes, t_mask, d_mask, t_cls, d_cls, B, T,
                       D, iou_thr, match, s);
  }
}
