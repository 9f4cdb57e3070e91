// Batched greedy track <-> detection assignment, one CTA per frame.
//
// Replaces the JAX package's kernels/association.py:greedy_assign_pallas
// (_assoc_kernel, _plane_cost, _greedy_body).  Per frame:
//   cost[i, j] = IoU(track i, detection j) where both slots are live and
//                the classes agree, else -1;
//   then at most min(T, D) steps: take the largest cost, lowest flat index
//   i * D + j among equal maxima (the reference's row-major argmax), stop
//   if it is below iou_thr, else commit match[i] = j and retire row i and
//   column j (set to -1).
// match[b, i] is the committed detection index or -1.
//
// Design: the (T, D) cost matrix lives in shared memory (64 x 32 floats =
// 8 KB at the engine's shapes).  Each step is a block-wide argmax: every
// thread scans a strided slice keeping its first maximum, warps reduce
// with shuffles under the (value desc, index asc) order, and warp 0
// reduces the warp winners.  IoU is computed in the reference's operation
// order with IEEE division, built with -fmad=false (see build.py).
//
// Bound on the card: a frame reads T + D boxes and writes T ints; the
// serial argmax steps (one per committed match, <= 32) are bound by
// block synchronisation latency, not by memory or arithmetic.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__global__ void assign_kernel(const float4* __restrict__ t_boxes,
                              const float4* __restrict__ d_boxes,
                              const bool* __restrict__ t_mask,
                              const bool* __restrict__ d_mask,
                              const int* __restrict__ t_cls,
                              const int* __restrict__ d_cls, int T, int D,
                              float iou_thr, int* __restrict__ match) {
  extern __shared__ float cost[];  // [T][D]
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ float s_best_v;
  __shared__ int s_best_i;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n = T * D;
  const float4* tb = t_boxes + static_cast<size_t>(b) * T;
  const float4* db = d_boxes + static_cast<size_t>(b) * D;
  const bool* tm = t_mask + static_cast<size_t>(b) * T;
  const bool* dm = d_mask + static_cast<size_t>(b) * D;
  const int* tc = t_cls + static_cast<size_t>(b) * T;
  const int* dc = d_cls + static_cast<size_t>(b) * D;
  int* fm = match + static_cast<size_t>(b) * T;

  for (int e = tid; e < n; e += blockDim.x) {
    const int i = e / D;
    const int j = e - i * D;
    const float4 t = tb[i];
    const float4 d = db[j];
    const float ix0 = fmaxf(t.x, d.x);
    const float iy0 = fmaxf(t.y, d.y);
    const float ix1 = fminf(t.z, d.z);
    const float iy1 = fminf(t.w, d.w);
    const float inter = fmaxf(ix1 - ix0, 0.0f) * fmaxf(iy1 - iy0, 0.0f);
    const float t_area = (t.z - t.x) * (t.w - t.y);
    const float d_area = (d.z - d.x) * (d.w - d.y);
    const float uni = t_area + d_area - inter;
    const float v = inter / fmaxf(uni, 1e-9f);
    cost[e] = (tm[i] && dm[j] && tc[i] == dc[j]) ? v : -1.0f;
  }
  for (int i = tid; i < T; i += blockDim.x) fm[i] = -1;
  __syncthreads();

  const int steps = min(T, D);
  for (int it = 0; it < steps; ++it) {
    float bv = -INFINITY;
    int bi = n;
    for (int e = tid; e < n; e += blockDim.x) {
      const float v = cost[e];
      if (v > bv) {  // ascending e: the first maximum of this slice
        bv = v;
        bi = e;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < kWarps ? red_v[lane] : -INFINITY;
      bi = lane < kWarps ? red_i[lane] : n;
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, bv, off);
        const int oi = __shfl_down_sync(0xffffffffu, bi, off);
        if (better(ov, oi, bv, bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (lane == 0) {
        s_best_v = bv;
        s_best_i = bi;
      }
    }
    __syncthreads();
    const float best = s_best_v;
    const int flat = s_best_i;
    if (!(best >= iou_thr)) break;  // uniform: every thread reads shared
    const int i = flat / D;
    const int j = flat - i * D;
    if (tid == 0) fm[i] = j;
    for (int k = tid; k < D; k += blockDim.x) cost[i * D + k] = -1.0f;
    for (int k = tid; k < T; k += blockDim.x) cost[k * D + j] = -1.0f;
    __syncthreads();
  }
}

}  // namespace

static size_t greedy_assign_smem_bytes(int T, int D) {
  return static_cast<size_t>(T) * D * sizeof(float);
}

// t_boxes (B, T, 4) f32 xyxy, d_boxes (B, D, 4) f32, t_mask (B, T) bool,
// d_mask (B, D) bool, t_cls (B, T) i32, d_cls (B, D) i32, all contiguous;
// match (B, T) i32 output.  One CTA takes at most the default 48 KB of
// dynamic shared memory (T * D <= 12288); a larger cost matrix fails at
// launch and the error code is returned.
extern "C" int greedy_assign_launch(const void* t_boxes, const void* d_boxes,
                                    const void* t_mask, const void* d_mask,
                                    const void* t_cls, const void* d_cls,
                                    int B, int T, int D, float iou_thr,
                                    void* match, void* stream) {
  const size_t smem = greedy_assign_smem_bytes(T, D);
  assign_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(t_boxes), static_cast<const float4*>(d_boxes),
      static_cast<const bool*>(t_mask), static_cast<const bool*>(d_mask),
      static_cast<const int*>(t_cls), static_cast<const int*>(d_cls), T, D,
      iou_thr, static_cast<int*>(match));
  return static_cast<int>(cudaGetLastError());
}
