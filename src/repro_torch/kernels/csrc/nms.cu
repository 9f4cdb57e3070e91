// Batched greedy NMS, one CTA per frame.
//
// Replaces the JAX package's kernels/nms.py:batched_nms_pallas
// (_nms_kernel).  Same function as its XLA twin batched_nms_xla: the
// wrapper (repro_torch/kernels/nms.py) thresholds the scores, sorts each
// frame stably by descending thresholded score and gathers boxes, scores
// and original indices in that order; this kernel runs greedy suppression
// over the sorted candidates in tiles of 32 and writes
//   keep[b, s]  = original index of the s-th survivor (0 in unused slots)
//   count[b]    = min(survivors found, max_out).
//
// The tiles are semantic, not a tuning choice: the reference stops at
// tile granularity.  A frame stops before tile t when it already has
// max_out survivors, or (stop_at_zero) when tile t's first sorted score is
// not > 0.  A tile that is entered is processed whole, so zero-score
// candidates inside it survive and take keep slots, exactly as in the
// reference; the detector masks them out of `valid` afterwards.
//
// Design: the sorted boxes, their areas and an `alive` bit mask (one
// 32-bit word per tile) live in shared memory.  For each tile all threads
// compute the tile's IoU rows against every candidate from the tile on,
// as suppression bit words; thread 0 then resolves the greedy order
// inside the tile on those bits (32 bit tests), and all threads clear the
// suppressed bits of the later words.  The IoU is computed in the
// reference's operation order, inter / max(a_i + a_j - inter, 1e-9), with
// IEEE division; the library is built with -fmad=false so no multiply-add
// is contracted and a threshold compare never flips on one ULP.
//
// Bound on the card: at the engine's shapes (B <= 8 frames, A = 160,
// max_out = 32) the work is a few thousand IoUs per frame and the bytes
// are ~4 KB per frame, so the kernel is bound by launch latency and the
// serial tile loop, not by memory or arithmetic.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;
constexpr int kThreads = 256;

__device__ __forceinline__ float iou(float4 a, float area_a, float4 b,
                                     float area_b) {
  const float ix0 = fmaxf(a.x, b.x);
  const float iy0 = fmaxf(a.y, b.y);
  const float ix1 = fminf(a.z, b.z);
  const float iy1 = fminf(a.w, b.w);
  const float inter = fmaxf(ix1 - ix0, 0.0f) * fmaxf(iy1 - iy0, 0.0f);
  const float uni = area_a + area_b - inter;
  return inter / fmaxf(uni, 1e-9f);
}

__global__ void nms_kernel(const float4* __restrict__ boxes,
                           const float* __restrict__ scores,
                           const int* __restrict__ order, int A,
                           int max_out, float iou_thr, int stop_at_zero,
                           int* __restrict__ keep, int* __restrict__ count) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = (A + kTile - 1) / kTile;
  float4* sb = reinterpret_cast<float4*>(smem);
  float* sa = reinterpret_cast<float*>(sb + A);
  uint32_t* alive = reinterpret_cast<uint32_t*>(sa + A);
  uint32_t* sup = alive + W;  // [kTile][W] suppression bits of one tile
  __shared__ int s_found;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const float4* fb = boxes + static_cast<size_t>(b) * A;
  const float* fs = scores + static_cast<size_t>(b) * A;
  const int* fo = order + static_cast<size_t>(b) * A;
  int* fk = keep + static_cast<size_t>(b) * max_out;

  for (int i = tid; i < A; i += blockDim.x) {
    const float4 v = fb[i];
    sb[i] = v;
    sa[i] = (v.z - v.x) * (v.w - v.y);
  }
  for (int w = tid; w < W; w += blockDim.x) {
    const int n = min(kTile, A - kTile * w);
    alive[w] = n == kTile ? 0xffffffffu : ((1u << n) - 1u);
  }
  for (int s = tid; s < max_out; s += blockDim.x) fk[s] = 0;
  if (tid == 0) s_found = 0;
  __syncthreads();

  for (int w0 = 0; w0 < W; ++w0) {
    const int c0 = w0 * kTile;
    // every thread reads the same shared values: the exit is uniform
    if (s_found >= max_out) break;
    if (stop_at_zero && !(fs[c0] > 0.0f)) break;
    const int T = min(kTile, A - c0);
    const int nw = W - w0;
    for (int e = tid; e < T * nw; e += blockDim.x) {
      const int i = e / nw;
      const int w = w0 + e % nw;
      const float4 bi = sb[c0 + i];
      const float ai = sa[c0 + i];
      const int jn = min(kTile, A - kTile * w);
      uint32_t bits = 0;
      for (int k = 0; k < jn; ++k) {
        const int j = kTile * w + k;
        if (iou(bi, ai, sb[j], sa[j]) >= iou_thr) bits |= 1u << k;
      }
      sup[i * W + w] = bits;
    }
    __syncthreads();
    if (tid == 0) {
      uint32_t a = alive[w0];
      int found = s_found;
      for (int i = 0; i < T; ++i) {
        if ((a >> i) & 1u) {
          if (found < max_out) fk[found] = fo[c0 + i];
          ++found;
          const uint32_t later = i == kTile - 1 ? 0u : (~0u << (i + 1));
          a &= ~(sup[i * W + w0] & later);
        }
      }
      alive[w0] = a;
      s_found = found;
    }
    __syncthreads();
    const uint32_t kept = alive[w0];
    for (int w = w0 + 1 + tid; w < W; w += blockDim.x) {
      uint32_t dead = 0;
      for (int i = 0; i < T; ++i)
        if ((kept >> i) & 1u) dead |= sup[i * W + w];
      alive[w] &= ~dead;
    }
    __syncthreads();
  }
  if (tid == 0) count[b] = min(s_found, max_out);
}

}  // namespace

static size_t batched_nms_smem_bytes(int A) {
  const int W = (A + kTile - 1) / kTile;
  return static_cast<size_t>(A) * (sizeof(float4) + sizeof(float)) +
         static_cast<size_t>(W) * (1 + kTile) * sizeof(uint32_t);
}

// boxes (B, A, 4) f32, scores (B, A) f32, order (B, A) i32, all sorted per
// frame and contiguous; keep (B, max_out) i32 and count (B,) i32 outputs.
// One CTA takes at most the default 48 KB of dynamic shared memory (about
// 2400 candidates); a larger frame fails at launch and the error code is
// returned.
extern "C" int batched_nms_launch(const void* boxes, const void* scores,
                                  const void* order, int B, int A,
                                  int max_out, float iou_thr,
                                  int stop_at_zero, void* keep, void* count,
                                  void* stream) {
  const size_t smem = batched_nms_smem_bytes(A);
  nms_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(scores),
      static_cast<const int*>(order), A, max_out, iou_thr, stop_at_zero,
      static_cast<int*>(keep), static_cast<int*>(count));
  return static_cast<int>(cudaGetLastError());
}
