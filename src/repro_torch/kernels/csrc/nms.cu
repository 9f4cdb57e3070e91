// Batched greedy NMS, one CTA per frame, the candidate sort included.
//
// Replaces the JAX package's kernels/nms.py:batched_nms_pallas
// (_nms_kernel) and the sort its wrapper runs around it.  Same function as
// its XLA twin batched_nms_xla.  From the frame's unsorted boxes and
// scores this kernel
//   1. thresholds the scores: key = s >= score_thr ? s : 0 (no threshold:
//      key = s), compared in float32 as the wrapper's torch.where does;
//   2. sorts the candidates as torch.argsort(-key, stable=True) does, by
//      rank: rank_i = #{j : key_j > key_i, or key_j == key_i and j < i},
//      with NaN keys after every other key and tied among themselves.
//      Keys compare as floats, so -0.0 and 0.0 tie (the thresholded
//      zeros are such ties) and the order by index decides; candidate i
//      lands at position rank_i (O(A^2) comparisons, about 100 a thread
//      at A = 160);
//   3. runs greedy suppression over the sorted candidates in tiles of 32
//      and writes
//        keep[b, s]  = original index of the s-th survivor (0 in unused
//                      slots)
//        valid[b, s] = s < min(survivors found, max_out).
//
// The tiles are semantic, not a tuning choice: the reference stops at
// tile granularity.  A frame stops before tile t when it already has
// max_out survivors, or (stop_at_zero) when tile t's first sorted key is
// not > 0.  A tile that is entered is processed whole, so zero-score
// candidates inside it survive and take keep slots, exactly as in the
// reference; the detector masks them out of `valid` afterwards.
//
// Design: the sorted boxes, their areas, their original indices and an
// `alive` bit mask (one 32-bit word per tile) live in shared memory.  For
// each tile all threads compute the tile's IoU rows against every
// candidate from the tile on, as suppression bit words; thread 0 then
// resolves the greedy order inside the tile on those bits (32 bit tests),
// and all threads clear the suppressed bits of the later words.  The IoU
// is common.cuh's box_iou: the reference's operation order,
// inter / max(a_i + a_j - inter, 1e-9), with IEEE division, no
// contracted multiply-add, and NaN carried through every max and min as
// the reference does, so a box with a NaN coordinate has a NaN IoU, which
// fails `>= iou_thr` and suppresses nothing.
//
// Bound on the card: at the engine's shapes (B <= 8 frames, A = 160,
// max_out = 32) the work is a few thousand IoUs and 25,600 key
// comparisons per frame and the bytes are ~4 KB per frame, so the kernel
// is bound by launch latency and the serial tile loop, not by memory or
// arithmetic.  Folding the sort in removes the threshold, radix sort,
// gather and cast launches the wrapper ran before: one launch a call.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kTile = 32;
constexpr int kThreads = 256;

// position of candidate i in torch.argsort(-key, stable=True)
__device__ __forceinline__ int sorted_rank(const float* key, int A, int i) {
  const float ki = key[i];
  int rank = 0;
  if (isnan(ki)) {  // after every number, then by index among the NaNs
    for (int j = 0; j < A; ++j) rank += j < i || !isnan(key[j]);
    return rank;
  }
  for (int j = 0; j < i; ++j) rank += key[j] >= ki;
  for (int j = i + 1; j < A; ++j) rank += key[j] > ki;
  return rank;
}

__global__ void __launch_bounds__(kThreads)
nms_kernel(const float4* __restrict__ boxes, const float* __restrict__ scores,
           int A, int max_out, int use_thr, float score_thr, float iou_thr,
           int stop_at_zero, int* __restrict__ keep, bool* __restrict__ valid) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = (A + kTile - 1) / kTile;
  float4* sb = reinterpret_cast<float4*>(smem);           // [A] sorted boxes
  float* sa = reinterpret_cast<float*>(sb + A);           // [A] their areas
  int* so = reinterpret_cast<int*>(sa + A);               // [A] their indices
  uint32_t* alive = reinterpret_cast<uint32_t*>(so + A);  // [W]
  float* lead = reinterpret_cast<float*>(alive + W);      // [W] first key
  uint32_t* sup = reinterpret_cast<uint32_t*>(lead + W);  // [kTile][W]
  float* key = reinterpret_cast<float*>(sup);  // [A] unsorted, before sup
  __shared__ int s_found;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const float4* fb = boxes + static_cast<size_t>(b) * A;
  const float* fs = scores + static_cast<size_t>(b) * A;
  int* fk = keep + static_cast<size_t>(b) * max_out;
  bool* fv = valid + static_cast<size_t>(b) * max_out;

  for (int i = tid; i < A; i += blockDim.x) {
    const float s = fs[i];
    key[i] = (use_thr && !(s >= score_thr)) ? 0.0f : s;
  }
  __syncthreads();
  for (int i = tid; i < A; i += blockDim.x) {
    const int r = sorted_rank(key, A, i);
    const float4 v = fb[i];
    sb[r] = v;
    sa[r] = box_area(v);
    so[r] = i;
    if (r % kTile == 0) lead[r / kTile] = key[i];
  }
  for (int w = tid; w < W; w += blockDim.x) {
    const int n = min(kTile, A - kTile * w);
    alive[w] = n == kTile ? 0xffffffffu : ((1u << n) - 1u);
  }
  for (int s = tid; s < max_out; s += blockDim.x) fk[s] = 0;
  if (tid == 0) s_found = 0;
  __syncthreads();  // the keys are consumed: sup may overwrite them

  for (int w0 = 0; w0 < W; ++w0) {
    const int c0 = w0 * kTile;
    // every thread reads the same shared values: the exit is uniform
    if (s_found >= max_out) break;
    if (stop_at_zero && !(lead[w0] > 0.0f)) break;
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
        if (box_iou(bi, ai, sb[j], sa[j]) >= iou_thr) bits |= 1u << k;
      }
      sup[i * W + w] = bits;
    }
    __syncthreads();
    if (tid == 0) {
      uint32_t a = alive[w0];
      int found = s_found;
      for (int i = 0; i < T; ++i) {
        if ((a >> i) & 1u) {
          if (found < max_out) fk[found] = so[c0 + i];
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
  const int count = min(s_found, max_out);
  for (int s = tid; s < max_out; s += blockDim.x) fv[s] = s < count;
}

}  // namespace

static size_t batched_nms_smem_bytes(int A) {
  const int W = (A + kTile - 1) / kTile;
  return static_cast<size_t>(A) * (sizeof(float4) + sizeof(float) +
                                   sizeof(int)) +
         static_cast<size_t>(W) * (2 + kTile) * sizeof(uint32_t);
}

// boxes (B, A, 4) f32 and scores (B, A) f32, unsorted and contiguous;
// score_thr applies when use_thr is 1; keep (B, max_out) i32 and valid
// (B, max_out) bool outputs.  A frame takes 24 A + 136 ceil(A / 32) bytes
// of shared memory: above the default 48 KB (about 1,700 candidates) the
// launcher opts into more, up to the card's limit (227 KB on an H100,
// about 8,200 candidates); a larger frame fails and the error code is
// returned.
extern "C" int batched_nms_launch(const void* boxes, const void* scores,
                                  int B, int A, int max_out, int use_thr,
                                  float score_thr, float iou_thr,
                                  int stop_at_zero, void* keep, void* valid,
                                  void* stream) {
  const size_t smem = batched_nms_smem_bytes(A);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(scores),
      A, max_out, use_thr, score_thr, iou_thr, stop_at_zero,
      static_cast<int*>(keep), static_cast<bool*>(valid));
  return static_cast<int>(cudaGetLastError());
}
