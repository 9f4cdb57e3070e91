// Pairwise IoU matrix, one thread per pair.
//
// Replaces the JAX package's kernels/iou.py:iou_matrix (_iou_kernel).
// That kernel carries the boxes as (4, N) planes so the box index lands
// on the TPU's 128-wide lanes, and computes 128x128 tiles.  On this card
// the boxes stay (N, 4): a CTA of 32x8 threads computes a 32x32 tile of
// the output.  Its 32 row boxes and 32 column boxes (and their areas) are
// staged once in shared memory; thread (x, y) computes column x of rows
// y, y + 8, y + 16, y + 24, so each warp stores 32 consecutive floats of
// a row (coalesced along j).
//
// Arithmetic follows the reference's operation order exactly:
//   inter = max(ix1 - ix0, 0) * max(iy1 - iy0, 0)
//   union = area_a + area_b - inter
//   iou   = inter / max(union, 1e-9)
// with IEEE division; the library is built with -fmad=false, so no
// multiply-add is contracted and the result equals the plain PyTorch
// version bit for bit.
//
// Bound on the card: 13 flops a pair against 4 bytes written a pair, so
// the kernel is bound by the bytes it writes (an 8732 x 8732 matrix is
// 305 MB, about 0.09 ms of HBM time); at the seed NMS path's 160 x 160 a
// launch is latency-bound.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kRowsPerPass = 8;

__device__ __forceinline__ float area(const float4 v) {
  return (v.z - v.x) * (v.w - v.y);
}

__global__ void iou_kernel(const float* __restrict__ a,
                           const float* __restrict__ b, int N, int M,
                           float* __restrict__ out) {
  __shared__ float4 sa[kTile];
  __shared__ float4 sb[kTile];
  __shared__ float s_area_a[kTile];
  __shared__ float s_area_b[kTile];
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  if (ty == 0 && i0 + tx < N) {
    const float* p = a + 4 * static_cast<size_t>(i0 + tx);
    const float4 v = make_float4(p[0], p[1], p[2], p[3]);
    sa[tx] = v;
    s_area_a[tx] = area(v);
  } else if (ty == 1 && j0 + tx < M) {
    const float* p = b + 4 * static_cast<size_t>(j0 + tx);
    const float4 v = make_float4(p[0], p[1], p[2], p[3]);
    sb[tx] = v;
    s_area_b[tx] = area(v);
  }
  __syncthreads();
  const int j = j0 + tx;
  if (j >= M) return;
  const float4 bj = sb[tx];
  const float area_b = s_area_b[tx];
  for (int r = ty; r < kTile; r += kRowsPerPass) {
    const int i = i0 + r;
    if (i >= N) break;
    const float4 ai = sa[r];
    const float ix0 = fmaxf(ai.x, bj.x);
    const float iy0 = fmaxf(ai.y, bj.y);
    const float ix1 = fminf(ai.z, bj.z);
    const float iy1 = fminf(ai.w, bj.w);
    const float inter = fmaxf(ix1 - ix0, 0.0f) * fmaxf(iy1 - iy0, 0.0f);
    const float uni = s_area_a[r] + area_b - inter;
    out[static_cast<size_t>(i) * M + j] = inter / fmaxf(uni, 1e-9f);
  }
}

}  // namespace

// a (N, 4) and b (M, 4) f32 contiguous xyxy boxes; out (N, M) f32.
// Returns the launch's CUDA error.
extern "C" int iou_matrix_launch(const void* a, const void* b, int N, int M,
                                 void* out, void* stream) {
  const dim3 grid((M + kTile - 1) / kTile, (N + kTile - 1) / kTile);
  const dim3 block(kTile, kRowsPerPass);
  iou_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), N, M,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
