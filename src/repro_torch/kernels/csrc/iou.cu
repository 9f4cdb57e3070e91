// Pairwise IoU matrix in 16-byte column strips.
//
// Replaces the JAX package's kernels/iou.py:iou_matrix (_iou_kernel).
// That kernel carries the boxes as (4, N) planes so the box index lands
// on the TPU's 128-wide lanes, and computes 128x128 tiles.  On this card
// the boxes stay (N, 4).
//
// Bound on the card: 13 flops a pair against 4 bytes written a pair, so
// the kernel is bound by the bytes it writes (an 8732 x 8732 matrix is
// 305 MB, about 0.09 ms of HBM time); at the seed NMS path's 160 x 160 a
// launch is latency-bound.
//
// Design: a CTA of 8 warps computes a tile of 128 columns by 64 rows
// (9,453 tiles at SSD300's 8732^2; one CTA a tile measured faster there
// than walking the tiles grid-strided over the resident CTAs, as the
// block scheduler evens out the tail).  Where 64-row tiles would
// leave SMs idle the launcher halves the tile height, down to 8 rows
// (160^2: 40 tiles of 8 rows).  Lane l of every warp owns the four
// adjacent columns 4l .. 4l+3 of the tile's strip and keeps their boxes
// and areas in registers; the tile's row boxes are loaded once as float4
// into shared memory with their areas; warp w computes rows w, w + 8, ...
// and writes each row's 512-byte strip with streaming 16-byte stores.
// Row i starts (i * M) mod 4 floats past 16 bytes: where that is not 0
// (M % 4 != 0) the strip's first h = (4 - (i * M) % 4) % 4 floats go out
// as a scalar head from lane 0, each lane writes the aligned four from
// its column 4l + h (its own last 4 - h values and the first h of lane
// l + 1, by a shuffle), and lane 31's last 4 - h values are a scalar
// tail.  Columns past M are computed on the last column's box and never
// stored.  IoU is common.cuh's box_iou: the reference's operation order,
// IEEE division, no contracted multiply-add, NaN carried, so the result
// equals the plain PyTorch version bit for bit.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kRows = 64;     // rows of a tile, at most
constexpr int kMinRows = 8;   // rows of a tile, at least
constexpr int kCols = 128;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// Row `row` of the output's columns j0 .. j0 + 127 (those < M): this
// lane's values v of columns c0 = j0 + 4 lane .. c0 + 3.  h (the head) is
// uniform over the warp.
__device__ __forceinline__ void store_strip(float* row, int j0, int M,
                                            int h, int lane,
                                            const float (&v)[4]) {
  const int c0 = j0 + 4 * lane;
  if (h == 0) {
    if (c0 + 3 < M) {
      __stcs(reinterpret_cast<float4*>(row + c0),
             make_float4(v[0], v[1], v[2], v[3]));
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (c0 + k < M) __stcs(row + c0 + k, v[k]);
    }
    return;
  }
  float n[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) n[k] = __shfl_down_sync(kFull, v[k], 1);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k)
      if (k < h && j0 + k < M) __stcs(row + j0 + k, v[k]);
  }
  // the aligned four from column c0 + h: v[h..3], then n[0..h-1]
  const float w[4] = {h == 1 ? v[1] : h == 2 ? v[2] : v[3],
                      h == 1 ? v[2] : h == 2 ? v[3] : n[0],
                      h == 1 ? v[3] : h == 2 ? n[0] : n[1],
                      h == 1 ? n[0] : h == 2 ? n[1] : n[2]};
  const int g = c0 + h;
  const int end = min(j0 + kCols, M);
  if (g + 3 < end) {
    __stcs(reinterpret_cast<float4*>(row + g),
           make_float4(w[0], w[1], w[2], w[3]));
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (g + k < end) __stcs(row + g + k, w[k]);
  }
}

__global__ void __launch_bounds__(kThreads)
iou_kernel(const float4* __restrict__ a, const float4* __restrict__ b,
           int N, int M, int tile_rows, int n_strips,
           float* __restrict__ out) {
  __shared__ float4 sa[kRows];
  __shared__ float s_area[kRows];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int i0 = (blockIdx.x / n_strips) * tile_rows;
  const int j0 = (blockIdx.x % n_strips) * kCols;
  float4 bj[4];
  float area_b[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    bj[k] = b[min(j0 + 4 * lane + k, M - 1)];
    area_b[k] = box_area(bj[k]);
  }
  if (threadIdx.x < tile_rows && i0 + threadIdx.x < N) {
    const float4 v = a[i0 + threadIdx.x];
    sa[threadIdx.x] = v;
    s_area[threadIdx.x] = box_area(v);
  }
  __syncthreads();
  const int rows = min(tile_rows, N - i0);
  for (int r = warp; r < rows; r += kWarps) {
    const float4 ai = sa[r];
    const float area_a = s_area[r];
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = box_iou(ai, area_a, bj[k], area_b[k]);
    const size_t start = static_cast<size_t>(i0 + r) * M;
    const int h = static_cast<int>((4 - (start & 3)) & 3);
    store_strip(out + start, j0, M, h, lane, v);
  }
}

// the current device's SM count (cached per device)
int sm_count() {
  static int cached[64];
  int dev = 0;
  cudaGetDevice(&dev);
  int& n = cached[dev & 63];
  if (n == 0) cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

}  // namespace

// a (N, 4) and b (M, 4) f32 contiguous xyxy boxes, each starting on 16
// bytes; out (N, M) f32 on 16 bytes.  Returns the launch's CUDA error.
extern "C" int iou_matrix_launch(const void* a, const void* b, int N, int M,
                                 void* out, void* stream) {
  const int n_strips = (M + kCols - 1) / kCols;
  int tile_rows = kRows;  // shorter tiles where 64-row ones leave SMs idle
  while (tile_rows > kMinRows &&
         (N + tile_rows - 1) / tile_rows * n_strips < sm_count())
    tile_rows /= 2;
  const int n_tiles = (N + tile_rows - 1) / tile_rows * n_strips;
  iou_kernel<<<n_tiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(a), static_cast<const float4*>(b), N, M,
      tile_rows, n_strips, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
