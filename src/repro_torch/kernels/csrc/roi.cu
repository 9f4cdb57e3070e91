// ROI crop-resize and uncrop for the cascade's hierarchical second pass.
//
// crop_kernel replaces the JAX package's
// kernels/roi.py:crop_resize_pallas (_crop_kernel).  That kernel gathers
// with two one-hot matrix products on the TPU's matrix unit, because a
// per-pixel gather is slow there; on this card a gather is a plain load,
// so the products go and the kernel reads the source pixels directly:
//   out[b, r, i, j, k] = img[b, ys[i], xs[j], k]
//   ys[i] = clip(floor((y0 + ((i + 0.5) / C) * (y1 - y0)) * H), 0, H - 1)
// and xs likewise along W.  One CTA per (frame, window): its C row and C
// column indices are computed once into shared memory, in the reference's
// float32 operation order with IEEE division (the library is built with
// -fmad=false, so nothing is contracted), clipped as floats and then cast.
// Threads then walk the window's C*C*ch outputs in order, so stores are
// coalesced along (j, k); the gathered reads hit the frame's few tens of
// KB, which stay in L1/L2.  A zero-area window gives a tile of pixel
// (0, 0), as in the reference.
//
// uncrop_kernel replaces kernels/roi.py:uncrop_boxes_pallas
// (_uncrop_kernel): one thread per box, four outputs,
//   ((b / C) * (x1 - x0) + x0) * W   (and y with H),
// rounded after every operation like the numpy oracle.  (The reference's
// jitted tiers contract x0 + t * (x1 - x0) into an FMA and so differ from
// this by at most one ULP of the frame scale.)  The wrapper materializes
// the rois' broadcast, so each box reads its own roi.
//
// Bound on the card: both kernels move bytes and do a handful of flops
// per element.  At the engine's shapes (8 frames x 4 windows of 64x64x3,
// 1024 boxes) the crop writes 1.5 MB and the uncrop moves 48 KB, well
// under a microsecond of HBM time each, so launch latency dominates.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCropThreads = 256;
constexpr int kUncropThreads = 256;

// source index of output pixel i along an axis of S pixels, window [lo, hi]
__device__ __forceinline__ int src_index(int i, int C, float lo, float hi,
                                         int S) {
  const float f = (static_cast<float>(i) + 0.5f) / static_cast<float>(C);
  const float d = hi - lo;
  const float t = f * d;
  const float u = lo + t;
  const float v = floorf(u * static_cast<float>(S));
  const float c = fminf(fmaxf(v, 0.0f), static_cast<float>(S - 1));
  return static_cast<int>(c);
}

__global__ void crop_kernel(const float* __restrict__ images,
                            const float4* __restrict__ rois, int R, int H,
                            int W, int ch, int C, float* __restrict__ out) {
  extern __shared__ int sidx[];  // [C] rows, then [C] columns
  int* ys = sidx;
  int* xs = sidx + C;
  const int win = blockIdx.x;  // b * R + r
  const int b = win / R;
  const float4 roi = rois[win];  // x0, y0, x1, y1
  for (int i = threadIdx.x; i < C; i += blockDim.x) {
    ys[i] = src_index(i, C, roi.y, roi.w, H);
    xs[i] = src_index(i, C, roi.x, roi.z, W);
  }
  __syncthreads();
  const float* img = images + static_cast<size_t>(b) * H * W * ch;
  float* o = out + static_cast<size_t>(win) * C * C * ch;
  const int row = C * ch;
  const int n = C * row;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int i = e / row;
    const int rem = e - i * row;
    const int j = rem / ch;
    const int k = rem - j * ch;
    o[e] = img[(static_cast<size_t>(ys[i]) * W + xs[j]) * ch + k];
  }
}

__global__ void uncrop_kernel(const float4* __restrict__ boxes,
                              const float4* __restrict__ rois, int N,
                              float C, float W, float H,
                              float4* __restrict__ out) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const float4 b = boxes[n];
  const float4 r = rois[n];
  const float sx = r.z - r.x;
  const float sy = r.w - r.y;
  float4 o;
  o.x = ((b.x / C) * sx + r.x) * W;
  o.y = ((b.y / C) * sy + r.y) * H;
  o.z = ((b.z / C) * sx + r.x) * W;
  o.w = ((b.w / C) * sy + r.y) * H;
  out[n] = o;
}

}  // namespace

// images (B, H, W, ch) f32 and rois (B, R, 4) f32 normalized xyxy, both
// contiguous; out (B, R, C, C, ch) f32.  Returns the launch's CUDA error.
extern "C" int crop_resize_launch(const void* images, const void* rois,
                                  int B, int R, int H, int W, int ch, int C,
                                  void* out, void* stream) {
  const size_t smem = 2 * static_cast<size_t>(C) * sizeof(int);
  crop_kernel<<<B * R, kCropThreads, smem,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(images), static_cast<const float4*>(rois), R,
      H, W, ch, C, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// boxes (N, 4) and rois (N, 4) f32 contiguous (rois already broadcast);
// out (N, 4) f32.  C, W, H are the crop size and the parent frame's
// bounds, as float32.  Returns the launch's CUDA error.
extern "C" int uncrop_boxes_launch(const void* boxes, const void* rois,
                                   int N, float C, float W, float H,
                                   void* out, void* stream) {
  const int grid = (N + kUncropThreads - 1) / kUncropThreads;
  uncrop_kernel<<<grid, kUncropThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const float4*>(rois), N,
      C, W, H, static_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}
