// ROI crop-resize and uncrop for the cascade's hierarchical second pass.
//
// crop_kernel replaces the JAX package's
// kernels/roi.py:crop_resize_pallas (_crop_kernel).  That kernel gathers
// with two one-hot matrix products on the TPU's matrix unit, because a
// per-pixel gather is slow there; on this card a gather is a plain load,
// so the products go and the kernel reads the source pixels directly:
//   out[b, r, i, j, k] = img[b, ys[i], xs[j], k]
//   ys[i] = clip(floor((y0 + ((i + 0.5) / C) * (y1 - y0)) * H), 0, H - 1)
// and xs likewise along W.  The indices keep the reference's float32
// operation order with IEEE division (the library is built with
// -fmad=false, so nothing is contracted), clipped as floats and then
// cast (src_index).  A zero-area window gives a tile of pixel (0, 0), as
// in the reference.
//
// Bound on the card: bytes, and at the serve's shapes far below a
// microsecond of them (one frame of 64x64x3 in, 4 windows of 64x64x3 =
// 196 KB out), so what is left is the launch and one chain of dependent
// loads: roi -> indices -> gathered pixel -> store.  The serve sends
// one-frame micro-batches of 4 windows, so a CTA per window would leave
// most of the 132 SMs idle: a CTA takes (window, tile of `rows` output
// rows) instead, windows on gridDim.x (up to 2^31 - 1), row tiles on
// gridDim.y; roi.py:crop_split picks `rows` and the threads from the
// shape alone so that a one-frame batch still fills about one wave.  The
// CTA computes once, in shared memory, its rows' source rows and a
// gather map for one output row: the source offset xs[j] * ch + k of
// each of the row's C * ch elements, which every row of the tile reuses,
// so the copy loop divides by nothing.  A warp then writes a row (C * ch
// contiguous floats): a scalar head up to the first 16-byte boundary,
// 16-byte stores of four gathered values, a scalar tail.  Gathered reads
// go through the read-only path; they hit the frame's few tens of KB,
// which stay in L1/L2.
//
// uncrop_kernel replaces kernels/roi.py:uncrop_boxes_pallas
// (_uncrop_kernel): one thread per box, four outputs,
//   ((b / C) * (x1 - x0) + x0) * W   (and y with H),
// rounded after every operation like the numpy oracle.  (The reference's
// jitted tiers contract x0 + t * (x1 - x0) into an FMA and so differ from
// this by at most one ULP of the frame scale.)  The rois are read through
// their broadcast against the boxes, so a call is one launch and the
// serve's broadcast view of its windows is never copied: the launcher
// takes the boxes' leading sizes and the rois' strides along them (0
// where broadcast), and each thread splits its box index into leading
// indices to find its roi.  Bound: bytes (the boxes, the rois as given,
// the output), tens of KB.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kUncropThreads = 128;
constexpr int kMaxRank = 8;      // roi.py:MAX_ROI_RANK
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr int kMaxDevices = 64;

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

inline size_t crop_smem_bytes(int C, int ch, int rows) {
  return (static_cast<size_t>(C) * ch + rows) * sizeof(int);
}

__global__ void crop_kernel(const float* __restrict__ images,
                            const float4* __restrict__ rois, int R, int H,
                            int W, int ch, int C, int rows,
                            float* __restrict__ out) {
  extern __shared__ int smem[];
  const int row = C * ch;                             // floats a row
  int* map = smem;                                    // [row]
  int* ys = map + row;                                // [rows]
  const int win = blockIdx.x;                         // b * R + r
  const int i0 = blockIdx.y * rows;
  const int nrows = min(rows, C - i0);
  const float4 roi = __ldg(rois + win);               // x0, y0, x1, y1
  for (int c = threadIdx.x; c < row; c += blockDim.x) {
    const int j = c / ch;
    map[c] = src_index(j, C, roi.x, roi.z, W) * ch + (c - j * ch);
  }
  for (int il = threadIdx.x; il < nrows; il += blockDim.x)
    ys[il] = src_index(i0 + il, C, roi.y, roi.w, H);
  __syncthreads();

  const float* img = images + static_cast<size_t>(win / R) * H * W * ch;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int il = threadIdx.x >> 5; il < nrows; il += nwarps) {
    const float* src = img + static_cast<size_t>(ys[il]) * W * ch;
    float* dst = out + (static_cast<size_t>(win) * C + i0 + il) * row;
    const int head =
        min(row, static_cast<int>(
                     ((16u - (reinterpret_cast<uintptr_t>(dst) & 15u)) & 15u)
                     >> 2));
    const int nvec = (row - head) >> 2;
    if (lane < head) dst[lane] = __ldg(src + map[lane]);
    float4* dv = reinterpret_cast<float4*>(dst + head);
    const int* m = map + head;
    for (int v = lane; v < nvec; v += 32) {
      const int c = 4 * v;
      dv[v] = make_float4(__ldg(src + m[c]), __ldg(src + m[c + 1]),
                          __ldg(src + m[c + 2]), __ldg(src + m[c + 3]));
    }
    const int t = head + 4 * nvec + lane;
    if (t < row) dst[t] = __ldg(src + map[t]);
  }
}

struct RoiLayout {
  int rank;                    // leading dims of the boxes
  int size[kMaxRank];          // the boxes' leading sizes
  long long stride[kMaxRank];  // the rois' strides along them, in floats
};

// the roi as four scalar loads: a float4 load where the base and strides
// allow it measured no faster (0.0016 ms a call either way at the serve's
// 1024 boxes on the H100)
__global__ void uncrop_kernel(const float4* __restrict__ boxes,
                              const float* __restrict__ rois, RoiLayout L,
                              int N, float C, float W, float H,
                              float4* __restrict__ out) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  // box n's leading indices, last dim fastest, and its roi's offset
  int rem = n;
  long long off = 0;
#pragma unroll
  for (int d = kMaxRank - 1; d > 0; --d) {
    if (d < L.rank) {
      const int q = rem / L.size[d];
      off += static_cast<long long>(rem - q * L.size[d]) * L.stride[d];
      rem = q;
    }
  }
  if (L.rank > 0) off += static_cast<long long>(rem) * L.stride[0];
  const float4 r = make_float4(__ldg(rois + off), __ldg(rois + off + 1),
                               __ldg(rois + off + 2), __ldg(rois + off + 3));
  const float4 b = __ldg(boxes + n);
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

// images (B, H, W, ch) f32 contiguous, rois (B, R, 4) f32 normalized xyxy
// contiguous on 16 bytes; out (B, R, C, C, ch) f32.  `rows` output rows
// and `threads` (a multiple of 32) a CTA, from roi.py:crop_split.
// The wrapper refuses a shape whose shared memory (crop_smem_bytes) passes
// what a CTA can opt into.  Returns the launch's CUDA error.
extern "C" int crop_resize_launch(const void* images, const void* rois,
                                  int B, int R, int H, int W, int ch, int C,
                                  int rows, int threads, void* out,
                                  void* stream) {
  if (rows < 1 || threads < 32 || threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = crop_smem_bytes(C, ch, rows);
  if (smem > kDefaultSmem) {
    // once per device, opt into all the shared memory a CTA can have
    static bool opted[kMaxDevices] = {};
    int dev = 0, most = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
    if (!opted[dev]) {
      err = cudaDeviceGetAttribute(
          &most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(
            crop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
      if (err != cudaSuccess) return static_cast<int>(err);
      opted[dev] = true;
    }
  }
  const dim3 grid(static_cast<unsigned>(B) * static_cast<unsigned>(R),
                  (C + rows - 1) / rows);
  crop_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(images), static_cast<const float4*>(rois), R,
      H, W, ch, C, rows, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// boxes (N, 4) f32 contiguous on 16 bytes; rois f32 with unit stride
// along their last dim, read at rois + sum_d index_d * stride_d for a box
// of leading indices index_0.. (row-major over the boxes); layout holds
// kMaxRank sizes, then kMaxRank strides in floats (0 along a broadcast
// dim), of which the first `rank` count; out (N, 4) f32.  C, W, H are the
// crop size and the parent frame's bounds, as float32.  Returns the
// launch's CUDA error.
extern "C" int uncrop_boxes_launch(const void* boxes, const void* rois,
                                   int N, int rank, const long long* layout,
                                   float C, float W, float H, void* out,
                                   void* stream) {
  if (rank < 0 || rank > kMaxRank)
    return static_cast<int>(cudaErrorInvalidValue);
  RoiLayout L;
  L.rank = rank;
  for (int d = 0; d < kMaxRank; ++d) {
    L.size[d] = d < rank ? static_cast<int>(layout[d]) : 1;
    L.stride[d] = d < rank ? layout[kMaxRank + d] : 0;
  }
  const int grid = (N + kUncropThreads - 1) / kUncropThreads;
  uncrop_kernel<<<grid, kUncropThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(rois), L,
      N, C, W, H, static_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}
