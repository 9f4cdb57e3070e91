// RWKV-6 recurrence, the state spread over the SMs.
//
// Replaces the JAX package's kernels/rwkv_scan.py:rwkv_scan
// (_rwkv_kernel).  That kernel keeps the (hs, hs) float32 state in a VMEM
// scratch across a sequential grid of T-chunks.  Per (batch, head) and
// step t, with state rows i and columns j,
//   kv_ij  = k_i * v_j
//   out_j  = sum_i r_i * (S_ij + u_i * kv_ij)
//   S_ij  <- w_i * S_ij + kv_ij
// Every state element updates on its own (S_ij needs only w_i, k_i, v_j);
// only out_j sums over i.  So the state is cut, by the shape alone
// (rwkv_scan.py:scan_split): one CTA per (b, h, block of `cols` columns)
// walks the whole sequence, and its thread (column j, slice of kRows = 8
// rows) keeps that strip of S, and the strip's u_i, in registers for all
// T steps.  The state never leaves the SM and is never rounded: float32
// from s0 to s_final, each element updated in the per-step order above
// (-fmad=false: kv, u * kv, S + u kv, r * (..), w * S and + kv are each
// rounded once), so it equals the plain version's bit for bit.
//
// Each chunk of kChunk = 16 steps of r, k and w (all rows) and of v (the
// CTA's columns) is staged in shared memory as float32, with 16-byte
// loads where hs allows (hs % 16 == 0 and aligned rows), so that all of a
// thread's loads of a chunk are in flight at once; a warp's threads cover
// two slices, so each reads r_i, k_i and w_i of its slice as float4
// broadcasts and v_j from its own column.  A thread sums its slice's
// terms in row order into one partial of out_j a step and stores it; once
// the chunk is done the partials of each (step, column) are added in
// slice order 0, 1, ... and written in the inputs' type
// (__float2bfloat16_rn for bf16, as tensor.to(torch.bfloat16) rounds).
// That order depends on hs alone, so the bf16 instance does the float32
// instance's arithmetic on widened inputs; only the order of the sum over
// i differs from the plain version's (within 2e-5).
//
// Bound on the card: 7 float32 operations per state element per step
// (the inputs' type does not change that) against 4 input and 1 output
// values per head row per step, so it is bound by operations at hs = 64:
// 7 B H T hs^2 at 67 TFLOP/s.  What holds it back is latency: the time
// follows the warps resident at once, and each CTA stops at every chunk
// for its staging loads.  So rwkv6-3b (B = 4, H = 40, hs = 64) runs
// 4 column blocks x 160 (b, h) = 640 CTAs of 4 warps, all resident on 132
// SMs, 5 an SM (a build whose registers left room for 4 ran in two waves
// and took twice as long), each thread with 8 independent state chains.
// The first port ran 160 CTAs of 2 warps with one serial chain of 64 a
// thread.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kRows = 8;        // state rows a thread keeps (a slice)
constexpr int kChunk = 16;      // steps staged a time
constexpr int kMaxThreads = 512;

__host__ __device__ inline int n_slices(int hs) {
  return (hs + kRows - 1) / kRows;
}

__host__ inline size_t smem_bytes(int hs, int cols) {
  const int ns = n_slices(hs);
  return sizeof(float) * kChunk *
         (3 * static_cast<size_t>(ns) * kRows + cols + ns * cols);
}

// the float32 values of 16 bytes of T
__device__ __forceinline__ void widen(uint4 x, float* out, float) {
  *reinterpret_cast<uint4*>(out) = x;
}
__device__ __forceinline__ void widen(uint4 x, float* out, __nv_bfloat16) {
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&x);
  float4 a, b;
  a.x = __bfloat162float(h[0]); a.y = __bfloat162float(h[1]);
  a.z = __bfloat162float(h[2]); a.w = __bfloat162float(h[3]);
  b.x = __bfloat162float(h[4]); b.y = __bfloat162float(h[5]);
  b.z = __bfloat162float(h[6]); b.w = __bfloat162float(h[7]);
  reinterpret_cast<float4*>(out)[0] = a;
  reinterpret_cast<float4*>(out)[1] = b;
}

// one step of a thread's strip: its partial of out_j, and the strip
// updated, each element in the plain version's operation order
__device__ __forceinline__ float step_strip(const float* r_s,
                                            const float* k_s,
                                            const float* w_s, float vj,
                                            float (&s)[kRows],
                                            const float (&uu)[kRows],
                                            int nrows) {
  const float4 r0 = *reinterpret_cast<const float4*>(r_s);
  const float4 r1 = *reinterpret_cast<const float4*>(r_s + 4);
  const float4 k0 = *reinterpret_cast<const float4*>(k_s);
  const float4 k1 = *reinterpret_cast<const float4*>(k_s + 4);
  const float4 w0 = *reinterpret_cast<const float4*>(w_s);
  const float4 w1 = *reinterpret_cast<const float4*>(w_s + 4);
  const float rr[kRows] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
  const float kk[kRows] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
  const float ww[kRows] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
  float acc = 0.0f;
#pragma unroll
  for (int ii = 0; ii < kRows; ++ii) {
    if (ii < nrows) {
      const float kv = kk[ii] * vj;
      const float term = s[ii] + uu[ii] * kv;
      acc = acc + rr[ii] * term;
      s[ii] = ww[ii] * s[ii] + kv;
    }
  }
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
rwkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            int H, int Tn, int hs, int cols, int wide, T* __restrict__ out,
            float* __restrict__ s_final) {
  extern __shared__ __align__(16) float smem[];
  const int ns = n_slices(hs);
  const int hsp = ns * kRows;              // rows, padded to whole slices
  float* r_s = smem;                       // [kChunk][hsp]
  float* k_s = r_s + kChunk * hsp;         // [kChunk][hsp]
  float* w_s = k_s + kChunk * hsp;         // [kChunk][hsp]
  float* v_s = w_s + kChunk * hsp;         // [kChunk][cols]
  float* part = v_s + kChunk * cols;       // [kChunk][ns][cols]

  const int n_blocks = (hs + cols - 1) / cols;
  const int bh = blockIdx.x / n_blocks;
  const int j0 = (blockIdx.x % n_blocks) * cols;
  const int h = bh % H;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int c = tid % cols;
  const int sl = tid / cols;
  const int j = j0 + c;
  const int i0 = sl * kRows;
  const int nrows = min(kRows, hs - i0);
  const bool mine = j < hs;
  const size_t seq = static_cast<size_t>(bh) * Tn * hs;
  const float* S0 = s0 + static_cast<size_t>(bh) * hs * hs;

  float s[kRows], uu[kRows];
#pragma unroll
  for (int ii = 0; ii < kRows; ++ii) {
    s[ii] = (mine && ii < nrows) ? S0[static_cast<size_t>(i0 + ii) * hs + j]
                                 : 0.0f;
    uu[ii] = ii < nrows ? u[static_cast<size_t>(h) * hs + i0 + ii] : 0.0f;
  }

  constexpr int kVec = 16 / sizeof(T);     // elements in 16 bytes
  for (int t0 = 0; t0 < Tn; t0 += kChunk) {
    const int n = min(kChunk, Tn - t0);
    const size_t g0 = seq + static_cast<size_t>(t0) * hs;
    // stage the chunk; the previous chunk's partials are merged below
    // before the next sync, and nothing here writes them
    if (wide) {
      // hs % 16 == 0 (so hsp == hs), 16-byte aligned rows, full column
      // blocks: each thread has its 16-byte loads of r, k, w and v in
      // flight together before it stores any
      const int nv = n * hs / kVec;
      const uint4* r4 = reinterpret_cast<const uint4*>(r + g0);
      const uint4* k4 = reinterpret_cast<const uint4*>(k + g0);
      const uint4* w4 = reinterpret_cast<const uint4*>(w + g0);
      for (int q = tid; q < nv; q += nthr) {
        const uint4 a = r4[q], b = k4[q], d = w4[q];
        widen(a, r_s + q * kVec, T());
        widen(b, k_s + q * kVec, T());
        widen(d, w_s + q * kVec, T());
      }
      const int per_step = cols / kVec;
      for (int q = tid; q < n * per_step; q += nthr) {
        const int t = q / per_step;
        const int m = q - t * per_step;
        widen(*reinterpret_cast<const uint4*>(
                  v + g0 + static_cast<size_t>(t) * hs + j0 + m * kVec),
              v_s + t * cols + m * kVec, T());
      }
    } else {
      for (int e = tid, t = tid / hs, i = tid % hs; e < n * hs; e += nthr) {
        const int a = t * hsp + i;
        r_s[a] = to_f32(r[g0 + e]);
        k_s[a] = to_f32(k[g0 + e]);
        w_s[a] = to_f32(w[g0 + e]);
        for (i += nthr; i >= hs; i -= hs) ++t;
      }
      for (int e = tid; e < n * cols; e += nthr) {
        const int t = e / cols;
        const int jj = j0 + e - t * cols;
        v_s[e] = jj < hs ? to_f32(v[g0 + static_cast<size_t>(t) * hs + jj])
                         : 0.0f;
      }
    }
    __syncthreads();
    if (mine) {
      for (int t = 0; t < n; ++t) {
        const int a = t * hsp + i0;
        part[(t * ns + sl) * cols + c] = step_strip(
            r_s + a, k_s + a, w_s + a, v_s[t * cols + c], s, uu, nrows);
      }
    }
    __syncthreads();
    // out_j of each step: the slices' partials in slice order
    for (int e = tid; e < n * cols; e += nthr) {
      const int t = e / cols;
      const int cc = e - t * cols;
      if (j0 + cc >= hs) continue;
      const float* p = part + t * ns * cols + cc;
      float o = p[0];
      for (int q = 1; q < ns; ++q) o = o + p[q * cols];
      out[g0 + static_cast<size_t>(t) * hs + j0 + cc] = from_f32<T>(o);
    }
  }
  if (mine) {
    float* SF = s_final + static_cast<size_t>(bh) * hs * hs;
#pragma unroll
    for (int ii = 0; ii < kRows; ++ii)
      if (ii < nrows) SF[static_cast<size_t>(i0 + ii) * hs + j] = s[ii];
  }
}

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* w, const void* u, const void* s0, int B,
                   int H, int Tn, int hs, int cols, void* out,
                   void* s_final, cudaStream_t stream) {
  const size_t smem = smem_bytes(hs, cols);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rwkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int grid = B * H * ((hs + cols - 1) / cols);
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int wide = hs % 16 == 0 && (cols * sizeof(T)) % 16 == 0 &&
                   hs % cols == 0 && aligned(r) && aligned(k) &&
                   aligned(v) && aligned(w);
  rwkv_kernel<T><<<grid, cols * n_slices(hs), smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0), H, Tn, hs,
      cols, wide, static_cast<T*>(out), static_cast<float*>(s_final));
  return cudaGetLastError();
}

}  // namespace

// r, k, v, w (B, H, T, hs) contiguous, all f32 (dtype 0) or all bf16
// (dtype 1); u (H, hs) and s0 (B, H, hs, hs) f32 contiguous; out (B, H, T,
// hs) in the inputs' type, s_final (B, H, hs, hs) f32.  The split comes
// from rwkv_scan.py:scan_split: `cols` columns a CTA, `rows` (= 8) rows a
// thread, at most 512 threads a CTA.  Returns the launch's CUDA error.
extern "C" int rwkv_scan_launch(const void* r, const void* k, const void* v,
                                const void* w, const void* u, const void* s0,
                                int B, int H, int T, int hs, int cols,
                                int rows, int dtype, void* out, void* s_final,
                                void* stream) {
  if (rows != kRows || cols < 1 || hs < 1 ||
      cols * n_slices(hs) > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(r, k, v, w, u, s0, B, H, T, hs, cols, out, s_final,
                        st);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(r, k, v, w, u, s0, B, H, T, hs, cols, out,
                                s_final, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
