// RWKV-6 recurrence, one CTA per (batch, head).
//
// Replaces the JAX package's kernels/rwkv_scan.py:rwkv_scan
// (_rwkv_kernel).  That kernel keeps the (hs, hs) float32 state in a VMEM
// scratch across a sequential grid of T-chunks.  Here one CTA walks the
// whole sequence of its (b, h) and the state never leaves the SM: thread
// j keeps column S[:, j] in registers (hs floats).  Each chunk of kChunk
// steps of r, k, v, w (contiguous in memory) is staged in shared memory
// as float32, and then, for every step,
//   kv_i   = k_i * v_j
//   out_j  = sum_i r_i * (S_ij + u_i * kv_i)        (i in order)
//   S_ij  <- w_i * S_ij + kv_i
// which is the reference's per-step operation order; only the order of
// the sum over i may differ from the reference's reduction.  out is
// written in the inputs' type (__float2bfloat16_rn for bf16, as
// tensor.to(torch.bfloat16) rounds) and the final state in float32.  The
// state is never rounded between chunks.
//
// Bound on the card: 7 flops per state element per step against 4 input
// and 1 output values per head column per step, so it is bound by
// operations at hs = 64 (hs flops per byte read); the design is latency-
// bound first: one CTA of hs threads per (b, h), a serial chain of T
// steps, and shared-memory broadcasts of r_i, k_i, w_i, u_i for every
// state element.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kChunk = 16;

template <typename T, int MAXHS>
__global__ void __launch_bounds__(MAXHS)
rwkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            int H, int Tn, int hs, T* __restrict__ out,
            float* __restrict__ s_final) {
  __shared__ float r_s[kChunk][MAXHS];
  __shared__ float k_s[kChunk][MAXHS];
  __shared__ float v_s[kChunk][MAXHS];
  __shared__ float w_s[kChunk][MAXHS];
  __shared__ float u_s[MAXHS];
  const int bh = blockIdx.x;
  const int h = bh % H;
  const int j = threadIdx.x;
  const bool mine = j < hs;
  const size_t seq = static_cast<size_t>(bh) * Tn * hs;
  const float* S0 = s0 + static_cast<size_t>(bh) * hs * hs;

  float s[MAXHS];
#pragma unroll
  for (int i = 0; i < MAXHS; ++i)
    s[i] = (mine && i < hs) ? S0[static_cast<size_t>(i) * hs + j] : 0.0f;
  if (mine) u_s[j] = u[static_cast<size_t>(h) * hs + j];

  for (int t0 = 0; t0 < Tn; t0 += kChunk) {
    const int n = min(kChunk, Tn - t0);
    __syncthreads();  // the previous chunk is consumed
    for (int e = j; e < n * hs; e += blockDim.x) {
      const int t = e / hs;
      const int i = e - t * hs;
      const size_t g = seq + static_cast<size_t>(t0) * hs + e;
      r_s[t][i] = to_f32(r[g]);
      k_s[t][i] = to_f32(k[g]);
      v_s[t][i] = to_f32(v[g]);
      w_s[t][i] = to_f32(w[g]);
    }
    __syncthreads();
    if (!mine) continue;
    for (int t = 0; t < n; ++t) {
      const float vj = v_s[t][j];
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < MAXHS; ++i) {
        if (i < hs) {
          const float kv = k_s[t][i] * vj;
          const float term = s[i] + u_s[i] * kv;
          acc = acc + r_s[t][i] * term;
          s[i] = w_s[t][i] * s[i] + kv;
        }
      }
      out[seq + static_cast<size_t>(t0 + t) * hs + j] = from_f32<T>(acc);
    }
  }
  if (mine) {
    float* SF = s_final + static_cast<size_t>(bh) * hs * hs;
#pragma unroll
    for (int i = 0; i < MAXHS; ++i)
      if (i < hs) SF[static_cast<size_t>(i) * hs + j] = s[i];
  }
}

template <typename T, int MAXHS>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* w, const void* u, const void* s0, int B,
                   int H, int Tn, int hs, void* out, void* s_final,
                   cudaStream_t stream) {
  rwkv_kernel<T, MAXHS><<<B * H, MAXHS, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0), H, Tn, hs,
      static_cast<T*>(out), static_cast<float*>(s_final));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hs(const void* r, const void* k, const void* v,
                      const void* w, const void* u, const void* s0, int B,
                      int H, int Tn, int hs, void* out, void* s_final,
                      cudaStream_t stream) {
  if (hs <= 32)
    return launch<T, 32>(r, k, v, w, u, s0, B, H, Tn, hs, out, s_final,
                         stream);
  if (hs <= 64)
    return launch<T, 64>(r, k, v, w, u, s0, B, H, Tn, hs, out, s_final,
                         stream);
  if (hs <= 128)
    return launch<T, 128>(r, k, v, w, u, s0, B, H, Tn, hs, out, s_final,
                          stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// r, k, v, w (B, H, T, hs) contiguous, all f32 (dtype 0) or all bf16
// (dtype 1); u (H, hs) and s0 (B, H, hs, hs) f32 contiguous; out (B, H, T,
// hs) in the inputs' type, s_final (B, H, hs, hs) f32.  hs <= 128.
// Returns the launch's CUDA error.
extern "C" int rwkv_scan_launch(const void* r, const void* k, const void* v,
                                const void* w, const void* u, const void* s0,
                                int B, int H, int T, int hs, int dtype,
                                void* out, void* s_final, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_hs<float>(r, k, v, w, u, s0, B, H, T, hs, out, s_final, st);
  else if (dtype == 1)
    err = launch_hs<__nv_bfloat16>(r, k, v, w, u, s0, B, H, T, hs, out,
                                   s_final, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
