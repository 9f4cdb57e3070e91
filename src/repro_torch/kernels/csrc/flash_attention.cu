// Blocked prefill attention with an online softmax, one CTA per (batch,
// head, query tile), float32 on the CUDA cores.
//
// Replaces the JAX package's kernels/flash_attention.py:flash_attention
// (_flash_kernel).  A CTA holds kBlockQ = 64 query rows, scaled by
// `scale` as they are loaded (the reference scales q before the dot), and
// streams K/V in tiles of kBlockK = 64 rows through shared memory.  Warp
// w owns rows 8w .. 8w + 7; lane x computes the scores of keys x and
// x + 32 for those rows, and owns output columns x, x + 32, ... of them.
// Per tile and row, in float32:
//   m_new = max(m, max_j s);  p = exp(s - m_new);  corr = exp(m - m_new)
//   l     = l * corr + sum_j p;  acc = acc * corr + p . V
//   out   = acc / max(l, 1e-30)                       in q's type
// with m starting at the reference's NEG_INF = -1e30 and expf.
//
// Causal masking is aligned to the bottom right (key s is seen by query t
// when s <= t + S - T).  As in the reference, a query tile skips the key
// tiles right of its last row's diagonal; inside a tile a key that is not
// seen gets p = 0 exactly (the reference's exp(-1e30 - m)).  A query row
// that sees no key at all (t < T - S) keeps l = 0 and acc = 0 and so
// writes 0, as the reference kernel does when it skips all of that row's
// key blocks.
//
// Shared memory: q (64 x D), K (64 x (D + 1), padded so a warp reading 32
// key rows at one d hits 32 banks), V (64 x D) and the probabilities
// (64 x 64): 113 KB at D = 128, above the 48 KB default, so the launcher
// raises the kernel's dynamic shared-memory limit with
// cudaFuncSetAttribute (and 2 CTAs fit an SM).
//
// Bound on the card: 4 D flops per (query, seen key) pair against 4 D
// values of input and output per query row, so prefill at T = S = 2048 is
// bound by operations.  This design does them as scalar float32 multiplies
// and adds (no tensor cores, and -fmad=false keeps them unfused), reading
// both operands from shared memory; wgmma on bf16 tiles is the redesign.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr int kRows = kBlockQ / (kThreads / 32);  // query rows a warp owns
constexpr float kNegInf = -1e30f;

size_t smem_bytes(int D) {
  return sizeof(float) * (static_cast<size_t>(kBlockQ) * D +
                          static_cast<size_t>(kBlockK) * (D + 1) +
                          static_cast<size_t>(kBlockK) * D +
                          static_cast<size_t>(kBlockQ) * kBlockK);
}

// NC = ceil(D / 32) output columns a lane owns, D <= 32 * NC
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, int T_len, int S, int D, float scale,
             int causal, T* __restrict__ out) {
  extern __shared__ float sm[];
  float* q_s = sm;
  float* k_s = q_s + kBlockQ * D;
  float* v_s = k_s + kBlockK * (D + 1);
  float* p_s = v_s + kBlockK * D;

  // heaviest causal tiles first: block x takes query tile (last - x)
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int q0 = qt * kBlockQ;
  const size_t bh = static_cast<size_t>(blockIdx.z) * gridDim.y + blockIdx.y;
  const T* qp = q + (bh * T_len + q0) * D;
  const T* kp = k + bh * S * D;
  const T* vp = v + bh * S * D;
  T* op = out + (bh * T_len + q0) * D;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = warp * kRows;
  const int offset = S - T_len;

  for (int e = tid; e < kBlockQ * D; e += kThreads)
    q_s[e] = to_f32(qp[e]) * scale;

  float m[kRows], l[kRows], acc[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.0f;
  }

  int n_tiles = S / kBlockK;
  if (causal) {
    const int last = q0 + kBlockQ - 1 + offset;  // last row's position
    n_tiles = last < 0 ? 0 : min(n_tiles, last / kBlockK + 1);
  }
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // the previous tile is consumed; q is loaded
    for (int e = tid; e < kBlockK * D; e += kThreads) {
      const int row = e / D;
      const int d = e - row * D;
      k_s[row * (D + 1) + d] = to_f32(kp[static_cast<size_t>(k0) * D + e]);
      v_s[e] = to_f32(vp[static_cast<size_t>(k0) * D + e]);
    }
    __syncthreads();

    float s[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r][0] = s[r][1] = 0.0f;
    const float* ka = k_s + lane * (D + 1);
    const float* kb = k_s + (lane + 32) * (D + 1);
    for (int d = 0; d < D; ++d) {
      const float x0 = ka[d];
      const float x1 = kb[d];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float qv = q_s[(row0 + r) * D + d];
        s[r][0] = s[r][0] + qv * x0;
        s[r][1] = s[r][1] + qv * x1;
      }
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = q0 + row0 + r + offset;
      const bool seen0 = !causal || k0 + lane <= qpos;
      const bool seen1 = !causal || k0 + lane + 32 <= qpos;
      const float tile_max = warp_max(fmaxf(seen0 ? s[r][0] : kNegInf,
                                            seen1 ? s[r][1] : kNegInf));
      const float m_new = fmaxf(m[r], tile_max);
      const float p0 = seen0 ? expf(s[r][0] - m_new) : 0.0f;
      const float p1 = seen1 ? expf(s[r][1] - m_new) : 0.0f;
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(p0 + p1);
      m[r] = m_new;
      p_s[(row0 + r) * kBlockK + lane] = p0;
      p_s[(row0 + r) * kBlockK + lane + 32] = p1;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] = acc[r][c] * corr;
    }
    __syncwarp();  // a warp reads only its own rows of p_s

    for (int j = 0; j < kBlockK; ++j) {
      float vj[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = lane + 32 * c;
        vj[c] = d < D ? v_s[j * D + d] : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float p = p_s[(row0 + r) * kBlockK + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = acc[r][c] + p * vj[c];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < D)
        op[static_cast<size_t>(row0 + r) * D + d] =
            from_f32<T>(acc[r][c] / den);
    }
  }
}

template <typename T, int NC>
cudaError_t launch(const void* q, const void* k, const void* v, int B,
                   int H, int T_len, int S, int D, float scale, int causal,
                   void* out, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(T_len / kBlockQ, H, B);
  flash_kernel<T, NC><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), T_len, S, D, scale, causal,
      static_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, int B,
                     int H, int T_len, int S, int D, float scale, int causal,
                     void* out, cudaStream_t stream) {
  if (D <= 32)
    return launch<T, 1>(q, k, v, B, H, T_len, S, D, scale, causal, out,
                        stream);
  if (D <= 64)
    return launch<T, 2>(q, k, v, B, H, T_len, S, D, scale, causal, out,
                        stream);
  if (D <= 128)
    return launch<T, 4>(q, k, v, B, H, T_len, S, D, scale, causal, out,
                        stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q (B, H, T, D), k and v (B, H, S, D) contiguous, all f32 (dtype 0) or
// all bf16 (dtype 1); T and S multiples of 128, D <= 128; out (B, H, T, D)
// in the same type.  Returns the CUDA error of the attribute call or the
// launch.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, int B, int H, int T,
                                      int S, int D, float scale, int causal,
                                      int dtype, void* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_d<float>(q, k, v, B, H, T, S, D, scale, causal, out, st);
  else if (dtype == 1)
    err = launch_d<__nv_bfloat16>(q, k, v, B, H, T, S, D, scale, causal, out,
                                  st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
