// GQA single-token decode attention, one CTA per (batch, kv head).
//
// Replaces the JAX package's kernels/decode_attention.py:decode_attention
// (_decode_kernel).  As there, the G = H / KV query heads that share a kv
// head form one (G, D) tile, so each K/V row loaded from device memory
// serves all G heads and the GQA repeat never materializes; the cache
// streams through shared memory in tiles of kTileS rows with an online
// softmax in float32:
//   s      = (q * scale) . k_j                       (G x kTileS)
//   m_new  = max(m, max_j s);  p = exp(s - m_new);  corr = exp(m - m_new)
//   l      = l * corr + sum_j p
//   acc    = acc * corr + p . V
//   out    = acc / max(l, 1e-30)                      in q's type
// with m starting at the reference's NEG_INF = -1e30 and expf (not the
// approximate __expf).  There is no length mask: every one of the S cache
// rows is attended, as in the reference.  The tile is 32 rows instead of
// the reference's 512, so the softmax is rescaled at other points; the
// result agrees to rounding (float32 tolerance 2e-5).
//
// Shared memory holds q (G x D), one K and one V tile (K padded to D + 1
// floats a row so that a warp reading 32 rows at one d hits 32 banks),
// the G x 32 probabilities and the G x D accumulator: about 69 KB at
// G = 32, D = 128, above the 48 KB default, so the launcher raises the
// kernel's dynamic shared-memory limit with cudaFuncSetAttribute.
//
// Bound on the card: 4 D flops per cache row and query head against 2 D
// values read per cache row and kv head, so at G <= 16 decode is bound by
// the bytes of the cache.  This simple design puts one CTA on each
// (b, kv head) -- 32 CTAs at B = 4, KV = 8 on 132 SMs -- with scalar
// loads and four barriers per tile, so it reaches a fraction of the
// card's bandwidth; splitting S across CTAs is the redesign's first step.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kTileS = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

size_t smem_floats(int G, int D) {
  return static_cast<size_t>(G) * D          // q
         + static_cast<size_t>(kTileS) * (D + 1)  // k tile
         + static_cast<size_t>(kTileS) * D   // v tile
         + static_cast<size_t>(G) * kTileS   // p
         + static_cast<size_t>(G) * D        // acc
         + 3 * static_cast<size_t>(G);       // m, l, corr
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, int KV, int S, int D, int G,
              float scale, T* __restrict__ out) {
  extern __shared__ float sm[];
  float* q_s = sm;
  float* k_s = q_s + G * D;
  float* v_s = k_s + kTileS * (D + 1);
  float* p_s = v_s + kTileS * D;
  float* acc_s = p_s + G * kTileS;
  float* m_s = acc_s + G * D;
  float* l_s = m_s + G;
  float* c_s = l_s + G;

  const int b = blockIdx.x / KV;
  const int kv = blockIdx.x % KV;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int GD = G * D;
  // q (B, H, D): heads kv*G .. kv*G + G - 1 are GD contiguous values
  const size_t q_off = (static_cast<size_t>(b) * KV + kv) * GD;
  for (int e = tid; e < GD; e += kThreads) {
    q_s[e] = to_f32(q[q_off + e]) * scale;
    acc_s[e] = 0.0f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.0f;
  }
  const size_t row_stride = static_cast<size_t>(KV) * D;
  const size_t kv_off = static_cast<size_t>(b) * S * row_stride +
                        static_cast<size_t>(kv) * D;

  for (int j0 = 0; j0 < S; j0 += kTileS) {
    const int n = min(kTileS, S - j0);
    __syncthreads();  // the previous tile is consumed; q, m, l are set
    for (int e = tid; e < n * D; e += kThreads) {
      const int row = e / D;
      const int d = e - row * D;
      const size_t gi = kv_off + (j0 + row) * row_stride + d;
      k_s[row * (D + 1) + d] = to_f32(k[gi]);
      v_s[row * D + d] = to_f32(v[gi]);
    }
    __syncthreads();
    for (int e = tid; e < G * n; e += kThreads) {
      const int g = e / n;
      const int j = e - g * n;
      const float* qg = q_s + g * D;
      const float* kj = k_s + j * (D + 1);
      float s = 0.0f;
      for (int d = 0; d < D; ++d) s = s + qg[d] * kj[d];
      p_s[g * kTileS + j] = s;
    }
    __syncthreads();
    for (int g = warp; g < G; g += kWarps) {
      const float s = lane < n ? p_s[g * kTileS + lane] : kNegInf;
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float p = lane < n ? expf(s - m_new) : 0.0f;
      p_s[g * kTileS + lane] = p;
      const float psum = warp_sum(p);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        l_s[g] = l_s[g] * corr + psum;
        c_s[g] = corr;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    for (int e = tid; e < GD; e += kThreads) {
      const int g = e / D;
      const int d = e - g * D;
      const float* pg = p_s + g * kTileS;
      float pv = 0.0f;
      for (int j = 0; j < n; ++j) pv = pv + pg[j] * v_s[j * D + d];
      acc_s[e] = acc_s[e] * c_s[g] + pv;
    }
  }
  __syncthreads();
  for (int e = tid; e < GD; e += kThreads) {
    const float l = fmaxf(l_s[e / D], 1e-30f);
    out[q_off + e] = from_f32<T>(acc_s[e] / l);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, int B,
                   int KV, int S, int D, int G, float scale, void* out,
                   cudaStream_t stream) {
  const size_t smem = smem_floats(G, D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  decode_kernel<T><<<B * KV, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), KV, S, D, G, scale, static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

// q (B, H, D), k and v (B, S, KV, D) contiguous, all f32 (dtype 0) or all
// bf16 (dtype 1), H a multiple of KV; out (B, H, D) in the same type.  A
// (G, D) tile that needs more shared memory than a CTA may have fails
// here and its error is returned.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, int B, int H, int KV,
                                       int S, int D, float scale, int dtype,
                                       void* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = H / KV;
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(q, k, v, B, KV, S, D, G, scale, out, st);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(q, k, v, B, KV, S, D, G, scale, out, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
