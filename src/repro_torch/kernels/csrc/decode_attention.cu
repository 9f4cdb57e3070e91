// GQA single-token decode attention, the cache split across CTAs
// ("flash-decoding"), one launch a call.
//
// Replaces the JAX package's kernels/decode_attention.py:decode_attention
// (_decode_kernel).  As there, the G = H / KV query heads that share a kv
// head read each K/V row once, and the GQA repeat never materializes.  In
// float32, with the reference's NEG_INF = -1e30 and expf (not __expf):
//   s      = (q * scale) . k_j
//   m_new  = max(m, max_j s);  p = exp(s - m_new);  corr = exp(m - m_new)
//   l      = l * corr + sum_j p;  acc = acc * corr + sum_j p v_j
//   out    = acc / max(l, 1e-30)                      in q's type, once
// There is no length mask: every one of the S cache rows is attended.
//
// Bound on the card: 4 D flops per cache row and query head against 2 D
// values read per cache row and kv head, so at G <= 16 decode is bound by
// the bytes of the cache, and float32 on the CUDA cores is enough.  The
// design is built to stream the cache at the card's rate:
//
// * Grid (B * KV * ceil(G / GC), n_split).  Split y takes cache rows
//   [y * rows, min((y + 1) * rows, S)); decode_attention.py:split_rows
//   picks n_split and rows from (B, KV, S, D) alone, so that about four
//   CTAs sit on each SM.  A CTA serves GC <= 8 query heads (more heads
//   read the cache once more per GC).
// * Lanes.  A lane owns the 8 values of d that one 16-byte bf16 vector
//   holds (d0 = 8 * (lane % LPR)); LPR = D / 8 rounded up to 4, 8, 16 or
//   32 lanes hold a row, so a warp takes RPW = 32 / LPR rows at once and
//   a 4-warp CTA a tile of 4 * RPW * kRows rows.  The float32 instance
//   loads the same 8 values as two 16-byte vectors: which lane owns
//   which d, the order of every sum and every shuffle, and so every
//   rounding, are fixed by the shape and never by the type.  That is
//   what makes the bf16 instance equal, bit for bit, the float32
//   instance on the inputs widened to float32 (chip_smoke's check).
// * Loads.  Each thread cp.async's the 16-byte vectors it will itself
//   consume into its own slots of a ring in shared memory (3 tiles deep
//   in bf16, 48 KB; 2 in f32, 64 KB), so the loop needs no barrier:
//   cp.async.wait_group alone orders a thread's copies before its reads.  Rows past the split's end and d
//   past D are zero-filled.  When D % 8 != 0 or a pointer is not 16-byte
//   aligned the same slots are filled by scalar loads instead.
// * Arithmetic.  q (scaled) and the accumulators of the GC heads stay in
//   registers.  Each lane group runs its own online softmax over the rows
//   it sees, kRows rows at a time (one rescale per kRows rows); q . k is
//   8 fused multiply-adds and a shuffle butterfly across the row's lanes.
//   The groups merge with shuffles, the warps through shared memory, once
//   per CTA, in a fixed order.
// * Combine.  Each split writes (m, l, acc[D]) in float32 to the scratch
//   the wrapper allocates; the CTA that takes the last ticket of its
//   (b, kv, head chunk) (an integer atomicAdd after __threadfence) merges
//   the splits in the order 0, 1, ..., writes the output and resets the
//   ticket to 0.  No float atomics: the result does not depend on which
//   CTA finishes first.
//
// Every sum is written with __fmaf_rn / __fmul_rn / __fadd_rn, so the
// compiler's contraction (this source is built without -fmad=false)
// cannot make the two instances round differently.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 4;       // rows a lane group takes per tile
constexpr int kVec = 8;        // d values a lane owns
constexpr float kNegInf = -1e30f;

// 16-byte vectors a lane's 8 values take: 1 (bf16) or 2 (f32)
template <typename T>
__host__ __device__ constexpr int n_vec() {
  return static_cast<int>(sizeof(T)) * kVec / 16;
}
// ring depth: 3 tiles of bf16 (48 KB), 2 of f32 (64 KB)
template <typename T>
__host__ __device__ constexpr int n_stages() {
  return sizeof(T) == 2 ? 3 : 2;
}

template <typename T>
constexpr size_t ring_bytes() {
  return static_cast<size_t>(n_stages<T>()) * kRows * 2 * n_vec<T>() *
         kThreads * 16;
}

template <int GC>
constexpr size_t merge_bytes(int DP) {
  return sizeof(float) * static_cast<size_t>(kWarps) * GC * (DP + 2);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// slot of (stage, row r of the group, tensor kv, vector h) of thread tid
__device__ __forceinline__ int slot(int stage, int r, int kv, int h, int nv,
                                    int tid) {
  return (((stage * kRows + r) * 2 + kv) * nv + h) * kThreads + tid;
}

template <typename T, int GC, int LPR>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, int H, int KV, int S, int D,
                    int G, float scale, int rows, int n_split, int vec,
                    float* __restrict__ part, int* __restrict__ tickets,
                    T* __restrict__ out) {
  constexpr int RPW = 32 / LPR;              // rows a warp takes at once
  constexpr int TILE = kWarps * RPW * kRows;  // rows a CTA takes a tile
  constexpr int NV = n_vec<T>();
  constexpr int STAGES = n_stages<T>();
  constexpr int DP = LPR * kVec;             // D rounded up
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* ring = reinterpret_cast<uint4*>(smem);

  const int n_gc = (G + GC - 1) / GC;
  const int x = blockIdx.x;
  const int chunk = x % n_gc;
  const int b = x / n_gc / KV;
  const int kvh = x / n_gc % KV;
  const int g0 = chunk * GC;                 // first head of the chunk
  const int n_heads = min(GC, G - g0);
  const int split = blockIdx.y;
  const int r0 = split * rows;
  const int r1 = min(r0 + rows, S);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int grp = lane / LPR;                // row group in the warp
  const int d0 = (lane % LPR) * kVec;
  const size_t row_stride = static_cast<size_t>(KV) * D;
  const size_t kv_off = static_cast<size_t>(b) * S * row_stride +
                        static_cast<size_t>(kvh) * D + d0;
  const size_t head0 = static_cast<size_t>(b) * H +
                       static_cast<size_t>(kvh) * G + g0;

  float qr[GC][kVec], acc[GC][kVec], m[GC], l[GC];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m[g] = kNegInf;
    l[g] = 0.0f;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const bool ok = g < n_heads && d0 + j < D;
      qr[g][j] = ok ? __fmul_rn(to_f32(q[(head0 + g) * D + d0 + j]), scale)
                    : 0.0f;
      acc[g][j] = 0.0f;
    }
  }

  const int n_tiles = (r1 - r0 + TILE - 1) / TILE;
  const int row_in_tile = warp * kRows * RPW + grp;
  auto issue = [&](int t) {
    const int stage = t % STAGES;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = r0 + t * TILE + row_in_tile + r * RPW;
      const bool ok = row < r1 && d0 < D;
      const size_t off = kv_off + static_cast<size_t>(row) * row_stride;
#pragma unroll
      for (int kv = 0; kv < 2; ++kv) {
        const T* base = kv == 0 ? k : v;
        const T* src = base + off;
        if (vec) {
          // a zero-filled vector reads nothing; it names the tensor's start
#pragma unroll
          for (int h = 0; h < NV; ++h)
            cp_async16(ring + slot(stage, r, kv, h, NV, tid),
                       ok ? src + h * (16 / sizeof(T)) : base, ok ? 16 : 0);
        } else {
          // scalar fill of the same slots; vector h holds values
          // h * (8 / NV) .. of the lane's 8
#pragma unroll
          for (int j = 0; j < kVec; ++j) {
            const int h = j / (kVec / NV);
            const int i = j % (kVec / NV);
            T* d = reinterpret_cast<T*>(ring + slot(stage, r, kv, h, NV,
                                                    tid)) + i;
            *d = (row < r1 && d0 + j < D) ? src[j] : from_f32<T>(0.0f);
          }
        }
      }
    }
  };
  auto load8 = [&](int stage, int r, int kv, float (&f)[kVec]) {
#pragma unroll
    for (int h = 0; h < NV; ++h) {
      const T* p = reinterpret_cast<const T*>(ring + slot(stage, r, kv, h,
                                                          NV, tid));
#pragma unroll
      for (int i = 0; i < kVec / NV; ++i)
        f[h * (kVec / NV) + i] = to_f32(p[i]);
    }
  };

#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < n_tiles) issue(t);
    cp_async_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    if (t + STAGES - 1 < n_tiles) issue(t + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    const int stage = t % STAGES;
    const int row_base = r0 + t * TILE + row_in_tile;

    float s[kRows][GC];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float kf[kVec];
      load8(stage, r, 0, kf);
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        float dot = 0.0f;
#pragma unroll
        for (int j = 0; j < kVec; ++j) dot = __fmaf_rn(qr[g][j], kf[j], dot);
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1)
          dot = __fadd_rn(dot, __shfl_xor_sync(0xffffffffu, dot, o));
        s[r][g] = dot;
      }
    }
    float p[kRows][GC];
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      float tile_max = kNegInf;
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (row_base + r * RPW < r1) tile_max = fmaxf(tile_max, s[r][g]);
      const float m_new = fmaxf(m[g], tile_max);
      const float corr = expf(m[g] - m_new);
      float psum = 0.0f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        p[r][g] = row_base + r * RPW < r1 ? expf(s[r][g] - m_new) : 0.0f;
        psum = __fadd_rn(psum, p[r][g]);
      }
      l[g] = __fadd_rn(__fmul_rn(l[g], corr), psum);
      m[g] = m_new;
#pragma unroll
      for (int j = 0; j < kVec; ++j) acc[g][j] = __fmul_rn(acc[g][j], corr);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float vf[kVec];
      load8(stage, r, 1, vf);
#pragma unroll
      for (int g = 0; g < GC; ++g)
#pragma unroll
        for (int j = 0; j < kVec; ++j)
          acc[g][j] = __fmaf_rn(p[r][g], vf[j], acc[g][j]);
    }
  }
  cp_async_wait<0>();

  // merge the warp's row groups: lanes lane ^ o (o >= LPR) hold the same
  // d for another group; fmul/fadd are commutative, so both lanes of a
  // pair compute the same bits
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], o);
      const float mm = fmaxf(m[g], mo);
      const float c_me = expf(m[g] - mm);
      const float c_ot = expf(mo - mm);
      l[g] = __fadd_rn(__fmul_rn(l[g], c_me), __fmul_rn(lo, c_ot));
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][j], o);
        acc[g][j] = __fadd_rn(__fmul_rn(acc[g][j], c_me),
                              __fmul_rn(ao, c_ot));
      }
      m[g] = mm;
    }
  }

  // merge the warps in the order 0, 1, ... through shared memory (the
  // ring is free: every copy has landed and every slot been read)
  __syncthreads();
  float* red_m = reinterpret_cast<float*>(smem);
  float* red_l = red_m + kWarps * GC;
  float* red_acc = red_l + kWarps * GC;      // [warp][g][DP]
  if (grp == 0) {
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      if (lane == 0) {
        red_m[warp * GC + g] = m[g];
        red_l[warp * GC + g] = l[g];
      }
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        red_acc[(warp * GC + g) * DP + d0 + j] = acc[g][j];
    }
  }
  __syncthreads();
  float* my_part = part + (head0 * n_split + split) * (D + 2);
  const size_t head_stride = static_cast<size_t>(n_split) * (D + 2);
  for (int e = tid; e < n_heads * D; e += kThreads) {
    const int g = e / D;
    const int d = e - g * D;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, red_m[w * GC + g]);
    float ls = 0.0f, as = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(red_m[w * GC + g] - mm);
      ls = __fadd_rn(ls, __fmul_rn(red_l[w * GC + g], c));
      as = __fadd_rn(as, __fmul_rn(red_acc[(w * GC + g) * DP + d], c));
    }
    float* hp = my_part + g * head_stride;
    if (d == 0) {
      hp[0] = mm;
      hp[1] = ls;
    }
    hp[2 + d] = as;
  }

  // the last split of this (b, kv, head chunk) to finish merges them all
  __threadfence();
  __syncthreads();
  __shared__ int is_last;
  if (tid == 0) is_last = atomicAdd(tickets + x, 1) == n_split - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const float* hp0 = part + head0 * head_stride;
  for (int e = tid; e < n_heads * D; e += kThreads) {
    const int g = e / D;
    const int d = e - g * D;
    const float* hp = hp0 + g * head_stride;
    float mm = kNegInf;
    for (int i = 0; i < n_split; ++i)
      mm = fmaxf(mm, __ldcg(hp + i * (D + 2)));
    float ls = 0.0f, as = 0.0f;
    for (int i = 0; i < n_split; ++i) {
      const float* pi = hp + i * (D + 2);
      const float c = expf(__ldcg(pi) - mm);
      ls = __fadd_rn(ls, __fmul_rn(__ldcg(pi + 1), c));
      as = __fadd_rn(as, __fmul_rn(__ldcg(pi + 2 + d), c));
    }
    out[(head0 + g) * D + d] = from_f32<T>(as / fmaxf(ls, 1e-30f));
  }
  if (tid == 0) tickets[x] = 0;
}

template <typename T, int GC, int LPR>
cudaError_t launch(const void* q, const void* k, const void* v, int B,
                   int H, int KV, int S, int D, float scale, int rows,
                   int n_split, void* part, void* tickets, void* out,
                   cudaStream_t stream) {
  const int G = H / KV;
  const size_t smem = ring_bytes<T>() > merge_bytes<GC>(LPR * kVec)
                          ? ring_bytes<T>()
                          : merge_bytes<GC>(LPR * kVec);
  // 48 KB of ring and the ticket flag pass the default limit
  const cudaError_t err = cudaFuncSetAttribute(
      decode_split_kernel<T, GC, LPR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec = D % kVec == 0 && aligned(k) && aligned(v);
  const dim3 grid(B * KV * ((G + GC - 1) / GC), n_split);
  decode_split_kernel<T, GC, LPR><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), H, KV, S, D, G, scale, rows, n_split, vec,
      static_cast<float*>(part), static_cast<int*>(tickets),
      static_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T, int GC>
cudaError_t launch_lpr(const void* q, const void* k, const void* v, int B,
                       int H, int KV, int S, int D, float scale, int rows,
                       int n_split, void* part, void* tickets, void* out,
                       cudaStream_t st) {
  if (D <= 32)
    return launch<T, GC, 4>(q, k, v, B, H, KV, S, D, scale, rows, n_split,
                            part, tickets, out, st);
  if (D <= 64)
    return launch<T, GC, 8>(q, k, v, B, H, KV, S, D, scale, rows, n_split,
                            part, tickets, out, st);
  if (D <= 128)
    return launch<T, GC, 16>(q, k, v, B, H, KV, S, D, scale, rows, n_split,
                             part, tickets, out, st);
  if (D <= 256)
    return launch<T, GC, 32>(q, k, v, B, H, KV, S, D, scale, rows, n_split,
                             part, tickets, out, st);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_g(const void* q, const void* k, const void* v, int B,
                     int H, int KV, int S, int D, float scale, int rows,
                     int n_split, void* part, void* tickets, void* out,
                     cudaStream_t st) {
  const int G = H / KV;
  if (G <= 1)
    return launch_lpr<T, 1>(q, k, v, B, H, KV, S, D, scale, rows, n_split,
                            part, tickets, out, st);
  if (G <= 2)
    return launch_lpr<T, 2>(q, k, v, B, H, KV, S, D, scale, rows, n_split,
                            part, tickets, out, st);
  if (G <= 4)
    return launch_lpr<T, 4>(q, k, v, B, H, KV, S, D, scale, rows, n_split,
                            part, tickets, out, st);
  return launch_lpr<T, 8>(q, k, v, B, H, KV, S, D, scale, rows, n_split,
                          part, tickets, out, st);
}

}  // namespace

// q (B, H, D), k and v (B, S, KV, D) contiguous, all f32 (dtype 0) or all
// bf16 (dtype 1), H a multiple of KV, D <= 256; out (B, H, D) in the same
// type.  The cache is cut into n_split splits of `rows` rows (the last may
// be shorter; every split must hold a row).  part: B * H * n_split *
// (D + 2) floats of scratch; tickets: B * H ints, zero on entry, zero
// again on exit.  Returns the CUDA error of the attribute call or the
// launch.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, int B, int H, int KV,
                                       int S, int D, float scale, int dtype,
                                       int rows, int n_split, void* part,
                                       void* tickets, void* out,
                                       void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows < 1 || n_split < 1 || (n_split - 1) * rows >= S ||
      n_split * static_cast<long long>(rows) < S)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (dtype == 0)
    err = launch_g<float>(q, k, v, B, H, KV, S, D, scale, rows, n_split,
                          part, tickets, out, st);
  else if (dtype == 1)
    err = launch_g<__nv_bfloat16>(q, k, v, B, H, KV, S, D, scale, rows,
                                  n_split, part, tickets, out, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
