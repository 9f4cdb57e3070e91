// Blocked prefill attention with an online softmax on Hopper's tensor
// cores (wgmma), one CTA (one warpgroup) per (batch, head, 64-query
// tile), one template for float32 and bfloat16 inputs.
//
// Replaces the JAX package's kernels/flash_attention.py:flash_attention
// (_flash_kernel).  Per 64-key tile and query row, in float32:
//   s     = scale * (q . k)                        (tensor cores, f32 sum)
//   m_new = max(m, max_j s);  p = exp(s - m_new);  corr = exp(m - m_new)
//   l     = l * corr + sum_j p;  acc = acc * corr + p . V   (tensor cores)
//   out   = acc / max(l, 1e-30)                     in q's type, once
// with m starting at the reference's NEG_INF = -1e30 and expf.
//
// Numerics.  The tensor cores multiply bf16 operands exactly and sum in
// float32, so every float32 operand goes in as bf16 pieces x = hi + mid +
// lo (each the bf16 rounding of what the earlier pieces leave; 24 bits):
// * Q . K^T multiplies unscaled pieces and applies `scale` to the float32
//   scores afterwards (the reference scales q first: the two differ at
//   float32 rounding; rounding q * scale to bf16 would cost ~2^-9 in
//   every score).  Float32 inputs keep the terms lo.hi, hi.lo, mid.mid,
//   mid.hi, hi.mid, hi.hi, in that order (smallest first); the dropped
//   ones are below 2^-24 of a product.
// * P is float32 and never rounded to bf16: it goes in as three pieces
//   P0 + P1 + P2 (at most 2^-27 of p left over, below float32's own
//   rounding; two pieces leave 2^-18, 7e-6 at T = S = 2048 against the
//   2e-5 float32 tolerance, and one leaves 2^-9, which the tolerance
//   refuses).  Float32 inputs take P2.Vhi, P0.Vlo, P1.Vmid, P0.Vmid,
//   P1.Vhi, P0.Vhi, in that order.
// * Bf16 inputs are their own hi piece.  They run the same sequence with
//   the products of the absent pieces left out: hi.hi for the scores,
//   P2.V, P1.V and P0.V for the output.  On float32 inputs widened from
//   bf16 every piece but hi is exactly 0, the float32 instance's extra
//   products add 0 to the accumulator (D = 0 . B + C returns C, which
//   chip_smoke checks on the card first), and its nonzero products meet
//   the accumulator in the bf16 instance's order.  The key tile, the
//   order of the rescales and the product shapes are the same in both.
//   So the bf16 result is the float32 instance's result on the widened
//   inputs, rounded: the bit check chip_smoke holds the kernel to.
// * Every scalar sum is written with __fmul_rn / __fadd_rn, so contraction
//   (this source is built without -fmad=false) cannot tell the two
//   instances apart.
//
// Causal masking is aligned to the bottom right (key s is seen by query t
// when s <= t + S - T).  A query tile skips the key tiles right of its
// last row's diagonal; inside a tile a key that is not seen gets p = 0
// exactly.  A row that sees no key at all (t < T - S) keeps l = 0 and
// acc = 0 and writes 0, as the reference kernel does.
//
// Bound on the card: 4 D flops per (query, seen key) pair against 4 D
// values per query row, so prefill at T = S = 2048 is bound by operations.
// The design for the card:
// * Products.  wgmma.m64n64k16 for the 64 x 64 scores, A (Q) and B (K)
//   read by the tensor cores from shared memory through descriptors;
//   wgmma.m64nDPk16 for P . V with P's bf16 pieces as the register A
//   operand (each warp's 16 x 64 slice of the scores stays in registers:
//   the accumulator's fragment is the A fragment) and V as a transposed
//   (N-major) B from shared memory.  D <= 64 runs at DP = 64, D <= 128 at
//   DP = 128; the padding columns hold zeros.
// * Shared memory.  Tiles are stored as DP / 64 blocks of 64 rows x 128
//   bytes with the 128-byte swizzle (16-byte chunk c of row r at c ^ (r %
//   8)), the layout the descriptors name: K-major with 1024 bytes between
//   8-row groups for Q and K, N-major with 8192 bytes between 64-wide
//   blocks of d for V.  Bf16 K/V tiles arrive by cp.async in a two-stage
//   ring, the next tile in flight while this one is multiplied (80 KB at
//   DP = 128: two CTAs an SM).  Float32 K/V tiles arrive by cp.async in a
//   float32 staging tile, are cut into three pieces each, and are
//   multiplied while the next tile lands in the staging tile (208 KB at
//   DP = 128: one CTA an SM).  Writes by the threads (cp.async, stores)
//   are fenced into the tensor cores' async proxy before each barrier.
// * Softmax.  The tiles left of the diagonal (all but one or two a query
//   tile) take a path with no index arithmetic; only the diagonal tiles
//   mask.  expf stays IEEE (no fast math).
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 128;           // one warpgroup
constexpr int kBlockBytes = 64 * 128;   // a 64-row block of 64 bf16 columns
constexpr float kNegInf = -1e30f;

using bf16 = __nv_bfloat16;

template <typename T>
__host__ __device__ constexpr int n_pieces() {
  return sizeof(T) == 4 ? 3 : 1;
}
// K/V buffers: two stages of bf16, or three pieces of one float32 tile
template <typename T>
__host__ __device__ constexpr int n_bufs() {
  return sizeof(T) == 4 ? 3 : 2;
}

// bytes of one [64][DP] bf16 tile
__host__ __device__ constexpr int tile_bytes(int DP) { return 64 * DP * 2; }

template <typename T>
size_t smem_bytes(int DP) {
  size_t b = static_cast<size_t>(tile_bytes(DP)) *
             (n_pieces<T>() + 2 * n_bufs<T>());
  if (sizeof(T) == 4) b += 2 * sizeof(float) * 64 * DP;  // staging K, V
  return b + 1024;   // room to align the base to the swizzle's 1024 bytes
}

// byte offset of (row, col) in a [64][DP] bf16 tile: DP / 64 blocks of
// 64 rows x 128 bytes, 128-byte swizzle
__device__ __forceinline__ int toff(int row, int col) {
  return (col >> 6) * kBlockBytes + row * 128 +
         ((((col >> 3) & 7) ^ (row & 7)) << 4) + (col & 7) * 2;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// wgmma shared-memory descriptor, 128-byte swizzle: start address, the
// byte offset between 64-wide blocks of an N-major operand (lbo; unused
// for a K-major one) and between 8-row groups (1024)
__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t lbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 | static_cast<uint64_t>(1)
                                                      << 62;
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// make this thread's generic-proxy writes to shared memory (stores,
// cp.async) visible to the tensor cores' reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// c (64 x 64, f32) += a (64 x 16, smem) . b (16 x 64, smem, K-major)
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t a,
                                           uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, 1, 1, 1, 0, 0;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b));
}
// c (64 x 64 or 64 x 128, f32) += a (64 x 16, registers) . b (16 x N,
// smem, N-major)
__device__ __forceinline__ void wgmma_rs64(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}
__device__ __forceinline__ void wgmma_rs128(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
      "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}
template <int DP>
__device__ __forceinline__ void wgmma_rs(float (&d)[DP / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (DP == 128)
    wgmma_rs128(d, a, b);
  else
    wgmma_rs64(d, a, b);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}
// the bf16 pieces of x: pc[0] = rn(x), pc[i] = rn(x - pc[0] - ... )
template <int NP>
__device__ __forceinline__ void split(float x, bf16 (&pc)[NP]) {
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    pc[i] = __float2bfloat16_rn(x);
    x = __fsub_rn(x, __bfloat162float(pc[i]));
  }
}
// P0, P1 and P2 of a pair of probabilities, each packed as one
// A-fragment register
__device__ __forceinline__ void split_pair(float x, float y, uint32_t& p0,
                                           uint32_t& p1, uint32_t& p2) {
  bf16 px[3], py[3];
  split<3>(x, px);
  split<3>(y, py);
  p0 = pack(px[0], py[0]);
  p1 = pack(px[1], py[1]);
  p2 = pack(px[2], py[2]);
}

// n <= 8 values of src (n < 8 at the edge of D) as float32
template <typename T>
__device__ __forceinline__ void load8(const T* src, int n, int vec,
                                      float (&f)[8]) {
  if (vec && n == 8) {
    if (sizeof(T) == 2) {
      const uint4 u = *reinterpret_cast<const uint4*>(src);
      const bf16* h = reinterpret_cast<const bf16*>(&u);
#pragma unroll
      for (int j = 0; j < 8; ++j) f[j] = __bfloat162float(h[j]);
    } else {
      const float4 a = reinterpret_cast<const float4*>(src)[0];
      const float4 b = reinterpret_cast<const float4*>(src)[1];
      f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
      f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) f[j] = j < n ? to_f32(src[j]) : 0.0f;
  }
}

// K/V tile of 64 rows from rows k0.. of kp/vp ((S, D) each): bf16 by
// cp.async straight into the swizzled tiles `dst_k` / `dst_v`; float32 by
// cp.async into the float32 staging tiles ([64][DP], plain rows)
template <typename T, int DP>
__device__ __forceinline__ void issue_kv(const T* kp, const T* vp, int k0,
                                         int D, int vec, void* dst_k,
                                         void* dst_v, int tid) {
  constexpr int EPC = 16 / sizeof(T);   // elements a 16-byte chunk
  constexpr int CPR = DP / EPC;         // chunks a row
#pragma unroll 4
  for (int e = tid; e < kBlockK * CPR; e += kThreads) {
    const int row = e / CPR;
    const int col = (e - row * CPR) * EPC;
    const size_t off = static_cast<size_t>(k0 + row) * D + col;
    T* dk = reinterpret_cast<T*>(
        static_cast<unsigned char*>(dst_k) +
        (sizeof(T) == 2 ? toff(row, col) : 4 * (row * DP + col)));
    T* dv = reinterpret_cast<T*>(
        static_cast<unsigned char*>(dst_v) +
        (sizeof(T) == 2 ? toff(row, col) : 4 * (row * DP + col)));
    if (vec) {
      const bool ok = col < D;        // D % 8 == 0: a chunk is all in or out
      cp_async16(dk, ok ? kp + off : kp, ok ? 16 : 0);
      cp_async16(dv, ok ? vp + off : vp, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int j = 0; j < EPC; ++j) {
        const bool ok = col + j < D;
        dk[j] = ok ? kp[off + j] : from_f32<T>(0.0f);
        dv[j] = ok ? vp[off + j] : from_f32<T>(0.0f);
      }
    }
  }
}

// cut the float32 staging tiles into three swizzled bf16 pieces each
template <int DP>
__device__ __forceinline__ void split_kv(const float* st_k, const float* st_v,
                                         unsigned char* k_s,
                                         unsigned char* v_s, int tid) {
#pragma unroll 4
  for (int e = tid; e < kBlockK * DP / 4; e += kThreads) {
    const int row = e / (DP / 4);
    const int col = (e - row * (DP / 4)) * 4;
#pragma unroll
    for (int kv = 0; kv < 2; ++kv) {
      const float4 x = *reinterpret_cast<const float4*>(
          (kv == 0 ? st_k : st_v) + row * DP + col);
      bf16 a[3], b[3], c[3], d[3];
      split<3>(x.x, a);
      split<3>(x.y, b);
      split<3>(x.z, c);
      split<3>(x.w, d);
      unsigned char* base = kv == 0 ? k_s : v_s;
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        uint2 w;
        w.x = pack(a[p], b[p]);
        w.y = pack(c[p], d[p]);
        *reinterpret_cast<uint2*>(base + p * tile_bytes(DP) +
                                  toff(row, col)) = w;
      }
    }
  }
}

// Scale a warp's 16 x 64 scores (element (j, e): row g + 8 (e / 2), key
// key0 + 8 j + e % 2, key0 = k0 + 2 t4), set the unseen ones to NEG_INF
// (MASK: only tiles that cross the diagonal) and take each row's max
// over the fragment.  The unmasked instance does no index arithmetic,
// which the tiles left of the diagonal (all but one or two a row) take.
template <bool MASK>
__device__ __forceinline__ void scale_max(float (&sc)[32], float scale,
                                          int key0, int qpos0,
                                          float (&mx)[2]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool seen =
          !MASK || key0 + 8 * j + (e & 1) <= qpos0 + 8 * (e >> 1);
      sc[4 * j + e] = seen ? __fmul_rn(sc[4 * j + e], scale) : kNegInf;
      mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * j + e]);
    }
}
// p = exp(s - m_new), exactly 0 for an unseen key, summed a row
template <bool MASK>
__device__ __forceinline__ void exp_sum(float (&sc)[32], int key0,
                                        int qpos0, const float (&m_new)[2],
                                        float (&psum)[2]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool seen =
          !MASK || key0 + 8 * j + (e & 1) <= qpos0 + 8 * (e >> 1);
      sc[4 * j + e] = seen ? expf(sc[4 * j + e] - m_new[e >> 1]) : 0.0f;
      psum[e >> 1] = __fadd_rn(psum[e >> 1], sc[4 * j + e]);
    }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, int T_len, int S, int D, float scale,
             int causal, int vec, T* __restrict__ out) {
  constexpr int NP = n_pieces<T>();
  constexpr int NB = n_bufs<T>();
  constexpr int KS = DP / 16;          // k16 steps over d
  constexpr int TB = tile_bytes(DP);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* q_s = smem;                   // NP pieces of Q
  unsigned char* k_s = q_s + NP * TB;          // NB stages or pieces
  unsigned char* v_s = k_s + NB * TB;
  float* st_k = reinterpret_cast<float*>(v_s + NB * TB);  // f32 only
  float* st_v = st_k + 64 * DP;

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
  const int g = lane >> 2;             // fragment row
  const int t4 = lane & 3;             // fragment column pair
  const int wr = warp * 16;            // the warp's first row in the tile
  const int offset = S - T_len;

  int n_tiles = S / kBlockK;
  if (causal) {
    const int last = q0 + kBlockQ - 1 + offset;  // last row's position
    n_tiles = last < 0 ? 0 : min(n_tiles, last / kBlockK + 1);
  }
  if (n_tiles > 0)
    issue_kv<T, DP>(kp, vp, 0, D, vec, NP == 1 ? (void*)k_s : (void*)st_k,
                    NP == 1 ? (void*)v_s : (void*)st_v, tid);
  cp_async_commit();

  // Q's pieces, once (rows always in range: T % 64 == 0)
  for (int e = tid; e < kBlockQ * (DP / 8); e += kThreads) {
    const int row = e / (DP / 8);
    const int col = (e - row * (DP / 8)) * 8;
    float f[8];
    load8<T>(qp + static_cast<size_t>(row) * D + col, max(0, min(8, D - col)),
             vec, f);
    bf16 pc[8][NP];
#pragma unroll
    for (int j = 0; j < 8; ++j) split<NP>(f[j], pc[j]);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      uint4 w;
      w.x = pack(pc[0][p], pc[1][p]);
      w.y = pack(pc[2][p], pc[3][p]);
      w.z = pack(pc[4][p], pc[5][p]);
      w.w = pack(pc[6][p], pc[7][p]);
      *reinterpret_cast<uint4*>(q_s + p * TB + toff(row, col)) = w;
    }
  }
  fence_async_smem();

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.0f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockK;
    const unsigned char* kb_s;
    const unsigned char* vb_s;
    if constexpr (NP == 1) {
      const int stage = kt & 1;
      if (kt + 1 < n_tiles)
        issue_kv<T, DP>(kp, vp, k0 + kBlockK, D, vec,
                        k_s + (stage ^ 1) * TB, v_s + (stage ^ 1) * TB, tid);
      cp_async_commit();
      cp_async_wait<1>();
      fence_async_smem();
      __syncthreads();
      kb_s = k_s + stage * TB;
      vb_s = v_s + stage * TB;
    } else {
      cp_async_wait<0>();
      __syncthreads();   // staging landed; the previous tile's pieces free
      split_kv<DP>(st_k, st_v, k_s, v_s, tid);
      fence_async_smem();
      __syncthreads();   // pieces visible; staging free
      if (kt + 1 < n_tiles)
        issue_kv<T, DP>(kp, vp, k0 + kBlockK, D, vec, st_k, st_v, tid);
      cp_async_commit();
      kb_s = k_s;
      vb_s = v_s;
    }

    // S = Q K^T, unscaled: 64 x 64 a warpgroup, each warp's 16 rows in
    // the accumulator fragment (element 4 j + e: row wr + g + 8 (e / 2),
    // key k0 + 8 j + 2 t4 + e % 2)
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      // k16 step ks: block ks / 4 of 64 columns, 32 bytes a step in it
      const int at = (ks >> 2) * kBlockBytes + (ks & 3) * 32;
      uint64_t qd[NP], kd[NP];
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        qd[p] = gmma_desc(q_s + p * TB + at, 16);
        kd[p] = gmma_desc(kb_s + p * TB + at, 16);
      }
      if constexpr (NP == 3) {
        wgmma_ss64(sc, qd[2], kd[0]);   // lo.hi
        wgmma_ss64(sc, qd[0], kd[2]);   // hi.lo
        wgmma_ss64(sc, qd[1], kd[1]);   // mid.mid
        wgmma_ss64(sc, qd[1], kd[0]);   // mid.hi
        wgmma_ss64(sc, qd[0], kd[1]);   // hi.mid
      }
      wgmma_ss64(sc, qd[0], kd[0]);     // hi.hi
    }
    wgmma_commit_wait();

    // online softmax over the tile
    const bool mask =
        causal && k0 + kBlockK - 1 > q0 + wr + offset;  // warp-uniform
    const int qpos0 = q0 + wr + g + offset;
    const int key0 = k0 + 2 * t4;
    float mx[2] = {kNegInf, kNegInf};
    if (mask)
      scale_max<true>(sc, scale, key0, qpos0, mx);
    else
      scale_max<false>(sc, scale, key0, qpos0, mx);
    float corr[2], m_new[2], psum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      m_new[r] = fmaxf(m[r], mx[r]);
      corr[r] = expf(m[r] - m_new[r]);
    }
    if (mask)
      exp_sum<true>(sc, key0, qpos0, m_new, psum);
    else
      exp_sum<false>(sc, key0, qpos0, m_new, psum);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      psum[r] = __fadd_rn(psum[r], __shfl_xor_sync(0xffffffffu, psum[r], 1));
      psum[r] = __fadd_rn(psum[r], __shfl_xor_sync(0xffffffffu, psum[r], 2));
      l[r] = __fadd_rn(__fmul_rn(l[r], corr[r]), psum[r]);
      m[r] = m_new[r];
    }
#pragma unroll
    for (int i = 0; i < DP / 2; ++i)
      o[i] = __fmul_rn(o[i], corr[(i >> 1) & 1]);

    // O += P V: P's three pieces as register A fragments, 16 keys a step
    // (the A fragment of keys 16 kk.. is the scores' n8 tiles 2 kk and
    // 2 kk + 1); V N-major from shared memory, keys 16 kk.. at 2 KB a step
    uint32_t p0[4][4], p1[4][4], p2[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* a = sc + 8 * kk;
#pragma unroll
      for (int f = 0; f < 4; ++f)
        split_pair(a[2 * f], a[2 * f + 1], p0[kk][f], p1[kk][f], p2[kk][f]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint64_t vd[NP];
#pragma unroll
      for (int p = 0; p < NP; ++p)
        vd[p] = gmma_desc(vb_s + p * TB + kk * 16 * 128, kBlockBytes);
      wgmma_rs<DP>(o, p2[kk], vd[0]);     // P2.Vhi
      if constexpr (NP == 3) {
        wgmma_rs<DP>(o, p0[kk], vd[2]);   // P0.Vlo
        wgmma_rs<DP>(o, p1[kk], vd[1]);   // P1.Vmid
        wgmma_rs<DP>(o, p0[kk], vd[1]);   // P0.Vmid
      }
      wgmma_rs<DP>(o, p1[kk], vd[0]);     // P1.Vhi
      wgmma_rs<DP>(o, p0[kk], vd[0]);     // P0.Vhi
    }
    wgmma_commit_wait();
    if constexpr (NP == 1) __syncthreads();  // the stage is refilled next
  }
  cp_async_wait<0>();

  const float den[2] = {fmaxf(l[0], 1e-30f), fmaxf(l[1], 1e-30f)};
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int col = 8 * n + 2 * t4;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      T* dst = op + static_cast<size_t>(wr + g + 8 * r) * D + col;
      if (col < D) dst[0] = from_f32<T>(o[4 * n + 2 * r] / den[r]);
      if (col + 1 < D) dst[1] = from_f32<T>(o[4 * n + 2 * r + 1] / den[r]);
    }
  }
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, int B,
                   int H, int T_len, int S, int D, float scale, int causal,
                   void* out, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(DP);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec = D % 8 == 0 && aligned(q) && aligned(k) && aligned(v);
  const dim3 grid(T_len / kBlockQ, H, B);
  flash_kernel<T, DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), T_len, S, D, scale, causal, vec,
      static_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, int B,
                     int H, int T_len, int S, int D, float scale, int causal,
                     void* out, cudaStream_t stream) {
  if (D <= 64)
    return launch<T, 64>(q, k, v, B, H, T_len, S, D, scale, causal, out,
                         stream);
  if (D <= 128)
    return launch<T, 128>(q, k, v, B, H, T_len, S, D, scale, causal, out,
                          stream);
  return cudaErrorInvalidValue;
}

// The identity the bit check rests on, on the products the kernel runs:
// per 64 x 64 tile, c0 + a0 . b0 with a0 = 0 (registers) and b0 random
// (shared memory), and c1 + a1 . b1 with a1 random (shared memory) and
// b1 = 0 (shared memory).  b (64 x 64 bf16 values a tile, row-major) is
// the random operand of both; d must equal c bit for bit.
__global__ void zero_probe_kernel(const float* __restrict__ c,
                                  const bf16* __restrict__ b,
                                  float* __restrict__ d) {
  __shared__ __align__(1024) unsigned char sm[2 * kBlockBytes];
  const int tid = threadIdx.x;
  const bf16* bt = b + static_cast<size_t>(blockIdx.x) * 64 * 64;
  for (int e = tid; e < 64 * 64; e += kThreads) {
    const int row = e / 64, col = e % 64;
    *reinterpret_cast<bf16*>(sm + toff(row, col)) = bt[e];
    *reinterpret_cast<bf16*>(sm + kBlockBytes + toff(row, col)) =
        __float2bfloat16_rn(0.0f);
  }
  fence_async_smem();
  __syncthreads();
  const size_t base = (static_cast<size_t>(blockIdx.x) * 2 * kThreads + tid) *
                      32;
  float acc0[32], acc1[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    acc0[i] = c[base + i];
    acc1[i] = c[base + kThreads * 32 + i];
  }
  const uint32_t zero[4] = {0u, 0u, 0u, 0u};
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    wgmma_rs64(acc0, zero, gmma_desc(sm + ks * 16 * 128, kBlockBytes));
    wgmma_ss64(acc1, gmma_desc(sm + ks * 32, 16),
               gmma_desc(sm + kBlockBytes + ks * 32, 16));
  }
  wgmma_commit_wait();
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    d[base + i] = acc0[i];
    d[base + kThreads * 32 + i] = acc1[i];
  }
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
    err = launch_d<bf16>(q, k, v, B, H, T, S, D, scale, causal, out, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// D = 0 . B + C on the tensor cores as the kernel runs them, for n_tiles
// tiles: c holds 2 * 128 * 32 floats a tile, b 64 * 64 bf16 values a tile;
// d gets the products.  The caller holds d against c bit for bit.
extern "C" int flash_mma_zero_probe(const void* c, const void* b, void* d,
                                    int n_tiles, void* stream) {
  zero_probe_kernel<<<n_tiles, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(c), static_cast<const bf16*>(b),
      static_cast<float*>(d));
  return static_cast<int>(cudaGetLastError());
}
