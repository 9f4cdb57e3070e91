// MLA's weight-absorbed decode attention (DeepSeek-V2/V3) over the filled
// slots of the bf16 latent ring: three launches a call, all captured in the
// decode step's CUDA graph.
//
// Replaces no TPU kernel.  The JAX package leaves the absorbed decode to
// XLA (models/attention.py:apply_mla, einsums over the whole ring), and the
// port's plain path does the same in PyTorch
// (kernels/mla_decode.py:mla_decode_torch): every step and layer it widens
// the ring and W_vb to float32, runs three float32 products on the CUDA
// cores over every slot of the fixed ring, and masks the empty ones, in
// ~25 small launches.  The kernel takes bf16 tensors only; float32 keeps
// the plain version.
//
// Bound on the card: bytes.  A layer reads W_kb and W_vb (r H (nope + v)
// values: 33.6 MB at DeepSeek-V3's widths) and the n filled slots (r + rope
// values each, 1,152 bytes), ~11 us at 3.35 TB/s at n = 2,350.  The
// attention's 2 H n (r + rope) score and 2 H n r context operations, the
// context's taken three times (P's pieces), are ~2.5 us at n = 4,608 on the
// bf16 tensor cores; the absorb's and the combine's 2 H r (nope + v) float32
// multiply-adds ~0.5 us on the CUDA cores.  The design:
//
// 1. absorb: q_abs[b, h] = q_nope[b, h] W_kb[:, h, :]^T.  A block takes a
//    contiguous range of W_kb's (r, h) rows (nope values each); 16 lanes
//    take a row, 8 rows in flight a lane group; float32 sums, rounded once
//    to bf16 (as the einsum rounds).  q_abs is kept as (B, r, H), the rows'
//    own order, so its writes coalesce.
// 2. attend (split-KV): a block takes 16 heads of one batch row (an m16
//    tile) and one of S splits of the n filled slots.  decode_pos is read on
//    the device and the slots the mask keeps are found from it (the n newest
//    tokens, oldest first), so the grid is fixed by the shape and one graph
//    serves every position; no slot outside the mask is read.  The blocks
//    of a split's head tiles form a cluster of up to 8, and each stages
//    every 8th row of a 64-slot step into all of them by a TMA multicast
//    (a ckv and a kpe bulk copy a row, two buffers on mbarriers), so a ring
//    row leaves L2 once a cluster and staging takes no thread while the
//    step before is computed.  S is as many splits as fill the clusters
//    that fit on the card at once (15 of 8 on an H100: one wave).  8 warps
//    score all 64 slots by mma.sync m16n8k16 bf16 products with float32
//    sums (bf16 products are exact), each warp over every 8th k step, so
//    each query value is read once a step; the partial scores are added in
//    warp order.  Then an online softmax in float32 (IEEE expf), then the
//    context, each warp r/8 columns, by mma.sync with P cut into three bf16
//    pieces that add up to it exactly, so P is never rounded.  Each split
//    writes its running max, sum and r-wide unnormalized context in float32.
// 3. combine: a block a (batch row, head) weighs the splits by exp(m_s - M),
//    divides by the total, and multiplies the float32 context by W_vb[:, h,
//    :] (v values a row), rounding once.
// The hot loops have no branch: rows and tiles past the end read a valid
// row again and their sums are not written.  (Launching passes 2 and 3 as
// programmatic dependents, so that their blocks start before the pass
// before ends, saved ~3 us of ~40 a call, and the overlapping spans would
// count twice in a sum of kernel times; they are launched in order.)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kHeads = 16;         // an attend block's heads: one m16 tile
constexpr int kWarps = 8;          // an attend block's warps, 8 slots each
constexpr int kChunk = 8 * kWarps; // slots an attend step
constexpr int kVec = 8;            // bf16 values in 16 bytes
constexpr int kMaxR = 512;
constexpr int kMaxSplits = 256;
constexpr int kPad = 8;            // bf16 after a staged row: rows 16 B apart
constexpr int kLine = 256;         // threads of an absorb or combine block
constexpr int kGroup = 16;         // absorb: lanes a W_kb row
constexpr int kInFlight = 8;       // absorb: rows a lane group loads at once
constexpr int kMaxB = 1;           // absorb: batch rows a pass over W_kb
constexpr int kUnroll = 16;        // combine: W_vb rows a thread loads at once

struct Args {
  const bf16* q_nope;     // (B, 1, H, nope), strides qn_b, qn_h
  const bf16* q_pe;       // (B, 1, H, rope), strides qp_b, qp_h
  const bf16* ckv;        // (B, L, r)
  const bf16* kpe;        // (B, L, rope)
  const bf16* wk_b;       // (r, H, nope)
  const bf16* wv_b;       // (r, H, v)
  const long long* pos;   // 0-d decode_pos on the device, or null: pos_val
  long long qn_b, qn_h, qp_b, qp_h, pos_val;
  int B, H, N, R, P, V, L, S, window;
  float scale;
  bf16* q_abs;            // (B, r, H)
  float* part;            // (B, H, S, r)
  float* part_ml;         // (B, H, S, 2): running max and sum
  bf16* out;              // (B, 1, H, v)
};

// the newest position and the count n of filled slots the mask keeps: the
// n = min(pos + 1, L, window) newest tokens; the k-th oldest of them sits
// at slot (pos - n + 1 + k) % L
__device__ __forceinline__ void filled(const Args& a, long long* pos,
                                       long long* n) {
  const long long p = a.pos ? *a.pos : a.pos_val;
  long long m = p + 1 < a.L ? p + 1 : a.L;
  if (a.window > 0 && m > a.window) m = a.window;
  *pos = p;
  *n = m > 0 ? m : 0;
}

// 16 bytes of bf16 as floats (a bf16 is the high half of its float)
__device__ __forceinline__ void widen(const uint4 r, float* v) {
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// x = p0 + p1 + p2 exactly: each piece the round-to-nearest bf16 of what
// the pieces before it leave (8 + 8 + 8 bits of a float's 24)
__device__ __forceinline__ void split3(float x, bf16 (&p)[3]) {
  p[0] = __float2bfloat16_rn(x);
  const float r = x - __bfloat162float(p[0]);
  p[1] = __float2bfloat16_rn(r);
  p[2] = __float2bfloat16_rn(r - __bfloat162float(p[1]));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// the TMA unit's copy of bytes (a multiple of 16, both ends on 16 bytes)
// from global memory into the same offset of the shared memory of each
// block of the cluster in mask, counted on each one's mbarrier at bar's
// offset
__device__ __forceinline__ void bulk_copy_cluster(void* dst, const void* src,
                                                  unsigned bytes,
                                                  uint64_t* bar,
                                                  unsigned short mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar)), "h"(mask)
      : "memory");
}
// every thread of every block of the cluster; orders what each did before
// against what any does after
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ unsigned cluster_size() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// the one arrival of bar's phase, which then waits for bytes of copies
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// this thread's shared-memory accesses ordered before later TMA copies
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}
// c += a b: a 16 x 16 row-major, b 16 x 8 column-major, bf16; c float32
// (not volatile: the compiler may interleave independent products)
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------- absorb
__global__ void __launch_bounds__(kLine) absorb_kernel(Args a) {
  constexpr int kRows = 2 * kInFlight;        // rows a warp takes a step
  const int lane = threadIdx.x & 31, side = lane / kGroup;
  const int gl = lane % kGroup, warp = threadIdx.x / 32;
  // the block's contiguous range [lo, hi) of W_kb's (r, h) rows
  const int rows = a.R * a.H;
  const int lo = static_cast<int>(static_cast<long long>(rows) *
                                  blockIdx.x / gridDim.x);
  const int hi = static_cast<int>(static_cast<long long>(rows) *
                                  (blockIdx.x + 1) / gridDim.x);
  const int nvec = a.N / kVec;
  for (int b0 = 0; b0 < a.B; b0 += kMaxB) {
    const int nb = min(kMaxB, a.B - b0);
    for (int base = lo + warp * kRows; base < hi;
         base += kLine / 32 * kRows) {
      const int i0 = base + side * kInFlight;   // this group's rows
      // rows past hi read the last row again (its sums are not written),
      // so the loop below has no branch
      int row[kInFlight], hs[kInFlight];
      float acc[kInFlight][kMaxB];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        row[u] = min(i0 + u, hi - 1);
        hs[u] = row[u] % a.H;
#pragma unroll
        for (int bb = 0; bb < kMaxB; ++bb) acc[u][bb] = 0.f;
      }
      for (int v = gl; v < nvec; v += kGroup) {
        uint4 raw[kInFlight];
#pragma unroll
        for (int u = 0; u < kInFlight; ++u)
          raw[u] = __ldcs(reinterpret_cast<const uint4*>(
                              a.wk_b + static_cast<size_t>(row[u]) * a.N) +
                          v);
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          float wv[kVec];
          widen(raw[u], wv);
#pragma unroll
          for (int bb = 0; bb < kMaxB; ++bb) {
            float qv[kVec];
            widen(__ldg(reinterpret_cast<const uint4*>(
                            a.q_nope + (b0 + min(bb, nb - 1)) * a.qn_b +
                            hs[u] * a.qn_h) + v),
                  qv);
#pragma unroll
            for (int k = 0; k < kVec; ++k)
              acc[u][bb] = fmaf(qv[k], wv[k], acc[u][bb]);
          }
        }
      }
      // the group's 16 partial sums, added in a fixed butterfly
#pragma unroll
      for (int u = 0; u < kInFlight; ++u)
#pragma unroll
        for (int bb = 0; bb < kMaxB; ++bb)
#pragma unroll
          for (int o = kGroup / 2; o > 0; o >>= 1)
            acc[u][bb] += __shfl_xor_sync(0xffffffffu, acc[u][bb], o);
      if (gl == 0) {
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          if (i0 + u >= hi) continue;
#pragma unroll
          for (int bb = 0; bb < kMaxB; ++bb)
            if (bb < nb)             // q_abs is (B, r, H): the rows' order
              a.q_abs[static_cast<size_t>(b0 + bb) * rows + i0 + u] =
                  __float2bfloat16_rn(acc[u][bb]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------- attend
// shared memory of an attend block, in bf16 values from its start: the 16
// heads' query rows (q_abs then q_pe), the ring's staged rows (ckv then
// kpe; two buffers of kChunk rows), P's three pieces; then in floats each
// warp's partial scores and the rows' running max, sum and rescaling
// factor; then a TMA mbarrier a buffer
struct Layout {
  static constexpr int kPs = kChunk + 8;   // a row of P (bf16; 16 B apart)
  static constexpr int kSs = kChunk + 4;   // a row of scores (floats)
  int ks;                 // a staged row: r + rope + kPad bf16
  int q, k, p, s;         // offsets in bf16 values
  size_t bars;            // offset in bytes
  __host__ __device__ explicit Layout(int R, int P) : ks(R + P + kPad) {
    q = 0;
    k = q + kHeads * ks;
    p = k + 2 * kChunk * ks;
    s = p + 3 * kHeads * kPs;
    bars = 2 * static_cast<size_t>(s) +
           4 * (kWarps * kHeads * kSs + 3 * kHeads);
  }
  __host__ __device__ size_t bytes() const { return bars + 16; }
};

__global__ void __launch_bounds__(32 * kWarps) attend_kernel(Args a) {
  constexpr int kPs = Layout::kPs, kSs = Layout::kSs;
  constexpr int HW = kHeads / kWarps;     // softmax: heads a warp
  constexpr int SL = kChunk / 32;         // softmax: slots a lane
  constexpr int NT = kChunk / 8;          // scores: n8 tiles of a step
  constexpr int MT = 2 * ((kMaxR / 8 + 2 * kWarps - 1) / (2 * kWarps));
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const Layout lay(a.R, a.P);
  const int ks = lay.ks;
  bf16* sQ = smem + lay.q;
  bf16* sK = smem + lay.k;
  bf16* sP = smem + lay.p;
  float* sSp = reinterpret_cast<float*>(smem + lay.s);
  float* sM = sSp + kWarps * kHeads * kSs;
  float* sL = sM + kHeads;
  float* sC = sL + kHeads;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw + lay.bars);
  const int split = blockIdx.x, h0 = blockIdx.y * kHeads, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  long long pos, n;
  filled(a, &pos, &n);
  const long long k0 = split * n / a.S;
  const int cnt = static_cast<int>((split + 1) * n / a.S - k0);
  // the combine skips an empty split; a cluster shares its split, so its
  // blocks all return here or none does
  if (cnt == 0) return;

  const int K = a.R + a.P, vr = a.R / kVec, vk = K / kVec;
  // the ring slot of the split's oldest token; the next are after it
  const int base_slot = static_cast<int>((pos - n + 1 + k0) % a.L);
  const bf16* ckv = a.ckv + static_cast<size_t>(b) * a.L * a.R;
  const bf16* kpe = a.kpe + static_cast<size_t>(b) * a.L * a.P;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  if (tid == 0) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
  }
  if (tid < kHeads) {
    sM[tid] = -INFINITY;
    sL[tid] = 0.f;
  }
  // the blocks of a cluster (the head tiles of one split, one batch row)
  // stage each step together: each issues every cs-th row into all of
  // them, so each ring row leaves L2 once a cluster
  const int cs = static_cast<int>(cluster_size());
  const int rank = static_cast<int>(cluster_rank());
  cluster_sync();                // every block's mbarriers are set up

  // a step's slots t0.. into buffer buf by the TMA unit (a warp issues a
  // ckv and a kpe copy a row); rows past cnt zero (never read from the
  // ring: 0 x garbage could be NaN)
  auto stage = [&](int buf, int t0) {
    bf16* dst = sK + buf * kChunk * ks;
    const int rows = min(kChunk, cnt - t0);
    if (warp == 0) {
      const unsigned short mask = static_cast<unsigned short>((1 << cs) - 1);
      if (lane == 0) mbar_expect(&bars[buf], rows * K * 2);
      __syncwarp();
      for (int j = rank + lane * cs; j < rows; j += 32 * cs) {
        int slot = base_slot + t0 + j;
        if (slot >= a.L) slot -= a.L;
        bulk_copy_cluster(dst + j * ks, ckv + static_cast<size_t>(slot) * a.R,
                          a.R * 2, &bars[buf], mask);
        if (a.P)
          bulk_copy_cluster(dst + j * ks + a.R,
                            kpe + static_cast<size_t>(slot) * a.P, a.P * 2,
                            &bars[buf], mask);
      }
    }
    for (int j = rows + warp; j < kChunk; j += kWarps)
      for (int v = lane; v < vk; v += 32)
        *reinterpret_cast<uint4*>(dst + j * ks + v * kVec) = zero;
  };

  const int n_steps = (cnt + kChunk - 1) / kChunk;
  stage(0, 0);
  // the 16 heads' query rows, zero past H, while the first step lands:
  // q_abs from its (B, r, H) layout, a thread a head, q_pe a lane a piece
  {
    const bf16* qa = a.q_abs + static_cast<size_t>(b) * a.R * a.H;
    const bf16 zero1 = __float2bfloat16_rn(0.f);
    constexpr int kBatch = 16;   // loads in flight a thread
    const int total = kHeads * a.R;
    for (int i0 = tid; i0 < total; i0 += 32 * kWarps * kBatch) {
      bf16 v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * 32 * kWarps, h = h0 + i % kHeads;
        v[u] = i < total && h < a.H
                   ? qa[static_cast<size_t>(i / kHeads) * a.H + h]
                   : zero1;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * 32 * kWarps;
        if (i < total) sQ[(i % kHeads) * ks + i / kHeads] = v[u];
      }
    }
    for (int j = warp; j < kHeads; j += kWarps) {
      const int h = h0 + j;
      const bf16* rp = a.q_pe + b * a.qp_b + h * a.qp_h;
      for (int v = lane; v < vk - vr; v += 32)
        *reinterpret_cast<uint4*>(sQ + j * ks + a.R + v * kVec) =
            h < a.H ? __ldg(reinterpret_cast<const uint4*>(rp + v * kVec))
                    : zero;
    }
  }

  // the warp's context columns: n_mine n8 tiles from tile j_first, in
  // whole pairs (r / 8 is a multiple of 4), at most MT
  const int n8 = a.R / 8, tpw = 2 * ((n8 + 2 * kWarps - 1) / (2 * kWarps));
  const int j_first = warp * tpw;
  const int n_mine = max(0, min(tpw, n8 - j_first));
  const int g = lane >> 2, tq = lane & 3;
  // ldmatrix row addresses: an x4 A tile, an x4 pair of B tiles, an x4
  // trans pair
  const int a_row = ((lane >> 3) & 1) * 8 + (lane & 7);
  const int a_col = (lane >> 4) * 8;
  const int b_row = (lane >> 4) * 8 + (lane & 7);
  const int b_col = ((lane >> 3) & 1) * 8;
  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[m][e] = 0.f;

  for (int t = 0; t < n_steps; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_steps) stage(buf ^ 1, (t + 1) * kChunk);
    mbar_wait(&bars[buf], (t >> 1) & 1);
    __syncthreads();
    const bf16* kt = sK + buf * kChunk * ks;
    const int rows = min(kChunk, cnt - t * kChunk);

    // partial scores of all the step's slots over the warp's k steps
    // (kk = warp mod kWarps), so each query value is read once a step
    float sp[NT][4];
#pragma unroll
    for (int m = 0; m < NT; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) sp[m][e] = 0.f;
    for (int kk = warp; kk < K / 16; kk += kWarps) {
      unsigned qa[4];
      ldsm_x4(qa, sQ + a_row * ks + kk * 16 + a_col);
#pragma unroll
      for (int m = 0; m < NT; m += 2) {
        unsigned kb[4];
        ldsm_x4(kb, kt + (m * 8 + b_row) * ks + kk * 16 + b_col);
        mma(sp[m], qa, kb[0], kb[1]);
        mma(sp[m + 1], qa, kb[2], kb[3]);
      }
    }
    float* mine = sSp + warp * kHeads * kSs;
#pragma unroll
    for (int m = 0; m < NT; ++m) {
      const int col = m * 8 + 2 * tq;
      *reinterpret_cast<float2*>(mine + g * kSs + col) =
          make_float2(sp[m][0], sp[m][1]);
      *reinterpret_cast<float2*>(mine + (g + 8) * kSs + col) =
          make_float2(sp[m][2], sp[m][3]);
    }
    __syncthreads();

    // online softmax: a warp takes HW heads, a lane SL slots, each score
    // the warps' partials added in warp order; P in three pieces
#pragma unroll
    for (int i = 0; i < HW; ++i) {
      const int row = warp * HW + i;
      float sv[SL], mx = -INFINITY;
#pragma unroll
      for (int q = 0; q < SL; ++q) {
        const int col = lane + 32 * q;
        float sum_w = sSp[row * kSs + col];
#pragma unroll
        for (int w = 1; w < kWarps; ++w)
          sum_w += sSp[(w * kHeads + row) * kSs + col];
        sv[q] = col < rows ? sum_w * a.scale : -INFINITY;
        mx = fmaxf(mx, sv[q]);
      }
      const float m_old = sM[row];
      const float m_new = fmaxf(m_old, warp_max(mx));
      float pv[SL], sum = 0.f;
#pragma unroll
      for (int q = 0; q < SL; ++q) {
        pv[q] = expf(sv[q] - m_new);
        sum += pv[q];
      }
      sum = warp_sum(sum);
      const float corr = expf(m_old - m_new);
      __syncwarp();
      if (lane == 0) {
        sM[row] = m_new;
        sL[row] = sL[row] * corr + sum;
        sC[row] = corr;
      }
#pragma unroll
      for (int q = 0; q < SL; ++q) {
        bf16 pc[3];
        split3(pv[q], pc);
#pragma unroll
        for (int c = 0; c < 3; ++c)
          sP[c * kHeads * kPs + row * kPs + lane + 32 * q] = pc[c];
      }
    }
    __syncthreads();

    // the context: rescale, then add P V over the step's slots.  Every
    // warp computes MT tiles with no branch; a pair past its own (or past
    // r) reads the last pair of the row and is never written
    const float c_lo = sC[g], c_hi = sC[g + 8];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      acc[m][0] *= c_lo;
      acc[m][1] *= c_lo;
      acc[m][2] *= c_hi;
      acc[m][3] *= c_hi;
    }
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {
      unsigned pa[3][4];
#pragma unroll
      for (int c = 0; c < 3; ++c)
        ldsm_x4(pa[c],
                sP + c * kHeads * kPs + a_row * kPs + kk * 16 + a_col);
      const int v_row = kk * 16 + a_row;     // slots of the trans loads
      unsigned vb[MT][2];
#pragma unroll
      for (int m = 0; m < MT; m += 2) {
        const int col = (m < n_mine ? j_first + m : n8 - 2) * 8;
        unsigned x[4];
        ldsm_x4_t(x, kt + v_row * ks + col + a_col);
        vb[m][0] = x[0];
        vb[m][1] = x[1];
        vb[m + 1][0] = x[2];
        vb[m + 1][1] = x[3];
      }
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int m = 0; m < MT; ++m)
          mma(acc[m], pa[c], vb[m][0], vb[m][1]);
    }
    fence_async_proxy();
    cluster_sync();              // no block of the cluster reads buf now
  }

  // the split's partials: rows g and g + 8 of the warp's columns
  const size_t S = a.S;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int h = h0 + g + 8 * hh;
    if (h >= a.H) continue;
    float* dst = a.part + ((static_cast<size_t>(b) * a.H + h) * S + split) *
                              a.R + j_first * 8 + 2 * tq;
#pragma unroll
    for (int m = 0; m < MT; ++m)
      if (m < n_mine)
        *reinterpret_cast<float2*>(dst + m * 8) =
            make_float2(acc[m][2 * hh], acc[m][2 * hh + 1]);
  }
  if (tid < kHeads && h0 + tid < a.H) {
    float* ml = a.part_ml +
                ((static_cast<size_t>(b) * a.H + h0 + tid) * S + split) * 2;
    ml[0] = sM[tid];
    ml[1] = sL[tid];
  }
}

// --------------------------------------------------------------- combine
__global__ void __launch_bounds__(kLine) combine_kernel(Args a) {
  __shared__ float s_w[kMaxSplits];
  __shared__ unsigned char s_held[kMaxSplits];
  __shared__ float s_ctx[kMaxR];
  __shared__ __align__(16) float s_red[kLine * kVec];
  __shared__ float s_total;
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31;
  // W_vb[:, h, :]: nv lanes a row of v values; the first rows' loads go
  // out before the splits are combined
  const int nv = a.V / kVec, vl = tid % nv, grp = tid / nv;
  const int n_grp = kLine / nv;
  const bf16* w = a.wv_b + static_cast<size_t>(h) * a.V + vl * kVec;
  const size_t w_row = static_cast<size_t>(a.H) * a.V;
  uint4 raw[kUnroll];
  auto load = [&](int r0) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = min(r0 + u * n_grp, a.R - 1);
      raw[u] = __ldcs(reinterpret_cast<const uint4*>(w + r * w_row));
    }
  };
  load(grp);

  long long pos, n;
  filled(a, &pos, &n);
  const size_t row = static_cast<size_t>(b) * a.H + h;
  const float* ml = a.part_ml + row * a.S * 2;
  const float* part = a.part + row * a.S * a.R;
  // the splits' weights exp(m_s - M), those that hold slots ((s + 1) n / S
  // > s n / S) only, and the total of their sums, in a fixed order
  if (tid < 32) {
    float m_lane = -INFINITY;
    for (int s = lane; s < a.S; s += 32) {
      s_held[s] = (s + 1) * n / a.S > s * n / a.S;
      if (s_held[s]) m_lane = fmaxf(m_lane, ml[2 * s]);
    }
    const float M = warp_max(m_lane);
    float total = 0.f;
    for (int s = lane; s < a.S; s += 32) {
      const float ws = s_held[s] ? expf(ml[2 * s] - M) : 0.f;
      s_w[s] = ws;
      if (s_held[s]) total += ws * ml[2 * s + 1];
    }
    total = warp_sum(total);
    if (lane == 0) s_total = total;
  }
  __syncthreads();
  constexpr int kBatch = 16;     // partials in flight a thread
  for (int r = tid; r < a.R; r += kLine) {
    float c = 0.f;
    for (int s0 = 0; s0 < a.S; s0 += kBatch) {
      float v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int s = s0 + u;
        v[u] = s < a.S && s_held[s]
                   ? part[static_cast<size_t>(s) * a.R + r] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int s = s0 + u;
        if (s < a.S && s_held[s]) c += s_w[s] * v[u];
      }
    }
    s_ctx[r] = c / s_total;
  }
  __syncthreads();

  // out[v] = sum_r ctx[r] W_vb[r, h, v]
  float acc[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) acc[k] = 0.f;
  for (int r0 = grp; r0 < a.R; r0 += n_grp * kUnroll) {
    if (r0 != grp) load(r0);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      // a row past r (the last row read again) is selected away
      const int r = r0 + u * n_grp;
      float wv[kVec];
      widen(raw[u], wv);
      const float c = s_ctx[min(r, a.R - 1)];
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        acc[k] = r < a.R ? fmaf(c, wv[k], acc[k]) : acc[k];
    }
  }
#pragma unroll
  for (int k = 0; k < kVec; ++k) s_red[grp * a.V + vl * kVec + k] = acc[k];
  __syncthreads();
  bf16* out = a.out + row * a.V;
  for (int v = tid; v < a.V; v += kLine) {
    float o = s_red[v];
    for (int q = 1; q < n_grp; ++q) o += s_red[q * a.V + v];
    out[v] = __float2bfloat16_rn(o);
  }
}

// cudaFuncSetAttribute for the attend pass's dynamic shared memory, called
// once a device and size (the call costs more host time than a launch)
cudaError_t allow_smem(size_t bytes) {
  static size_t allowed[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= 64) return err;
  if (allowed[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(attend_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess) allowed[dev] = bytes;
  return err;
}

// the attend pass's launch configuration: clusters of cs head tiles of one
// split (attr holds the cluster's dimension)
cudaLaunchConfig_t attend_config(dim3 grid, size_t smem, int cs,
                                 cudaLaunchAttribute* attr,
                                 cudaStream_t st) {
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cs;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(32 * kWarps);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

cudaError_t launch(const Args& a, int sms, int cs, cudaStream_t st) {
  const long long rows = static_cast<long long>(a.R) * a.H;
  const long long per_block = kLine / 32 * 2 * kInFlight;
  const long long blocks = (rows + per_block - 1) / per_block;
  const int g1 = static_cast<int>(blocks < 2LL * sms ? blocks : 2LL * sms);
  absorb_kernel<<<g1, kLine, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = Layout(a.R, a.P).bytes();
  err = allow_smem(smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = attend_config(
      dim3(a.S, (a.H + kHeads - 1) / kHeads, a.B), smem, cs, attr, st);
  err = cudaLaunchKernelEx(&cfg, attend_kernel, a);
  if (err != cudaSuccess) return err;
  combine_kernel<<<dim3(a.H, a.B), kLine, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// q_nope (B, 1, H, N) and q_pe (B, 1, H, P) with unit last stride and the
// batch and head strides given (elements; rows on 16 bytes); the ring ckv
// (B, L, R), kpe (B, L, P) and the weights wk_b (R, H, N), wv_b (R, H, V)
// contiguous on 16 bytes; all bf16.  decode_pos at pos (a 0-d int64 on the
// device) or, where pos is null, pos_val; window 0 for none.  R a multiple
// of 32 up to 512, P of 8, R + P of 16, N a multiple of 8, V 8, 16, 32,
// ..., 256; 1 <= S <= 256 splits; clusters of cs (1, 2, 4 or 8, dividing
// the head tiles).  Scratch: q_abs B R H bf16, part B H S R floats,
// part_ml B H S 2 floats; out (B, 1, H, V) bf16.  Returns the CUDA error of
// an attribute call or a launch.
extern "C" int mla_decode_launch(
    const void* q_nope, const void* q_pe, const void* ckv, const void* kpe,
    const void* wk_b, const void* wv_b, const void* pos, long long qn_b,
    long long qn_h, long long qp_b, long long qp_h, long long pos_val, int B,
    int H, int N, int R, int P, int V, int L, int S, int window, int sms,
    int cs, float scale, void* q_abs, void* part, void* part_ml, void* out,
    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nv = V / kVec;
  const int tiles = (H + kHeads - 1) / kHeads;
  if (B < 1 || H < 1 || L < 1 || S < 1 || S > kMaxSplits || window < 0 ||
      sms < 1 || R < 32 || R % 32 || R > kMaxR || P < 0 || P % 8 ||
      (R + P) % 16 || N < 1 || N % kVec || V % kVec || nv < 1 || nv > 32 ||
      (nv & (nv - 1)) || cs < 1 || cs > 8 || (cs & (cs - 1)) || tiles % cs)
    return static_cast<int>(cudaErrorInvalidValue);
  typedef const bf16* in;
  Args a{static_cast<in>(q_nope), static_cast<in>(q_pe), static_cast<in>(ckv),
         static_cast<in>(kpe), static_cast<in>(wk_b), static_cast<in>(wv_b),
         static_cast<const long long*>(pos), qn_b, qn_h, qp_b, qp_h, pos_val,
         B, H, N, R, P, V, L, S, window, scale, static_cast<bf16*>(q_abs),
         static_cast<float*>(part), static_cast<float*>(part_ml),
         static_cast<bf16*>(out)};
  return static_cast<int>(launch(a, sms, cs, st));
}

// the clusters of cs blocks of the attend pass, for rows of R + P values,
// that fit on the current device at once; < 0: minus a CUDA error
extern "C" int mla_decode_clusters(int R, int P, int cs) {
  if (R < 32 || R % 32 || R > kMaxR || P < 0 || P % 8 || (R + P) % 16 ||
      cs < 1 || cs > 8)
    return -static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = Layout(R, P).bytes();
  cudaError_t err = allow_smem(smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      attend_config(dim3(1, cs, 1), smem, cs, attr, nullptr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, attend_kernel, &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}
