// The routed experts of a decode-shaped MoE layer: y = down(silu(x Wg) *
// (x Wu)) for each expert's C dispatch slots, reading only the weights of
// experts that hold a token.  Two launches a call: gate and up fused with
// SiLU and the product into bf16 (or f32) hidden rows, then the down
// product.
//
// Replaces no TPU kernel.  The JAX package leaves the expert products to
// XLA (models/moe.py: one batched product per matrix over all E experts
// and C slots), and the port's plain path does the same with torch.bmm
// (models/moe.py:_expert_ffn).  At decode the C slots of an expert hold at
// most a few tokens and most experts hold none: an empty slot carries a
// zero row and combine weight 0, so its output is multiplied away.  A
// batched product still reads every expert's weights.  This kernel reads
// the C occupancy flags (slot_w > 0) from device memory, so the decision
// needs no host value and the launch is captured in a CUDA graph with a
// fixed grid.
//
// Bound on the card: the touched experts' weight bytes at 3.35 TB/s.  C
// <= 4 rows (decode's capacity) against a whole weight matrix is 2 C
// flops a weight, far under the ~295 a byte where the tensor cores would
// bind, so the products run on the CUDA cores in float32.  The design streams the
// touched weights once, at the HBM rate:
//
// * Compacted experts.  Every block scans slot_w first and builds, in
//   shared memory, the list of experts with an occupied slot, in expert
//   order.  Nothing of an expert off the list is read.
// * Stream-K over a persistent grid.  The work of a launch is n_active
//   experts x n_tiles column tiles x ipt row chunks (RG rows each).  The
//   grid (one block an SM, fixed by the wrapper; fewer blocks where the
//   touched weights give a block under kMinRows rows) cuts that count into
//   equal contiguous ranges, one a block, so any number of touched
//   experts spreads over the SMs: the split is fixed by (n_active, shape,
//   grid) and never by timing.
// * Loads.  A lane owns VEC adjacent output columns (16 bytes of
//   weights, so CT x VEC accumulators a matrix), a warp a 32 * VEC
//   column tile, 8 warps take
//   interleaved groups of U = 8 rows: every row read is 32 * VEC
//   contiguous values, streamed past L1 (ld.global.cs), U rows of each
//   matrix in flight a thread (256 bytes in the gate/up pass; no
//   register spills at one block an SM).  The x rows of the chunk sit in
//   shared memory as float32, read as broadcasts.  (Measured at grok-1's
//   decode shape: ~0.83 of the HBM rate.  A cp.async ring of 3-8 stages
//   and warps across wider column tiles were no faster.)
// * Sums.  A thread accumulates in float32, row by row in ascending
//   order; the 8 warps' sums meet in shared memory and are added in warp
//   order.  A tile cut between blocks is written as float32 partials; the
//   block that takes the tile's last ticket (an integer atomicAdd after
//   __threadfence) adds them in block order, 8 float4 loads in flight a
//   thread, and finishes the tile.  No float atomics: two calls give the
//   same bits.
// * Rounding as the plain path rounds: gate and up to T, SiLU in float32
//   on the rounded gate then to T, the product in float32 then to T; the
//   down sums to T.  A slot whose weight is not > 0 and every row of an
//   expert off the list are written as exact zeros.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int CT = 4;                // the slots an expert: C <= CT
constexpr int kMaxExperts = 1024;
constexpr int kStageFloats = 16384;  // x values staged in shared memory
// the least rows of a tile a block takes: fewer blocks than the grid
// when the touched weights are few, so a cut tile has few partials
constexpr int kMinRows = 512;
constexpr int kFinishLoads = 8;      // partials a thread loads at once

// the element count a lane loads as one vector: 16 bytes
template <typename T>
__host__ __device__ constexpr int vec_of() {
  return static_cast<int>(16 / sizeof(T));
}

// 32-bit words of VEC values of T
template <typename T, int VEC>
__host__ __device__ constexpr int words() {
  return VEC * static_cast<int>(sizeof(T)) / 4;
}

template <int W>
struct Raw {
  unsigned int w[W];
};

template <typename T, int VEC>
__device__ __forceinline__ Raw<words<T, VEC>()> load_raw(const T* p) {
  constexpr int W = words<T, VEC>();
  Raw<W> r;
  if constexpr (W == 4) {
    const uint4 v = __ldcs(reinterpret_cast<const uint4*>(p));
    r.w[0] = v.x;
    r.w[1] = v.y;
    r.w[2] = v.z;
    r.w[3] = v.w;
  } else if constexpr (W == 2) {
    const uint2 v = __ldcs(reinterpret_cast<const uint2*>(p));
    r.w[0] = v.x;
    r.w[1] = v.y;
  } else {
    r.w[0] = __ldcs(reinterpret_cast<const unsigned int*>(p));
  }
  return r;
}

// VEC values of T as float32 (a bf16 is the high half of its float)
template <typename T, int VEC>
__device__ __forceinline__ void unpack(const Raw<words<T, VEC>()>& r,
                                       float (&v)[VEC]) {
  constexpr int W = words<T, VEC>();
#pragma unroll
  for (int i = 0; i < W; ++i) {
    if constexpr (sizeof(T) == 2) {
      v[2 * i] = __uint_as_float(r.w[i] << 16);
      v[2 * i + 1] = __uint_as_float(r.w[i] & 0xffff0000u);
    } else {
      v[i] = __uint_as_float(r.w[i]);
    }
  }
}

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

struct Problem {
  const void* x;          // (E, C, d_in) rows, expert-major
  const float* slot_w;    // (E * C) combine weights; > 0 marks a token
  const void* w0;         // (E, d_in, d_out)
  const void* w1;         // (E, d_in, d_out) (the up stack; gate/up only)
  void* out;              // (E, C, d_out)
  void* zero_out;         // (E, C, zero_d): rows of idle experts zeroed
  int zero_d;             // (gate/up only; 0 otherwise)
  float* part;            // grid * 2 * NM * C * TW floats
  int* tickets;           // E * n_tiles, zero on entry
  int E, C, d_in, d_out;
};

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float at4(float4 a, int k) {
  return k == 0 ? a.x : k == 1 ? a.y : k == 2 ? a.z : a.w;
}

// matrix m's sums of the 8 warps, in warp order, at slot c and the 4
// columns j..j+3 of the tile: red holds warp w's at ((w NM + m) CT + c)
// TW + column
template <int TW, int NM>
__device__ __forceinline__ float4 warp_sums(const float* red, int m, int c,
                                            int j) {
  float4 s = *reinterpret_cast<const float4*>(red + (m * CT + c) * TW + j);
#pragma unroll
  for (int w = 1; w < kWarps; ++w)
    s = add4(s, *reinterpret_cast<const float4*>(
                    red + ((w * NM + m) * CT + c) * TW + j));
  return s;
}

// the block of [0, G) whose range of [0, total) holds iteration i, where
// block b takes [b * total / G, (b + 1) * total / G)
__device__ __forceinline__ long long block_of(long long i, long long G,
                                              long long total) {
  return ((i + 1) * G - 1) / total;
}

// NM = 2: gate and up (out: the hidden rows); NM = 1: down (out: y)
template <typename T, int NM, int U>
__global__ void __launch_bounds__(kThreads, 1)
routed_kernel(Problem p) {
  constexpr int VEC = vec_of<T>();
  constexpr int TW = 32 * VEC;                 // columns of a tile
  constexpr int RG = kWarps * U;               // rows of an iteration
  constexpr int kStageRows = kStageFloats / CT;
  static_assert(kStageRows % RG == 0, "a stage is whole iterations");
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_active[kMaxExperts];
  __shared__ unsigned char s_on[kMaxExperts];
  __shared__ int s_n, s_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = p.C;

  // 1. the experts with an occupied slot, in expert order
  if (warp == 0) {
    int n = 0;
    for (int base = 0; base < p.E; base += 32) {
      const int e = base + lane;
      bool on = false;
      if (e < p.E)
        for (int c = 0; c < C; ++c)
          on |= p.slot_w[static_cast<size_t>(e) * C + c] > 0.f;
      const unsigned m = __ballot_sync(0xffffffffu, on);
      if (e < p.E) s_on[e] = on;
      if (on) s_active[n + __popc(m & ((1u << lane) - 1u))] = e;
      n += __popc(m);
    }
    if (lane == 0) s_n = n;
  }
  __syncthreads();
  const int n_active = s_n;

  if constexpr (NM == 2) {     // y's rows of the experts off the list
    const size_t per_e = static_cast<size_t>(C) * p.zero_d;
    const size_t n_y = per_e * p.E;
    T* y = static_cast<T*>(p.zero_out);
    for (size_t i = static_cast<size_t>(blockIdx.x) * kThreads + tid;
         i < n_y; i += static_cast<size_t>(gridDim.x) * kThreads)
      if (!s_on[i / per_e]) y[i] = from_f32<T>(0.f);
  }

  const int n_tiles = (p.d_out + TW - 1) / TW;
  const long long ipt = (p.d_in + RG - 1) / RG;
  const long long total = static_cast<long long>(n_active) * n_tiles * ipt;
  const long long G = min(static_cast<long long>(gridDim.x),
                          max(1LL, total * RG / kMinRows));
  const long long b = blockIdx.x;
  if (b >= G) return;
  const long long lo = b * total / G, hi = (b + 1) * total / G;

  const T* xs_all = static_cast<const T*>(p.x);
  const T* w0_all = static_cast<const T*>(p.w0);
  const T* w1_all = static_cast<const T*>(p.w1);
  T* out = static_cast<T*>(p.out);
  float* xs = smem;            // staged x: kStageRows rows of CT floats
  float* red = smem;           // the warps' sums, after the rows

  for (long long it = lo; it < hi;) {
    const long long tile = it / ipt;
    const long long tb = tile * ipt, te = tb + ipt;
    const long long se = min(hi, te);
    const int e = s_active[tile / n_tiles];
    const int col0 = static_cast<int>(tile % n_tiles) * TW;
    const int col = col0 + lane * VEC;
    const bool col_ok = col < p.d_out;
    const int k0 = static_cast<int>((it - tb) * RG);
    const int k1 = min(static_cast<int>((se - tb) * RG), p.d_in);
    const T* x = xs_all + static_cast<size_t>(e) * C * p.d_in;
    const size_t w_off = static_cast<size_t>(e) * p.d_in * p.d_out + col;
    const T* w[2] = {w0_all + w_off, NM == 2 ? w1_all + w_off : nullptr};

    float acc[NM][CT][VEC];
#pragma unroll
    for (int m = 0; m < NM; ++m)
#pragma unroll
      for (int c = 0; c < CT; ++c)
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[m][c][v] = 0.f;

    for (int kc = k0; kc < k1; kc += kStageRows) {
      const int n = min(kStageRows, k1 - kc);
      // whole iterations: the rows a warp reads past n are zeros
      const int n_st = min(kStageRows, (n + RG - 1) / RG * RG);
      __syncthreads();
      // 16 bytes of one slot's row a thread (d_in and kc are multiples
      // of 8, x starts on 16 bytes)
      constexpr int kPer = 16 / sizeof(T);
      const int groups = n_st / kPer;
      for (int i = tid; i < CT * groups; i += kThreads) {
        const int c = i / groups, r = i % groups * kPer;
        float v[kPer];
        if (c < C && r < n) {
          const Raw<4> raw = load_raw<T, kPer>(
              x + static_cast<size_t>(c) * p.d_in + kc + r);
          unpack<T, kPer>(raw, v);
        } else {
#pragma unroll
          for (int q = 0; q < kPer; ++q) v[q] = 0.f;
        }
#pragma unroll
        for (int q = 0; q < kPer; ++q) xs[(r + q) * CT + c] = v[q];
      }
      __syncthreads();
      if (!col_ok) continue;
      for (int i = warp * U; i < n; i += RG) {
        Raw<words<T, VEC>()> raw[NM][U];
#pragma unroll
        for (int m = 0; m < NM; ++m)
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if (i + u < n) {
              raw[m][u] = load_raw<T, VEC>(
                  w[m] + static_cast<size_t>(kc + i + u) * p.d_out);
            } else {
#pragma unroll
              for (int q = 0; q < words<T, VEC>(); ++q) raw[m][u].w[q] = 0u;
            }
          }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float xv[CT];
#pragma unroll
          for (int q = 0; q < CT / 4; ++q) {
            const float4 f4 =
                reinterpret_cast<const float4*>(xs + (i + u) * CT)[q];
            xv[4 * q] = f4.x;
            xv[4 * q + 1] = f4.y;
            xv[4 * q + 2] = f4.z;
            xv[4 * q + 3] = f4.w;
          }
#pragma unroll
          for (int m = 0; m < NM; ++m) {
            float wv[VEC];
            unpack<T, VEC>(raw[m][u], wv);
#pragma unroll
            for (int c = 0; c < CT; ++c)
#pragma unroll
              for (int v = 0; v < VEC; ++v)
                acc[m][c][v] = fmaf(xv[c], wv[v], acc[m][c][v]);
          }
        }
      }
    }

    // the warps' sums, added in warp order
    __syncthreads();
#pragma unroll
    for (int m = 0; m < NM; ++m)
#pragma unroll
      for (int c = 0; c < CT; ++c)
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          red[((warp * NM + m) * CT + c) * TW + lane * VEC + v] =
              acc[m][c][v];
    __syncthreads();

    const bool whole = it == tb && se == te;
    const int slot = lo >= tb ? 0 : 1;     // the block's first tile or last
    const size_t part_of = static_cast<size_t>(NM) * C * TW;
    const long long bf = block_of(tb, G, total);
    const long long bl = block_of(te - 1, G, total);
    // a thread's 4 adjacent outputs (c, j..j+3) of each matrix: the warps'
    // sums in warp order, then, for a cut tile, the contributors' in
    // block order
    constexpr int kQuads = TW / 4;
    if (!whole) {
      float* my_part = p.part + (static_cast<size_t>(b) * 2 + slot) * part_of;
      for (int q4 = tid; q4 < C * kQuads; q4 += kThreads) {
        const int c = q4 / kQuads, j = q4 % kQuads * 4;
#pragma unroll
        for (int m = 0; m < NM; ++m) {
          float4 s = warp_sums<TW, NM>(red, m, c, j);
          reinterpret_cast<float4*>(my_part + m * C * TW)[q4] = s;
        }
      }
      __threadfence();
      __syncthreads();
      if (tid == 0)
        s_last = atomicAdd(p.tickets + tile, 1) == static_cast<int>(bl - bf);
      __syncthreads();
      if (!s_last) {
        it = se;
        continue;
      }
      __threadfence();
    }

    for (int q4 = tid; q4 < C * kQuads; q4 += kThreads) {
      const int c = q4 / kQuads, j = q4 % kQuads * 4;
      float4 s[NM];
#pragma unroll
      for (int m = 0; m < NM; ++m) {
        if (whole) {
          s[m] = warp_sums<TW, NM>(red, m, c, j);
          continue;
        }
        for (long long b0 = bf; b0 <= bl; b0 += kFinishLoads) {
          float4 v[kFinishLoads];
#pragma unroll
          for (int q = 0; q < kFinishLoads; ++q) {
            const long long bb = b0 + q;
            if (bb > bl) break;
            const int bslot = bb * total / G >= tb ? 0 : 1;
            v[q] = __ldcg(reinterpret_cast<const float4*>(
                              p.part + (static_cast<size_t>(bb) * 2 + bslot) *
                                           part_of + m * C * TW) + q4);
          }
#pragma unroll
          for (int q = 0; q < kFinishLoads; ++q) {
            if (b0 + q > bl) break;
            s[m] = b0 + q == bf ? v[q] : add4(s[m], v[q]);
          }
        }
      }
      const bool on = p.slot_w[static_cast<size_t>(e) * C + c] > 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int cc = col0 + j + k;
        if (cc >= p.d_out) break;
        float o = 0.f;
        if (on) {
          if constexpr (NM == 2) {
            const float g = round_to<T>(at4(s[0], k));
            const float up = round_to<T>(at4(s[1], k));
            o = round_to<T>(g / (1.f + expf(-g))) * up;
          } else {
            o = at4(s[0], k);
          }
        }
        out[(static_cast<size_t>(e) * C + c) * p.d_out + cc] =
            from_f32<T>(o);
      }
    }
    it = se;
  }
}

template <typename T, int NM>
constexpr size_t smem_bytes() {
  constexpr size_t red = sizeof(float) * kWarps * NM * CT * 32 *
                         vec_of<T>();
  constexpr size_t stage = sizeof(float) * kStageFloats;
  return red > stage ? red : stage;
}

template <typename T, int NM, int U>
cudaError_t launch_one(const Problem& p, int grid, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<T, NM>();
  // 64 KB of warp sums pass the default limit
  const cudaError_t err = cudaFuncSetAttribute(
      routed_kernel<T, NM, U>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  routed_kernel<T, NM, U><<<grid, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const float* slot_w, const void* w_gate,
                   const void* w_up, const void* w_down, int E, int C, int d,
                   int f, int grid, float* part, long long part_floats,
                   int* tickets, long long n_tickets, void* h, void* y,
                   cudaStream_t st) {
  constexpr int TW = 32 * vec_of<T>();
  const long long tiles_f = (f + TW - 1) / TW, tiles_d = (d + TW - 1) / TW;
  if (part_floats < static_cast<long long>(grid) * 2 * 2 * C * TW ||
      n_tickets < E * (tiles_f + tiles_d))
    return cudaErrorInvalidValue;
  Problem up{x, slot_w, w_gate, w_up, h, y, d, part, tickets, E, C, d, f};
  cudaError_t err = launch_one<T, 2, 8>(up, grid, st);
  if (err != cudaSuccess) return err;
  Problem down{h, slot_w, w_down, nullptr, y, nullptr, 0, part,
               tickets + E * tiles_f, E, C, f, d};
  return launch_one<T, 1, 8>(down, grid, st);
}

}  // namespace

// x (E, C, d) and the stacks w_gate, w_up (E, d, f) and w_down (E, f, d),
// contiguous, 16-byte aligned, all f32 (dtype 0) or all bf16 (dtype 1),
// d and f multiples of 8, 1 <= C <= 4, 1 <= E <= 1024; slot_w (E * C)
// float32.  h (E, C, f) and y (E, C, d) in x's type: y is written whole,
// h only for experts with an occupied slot.  part: at least grid * 4 * C
// * TW floats of scratch, tickets: E * (ceil(f / TW) + ceil(d / TW)) ints,
// zero on entry, not on exit (TW = 32 * vec_of<T>).
// Returns the CUDA error of an attribute call or a launch.
extern "C" int routed_experts_launch(const void* x, const void* slot_w,
                                     const void* w_gate, const void* w_up,
                                     const void* w_down, int E, int C, int d,
                                     int f, int dtype, int grid, void* part,
                                     long long part_floats, void* tickets,
                                     long long n_tickets, void* h, void* y,
                                     void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (E < 1 || E > kMaxExperts || C < 1 || C > CT || d < 8 || f < 8 ||
      d % 8 || f % 8 || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* sw = static_cast<const float*>(slot_w);
  float* pt = static_cast<float*>(part);
  int* tk = static_cast<int*>(tickets);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(x, sw, w_gate, w_up, w_down, E, C, d, f, grid, pt,
                        part_floats, tk, n_tickets, h, y, st);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(x, sw, w_gate, w_up, w_down, E, C, d, f,
                                grid, pt, part_floats, tk, n_tickets, h, y,
                                st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
