// K2a/K2b/K2c paged_attention: one-token GQA decode through a paged KV
// pool, for Hopper (sm_90a). K2a reads float pools (bf16 or fp32); K2b
// reads quantized pools (src/repro_torch/quant/kv.py): int8 codes, or int4
// codes packed two per byte (low nibble first, biased by +8), with one fp16
// scale per group of `group_size` contiguous head elements. K2c is either
// walk under a sliding window with sink tokens (DESIGN.md §17): key
// position kp is attended iff kp <= pos and (pos - kp < window or
// kp < sinks).
//
// Replaces: src/repro/kernels/paged_attention/paged_attention.py:
// paged_attention_pallas (kernel body _kernel), with a float pool (K2a) or
// k_scale/v_scale (K2b), with window=None; with a window and sinks, K2c.
// The TPU kernel runs a (slot, logical block) grid with the block table
// (and, windowed, the first live block fl) scalar-prefetched into the K/V
// (and scale) index maps, routes dead blocks to block 0 and carries the
// online softmax state (m, l, acc) in VMEM scratch across a slot's blocks.
// Thread blocks on this card run in parallel and carry nothing from one to
// the next, so the walk is split ("flash-decoding"):
//
//   * a row's live logical blocks form one list: unwindowed, blocks
//     0 .. pos // bs; windowed, the sink blocks [0, ceil(sinks / bs)), then
//     [fl, pos // bs] with fl = max((pos - window + 1) // bs,
//     ceil(sinks / bs)) (floor division, as the engine's eviction computes
//     it). The list is cut into chunks of `chunk` blocks from its start;
//   * the split pass runs a (B, KV x head tiles, n_splits) grid: one thread
//     block per (slot, KV head, up to 8 of its query heads, chunk). It
//     writes its chunk's partial (m, l, acc[G][hd]) in fp32 to a workspace;
//     a chunk past the row's end writes (m = -inf, l = 0) and returns.
//     `chunk` and `n_splits` come from the host's integers (the wrapper's
//     split_plan): pos lives on the device and is never read on the host;
//   * the combine pass, one thread block per (slot, KV head, query head,
//     64 head elements), merges the row's partials in split order and
//     writes acc / max(l, 1e-30), one thread a head element; each
//     partial's weight exp(m - max m) is formed once, in shared memory.
//     Empty partials enter as exact zeros (their acc is never read), so
//     trailing empty splits leave the result's bits alone.
//
// What bounds it on an H100: bytes. Every cached K/V element is used for
// 2 FLOPs per query head of its group (G = 8 at tinyllama, 2 at gemma2),
// far below the ridge, so the floor is the K/V bytes (codes and scales for
// K2b) of the tokens each row attends: for K2c, the sinks and the window
// only. What the design does about it:
//   * enough thread blocks: a gemma2 long row (~4500 tokens) is ~70 chunks
//     of 64 tokens, each its own thread block, so a launch over two such
//     rows runs ~600 of them on the 132 SMs;
//   * inside a split block, 4 warps share the chunk's tokens: a warp takes
//     32 / lpr tokens a step, lpr = hd / 8 lanes per token row (rounded up
//     to a power of two), each lane 8 consecutive head elements: one
//     16-byte load of bf16, two of fp32, 8 bytes of int8 codes or 4 of int4
//     nibbles (and the group's scale). Every lane keeps G accumulators of 8
//     elements, so a wider load would cost registers that G = 8 lacks;
//   * each token's K row is read once and scored for all of the block's
//     query heads; the next two steps' K and V are loaded into registers
//     while the current step is scored;
//   * each token of the chunk is resolved once, into shared memory, to its
//     pool token or to "not attended": entries of -1, blocks past pos and
//     (K2c) blocks outside the two segments are never read (the TPU
//     kernel's `run` predicate), and masked columns are skipped, so no
//     masked score is computed;
//   * per token and query head: a lpr-lane q.k (shuffle butterfly), times
//     hd**-0.5, optional tanh softcap, then an online-softmax update of the
//     lane's m, l and acc. K, V and the probabilities stay fp32, as in the
//     TPU kernel. The token slots of a warp, then the warps in order, are
//     merged in a fixed order; no atomics, so two calls give the same bits.
// A window that does not bind (window > pos) gives the unwindowed list, the
// same chunks (the wrapper's chunk does not depend on the window) and the
// same per-column code, so K2c then gives K2a's or K2b's bits.
// The products and sums that merge carries are written with explicit
// rounding intrinsics, so no instantiation contracts them differently.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kWarps = 4;             // warps of a split thread block
constexpr int kThreads = 32 * kWarps;
constexpr int kEpl = 8;               // head elements a lane owns
constexpr int kHeadTile = 8;          // query heads a split block scores
constexpr int kMaxChunk = 64;         // blocks in a chunk, at most
constexpr int kMaxChunkTokens = 2048;  // tokens in a chunk, at most
constexpr int kMaxSplits = 4096;      // the combine's weights fit 32 KB
constexpr int kCombineCols = 64;      // head elements a combine block writes
constexpr int kCombineTile = 32;  // partials a combine thread has in flight

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// 8 bf16 (one uint4) -> fp32
__device__ __forceinline__ void bf16x8(const uint4& u, float (&x)[kEpl]) {
  x[0] = bf16_lo(u.x); x[1] = bf16_hi(u.x);
  x[2] = bf16_lo(u.y); x[3] = bf16_hi(u.y);
  x[4] = bf16_lo(u.z); x[5] = bf16_hi(u.z);
  x[6] = bf16_lo(u.w); x[7] = bf16_hi(u.w);
}

__device__ __forceinline__ int floor_div(int a, int b) {  // b > 0
  const int q = a / b;  // C++ truncates toward zero; floor it as Python does
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// Load policies: one lane's 8 consecutive head elements [d0, d0 + 8) of
// the K and V rows of token vector `vec` ((phys * bs + t) * KV + h), raw
// (Frag), then as fp32.
template <typename T>
struct FloatPool;

template <>
struct FloatPool<__nv_bfloat16> {
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  struct Frag {
    uint4 k, v;
  };

  __device__ __forceinline__ void load(Frag& f, size_t vec, int hd,
                                       int d0) const {
    const size_t o = vec * hd + d0;
    f.k = __ldg(reinterpret_cast<const uint4*>(k + o));
    f.v = __ldg(reinterpret_cast<const uint4*>(v + o));
  }
  __device__ __forceinline__ static void zero(Frag& f) {
    f.k = f.v = make_uint4(0u, 0u, 0u, 0u);
  }
  __device__ __forceinline__ static void to_f32(const Frag& f,
                                                float (&kf)[kEpl],
                                                float (&vf)[kEpl]) {
    bf16x8(f.k, kf);
    bf16x8(f.v, vf);
  }
};

template <>
struct FloatPool<float> {
  const float* k;
  const float* v;
  struct Frag {
    float4 k0, k1, v0, v1;
  };

  __device__ __forceinline__ void load(Frag& f, size_t vec, int hd,
                                       int d0) const {
    const float4* kk = reinterpret_cast<const float4*>(k + vec * hd + d0);
    const float4* vv = reinterpret_cast<const float4*>(v + vec * hd + d0);
    f.k0 = __ldg(kk);
    f.k1 = __ldg(kk + 1);
    f.v0 = __ldg(vv);
    f.v1 = __ldg(vv + 1);
  }
  __device__ __forceinline__ static void zero(Frag& f) {
    f.k0 = f.k1 = f.v0 = f.v1 = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __device__ __forceinline__ static void to_f32(const Frag& f,
                                                float (&kf)[kEpl],
                                                float (&vf)[kEpl]) {
    kf[0] = f.k0.x; kf[1] = f.k0.y; kf[2] = f.k0.z; kf[3] = f.k0.w;
    kf[4] = f.k1.x; kf[5] = f.k1.y; kf[6] = f.k1.z; kf[7] = f.k1.w;
    vf[0] = f.v0.x; vf[1] = f.v0.y; vf[2] = f.v0.z; vf[3] = f.v0.w;
    vf[4] = f.v1.x; vf[5] = f.v1.y; vf[6] = f.v1.z; vf[7] = f.v1.w;
  }
};

// BITS = 8: int8 codes (.., hd); BITS = 4: uint8 nibbles (.., hd / 2).
// Element d becomes code(d) * scale[d / group_size] in fp32, the product
// quant/kv.py:dequant_codes forms; group_size is a multiple of 8, so a
// lane's 8 elements share one scale.
template <int BITS>
struct QuantPool {
  const void* k;
  const void* v;
  const __half* k_scale;  // (.., ng)
  const __half* v_scale;
  int group_size;
  int ng;
  using Word = std::conditional_t<BITS == 8, uint2, uint32_t>;
  struct Frag {
    Word k, v;
    float ks, vs;
  };

  __device__ __forceinline__ void load(Frag& f, size_t vec, int hd,
                                       int d0) const {
    const size_t o = (vec * hd + d0) * BITS / 8;  // bytes
    f.k = __ldg(reinterpret_cast<const Word*>(
        static_cast<const uint8_t*>(k) + o));
    f.v = __ldg(reinterpret_cast<const Word*>(
        static_cast<const uint8_t*>(v) + o));
    const size_t so = vec * ng + d0 / group_size;
    f.ks = __half2float(k_scale[so]);
    f.vs = __half2float(v_scale[so]);
  }
  __device__ __forceinline__ static void zero(Frag& f) {
    if constexpr (BITS == 8) {
      f.k = f.v = make_uint2(0u, 0u);
    } else {
      f.k = f.v = 0u;
    }
    f.ks = f.vs = 0.f;
  }
  __device__ __forceinline__ static void codes(const Word& w,
                                               float (&x)[kEpl]) {
    if constexpr (BITS == 8) {
#pragma unroll
      for (int e = 0; e < kEpl; ++e) {
        const uint32_t word = e < 4 ? w.x : w.y;
        x[e] = static_cast<float>(
            static_cast<int8_t>((word >> (8 * (e & 3))) & 0xffu));
      }
    } else {
#pragma unroll
      for (int e = 0; e < kEpl; ++e) {
        x[e] = static_cast<float>(static_cast<int>((w >> (4 * e)) & 0xfu)
                                  - 8);
      }
    }
  }
  __device__ __forceinline__ static void to_f32(const Frag& f,
                                                float (&kf)[kEpl],
                                                float (&vf)[kEpl]) {
    codes(f.k, kf);
    codes(f.v, vf);
#pragma unroll
    for (int e = 0; e < kEpl; ++e) {
      kf[e] = __fmul_rn(kf[e], f.ks);
      vf[e] = __fmul_rn(vf[e], f.vs);
    }
  }
};

// Merge carry (mo, lo, ao) into (m, l, a). l == 0 marks an empty carry.
__device__ __forceinline__ void merge(float& m, float& l, float (&a)[kEpl],
                                      float mo, float lo,
                                      const float (&ao)[kEpl]) {
  if (lo == 0.f) return;
  if (l == 0.f) {
    m = mo;
    l = lo;
#pragma unroll
    for (int e = 0; e < kEpl; ++e) a[e] = ao[e];
    return;
  }
  const float mn = fmaxf(m, mo);
  const float w = expf(m - mn), wo = expf(mo - mn);
  l = __fadd_rn(__fmul_rn(l, w), __fmul_rn(lo, wo));
#pragma unroll
  for (int e = 0; e < kEpl; ++e) {
    a[e] = __fadd_rn(__fmul_rn(a[e], w), __fmul_rn(ao[e], wo));
  }
  m = mn;
}

// Workspace: acc (rows, hd) then (m, l) (rows, 2), rows = B * KV * n_splits
// * G, row ((b * KV + h) * n_splits + split) * G + g.
__device__ __forceinline__ size_t ws_row(int b, int h, int split, int g,
                                         int KV, int nsplit, int G) {
  return (((size_t)b * KV + h) * nsplit + split) * G + g;
}

// Load token u of the chunk into f: s_tok[u] is its pool token (phys * bs
// + column), or -1 where the row does not attend it (and for u past the
// chunk). Returns whether it is attended; a token that is not, and a lane
// past hd, is not read and loads zeros.
template <typename Pool>
__device__ __forceinline__ bool fetch(const Pool& pool,
                                      typename Pool::Frag& f, int u,
                                      int ntok, const int* s_tok, int h,
                                      int KV, int hd, int d0, bool lane_on) {
  const int pt = u < ntok ? s_tok[u] : -1;
  if (pt >= 0 && lane_on) {
    pool.load(f, (size_t)pt * KV + h, hd, d0);
  } else {
    Pool::zero(f);
  }
  return pt >= 0;
}

// The split pass of one (slot b, KV head h, head tile, chunk) thread block.
// GMAX: the head tile's width rounded up to a power of two (<= kHeadTile).
template <bool WINDOWED, int GMAX, typename Pool>
__device__ __forceinline__ void split_pass(
    const __nv_bfloat16* __restrict__ q, const Pool& pool,
    const int* __restrict__ table, const int* __restrict__ pos,
    float* __restrict__ ws, int B, int KV, int G, int hd, int bs,
    int max_blocks, int chunk, float scale, float softcap, int window,
    int sinks) {
  // per warp: GMAX x hd acc and GMAX x (m, l); then the chunk's tokens
  extern __shared__ float smem[];

  const int b = blockIdx.x;
  const int tiles = (G + kHeadTile - 1) / kHeadTile;
  const int h = blockIdx.y / tiles;
  const int g0 = (blockIdx.y % tiles) * kHeadTile;
  const int gt = min(G - g0, kHeadTile);  // query heads of this block
  const int split = blockIdx.z;
  const int nsplit = gridDim.z;
  const int p = pos[b];
  const int* row = table + (size_t)b * max_blocks;
  const size_t rows = (size_t)B * KV * nsplit * G;
  float* ws_acc = ws + ws_row(b, h, split, g0, KV, nsplit, G) * hd;
  float* ws_ml = ws + rows * hd + ws_row(b, h, split, g0, KV, nsplit, G) * 2;

  // the row's live blocks as one list: [0, sink_end) then [first, last]
  const int last = p < 0 ? -1 : min(p / bs, max_blocks - 1);
  int sink_end = 0, first = 0;
  if constexpr (WINDOWED) {
    const int sink_blocks = (sinks + bs - 1) / bs;
    first = max(floor_div(p - window + 1, bs), sink_blocks);
    sink_end = min(sink_blocks, last + 1);
  }
  const int len = sink_end + max(0, last - first + 1);
  const int i0 = split * chunk;
  if (i0 >= len) {  // past the row's end: an empty partial
    for (int g = threadIdx.x; g < gt; g += blockDim.x) {
      ws_ml[2 * g] = -INFINITY;
      ws_ml[2 * g + 1] = 0.f;
    }
    return;
  }
  // each token of the chunk: its pool token, or -1 where it is not
  // attended (a table entry of -1, a column past pos, outside the window)
  const int ntok = chunk * bs;
  int* s_tok =
      reinterpret_cast<int*>(smem + (size_t)kWarps * GMAX * (hd + 2));
  for (int u = threadIdx.x; u < ntok; u += blockDim.x) {
    const int li = i0 + u / bs;
    const int t = u % bs;
    int pt = -1;
    if (li < len) {
      const int j = li < sink_end ? li : first + (li - sink_end);
      const int ph = row[j];
      const int kp = j * bs + t;
      bool ok = ph >= 0 && kp <= p;
      if constexpr (WINDOWED) ok = ok && (p - kp < window || kp < sinks);
      if (ok) pt = ph * bs + t;
    }
    s_tok[u] = pt;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  int lpr = 1;  // lanes per token row
  while (lpr * kEpl < hd) lpr <<= 1;
  const int tpw = 32 / lpr;  // tokens a warp takes per step
  const int slot = lane / lpr;
  const int d0 = (lane % lpr) * kEpl;
  const bool lane_on = d0 < hd;

  uint4 qv[GMAX];  // 8 bf16 of each query head
  float m[GMAX], l[GMAX], acc[GMAX][kEpl];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    qv[g] = make_uint4(0u, 0u, 0u, 0u);
    if (lane_on && g < gt) {
      qv[g] = __ldg(reinterpret_cast<const uint4*>(
          q + (((size_t)b * KV + h) * G + g0 + g) * hd + d0));
    }
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kEpl; ++e) acc[g][e] = 0.f;
  }

  const int step = kWarps * tpw;
  const int nsteps = (ntok + step - 1) / step;
  using Frag = typename Pool::Frag;
  // the token slot's K/V of this step (f0) and of the next two (f1, f2)
  Frag f0, f1, f2;
  const int u0 = warp * tpw + slot;
  bool ok0 = fetch(pool, f0, u0, ntok, s_tok, h, KV, hd, d0, lane_on);
  bool ok1 = fetch(pool, f1, u0 + step, ntok, s_tok, h, KV, hd, d0, lane_on);
  for (int s = 0; s < nsteps; ++s) {
    const bool ok2 = fetch(pool, f2, u0 + (s + 2) * step, ntok, s_tok, h,
                           KV, hd, d0, lane_on);
    float kf[kEpl], vf[kEpl];
    Pool::to_f32(f0, kf, vf);
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      float qf[kEpl];
      bf16x8(qv[g], qf);
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < kEpl; ++e) dot = __fmaf_rn(qf[e], kf[e], dot);
      for (int o = lpr / 2; o > 0; o >>= 1) {
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      }
      if (ok0 && g < gt) {  // uniform over the token's lanes
        float sc = dot * scale;
        if (softcap > 0.f) sc = tanhf(sc / softcap) * softcap;
        const float m_new = fmaxf(m[g], sc);
        const float alpha = expf(m[g] - m_new);
        const float pe = expf(sc - m_new);
        l[g] = __fmaf_rn(l[g], alpha, pe);
#pragma unroll
        for (int e = 0; e < kEpl; ++e) {
          acc[g][e] = __fmaf_rn(pe, vf[e], __fmul_rn(acc[g][e], alpha));
        }
        m[g] = m_new;
      }
    }
    f0 = f1;
    ok0 = ok1;
    f1 = f2;
    ok1 = ok2;
  }

  // merge the warp's token slots (butterfly over the slot bits), then the
  // warps in order through shared memory
  for (int o = lpr; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], o);
      float ao[kEpl];
#pragma unroll
      for (int e = 0; e < kEpl; ++e) {
        ao[e] = __shfl_xor_sync(0xffffffffu, acc[g][e], o);
      }
      merge(m[g], l[g], acc[g], mo, lo, ao);
    }
  }
  float* w_acc = smem;                            // (kWarps, GMAX, hd)
  float* w_ml = smem + (size_t)kWarps * GMAX * hd;  // (kWarps, GMAX, 2)
  if (slot == 0 && lane_on) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < gt) {
#pragma unroll
        for (int e = 0; e < kEpl; ++e) {
          w_acc[(warp * GMAX + g) * hd + d0 + e] = acc[g][e];
        }
        if (lane == 0) {
          w_ml[2 * (warp * GMAX + g)] = m[g];
          w_ml[2 * (warp * GMAX + g) + 1] = l[g];
        }
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < gt * hd; i += blockDim.x) {
    const int g = i / hd, d = i - g * hd;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (w_ml[2 * (w * GMAX + g) + 1] > 0.f) {
        mx = fmaxf(mx, w_ml[2 * (w * GMAX + g)]);
      }
    }
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float lw = w_ml[2 * (w * GMAX + g) + 1];
      if (lw > 0.f) {
        const float e = expf(w_ml[2 * (w * GMAX + g)] - mx);
        lsum = __fmaf_rn(lw, e, lsum);
        a = __fmaf_rn(w_acc[(w * GMAX + g) * hd + d], e, a);
      }
    }
    ws_acc[(size_t)g * hd + d] = a;
    if (d == 0) {
      ws_ml[2 * g] = mx;
      ws_ml[2 * g + 1] = lsum;
    }
  }
}

// The combine pass of one (slot b, KV head h, query head g, kCombineCols
// head elements) thread block: the row's n_splits partials merged in split
// order, one thread a head element. The largest m of the live partials (a
// max: the same in any order) and each partial's weight exp(m - max) are
// formed once, in shared memory; every element then sums l and acc times
// the weights in split order, its acc loads kCombineTile partials at a
// time. An empty partial (l = 0) has weight 0 and its acc is not read.
__device__ __forceinline__ void combine_pass(const float* __restrict__ ws,
                                             float* __restrict__ out, int B,
                                             int KV, int G, int hd,
                                             int nsplit) {
  extern __shared__ float sh[];  // (nsplit) weights, then (nsplit) l
  __shared__ float warp_max[kCombineCols / 32];
  float* wts = sh;
  float* ls = sh + nsplit;
  const int b = blockIdx.x;
  const int h = blockIdx.y / G;
  const int g = blockIdx.y % G;
  const size_t rows = (size_t)B * KV * nsplit * G;
  const size_t r0 = ws_row(b, h, 0, g, KV, nsplit, G);
  const float* ml = ws + rows * hd + r0 * 2;  // split s at 2 * s * G
  const float* acc = ws + r0 * hd;            // split s at s * G * hd
  float mx = -INFINITY;
  for (int s = threadIdx.x; s < nsplit; s += kCombineCols) {
    const float l = ml[2 * (size_t)s * G + 1];
    ls[s] = l;
    if (l > 0.f) mx = fmaxf(mx, ml[2 * (size_t)s * G]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  }
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = mx;
  __syncthreads();
  mx = -INFINITY;
#pragma unroll
  for (int w = 0; w < kCombineCols / 32; ++w) mx = fmaxf(mx, warp_max[w]);
  for (int s = threadIdx.x; s < nsplit; s += kCombineCols) {
    wts[s] = ls[s] > 0.f ? expf(ml[2 * (size_t)s * G] - mx) : 0.f;
  }
  __syncthreads();
  const int d = blockIdx.z * kCombineCols + threadIdx.x;
  if (d >= hd) return;
  float lsum = 0.f, a = 0.f;
  for (int s0 = 0; s0 < nsplit; s0 += kCombineTile) {
    float x[kCombineTile];
#pragma unroll
    for (int i = 0; i < kCombineTile; ++i) {
      const int s = s0 + i;
      x[i] = s < nsplit && ls[s] > 0.f ? acc[(size_t)s * G * hd + d] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kCombineTile; ++i) {
      const int s = s0 + i;
      if (s < nsplit) {
        lsum = __fmaf_rn(ls[s], wts[s], lsum);
        a = __fmaf_rn(x[i], wts[s], a);
      }
    }
  }
  out[(((size_t)b * KV + h) * G + g) * hd + d] = a / fmaxf(lsum, 1e-30f);
}

// One split kernel and one combine kernel per wrapper, each named
// "<wrapper>_kernel..." so that a profile charges both passes to it.
template <typename T, int GMAX>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const __nv_bfloat16* __restrict__ q, FloatPool<T> pool,
    const int* __restrict__ table, const int* __restrict__ pos,
    float* __restrict__ ws, int B, int KV, int G, int hd, int bs,
    int max_blocks, int chunk, float scale, float softcap) {
  split_pass<false, GMAX>(q, pool, table, pos, ws, B, KV, G, hd, bs,
                          max_blocks, chunk, scale, softcap, 0, 0);
}

template <int BITS, int GMAX>
__global__ void __launch_bounds__(kThreads) paged_attention_quant_kernel(
    const __nv_bfloat16* __restrict__ q, QuantPool<BITS> pool,
    const int* __restrict__ table, const int* __restrict__ pos,
    float* __restrict__ ws, int B, int KV, int G, int hd, int bs,
    int max_blocks, int chunk, float scale, float softcap) {
  split_pass<false, GMAX>(q, pool, table, pos, ws, B, KV, G, hd, bs,
                          max_blocks, chunk, scale, softcap, 0, 0);
}

template <typename T, int GMAX>
__global__ void __launch_bounds__(kThreads) paged_attention_window_kernel(
    const __nv_bfloat16* __restrict__ q, FloatPool<T> pool,
    const int* __restrict__ table, const int* __restrict__ pos,
    float* __restrict__ ws, int B, int KV, int G, int hd, int bs,
    int max_blocks, int chunk, float scale, float softcap, int window,
    int sinks) {
  split_pass<true, GMAX>(q, pool, table, pos, ws, B, KV, G, hd, bs,
                         max_blocks, chunk, scale, softcap, window, sinks);
}

template <int BITS, int GMAX>
__global__ void __launch_bounds__(kThreads)
    paged_attention_quant_window_kernel(
        const __nv_bfloat16* __restrict__ q, QuantPool<BITS> pool,
        const int* __restrict__ table, const int* __restrict__ pos,
        float* __restrict__ ws, int B, int KV, int G, int hd, int bs,
        int max_blocks, int chunk, float scale, float softcap, int window,
        int sinks) {
  split_pass<true, GMAX>(q, pool, table, pos, ws, B, KV, G, hd, bs,
                         max_blocks, chunk, scale, softcap, window, sinks);
}

__global__ void paged_attention_kernel_combine(const float* ws, float* out,
                                               int B, int KV, int G, int hd,
                                               int nsplit) {
  combine_pass(ws, out, B, KV, G, hd, nsplit);
}

__global__ void paged_attention_quant_kernel_combine(const float* ws,
                                                     float* out, int B,
                                                     int KV, int G, int hd,
                                                     int nsplit) {
  combine_pass(ws, out, B, KV, G, hd, nsplit);
}

__global__ void paged_attention_window_kernel_combine(const float* ws,
                                                      float* out, int B,
                                                      int KV, int G, int hd,
                                                      int nsplit) {
  combine_pass(ws, out, B, KV, G, hd, nsplit);
}

__global__ void paged_attention_quant_window_kernel_combine(
    const float* ws, float* out, int B, int KV, int G, int hd, int nsplit) {
  combine_pass(ws, out, B, KV, G, hd, nsplit);
}

// Shapes the kernels take: hd a multiple of 8 up to 256, 1 <= chunk <=
// kMaxChunk blocks of at most kMaxChunkTokens tokens, at most kMaxSplits
// splits, grid axes within CUDA's limits.
bool shapes_ok(int B, int KV, int G, int hd, int bs, int max_blocks,
               int chunk, int nsplit) {
  const long tiles = (G + kHeadTile - 1) / kHeadTile;
  return B >= 1 && KV >= 1 && G >= 1 && bs >= 1 && max_blocks >= 0 &&
         hd >= kEpl && hd <= 256 && hd % kEpl == 0 && chunk >= 1 &&
         chunk <= kMaxChunk && chunk * bs <= kMaxChunkTokens &&
         nsplit >= 1 && nsplit <= kMaxSplits &&
         (long)KV * tiles <= 65535 && (long)KV * G <= 65535;
}

// Calls launch(std::integral_constant<int, GMAX>{}) for the head tile's
// width, min(G, kHeadTile), rounded up to a power of two.
template <typename F>
void dispatch_heads(int G, F&& launch) {
  const int gt = G < kHeadTile ? G : kHeadTile;
  if (gt <= 1) {
    launch(std::integral_constant<int, 1>{});
  } else if (gt <= 2) {
    launch(std::integral_constant<int, 2>{});
  } else if (gt <= 4) {
    launch(std::integral_constant<int, 4>{});
  } else {
    launch(std::integral_constant<int, 8>{});
  }
}

struct Grid {
  dim3 split, split_block, combine, combine_block;
  size_t combine_smem;
};

Grid grids(int B, int KV, int G, int hd, int nsplit) {
  const int tiles = (G + kHeadTile - 1) / kHeadTile;
  return {dim3(B, KV * tiles, nsplit), dim3(kThreads),
          dim3(B, KV * G, (hd + kCombineCols - 1) / kCombineCols),
          dim3(kCombineCols), 2 * (size_t)nsplit * sizeof(float)};
}

template <int GMAX>
size_t split_smem(int hd, int bs, int chunk) {
  return (size_t)kWarps * GMAX * (hd + 2) * sizeof(float) +
         (size_t)chunk * bs * sizeof(int);
}

// window < 0: the unwindowed kernels (K2a); else the windowed ones (K2c).
template <typename T>
int launch_float(const void* q, const void* k_pool, const void* v_pool,
                 const int* table, const int* pos, float* out, float* ws,
                 int B, int KV, int G, int hd, int bs, int max_blocks,
                 int chunk, int nsplit, float scale, float softcap,
                 int window, int sinks, cudaStream_t stream) {
  const Grid gr = grids(B, KV, G, hd, nsplit);
  const auto* qq = static_cast<const __nv_bfloat16*>(q);
  const FloatPool<T> pool{static_cast<const T*>(k_pool),
                          static_cast<const T*>(v_pool)};
  dispatch_heads(G, [&](auto gm) {
    constexpr int GM = decltype(gm)::value;
    const size_t smem = split_smem<GM>(hd, bs, chunk);
    if (window < 0) {
      paged_attention_kernel<T, GM><<<gr.split, gr.split_block, smem,
                                      stream>>>(
          qq, pool, table, pos, ws, B, KV, G, hd, bs, max_blocks, chunk,
          scale, softcap);
    } else {
      paged_attention_window_kernel<T, GM><<<gr.split, gr.split_block, smem,
                                             stream>>>(
          qq, pool, table, pos, ws, B, KV, G, hd, bs, max_blocks, chunk,
          scale, softcap, window, sinks);
    }
  });
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  if (window < 0) {
    paged_attention_kernel_combine<<<gr.combine, gr.combine_block,
                                     gr.combine_smem, stream>>>(
        ws, out, B, KV, G, hd, nsplit);
  } else {
    paged_attention_window_kernel_combine<<<gr.combine, gr.combine_block,
                                            gr.combine_smem, stream>>>(
        ws, out, B, KV, G, hd, nsplit);
  }
  return static_cast<int>(cudaGetLastError());
}

// window < 0: the unwindowed kernels (K2b); else the windowed ones (K2c).
template <int BITS>
int launch_quant(const void* q, const void* k_codes, const void* v_codes,
                 const void* k_scale, const void* v_scale, const int* table,
                 const int* pos, float* out, float* ws, int B, int KV, int G,
                 int hd, int bs, int max_blocks, int chunk, int nsplit,
                 int group_size, float scale, float softcap, int window,
                 int sinks, cudaStream_t stream) {
  const Grid gr = grids(B, KV, G, hd, nsplit);
  const auto* qq = static_cast<const __nv_bfloat16*>(q);
  const QuantPool<BITS> pool{k_codes, v_codes,
                             static_cast<const __half*>(k_scale),
                             static_cast<const __half*>(v_scale), group_size,
                             hd / group_size};
  dispatch_heads(G, [&](auto gm) {
    constexpr int GM = decltype(gm)::value;
    const size_t smem = split_smem<GM>(hd, bs, chunk);
    if (window < 0) {
      paged_attention_quant_kernel<BITS, GM><<<gr.split, gr.split_block,
                                               smem, stream>>>(
          qq, pool, table, pos, ws, B, KV, G, hd, bs, max_blocks, chunk,
          scale, softcap);
    } else {
      paged_attention_quant_window_kernel<BITS, GM>
          <<<gr.split, gr.split_block, smem, stream>>>(
              qq, pool, table, pos, ws, B, KV, G, hd, bs, max_blocks, chunk,
              scale, softcap, window, sinks);
    }
  });
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  if (window < 0) {
    paged_attention_quant_kernel_combine<<<gr.combine, gr.combine_block,
                                           gr.combine_smem, stream>>>(
        ws, out, B, KV, G, hd, nsplit);
  } else {
    paged_attention_quant_window_kernel_combine<<<gr.combine,
                                                  gr.combine_block,
                                                  gr.combine_smem, stream>>>(
        ws, out, B, KV, G, hd, nsplit);
  }
  return static_cast<int>(cudaGetLastError());
}

int launch_any(const void* q, const void* k_pool, const void* v_pool,
               const int* table, const int* pos, float* out, float* ws,
               int B, int KV, int G, int hd, int bs, int max_blocks,
               int chunk, int nsplit, int pool_bf16, float scale,
               float softcap, int window, int sinks, void* stream) {
  if (!shapes_ok(B, KV, G, hd, bs, max_blocks, chunk, nsplit)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pool_bf16) {
    return launch_float<__nv_bfloat16>(q, k_pool, v_pool, table, pos, out, ws,
                                       B, KV, G, hd, bs, max_blocks, chunk,
                                       nsplit, scale, softcap, window, sinks,
                                       s);
  }
  return launch_float<float>(q, k_pool, v_pool, table, pos, out, ws, B, KV,
                             G, hd, bs, max_blocks, chunk, nsplit, scale,
                             softcap, window, sinks, s);
}

int launch_any_quant(const void* q, const void* k_codes, const void* v_codes,
                     const void* k_scale, const void* v_scale,
                     const int* table, const int* pos, float* out, float* ws,
                     int B, int KV, int G, int hd, int bs, int max_blocks,
                     int chunk, int nsplit, int bits, int group_size,
                     float scale, float softcap, int window, int sinks,
                     void* stream) {
  if (!shapes_ok(B, KV, G, hd, bs, max_blocks, chunk, nsplit) ||
      group_size <= 0 || group_size % kEpl != 0 || hd % group_size != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bits == 8) {
    return launch_quant<8>(q, k_codes, v_codes, k_scale, v_scale, table, pos,
                           out, ws, B, KV, G, hd, bs, max_blocks, chunk,
                           nsplit, group_size, scale, softcap, window, sinks,
                           s);
  }
  if (bits == 4) {
    return launch_quant<4>(q, k_codes, v_codes, k_scale, v_scale, table, pos,
                           out, ws, B, KV, G, hd, bs, max_blocks, chunk,
                           nsplit, group_size, scale, softcap, window, sinks,
                           s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q (B, KV, G, hd) bf16; k_pool/v_pool (num_blocks, bs, KV, hd) bf16 when
// pool_bf16 else fp32; table (B, max_blocks) int32 (-1 = unallocated);
// pos (B,) int32; out (B, KV, G, hd) fp32; ws a workspace of
// B * KV * nsplit * G * (hd + 2) fp32; chunk: blocks per split, nsplit: the
// split grid's third axis (the wrapper's split_plan). q and float pools
// 16-byte aligned; hd a multiple of 8 up to 256. softcap <= 0 means none.
// Launches the split and the combine pass; returns cudaErrorInvalidValue
// for a shape they do not take, else cudaGetLastError() after the
// launches (0 = launched).
extern "C" int paged_attention_bf16q(const void* q, const void* k_pool,
                                     const void* v_pool, const int* table,
                                     const int* pos, float* out, float* ws,
                                     int B, int KV, int G, int hd, int bs,
                                     int max_blocks, int chunk, int nsplit,
                                     int pool_bf16, float scale,
                                     float softcap, void* stream) {
  return launch_any(q, k_pool, v_pool, table, pos, out, ws, B, KV, G, hd, bs,
                    max_blocks, chunk, nsplit, pool_bf16, scale, softcap, -1,
                    0, stream);
}

// K2c over a float pool: as paged_attention_bf16q, attending only key
// positions kp <= pos with pos - kp < window or kp < sinks (window >= 1,
// sinks >= 0 tokens). Returns cudaErrorInvalidValue for window < 1 or
// sinks < 0, else as paged_attention_bf16q.
extern "C" int paged_attention_window_bf16q(
    const void* q, const void* k_pool, const void* v_pool, const int* table,
    const int* pos, float* out, float* ws, int B, int KV, int G, int hd,
    int bs, int max_blocks, int chunk, int nsplit, int pool_bf16,
    float scale, float softcap, int window, int sinks, void* stream) {
  if (window < 1 || sinks < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_any(q, k_pool, v_pool, table, pos, out, ws, B, KV, G, hd, bs,
                    max_blocks, chunk, nsplit, pool_bf16, scale, softcap,
                    window, sinks, stream);
}

// As paged_attention_bf16q over a quantized pool: k_codes/v_codes
// (num_blocks, bs, KV, hd) int8 for bits 8 or (num_blocks, bs, KV, hd / 2)
// uint8 nibbles for bits 4; k_scale/v_scale (num_blocks, bs, KV,
// hd / group_size) fp16, paged through the same table entries. Returns
// cudaErrorInvalidValue for other bits or a group_size that is not a
// multiple of 8 dividing hd, else as paged_attention_bf16q.
extern "C" int paged_attention_quant_bf16q(
    const void* q, const void* k_codes, const void* v_codes,
    const void* k_scale, const void* v_scale, const int* table, const int* pos,
    float* out, float* ws, int B, int KV, int G, int hd, int bs,
    int max_blocks, int chunk, int nsplit, int bits, int group_size,
    float scale, float softcap, void* stream) {
  return launch_any_quant(q, k_codes, v_codes, k_scale, v_scale, table, pos,
                          out, ws, B, KV, G, hd, bs, max_blocks, chunk,
                          nsplit, bits, group_size, scale, softcap, -1, 0,
                          stream);
}

// K2c over a quantized pool: as paged_attention_quant_bf16q under the
// window and sinks of paged_attention_window_bf16q.
extern "C" int paged_attention_quant_window_bf16q(
    const void* q, const void* k_codes, const void* v_codes,
    const void* k_scale, const void* v_scale, const int* table, const int* pos,
    float* out, float* ws, int B, int KV, int G, int hd, int bs,
    int max_blocks, int chunk, int nsplit, int bits, int group_size,
    float scale, float softcap, int window, int sinks, void* stream) {
  if (window < 1 || sinks < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_any_quant(q, k_codes, v_codes, k_scale, v_scale, table, pos,
                          out, ws, B, KV, G, hd, bs, max_blocks, chunk,
                          nsplit, bits, group_size, scale, softcap, window,
                          sinks, stream);
}
