// K7 flash_attention: whole-prompt attention with an online softmax, for
// Hopper (sm_90a). q: (B, Hq, S, D), k/v: (B, Hkv, S, D) with
// Hq % Hkv == 0, each addressed through its own (batch, head, position)
// strides with a contiguous last axis; out: (B, Hq, S, D) in q's dtype
// (bf16 or fp32), through its own strides too. Query p attends key kp iff
// kp < S, (not causal or kp <= p) and, with a window, p - kp < window or
// kp < sinks (DESIGN.md §17; sinks = 0 is the TPU kernel's function).
// Scores are hd**-0.5 q.k in fp32, optionally softcapped as
// tanh(s / cap) * cap; softmax statistics and the PV sums stay fp32; the
// output is acc / max(l, 1e-30) rounded to q's dtype.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py:
// flash_attention_pallas (kernel body _kernel). The TPU kernel runs a
// (batch*heads, q block, kv block) grid with the kv axis innermost, keeps
// m, l and the accumulator in VMEM scratch across it, skips kv blocks that
// lie wholly above the diagonal or outside the window (`run`), and takes
// repeated KV heads from its caller (ops.py jnp.repeat). Here one thread
// block owns one (b, h, query tile) and walks its key tiles in a loop; the
// carry lives in registers. The KV head is h / (Hq / Hkv), read in place:
// no repeated K/V is ever materialized. The model hands (B, S, H, D)
// tensors; their (B, H, S, D) views go in through strides, uncopied. Both
// kernels walk the same key tiles: the sink tiles, then the tiles from the
// first key any row of the query tile keeps (its window's start) to the
// diagonal (to S when not causal); tiles between are never loaded. Query
// tiles are issued longest-first, so the causal tail does not trail.
//
// What bounds it on an H100: operations. A (q, k) pair the mask keeps costs
// 4 D FLOPs (QK^T and PV) against D elements of K and V read once per
// query tile, so at S in the hundreds and beyond the work is far above the
// ridge: the floor is the attended pairs' FLOPs at the tensor-core peak.
//
// Two kernels; the wrapper (kernels/flash_attention/flash_attention.py)
// picks one by dtype and head dim, never by trying:
//
// tc::kernel, bf16 at D = 64, 128 and 256 (every prefill of the model):
//   * warp-specialised: 128 queries a block, two consumer warpgroups of 64
//     rows each and one producer warpgroup, of which one thread issues every
//     load; setmaxnreg moves registers from the producer to the consumers;
//   * TMA staging: q, k and v are 4-D tensor maps (D, H, S, B) over the
//     caller's strides, encoded on the host at every launch (three
//     cuTensorMapEncodeTiled calls, reached through cudaGetDriverEntryPoint
//     so the library links no libcuda); the shared-memory opt-in is made
//     once per device (opt_in_smem), for both kernels.
//     Boxes are 64 columns (one 128-byte row, 128-byte swizzle) by 128
//     queries or BK keys; a D = 256 row is four boxes. TMA zero-fills rows
//     past S. Q is loaded once; K and V tiles go through a ring of stages
//     with full (per K and per V) and empty mbarriers: D 64: BK 128 x 4
//     stages; D 128: BK 128 x 2; D 256: BK 64 x 2 (Q 64 KB + 2 x 64 KB);
//   * S = Q K^T: wgmma m64nBKk16, both operands in shared memory (K-major),
//     fp32 accumulators; bf16 x bf16 products are exact in fp32, so this
//     product needs no split;
//   * scale and softcap in registers with the accurate tanhf (not
//     tanh.approx: its ~2^-11 relative error times cap 50 moves a score by
//     up to 0.024), log2(e) folded into the scale for exp2f; only tiles that
//     straddle the diagonal, the window's edge, the sinks or S are masked;
//     the online softmax stays in the accumulator's layout (row max by quad
//     shuffles, each thread's partial row sum reduced once at the end);
//   * O += P V: the tensor cores take P as bf16, and one rounding of P
//     (2^-9 relative) moves an output near zero by tens of its bf16 ulps. So
//     P is split into P_hi = bf16(P) and P_lo = bf16(P - P_hi), and two
//     wgmma (A from registers, the accumulator's layout reused as the A
//     fragment; B the V tile in shared memory, MN-major) sum P_hi V + P_lo V
//     into one fp32 O: P is carried to ~2^-17, as fp32 probabilities would
//     be to the tolerance. Each k16 slice of keys is one m64nDk16 wgmma per
//     term, over all of V's boxes. O is rescaled between tiles;
//   * epilogue: O / max(l, 1e-30) rounded to bf16 and stored through the
//     output's strides; rows at or past S are not stored.
//
// flash_attention_kernel, fp32 operands (no main path hands K7 fp32: a
// bf16 tensor-core product cannot hold the 1e-4 fp32 tolerance without a
// three-way split) and bf16 at D = 16 and 32:
//   * the query tile (64 queries) is staged once, as fp32, in shared
//     memory; each 32-key K/V tile is staged as fp32 (rows padded by 4
//     floats so that the float4 reads of 8 neighbouring rows hit 32
//     distinct banks) and reused by all 64 queries. At D = 256 that is
//     141 KB of dynamic shared memory, opted in once per device;
//   * 256 threads; thread t owns query rows 2 (t / 8) and 2 (t / 8) + 1:
//     for the scores, keys t % 8 + 8 i (i < 4), dot products over float4
//     loads; for the output, head columns 4 (t % 8) + 32 i .. + 3. The 8
//     threads of a row pair are neighbouring lanes of one warp, so the row
//     max and sum are warp shuffles and the probabilities pass through
//     shared memory under a __syncwarp only;
//   * inside a loaded tile a masked column gets probability 0;
//   * the products run on the fp32 CUDA cores (FMA), with fp32
//     probabilities: staging is synchronous, through registers.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cmath>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;    // queries per thread block
constexpr int BK = 32;    // keys per staged tile
constexpr int NT = 256;   // threads per block
constexpr int PLD = BK + 1;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int Hq, Hkv, S;
  int causal, window, sinks;  // window <= 0: no window
  float scale, softcap;       // softcap <= 0: none
};

template <int D>
constexpr size_t smem_bytes() {
  return ((size_t)(BQ + 2 * BK) * (D + 4) + (size_t)BQ * PLD) *
         sizeof(float);
}

// Stage `rows` rows of D elements starting at position `p0` of one (b, h)
// into dst (row stride D + 4) as fp32; rows at or past S are zero.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* src,
                                      long long pos_stride, int p0, int rows,
                                      int S) {
  constexpr int LD = D + 4;
  for (int i = threadIdx.x; i < rows * D; i += NT) {
    const int r = i / D, d = i % D;
    const int p = p0 + r;
    dst[r * LD + d] = p < S ? to_float(src[(long long)p * pos_stride + d])
                            : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    flash_attention_kernel(const Params prm) {
  constexpr int LD = D + 4;
  constexpr int NCH = D >= 32 ? D / 32 : 1;  // float4 column chunks
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + BQ * LD;
  float* vs = ks + BK * LD;
  float* ps = vs + BK * LD;

  const int S = prm.S;
  const int bh = blockIdx.y;
  const int b = bh / prm.Hq, h = bh % prm.Hq;
  const int hk = h / (prm.Hq / prm.Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest rows first
  const int t = threadIdx.x;
  const int rg = t >> 3, cg = t & 7;
  const int r0 = 2 * rg;

  const T* qg = static_cast<const T*>(prm.q) + b * prm.q_sb + h * prm.q_sh;
  const T* kg = static_cast<const T*>(prm.k) + b * prm.k_sb + hk * prm.k_sh;
  const T* vg = static_cast<const T*>(prm.v) + b * prm.v_sb + hk * prm.v_sh;
  stage<T, D>(qs, qg, prm.q_ss, q0, BQ, S);

  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};
  float4 acc[2][NCH];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < NCH; ++c) acc[r][c] = make_float4(0.f, 0.f, 0.f, 0.f);

  // key tiles to walk: the sink tiles, then [kt_win, kt_end]
  const int q_last = min(q0 + BQ, S) - 1;
  const int kt_end = (prm.causal ? q_last : S - 1) / BK;
  int kt_win = 0, sink_tiles = 0;
  if (prm.window > 0) {
    const int lo = q0 - prm.window + 1;  // first key any row of the tile keeps
    kt_win = lo > 0 ? lo / BK : 0;
    sink_tiles = (prm.sinks + BK - 1) / BK;
  }

  for (int kt = 0; kt <= kt_end; ++kt) {
    if (kt >= sink_tiles && kt < kt_win) kt = kt_win;
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's K/V (and, first, nothing) done
    stage<T, D>(ks, kg, prm.k_ss, k0, BK, S);
    stage<T, D>(vs, vg, prm.v_ss, k0, BK, S);
    __syncthreads();

    // scores of rows r0, r0 + 1 against keys cg + 8 i
    float s[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[r][i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 qa = *reinterpret_cast<const float4*>(&qs[r0 * LD + d]);
      const float4 qb =
          *reinterpret_cast<const float4*>(&qs[(r0 + 1) * LD + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 kv =
            *reinterpret_cast<const float4*>(&ks[(cg + 8 * i) * LD + d]);
        s[0][i] += qa.x * kv.x + qa.y * kv.y + qa.z * kv.z + qa.w * kv.w;
        s[1][i] += qb.x * kv.x + qb.y * kv.y + qb.z * kv.z + qb.w * kv.w;
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = q0 + r0 + r;
      float mt = NEG_INF;
      bool keep[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kp = k0 + cg + 8 * i;
        keep[i] = kp < S && (!prm.causal || kp <= p) &&
                  (prm.window <= 0 || p - kp < prm.window ||
                   kp < prm.sinks);
        float x = s[r][i] * prm.scale;
        if (prm.softcap > 0.f) x = tanhf(x / prm.softcap) * prm.softcap;
        s[r][i] = x;
        if (keep[i]) mt = fmaxf(mt, x);
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_new = fmaxf(m[r], mt);
      const float alpha = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pr = keep[i] ? expf(s[r][i] - m_new) : 0.f;
        ps[(r0 + r) * PLD + cg + 8 * i] = pr;
        sum += pr;
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[r] = alpha * l[r] + sum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        acc[r][c].x *= alpha;
        acc[r][c].y *= alpha;
        acc[r][c].z *= alpha;
        acc[r][c].w *= alpha;
      }
    }
    __syncwarp();  // a row pair's probabilities come from its own 8 lanes

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float pa = ps[r0 * PLD + j];
      const float pb = ps[(r0 + 1) * PLD + j];
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const int col = 4 * cg + 32 * c;
        if (col >= D) continue;
        const float4 vv = *reinterpret_cast<const float4*>(&vs[j * LD + col]);
        acc[0][c].x += pa * vv.x;
        acc[0][c].y += pa * vv.y;
        acc[0][c].z += pa * vv.z;
        acc[0][c].w += pa * vv.w;
        acc[1][c].x += pb * vv.x;
        acc[1][c].y += pb * vv.y;
        acc[1][c].z += pb * vv.z;
        acc[1][c].w += pb * vv.w;
      }
    }
    __syncwarp();  // reads of ps done before the next tile overwrites it
  }

  T* og = static_cast<T*>(prm.out) + b * prm.o_sb + h * prm.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int p = q0 + r0 + r;
    if (p >= S) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int col = 4 * cg + 32 * c;
      if (col >= D) continue;
      T* dst = og + (long long)p * prm.o_ss + col;
      store(dst + 0, acc[r][c].x * inv);
      store(dst + 1, acc[r][c].y * inv);
      store(dst + 2, acc[r][c].z * inv);
      store(dst + 3, acc[r][c].w * inv);
    }
  }
}

template <typename T, int D>
int launch(const Params& prm, int B, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kernel = flash_attention_kernel<T, D>;
  static std::atomic<std::uint64_t> opted{0};
  const cudaError_t err = opt_in_smem(kernel, (int)smem, opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((prm.S + BQ - 1) / BQ, B * prm.Hq);
  kernel<<<grid, NT, smem, stream>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const Params& prm, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(prm, B, stream);
    case 32: return launch<T, 32>(prm, B, stream);
    case 64: return launch<T, 64>(prm, B, stream);
    case 128: return launch<T, 128>(prm, B, stream);
    case 256: return launch<T, 256>(prm, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

namespace {
namespace tc {

constexpr int BQ = 128;        // queries per block: two warpgroups of 64
constexpr int NT = 384;        // two consumer warpgroups, one producer
constexpr int ROW = 128;       // bytes of one swizzled box row: 64 bf16
constexpr int BOX = ROW / 2;   // head columns per TMA box
constexpr int EMPTY_ARRIVALS = 8;  // one per consumer warp
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Tile;  // key tile BK and ring depth per head dim
template <>
struct Tile<64> {
  static constexpr int BK = 128, STAGES = 4;
};
template <>
struct Tile<128> {
  static constexpr int BK = 128, STAGES = 2;
};
template <>
struct Tile<256> {
  static constexpr int BK = 64, STAGES = 2;
};

// Shared memory, from a 1024-byte aligned base (the 128-byte swizzle
// repeats every 8 rows): Q as D / 64 boxes of 128 rows, then the K ring,
// the V ring (each stage D / 64 boxes of BK rows), then the mbarriers:
// full K [STAGES], full V [STAGES], empty [STAGES], Q.
template <int D>
struct Layout {
  static constexpr int BK = Tile<D>::BK, STAGES = Tile<D>::STAGES;
  static constexpr int Q_BYTES = BQ * D * 2, KV_BYTES = BK * D * 2;
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int ALLOC = BAR_OFF + (3 * STAGES + 1) * 8 + 1024;
  static_assert(ALLOC <= 232448, "over the 227 KB a block can use");
};

struct Params {
  void* out;
  long long o_sb, o_sh, o_ss;
  int Hq, Hkv, S;
  int causal, window, sinks;  // window <= 0: no window
  float qk_scale;   // times q.k: hd^-0.5 log2(e), or hd^-0.5 / cap
  float cap_log2e;  // cap log2(e); 0: no softcap
};

// One TMA box of the 4-D map (D, H, S, B) at (d, h, s, b) into shared
// memory; completion counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int d, int h, int s, int b,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(d), "r"(h), "r"(s), "r"(b),
      "r"(bar)
      : "memory");
}

// The accumulator operands of one wgmma, written out: inline PTX takes no
// arrays.
#define F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define F16(i) F4(i), F4(i + 4), F4(i + 8), F4(i + 12)
#define F32(i) F16(i), F16(i + 16)

// S (+)= A B^T over one k16 slice: A (64 x 16) and B (N x 16), both K-major
// in shared memory; N = 64 or 128.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : F32(0)
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : F32(0), F32(32)
      : "l"(da), "l"(db), "r"(accumulate));
}

// O += A B over one k16 slice: A (64 x 16) from registers, B (16 x N)
// MN-major in shared memory; N = D = 64, 128 or 256.
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : F32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : F32(0), F32(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : F32(0), F32(32), F32(64), F32(96)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef F32
#undef F16
#undef F4

// bf16 pair (a in the low half, the first column of an A fragment pair)
// of P, and of what that rounding left over.
__device__ __forceinline__ void split(float a, float b, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// The key tiles a query tile walks: the sink tiles, then [win, end].
struct Walk {
  int sink_tiles, win, end;
  __device__ Walk(const Params& p, int q0, int bk) {
    const int q_last = min(q0 + BQ, p.S) - 1;
    end = (p.causal ? q_last : p.S - 1) / bk;
    win = 0;
    sink_tiles = 0;
    if (p.window > 0) {
      const int lo = q0 - p.window + 1;  // first key any row keeps
      win = lo > 0 ? lo / bk : 0;
      sink_tiles = (p.sinks + bk - 1) / bk;
    }
  }
  __device__ int fix(int kt) const {
    return kt >= sink_tiles && kt < win ? win : kt;
  }
};

template <int D>
__global__ void __launch_bounds__(NT, 1)
    kernel(const __grid_constant__ CUtensorMap qmap,
           const __grid_constant__ CUtensorMap kmap,
           const __grid_constant__ CUtensorMap vmap, const Params prm) {
  using L = Layout<D>;
  constexpr int BK = L::BK, STAGES = L::STAGES, NB = D / BOX;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t q_s = base, k_s = base + L::K_OFF, v_s = base + L::V_OFF;
  const uint32_t bars = base + L::BAR_OFF;
  // full K: bars + 8 s; full V: + 8 (STAGES + s); empty: + 8 (2 STAGES +
  // s); Q: + 24 STAGES
  const uint32_t q_bar = bars + 24 * STAGES;

  const int S = prm.S;
  const int bh = blockIdx.y;
  const int b = bh / prm.Hq, h = bh % prm.Hq;
  const int hk = h / (prm.Hq / prm.Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest rows first
  const Walk walk(prm, q0, BK);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (STAGES + s), 1);
      mbar_init(bars + 8 * (2 * STAGES + s), EMPTY_ARRIVALS);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_bar, L::Q_BYTES);
#pragma unroll
      for (int j = 0; j < NB; ++j)
        tma_load(q_s + j * BQ * ROW, &qmap, j * BOX, h, q0, b, q_bar);
      int i = 0;
      for (int kt = walk.fix(0); kt <= walk.end; kt = walk.fix(kt + 1), ++i) {
        const int s = i % STAGES, phase = (i / STAGES) & 1;
        mbar_wait(bars + 8 * (2 * STAGES + s), phase ^ 1);
        const uint32_t fk = bars + 8 * s, fv = bars + 8 * (STAGES + s);
        mbar_expect_tx(fk, L::KV_BYTES);
#pragma unroll
        for (int j = 0; j < NB; ++j)
          tma_load(k_s + s * L::KV_BYTES + j * BK * ROW, &kmap, j * BOX, hk,
                   kt * BK, b, fk);
        mbar_expect_tx(fv, L::KV_BYTES);
#pragma unroll
        for (int j = 0; j < NB; ++j)
          tma_load(v_s + s * L::KV_BYTES + j * BK * ROW, &vmap, j * BOX, hk,
                   kt * BK, b, fv);
      }
    }
  } else {
    // consumer warpgroup w: query rows r_lo .. r_lo + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int w = threadIdx.x >> 7;
    const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
    const int r_lo = q0 + 64 * w;
    const int row0 = r_lo + 16 * ((threadIdx.x >> 5) & 3) + g;
    const int row1 = row0 + 8;
    const bool capped = prm.cap_log2e > 0.f;

    float o[NB][32];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 32; ++e) o[j][e] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

    mbar_wait(q_bar, 0);
    const uint32_t q_w = q_s + 64 * w * ROW;
    int i = 0;
    for (int kt = walk.fix(0); kt <= walk.end; kt = walk.fix(kt + 1), ++i) {
      const int s = i % STAGES, phase = (i / STAGES) & 1;
      const int k0 = kt * BK, k_hi = k0 + BK - 1;
      // whole tile masked for these 64 rows (also: no row below S)
      const bool skip =
          r_lo >= S || (prm.causal && k0 > r_lo + 63) ||
          (prm.window > 0 && k0 >= prm.sinks && r_lo - k_hi >= prm.window);
      const int ks = max(k0, prm.sinks);  // first key that is not a sink
      const bool straddles =
          k_hi >= S || (prm.causal && k_hi > r_lo) ||
          (prm.window > 0 && ks <= k_hi && r_lo + 63 - ks >= prm.window);
      mbar_wait(bars + 8 * s, phase);
      if (!skip) {
        const uint32_t k_t = k_s + s * L::KV_BYTES;
        const uint32_t v_t = v_s + s * L::KV_BYTES;
        float sc[BK / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32;
          wgmma_ss(sc, desc(q_w + (kk / 4) * BQ * ROW + off),
                   desc(k_t + (kk / 4) * BK * ROW + off), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int e = 0; e < BK / 2; ++e) pin(sc[e]);

        // scores in log2 units, masked, and the tile's row maxima; element
        // 4c + e is row0 (e < 2) or row1, key k0 + 8c + 2 t4 + e % 2
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int e = 0; e < BK / 2; ++e) {
          float x = sc[e] * prm.qk_scale;
          if (capped) x = tanhf(x) * prm.cap_log2e;
          const int p = (e & 2) ? row1 : row0;
          if (straddles) {
            const int kp = k0 + 8 * (e >> 2) + 2 * t4 + (e & 1);
            const bool keep =
                kp < S && (!prm.causal || kp <= p) &&
                (prm.window <= 0 || p - kp < prm.window || kp < prm.sinks);
            if (!keep) x = -INFINITY;
          }
          sc[e] = x;
          if (e & 2)
            mx1 = fmaxf(mx1, x);
          else
            mx0 = fmaxf(mx0, x);
        }
#pragma unroll
        for (int o2 = 1; o2 < 4; o2 <<= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o2));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o2));
        }
        const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
        // a row with no kept key yet keeps exp2(-inf) = 0 everywhere
        const float u0 = n0 == -INFINITY ? 0.f : n0;
        const float u1 = n1 == -INFINITY ? 0.f : n1;
        const float a0 = exp2f(m0 - u0), a1 = exp2f(m1 - u1);
        m0 = n0;
        m1 = n1;
        float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
        for (int e = 0; e < BK / 2; ++e) {
          const float pr = exp2f(sc[e] - ((e & 2) ? u1 : u0));
          sc[e] = pr;
          if (e & 2)
            sum1 += pr;
          else
            sum0 += pr;
        }
        l0 = a0 * l0 + sum0;
        l1 = a1 * l1 + sum1;
        // P as the A fragments of the PV product, k16 slice kk: registers
        // (row0, keys 2 t4 +{0,1}), (row1, same), (row0, +8), (row1, +8)
        uint32_t ph[BK / 16][4], pl[BK / 16][4];
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            split(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1], ph[kk][r],
                  pl[kk][r]);
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int e = 0; e < 32; ++e) o[j][e] *= (e & 2) ? a1 : a0;

        mbar_wait(bars + 8 * (STAGES + s), phase);
        wgmma_fence();
        float(&of)[NB * 32] =
            *reinterpret_cast<float(*)[NB * 32]>(&o[0][0]);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          // V rows 16 kk .. + 15, all D columns: its boxes BK rows apart
          const uint64_t dv = desc(v_t + kk * 16 * ROW, BK * ROW);
          wgmma_rs(of, ph[kk], dv);
          wgmma_rs(of, pl[kk], dv);
        }
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int e = 0; e < 32; ++e) pin(o[j][e]);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            pin(ph[kk][r]);
            pin(pl[kk][r]);
          }
      } else {
        mbar_wait(bars + 8 * (STAGES + s), phase);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (2 * STAGES + s));
    }

#pragma unroll
    for (int o2 = 1; o2 < 4; o2 <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, o2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, o2);
    }
    const float inv0 = 1.f / fmaxf(l0, 1e-30f);
    const float inv1 = 1.f / fmaxf(l1, 1e-30f);
    __nv_bfloat16* og = static_cast<__nv_bfloat16*>(prm.out) +
                        b * prm.o_sb + h * prm.o_sh;
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = j * BOX + 8 * c + 2 * t4;
        if (row0 < S)
          *reinterpret_cast<__nv_bfloat162*>(
              og + (long long)row0 * prm.o_ss + col) =
              __floats2bfloat162_rn(o[j][4 * c] * inv0,
                                    o[j][4 * c + 1] * inv0);
        if (row1 < S)
          *reinterpret_cast<__nv_bfloat162*>(
              og + (long long)row1 * prm.o_ss + col) =
              __floats2bfloat162_rn(o[j][4 * c + 2] * inv1,
                                    o[j][4 * c + 3] * inv1);
      }
  }
}

// The 4-D map (D, H, S, B) of one bf16 operand, strides in elements; boxes
// of 64 head columns by `rows` positions, 128-byte swizzle, zeros past S.
bool encode(CUtensorMap* map, const void* ptr, int D, int H, int S, int B,
            long long sh, long long ss, long long sb, int rows) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)BOX, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, long long q_sb,
           long long q_sh, long long q_ss, long long k_sb, long long k_sh,
           long long k_ss, long long v_sb, long long v_sh, long long v_ss,
           int B, const Params& prm, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  if (!encode(&qm, q, D, prm.Hq, prm.S, B, q_sh, q_ss, q_sb, BQ) ||
      !encode(&km, k, D, prm.Hkv, prm.S, B, k_sh, k_ss, k_sb, Tile<D>::BK) ||
      !encode(&vm, v, D, prm.Hkv, prm.S, B, v_sh, v_ss, v_sb, Tile<D>::BK))
    return static_cast<int>(cudaErrorInvalidValue);
  auto fn = kernel<D>;
  const int smem = Layout<D>::ALLOC;
  static std::atomic<std::uint64_t> opted{0};
  const cudaError_t err = opt_in_smem(fn, smem, opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((prm.S + BQ - 1) / BQ, B * prm.Hq);
  fn<<<grid, NT, smem, stream>>>(qm, km, vm, prm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc
}  // namespace

// Strides in elements. bf16: 1 for bfloat16 q/k/v/out, 0 for fp32. bf16
// at D 64, 128 and 256 takes tc::kernel (every base address 16-byte
// aligned and every stride of a dimension longer than 1 a multiple of 8
// elements: the wrapper checks); fp32, and bf16 at D 16 and 32, the FMA
// kernel. window <= 0: none; softcap <= 0: none. Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for an unsupported head_dim or a
// tensor map the driver refuses).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss, int B, int Hq, int Hkv,
    int S, int D, int bf16, int causal, int window, int sinks, float scale,
    float softcap, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (bf16 && (D == 64 || D == 128 || D == 256)) {
    const bool capped = softcap > 0.f;
    const tc::Params prm{out, o_sb, o_sh, o_ss, Hq, Hkv, S, causal, window,
                         sinks,
                         capped ? scale / softcap : scale * tc::LOG2E,
                         capped ? softcap * tc::LOG2E : 0.f};
#define TC_LAUNCH(DIM)                                                    \
  tc::launch<DIM>(q, k, v, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, \
                  v_ss, B, prm, st)
    switch (D) {
      case 64: return TC_LAUNCH(64);
      case 128: return TC_LAUNCH(128);
      default: return TC_LAUNCH(256);
    }
#undef TC_LAUNCH
  }
  const Params prm{q, k, v, out,
                   q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                   v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
                   Hq, Hkv, S, causal, window, sinks, scale, softcap};
  return bf16 ? dispatch_d<__nv_bfloat16>(prm, B, D, st)
              : dispatch_d<float>(prm, B, D, st);
}
