// K7 flash_attention: whole-prompt causal attention with an online softmax,
// for Hopper (sm_90a). q: (B, Hq, S, D), k/v: (B, Hkv, S, D) with
// Hq % Hkv == 0, each addressed through its own (batch, head, position)
// strides with a contiguous last axis; out: (B, Hq, S, D) in q's dtype
// (bf16 or fp32), through its own strides too. Query p attends key kp iff
// kp < S, (not causal or kp <= p) and, with a window, p - kp < window or
// kp < sinks (DESIGN.md §17; sinks = 0 is the TPU kernel's function).
// Scores are hd**-0.5 q.k in fp32, optionally softcapped as
// tanh(s / cap) * cap; softmax statistics, probabilities and the PV sums
// stay fp32; the output is acc / max(l, 1e-30) rounded to q's dtype.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py:
// flash_attention_pallas (kernel body _kernel). The TPU kernel runs a
// (batch*heads, q block, kv block) grid with the kv axis innermost, keeps
// m, l and the accumulator in VMEM scratch across it, skips kv blocks that
// lie wholly above the diagonal or outside the window (`run`), and takes
// repeated KV heads from its caller (ops.py jnp.repeat). Here one thread
// block owns one (b, h, 64-query tile) and walks its key tiles in a loop;
// the carry lives in registers. The KV head is h / (Hq / Hkv), read in
// place: no repeated K/V is ever materialized. The model hands (B, S, H,
// D) tensors; their (B, H, S, D) views go in through strides, uncopied.
//
// What bounds it on an H100: operations. A (q, k) pair the mask keeps costs
// 4 D FLOPs (QK^T and PV) against D elements of K and V read once per
// query tile, so at S in the hundreds and beyond the work is far above the
// ridge: the floor is the attended pairs' FLOPs at the tensor-core peak.
// What the design does about it, simply for now:
//   * the query tile is staged once, as fp32, in shared memory; each
//     32-key K/V tile is staged as fp32 (rows padded by 4 floats so that
//     the float4 reads of 8 neighbouring rows hit 32 distinct banks) and
//     reused by all 64 queries. At D = 256 that is 141 KB of dynamic shared
//     memory, opted in with cudaFuncSetAttribute;
//   * 256 threads; thread t owns query rows 2 (t / 8) and 2 (t / 8) + 1:
//     for the scores, keys t % 8 + 8 i (i < 4), dot products over float4
//     loads; for the output, head columns 4 (t % 8) + 32 i .. + 3. The 8
//     threads of a row pair are neighbouring lanes of one warp, so the row
//     max and sum are warp shuffles and the probabilities pass through
//     shared memory under a __syncwarp only;
//   * key tiles above the diagonal, and tiles wholly outside the window
//     that hold no sink, are never loaded (the TPU kernel's `run`); inside
//     a loaded tile a masked column gets probability 0;
//   * the products run on the fp32 CUDA cores (FMA), not the tensor cores:
//     this kernel is right first. wgmma tiles over bf16 operands, TMA
//     staging and a split of long rows are for a later change.
// Query tiles are issued longest-first, so the causal tail does not trail.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
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

// Strides in elements. bf16: 1 for bfloat16 q/k/v/out, 0 for fp32.
// window <= 0: none; softcap <= 0: none. Returns cudaGetLastError() after
// the launch (cudaErrorInvalidValue for an unsupported head_dim).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss, int B, int Hq, int Hkv,
    int S, int D, int bf16, int causal, int window, int sinks, float scale,
    float softcap, void* stream) {
  const Params prm{q, k, v, out,
                   q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                   v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
                   Hq, Hkv, S, causal, window, sinks, scale, softcap};
  const auto st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch_d<__nv_bfloat16>(prm, B, D, st)
              : dispatch_d<float>(prm, B, D, st);
}
