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
// Here one thread block owns one (slot b, KV head h) pair, reads its own
// table row and pos[b], and walks its logical blocks in a loop; the carry
// lives in registers. Unwindowed, the walk is blocks 0 .. pos[b] // bs.
// Windowed, it is two segments: the sink blocks [0, ceil(sinks / bs)),
// then [fl, pos[b] // bs] with fl = max((pos[b] - window + 1) // bs,
// ceil(sinks / bs)) computed in the kernel (floor division, as the
// engine's eviction computes it), so dead blocks are never read.
//
// What bounds it on an H100: bytes. Every cached K/V element is used for
// 2 FLOPs per query head of its group (G = 8 at full width), far below the
// ridge, so the floor is the K/V bytes (codes and scales for K2b) of the
// tokens each row attends: for K2c, the sinks and the window only.
// What the design does about it:
//   * each K/V block of head h is read from device memory once per thread
//     block (coalesced, staged to shared memory as fp32) and reused by the G
//     warps of the group, one warp per query head;
//   * K2b dequantizes while staging: each token's codes and its ng scales
//     are read through the SAME table entry, and element d becomes
//     code(d) * scale[d / group_size] in fp32, the product
//     quant/kv.py:dequant_codes forms, so the warps read the same fp32
//     tiles as in K2a;
//   * entries of -1, blocks past pos and (K2c) blocks outside the two
//     segments are never read (the TPU kernel's `run` predicate), and the
//     last block stops at column pos; in K2c's boundary block and in a sink
//     block that `sinks` covers only in part, columns outside the mask are
//     skipped, so no masked score is computed and the softmax carry never
//     starts from a masked column;
//   * per token: a warp-reduced q.k (lane d holds q[d], q[d+32], ...), times
//     hd**-0.5, optional tanh softcap, then an online-softmax update of the
//     warp's m, l and acc registers. K, V and the probabilities stay fp32,
//     as in the TPU kernel.
//   * finalize writes acc / max(l, 1e-30) in fp32.
// A window that does not bind (window > pos, no sinks) walks the same
// blocks and columns in the same order through the same per-column code as
// the unwindowed walk, so K2c then gives K2a's or K2b's bits.
// Not done here: splitting long rows across blocks (flash-decoding),
// packing several tokens per warp step and wide loads of the codes; a later
// change can add them.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Staging policies: write K and V of one (block, head) into shared memory
// as fp32 (bs, hd) tiles, threads striding over the elements.
template <typename T>
struct FloatPool {
  const T* k;
  const T* v;

  __device__ __forceinline__ void stage(float* ks, float* vs, int phys, int h,
                                        int KV, int hd, int bs) const {
    for (int i = threadIdx.x; i < bs * hd; i += blockDim.x) {
      const int t = i / hd, d = i % hd;
      const size_t off = (((size_t)phys * bs + t) * KV + h) * hd + d;
      ks[i] = to_float(k[off]);
      vs[i] = to_float(v[off]);
    }
  }
};

// BITS = 8: int8 codes (.., hd); BITS = 4: uint8 nibbles (.., ceil(hd/2)).
template <int BITS>
struct QuantPool {
  const void* k;
  const void* v;
  const __half* k_scale;  // (.., ng)
  const __half* v_scale;
  int group_size;
  int ng;

  __device__ __forceinline__ static float code(const void* codes,
                                               size_t vec, int hdp, int d) {
    if constexpr (BITS == 8) {
      return static_cast<float>(
          static_cast<const int8_t*>(codes)[vec * hdp + d]);
    } else {
      const unsigned byte =
          static_cast<const uint8_t*>(codes)[vec * hdp + d / 2];
      return static_cast<float>(static_cast<int>((byte >> ((d & 1) * 4)) &
                                                 0xFu) - 8);
    }
  }

  __device__ __forceinline__ void stage(float* ks, float* vs, int phys, int h,
                                        int KV, int hd, int bs) const {
    const int hdp = BITS == 8 ? hd : (hd + 1) / 2;
    for (int i = threadIdx.x; i < bs * hd; i += blockDim.x) {
      const int t = i / hd, d = i % hd;
      const size_t vec = ((size_t)phys * bs + t) * KV + h;
      const size_t so = vec * ng + d / group_size;
      ks[i] = code(k, vec, hdp, d) * __half2float(k_scale[so]);
      vs[i] = code(v, vec, hdp, d) * __half2float(v_scale[so]);
    }
  }
};

__device__ __forceinline__ int floor_div(int a, int b) {  // b > 0
  const int q = a / b;  // C++ truncates toward zero; floor it as Python does
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// Stage logical block j of row b (physical block `phys`) and fold its
// columns [0, ntok) into the warp's online-softmax carry (m, l, acc). With
// WINDOWED, a column is scored only where p - kp < window || kp < sinks
// (the in-block mask of the TPU kernel); the test is uniform over the
// thread block, so skipped columns never split a warp's shuffles, and no
// column is scored at -1e30.
template <int NPL, bool WINDOWED, typename Pool>
__device__ __forceinline__ void attend_block(
    const Pool& pool, float* ks, float* vs, int phys, int j, int p, int h,
    int KV, int hd, int bs, float scale, float softcap, int window,
    int sinks, int lane, const float (&qv)[NPL], float (&acc)[NPL],
    float& m, float& l) {
  pool.stage(ks, vs, phys, h, KV, hd, bs);
  __syncthreads();
  const int ntok = min(bs, p - j * bs + 1);
  for (int t = 0; t < ntok; ++t) {
    if constexpr (WINDOWED) {
      const int kp = j * bs + t;
      if (!(p - kp < window || kp < sinks)) continue;
    }
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      const int d = lane + 32 * i;
      if (d < hd) dot = fmaf(qv[i], ks[t * hd + d], dot);
    }
    float s = warp_sum(dot) * scale;
    if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
    const float m_new = fmaxf(m, s);
    const float alpha = expf(m - m_new);
    const float pe = expf(s - m_new);
    l = l * alpha + pe;
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      const int d = lane + 32 * i;
      if (d < hd) acc[i] = acc[i] * alpha + pe * vs[t * hd + d];
    }
    m = m_new;
  }
  __syncthreads();
}

// NPL: head-dim elements per lane (hd <= 32 * NPL). Without WINDOWED the
// walk is logical blocks 0 .. last (K2a/K2b); with it, the sink blocks
// [0, ceil(sinks / bs)) and then [fl, last], fl = max((p - window + 1) //
// bs, ceil(sinks / bs)) (K2c). A window that does not bind (window > p,
// no sinks) gives fl = 0: the same blocks in the same order, so the same
// bits as the unwindowed walk.
template <int NPL, bool WINDOWED, typename Pool>
__device__ __forceinline__ void decode_row(
    const __nv_bfloat16* __restrict__ q, const Pool& pool,
    const int* __restrict__ table, const int* __restrict__ pos,
    float* __restrict__ out, int KV, int G, int hd, int bs, int max_blocks,
    float scale, float softcap, int window, int sinks) {
  extern __shared__ float smem[];
  float* ks = smem;            // (bs, hd) K of the current block, head h
  float* vs = smem + bs * hd;  // (bs, hd) V

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int warp = threadIdx.x / 32;  // query head within the group
  const int lane = threadIdx.x % 32;
  const int p = pos[b];
  const int* row = table + (size_t)b * max_blocks;

  const size_t qo = (((size_t)b * KV + h) * G + warp) * hd;
  float qv[NPL], acc[NPL];
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const int d = lane + 32 * i;
    qv[i] = d < hd ? __bfloat162float(q[qo + d]) : 0.f;
    acc[i] = 0.f;
  }
  float m = -1e30f, l = 0.f;

  const int last = p < 0 ? -1 : min(p / bs, max_blocks - 1);
  int first = 0;
  if constexpr (WINDOWED) {
    const int sink_blocks = (sinks + bs - 1) / bs;
    first = max(floor_div(p - window + 1, bs), sink_blocks);
    const int sink_end = min(sink_blocks, last + 1);
    for (int j = 0; j < sink_end; ++j) {
      const int phys = row[j];
      if (phys < 0) continue;  // uniform over the block
      attend_block<NPL, true>(pool, ks, vs, phys, j, p, h, KV, hd, bs,
                              scale, softcap, window, sinks, lane, qv, acc,
                              m, l);
    }
  }
  for (int j = first; j <= last; ++j) {
    const int phys = row[j];
    if (phys < 0) continue;  // uniform over the block: no divergent barrier
    attend_block<NPL, WINDOWED>(pool, ks, vs, phys, j, p, h, KV, hd, bs,
                                scale, softcap, window, sinks, lane, qv, acc,
                                m, l);
  }

  const float denom = fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const int d = lane + 32 * i;
    if (d < hd) out[qo + d] = acc[i] / denom;
  }
}

template <typename T, int NPL>
__global__ void paged_attention_kernel(
    const __nv_bfloat16* __restrict__ q, FloatPool<T> pool,
    const int* __restrict__ table, const int* __restrict__ pos,
    float* __restrict__ out, int KV, int G, int hd, int bs, int max_blocks,
    float scale, float softcap) {
  decode_row<NPL, false>(q, pool, table, pos, out, KV, G, hd, bs, max_blocks,
                         scale, softcap, 0, 0);
}

template <int BITS, int NPL>
__global__ void paged_attention_quant_kernel(
    const __nv_bfloat16* __restrict__ q, QuantPool<BITS> pool,
    const int* __restrict__ table, const int* __restrict__ pos,
    float* __restrict__ out, int KV, int G, int hd, int bs, int max_blocks,
    float scale, float softcap) {
  decode_row<NPL, false>(q, pool, table, pos, out, KV, G, hd, bs, max_blocks,
                         scale, softcap, 0, 0);
}

template <typename T, int NPL>
__global__ void paged_attention_window_kernel(
    const __nv_bfloat16* __restrict__ q, FloatPool<T> pool,
    const int* __restrict__ table, const int* __restrict__ pos,
    float* __restrict__ out, int KV, int G, int hd, int bs, int max_blocks,
    float scale, float softcap, int window, int sinks) {
  decode_row<NPL, true>(q, pool, table, pos, out, KV, G, hd, bs, max_blocks,
                        scale, softcap, window, sinks);
}

template <int BITS, int NPL>
__global__ void paged_attention_quant_window_kernel(
    const __nv_bfloat16* __restrict__ q, QuantPool<BITS> pool,
    const int* __restrict__ table, const int* __restrict__ pos,
    float* __restrict__ out, int KV, int G, int hd, int bs, int max_blocks,
    float scale, float softcap, int window, int sinks) {
  decode_row<NPL, true>(q, pool, table, pos, out, KV, G, hd, bs, max_blocks,
                        scale, softcap, window, sinks);
}

// Calls launch(std::integral_constant<int, NPL>{}) for the smallest NPL
// with hd <= 32 * NPL; returns cudaErrorInvalidValue for hd > 256, else
// cudaGetLastError() after the launch.
template <typename F>
int dispatch_npl(int hd, F&& launch) {
  if (hd <= 32) {
    launch(std::integral_constant<int, 1>{});
  } else if (hd <= 64) {
    launch(std::integral_constant<int, 2>{});
  } else if (hd <= 128) {
    launch(std::integral_constant<int, 4>{});
  } else if (hd <= 256) {
    launch(std::integral_constant<int, 8>{});
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// window < 0: the unwindowed kernel (K2a); else the windowed one (K2c).
template <typename T>
int launch_float(const void* q, const void* k_pool, const void* v_pool,
                 const int* table, const int* pos, float* out, int B, int KV,
                 int G, int hd, int bs, int max_blocks, float scale,
                 float softcap, int window, int sinks, cudaStream_t stream) {
  const dim3 grid(B, KV);
  const dim3 block(G * 32);
  const size_t smem = 2 * (size_t)bs * hd * sizeof(float);
  const auto* qq = static_cast<const __nv_bfloat16*>(q);
  const FloatPool<T> pool{static_cast<const T*>(k_pool),
                          static_cast<const T*>(v_pool)};
  return dispatch_npl(hd, [&](auto npl) {
    constexpr int N = decltype(npl)::value;
    if (window < 0) {
      paged_attention_kernel<T, N><<<grid, block, smem, stream>>>(
          qq, pool, table, pos, out, KV, G, hd, bs, max_blocks, scale,
          softcap);
    } else {
      paged_attention_window_kernel<T, N><<<grid, block, smem, stream>>>(
          qq, pool, table, pos, out, KV, G, hd, bs, max_blocks, scale,
          softcap, window, sinks);
    }
  });
}

// window < 0: the unwindowed kernel (K2b); else the windowed one (K2c).
template <int BITS>
int launch_quant(const void* q, const void* k_codes, const void* v_codes,
                 const void* k_scale, const void* v_scale, const int* table,
                 const int* pos, float* out, int B, int KV, int G, int hd,
                 int bs, int max_blocks, int group_size, float scale,
                 float softcap, int window, int sinks, cudaStream_t stream) {
  const dim3 grid(B, KV);
  const dim3 block(G * 32);
  const size_t smem = 2 * (size_t)bs * hd * sizeof(float);
  const auto* qq = static_cast<const __nv_bfloat16*>(q);
  const QuantPool<BITS> pool{k_codes, v_codes,
                             static_cast<const __half*>(k_scale),
                             static_cast<const __half*>(v_scale), group_size,
                             hd / group_size};
  return dispatch_npl(hd, [&](auto npl) {
    constexpr int N = decltype(npl)::value;
    if (window < 0) {
      paged_attention_quant_kernel<BITS, N><<<grid, block, smem, stream>>>(
          qq, pool, table, pos, out, KV, G, hd, bs, max_blocks, scale,
          softcap);
    } else {
      paged_attention_quant_window_kernel<BITS, N>
          <<<grid, block, smem, stream>>>(qq, pool, table, pos, out, KV, G,
                                          hd, bs, max_blocks, scale, softcap,
                                          window, sinks);
    }
  });
}

int launch_any(const void* q, const void* k_pool, const void* v_pool,
               const int* table, const int* pos, float* out, int B, int KV,
               int G, int hd, int bs, int max_blocks, int pool_bf16,
               float scale, float softcap, int window, int sinks,
               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pool_bf16) {
    return launch_float<__nv_bfloat16>(q, k_pool, v_pool, table, pos, out, B,
                                       KV, G, hd, bs, max_blocks, scale,
                                       softcap, window, sinks, s);
  }
  return launch_float<float>(q, k_pool, v_pool, table, pos, out, B, KV, G, hd,
                             bs, max_blocks, scale, softcap, window, sinks, s);
}

int launch_any_quant(const void* q, const void* k_codes, const void* v_codes,
                     const void* k_scale, const void* v_scale,
                     const int* table, const int* pos, float* out, int B,
                     int KV, int G, int hd, int bs, int max_blocks, int bits,
                     int group_size, float scale, float softcap, int window,
                     int sinks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (group_size <= 0 || hd % group_size != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bits == 8) {
    return launch_quant<8>(q, k_codes, v_codes, k_scale, v_scale, table, pos,
                           out, B, KV, G, hd, bs, max_blocks, group_size,
                           scale, softcap, window, sinks, s);
  }
  if (bits == 4) {
    return launch_quant<4>(q, k_codes, v_codes, k_scale, v_scale, table, pos,
                           out, B, KV, G, hd, bs, max_blocks, group_size,
                           scale, softcap, window, sinks, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q (B, KV, G, hd) bf16; k_pool/v_pool (num_blocks, bs, KV, hd) bf16 when
// pool_bf16 else fp32; table (B, max_blocks) int32 (-1 = unallocated);
// pos (B,) int32; out (B, KV, G, hd) fp32. softcap <= 0 means none.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int paged_attention_bf16q(const void* q, const void* k_pool,
                                     const void* v_pool, const int* table,
                                     const int* pos, float* out, int B, int KV,
                                     int G, int hd, int bs, int max_blocks,
                                     int pool_bf16, float scale, float softcap,
                                     void* stream) {
  return launch_any(q, k_pool, v_pool, table, pos, out, B, KV, G, hd, bs,
                    max_blocks, pool_bf16, scale, softcap, -1, 0, stream);
}

// K2c over a float pool: as paged_attention_bf16q, attending only key
// positions kp <= pos with pos - kp < window or kp < sinks (window >= 1,
// sinks >= 0 tokens). Returns cudaErrorInvalidValue for window < 1 or
// sinks < 0, else cudaGetLastError() after the launch.
extern "C" int paged_attention_window_bf16q(
    const void* q, const void* k_pool, const void* v_pool, const int* table,
    const int* pos, float* out, int B, int KV, int G, int hd, int bs,
    int max_blocks, int pool_bf16, float scale, float softcap, int window,
    int sinks, void* stream) {
  if (window < 1 || sinks < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_any(q, k_pool, v_pool, table, pos, out, B, KV, G, hd, bs,
                    max_blocks, pool_bf16, scale, softcap, window, sinks,
                    stream);
}

// As paged_attention_bf16q over a quantized pool: k_codes/v_codes
// (num_blocks, bs, KV, hd) int8 for bits 8 or (num_blocks, bs, KV,
// ceil(hd/2)) uint8 nibbles for bits 4; k_scale/v_scale (num_blocks, bs, KV,
// hd / group_size) fp16, paged through the same table entries.
// Returns cudaErrorInvalidValue for other bits or a group_size that does not
// divide hd, else cudaGetLastError() after the launch.
extern "C" int paged_attention_quant_bf16q(
    const void* q, const void* k_codes, const void* v_codes,
    const void* k_scale, const void* v_scale, const int* table, const int* pos,
    float* out, int B, int KV, int G, int hd, int bs, int max_blocks, int bits,
    int group_size, float scale, float softcap, void* stream) {
  return launch_any_quant(q, k_codes, v_codes, k_scale, v_scale, table, pos,
                          out, B, KV, G, hd, bs, max_blocks, bits, group_size,
                          scale, softcap, -1, 0, stream);
}

// K2c over a quantized pool: as paged_attention_quant_bf16q under the
// window and sinks of paged_attention_window_bf16q.
extern "C" int paged_attention_quant_window_bf16q(
    const void* q, const void* k_codes, const void* v_codes,
    const void* k_scale, const void* v_scale, const int* table, const int* pos,
    float* out, int B, int KV, int G, int hd, int bs, int max_blocks, int bits,
    int group_size, float scale, float softcap, int window, int sinks,
    void* stream) {
  if (window < 1 || sinks < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_any_quant(q, k_codes, v_codes, k_scale, v_scale, table, pos,
                          out, B, KV, G, hd, bs, max_blocks, bits, group_size,
                          scale, softcap, window, sinks, stream);
}
