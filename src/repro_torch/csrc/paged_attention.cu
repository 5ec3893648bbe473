// K2a/K2b paged_attention: one-token GQA decode through a paged KV pool, for
// Hopper (sm_90a). No window. K2a reads float pools (bf16 or fp32); K2b
// reads quantized pools (src/repro_torch/quant/kv.py): int8 codes, or int4
// codes packed two per byte (low nibble first, biased by +8), with one fp16
// scale per group of `group_size` contiguous head elements.
//
// Replaces: src/repro/kernels/paged_attention/paged_attention.py:
// paged_attention_pallas with window=None (kernel body _kernel), with a
// float pool (K2a) or k_scale/v_scale (K2b). The TPU kernel runs a (slot,
// logical block) grid with the block table scalar-prefetched into the K/V
// (and scale) index maps and carries the online softmax state (m, l, acc)
// in VMEM scratch across a slot's blocks. Here one thread block owns one
// (slot b, KV head h) pair, reads its own table row and pos[b], and walks
// logical blocks 0 .. pos[b] // bs in a loop; the carry lives in registers.
//
// What bounds it on an H100: bytes. Every cached K/V element is used for
// 2 FLOPs per query head of its group (G = 8 at full width), far below the
// ridge, so the floor is the K/V bytes (codes and scales for K2b) of the
// tokens each row attends.
// What the design does about it:
//   * each K/V block of head h is read from device memory once per thread
//     block (coalesced, staged to shared memory as fp32) and reused by the G
//     warps of the group, one warp per query head;
//   * K2b dequantizes while staging: each token's codes and its ng scales
//     are read through the SAME table entry, and element d becomes
//     code(d) * scale[d / group_size] in fp32, the product
//     quant/kv.py:dequant_codes forms, so the warps read the same fp32
//     tiles as in K2a;
//   * entries of -1 and blocks past pos are never read (the TPU kernel's
//     `run` predicate minus the window terms), and the last block stops at
//     column pos, so no masked score is computed;
//   * per token: a warp-reduced q.k (lane d holds q[d], q[d+32], ...), times
//     hd**-0.5, optional tanh softcap, then an online-softmax update of the
//     warp's m, l and acc registers. K, V and the probabilities stay fp32,
//     as in the TPU kernel.
//   * finalize writes acc / max(l, 1e-30) in fp32.
// Not done here: splitting long rows across blocks (flash-decoding),
// packing several tokens per warp step and wide loads of the codes; a later
// change can add them.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

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

// NPL: head-dim elements per lane (hd <= 32 * NPL).
template <int NPL, typename Pool>
__device__ __forceinline__ void decode_row(
    const __nv_bfloat16* __restrict__ q, const Pool& pool,
    const int* __restrict__ table, const int* __restrict__ pos,
    float* __restrict__ out, int KV, int G, int hd, int bs, int max_blocks,
    float scale, float softcap) {
  extern __shared__ float smem[];
  float* ks = smem;            // (bs, hd) K of the current block, head h
  float* vs = smem + bs * hd;  // (bs, hd) V

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int warp = threadIdx.x / 32;  // query head within the group
  const int lane = threadIdx.x % 32;
  const int p = pos[b];

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
  for (int j = 0; j <= last; ++j) {
    const int phys = table[(size_t)b * max_blocks + j];
    if (phys < 0) continue;  // uniform over the block: no divergent barrier
    pool.stage(ks, vs, phys, h, KV, hd, bs);
    __syncthreads();
    const int ntok = min(bs, p - j * bs + 1);
    for (int t = 0; t < ntok; ++t) {
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
  decode_row<NPL>(q, pool, table, pos, out, KV, G, hd, bs, max_blocks, scale,
                  softcap);
}

template <int BITS, int NPL>
__global__ void paged_attention_quant_kernel(
    const __nv_bfloat16* __restrict__ q, QuantPool<BITS> pool,
    const int* __restrict__ table, const int* __restrict__ pos,
    float* __restrict__ out, int KV, int G, int hd, int bs, int max_blocks,
    float scale, float softcap) {
  decode_row<NPL>(q, pool, table, pos, out, KV, G, hd, bs, max_blocks, scale,
                  softcap);
}

// One launch of `kernel<..., NPL>` for the smallest NPL with hd <= 32 * NPL.
#define PA_DISPATCH_NPL(KERNEL, ...)                                         \
  do {                                                                       \
    if (hd <= 32) {                                                          \
      KERNEL<__VA_ARGS__, 1><<<grid, block, smem, stream>>>(                 \
          qq, pool, table, pos, out, KV, G, hd, bs, max_blocks, scale,       \
          softcap);                                                          \
    } else if (hd <= 64) {                                                   \
      KERNEL<__VA_ARGS__, 2><<<grid, block, smem, stream>>>(                 \
          qq, pool, table, pos, out, KV, G, hd, bs, max_blocks, scale,       \
          softcap);                                                          \
    } else if (hd <= 128) {                                                  \
      KERNEL<__VA_ARGS__, 4><<<grid, block, smem, stream>>>(                 \
          qq, pool, table, pos, out, KV, G, hd, bs, max_blocks, scale,       \
          softcap);                                                          \
    } else if (hd <= 256) {                                                  \
      KERNEL<__VA_ARGS__, 8><<<grid, block, smem, stream>>>(                 \
          qq, pool, table, pos, out, KV, G, hd, bs, max_blocks, scale,       \
          softcap);                                                          \
    } else {                                                                 \
      return static_cast<int>(cudaErrorInvalidValue);                        \
    }                                                                        \
  } while (0)

template <typename T>
int launch_float(const void* q, const void* k_pool, const void* v_pool,
                 const int* table, const int* pos, float* out, int B, int KV,
                 int G, int hd, int bs, int max_blocks, float scale,
                 float softcap, cudaStream_t stream) {
  const dim3 grid(B, KV);
  const dim3 block(G * 32);
  const size_t smem = 2 * (size_t)bs * hd * sizeof(float);
  const auto* qq = static_cast<const __nv_bfloat16*>(q);
  const FloatPool<T> pool{static_cast<const T*>(k_pool),
                          static_cast<const T*>(v_pool)};
  PA_DISPATCH_NPL(paged_attention_kernel, T);
  return static_cast<int>(cudaGetLastError());
}

template <int BITS>
int launch_quant(const void* q, const void* k_codes, const void* v_codes,
                 const void* k_scale, const void* v_scale, const int* table,
                 const int* pos, float* out, int B, int KV, int G, int hd,
                 int bs, int max_blocks, int group_size, float scale,
                 float softcap, cudaStream_t stream) {
  const dim3 grid(B, KV);
  const dim3 block(G * 32);
  const size_t smem = 2 * (size_t)bs * hd * sizeof(float);
  const auto* qq = static_cast<const __nv_bfloat16*>(q);
  const QuantPool<BITS> pool{k_codes, v_codes,
                             static_cast<const __half*>(k_scale),
                             static_cast<const __half*>(v_scale), group_size,
                             hd / group_size};
  PA_DISPATCH_NPL(paged_attention_quant_kernel, BITS);
  return static_cast<int>(cudaGetLastError());
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pool_bf16) {
    return launch_float<__nv_bfloat16>(q, k_pool, v_pool, table, pos, out, B,
                                       KV, G, hd, bs, max_blocks, scale,
                                       softcap, s);
  }
  return launch_float<float>(q, k_pool, v_pool, table, pos, out, B, KV, G, hd,
                             bs, max_blocks, scale, softcap, s);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (group_size <= 0 || hd % group_size != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bits == 8) {
    return launch_quant<8>(q, k_codes, v_codes, k_scale, v_scale, table, pos,
                           out, B, KV, G, hd, bs, max_blocks, group_size,
                           scale, softcap, s);
  }
  if (bits == 4) {
    return launch_quant<4>(q, k_codes, v_codes, k_scale, v_scale, table, pos,
                           out, B, KV, G, hd, bs, max_blocks, group_size,
                           scale, softcap, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
