// K1 quant_matmul and K4 quant_matmul_packed: fused dequant GEMMs for
// Hopper (sm_90a). K5 int_matmul and K6 int_matmul_packed, the integer
// GEMMs, follow below them.
//
//     out[m, n] = scale[n] * (x @ codes)[m, n] + bias[n] * rowsum[m]
//
// which equals x @ (codes * scale + bias) in exact arithmetic: the weight is
// never widened to float in device memory. K1 reads int8 codes (K, N); K4
// reads 2- or 4-bit codes packed along K into uint8 (ceil(K/per), N), byte i
// of a column holding codes i*per + j in bits [j*b, (j+1)*b), biased by
// 2^(b-1) (src/repro_torch/quant/pack.py).
//
// Replaces: src/repro/kernels/quant_matmul/quant_matmul.py:
// quant_matmul_pallas (kernel body _kernel) and quant_matmul_packed_pallas
// (_packed_kernel, unpacking through layout.py:unpack_tile). The TPU kernels
// walk a sequential K grid axis and accumulate into the revisited fp32
// output tile, applying the affine epilogue on the last K step. Here one
// thread block owns one BM x BN output tile and loops over K itself; the
// epilogue runs in registers before the only store.
//
// What bounds them on an H100: at decode (M = serving slots, 8) the work is
// a stream of weight-code bytes with 2 FLOPs per code per row, far below the
// card's ~20 FLOP/byte fp32 ridge: they are bound by the bytes of `codes`
// (K*N, K*N/2 or K*N/4 of them). At prefill (M = the padded prompt, up to
// 512) they are bound by fp32 FMAs.
// What the design does about it:
//   * codes are read as bytes (a quarter of fp32's, or 1/8 and 1/16 packed)
//     and widened to float only in shared memory, once per tile. The packed
//     loader writes the unpacked, centered code
//     ((byte >> (j*b)) & mask) - 2^(b-1) into the same fp32 tile K1 fills,
//     and both run one tile body (gemm_tile) with the same K order and the
//     same explicitly rounded epilogue, so K4 on pack(c) equals K1 on c bit
//     for bit;
//   * x and codes tiles are staged in shared memory and reused by every
//     thread of the block; each thread keeps a TM x TN fp32 register tile;
//   * two tile shapes: M <= 8 takes an 8-row tile (one output per thread,
//     no idle rows at decode), larger M takes 64 x 64 tiles with 4 x 4
//     register tiles. Both K tiles (128 and 16) are whole packed rows at 2
//     and 4 bits. Split-K, wider loads, cp.async/TMA pipelining and tensor
//     cores are left for a later change; at M = 8 a block still reads its
//     codes tile with plain byte loads and few bytes in flight, and K4
//     reads each packed byte once per code it holds (the repeats hit L1).
//   * ragged M/N/K edges are zero-filled on load (a ragged K tail would
//     otherwise add garbage to real sums; for K4 this also zeroes the x
//     columns that meet pack padding, and no packed row >= ceil(K/per) is
//     read) and masked on store.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Code (gk, gn) as an int: an int8 code (BITS = 8), or the centered
// BITS-bit field of a packed byte (BITS = 2, 4). K4's and K6's unpack
// loader.
template <int BITS>
__device__ __forceinline__ int load_code_int(const void* codes, int gk,
                                             int gn, int N) {
  if constexpr (BITS == 8) {
    return static_cast<const int8_t*>(codes)[(size_t)gk * N + gn];
  } else {
    constexpr int PER = 8 / BITS;
    const unsigned byte =
        static_cast<const uint8_t*>(codes)[(size_t)(gk / PER) * N + gn];
    const int field = (byte >> ((gk % PER) * BITS)) & ((1 << BITS) - 1);
    return field - (1 << (BITS - 1));
  }
}

// The same code as a float (exact: |code| <= 128).
template <int BITS>
__device__ __forceinline__ float load_code(const void* codes, int gk, int gn,
                                           int N) {
  return static_cast<float>(load_code_int<BITS>(codes, gk, gn, N));
}

// One BM x BN output tile of out = scale * (x @ codes) + bias * rowsum.
template <int BITS, int BM, int BN, int BK, int TM, int TN>
__device__ __forceinline__ void gemm_tile(const float* __restrict__ x,
                                          const void* __restrict__ codes,
                                          const float* __restrict__ scale,
                                          const float* __restrict__ bias,
                                          const float* __restrict__ rowsum,
                                          float* __restrict__ out, int M,
                                          int N, int K) {
  constexpr int RT = BM / TM;  // thread rows: thread (ty, tx) owns rows
  constexpr int CT = BN / TN;  // ty + i*RT and columns tx + j*CT
  constexpr int NT = RT * CT;
  __shared__ float xs[BK][BM + 1];
  __shared__ float cs[BK][BN];

  const int tid = threadIdx.x;
  const int ty = tid / CT;
  const int tx = tid % CT;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += NT) {
      const int r = i / BK, c = i % BK;
      const int gm = m0 + r, gk = k0 + c;
      xs[c][r] = (gm < M && gk < K) ? x[(size_t)gm * K + gk] : 0.f;
    }
    for (int i = tid; i < BK * BN; i += NT) {
      const int r = i / BN, c = i % BN;
      const int gk = k0 + r, gn = n0 + c;
      cs[r][c] = (gk < K && gn < N) ? load_code<BITS>(codes, gk, gn, N) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty + i * RT];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = cs[kk][tx + j * CT];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + i * RT;
    if (m >= M) continue;
    const float rs = rowsum[m];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + j * CT;
      // rounded explicitly, so no instantiation contracts it differently
      if (n < N)
        out[(size_t)m * N + n] = fmaf(acc[i][j], scale[n],
                                      __fmul_rn(rs, bias[n]));
    }
  }
}

template <int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
quant_matmul_kernel(const float* __restrict__ x,
                    const int8_t* __restrict__ codes,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias,
                    const float* __restrict__ rowsum,
                    float* __restrict__ out, int M, int N, int K) {
  gemm_tile<8, BM, BN, BK, TM, TN>(x, codes, scale, bias, rowsum, out, M, N,
                                   K);
}

template <int BITS, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
quant_matmul_packed_kernel(const float* __restrict__ x,
                           const uint8_t* __restrict__ packed,
                           const float* __restrict__ scale,
                           const float* __restrict__ bias,
                           const float* __restrict__ rowsum,
                           float* __restrict__ out, int M, int N, int K) {
  static_assert(BK % (8 / BITS) == 0, "K tile must be whole packed rows");
  gemm_tile<BITS, BM, BN, BK, TM, TN>(x, packed, scale, bias, rowsum, out, M,
                                      N, K);
}

// The tile shapes of both kernels: an 8-row tile at decode, 64 x 64 above.
constexpr int kSmallM = 8;

dim3 grid_of(int M, int N, int bm, int bn) {
  return dim3((N + bn - 1) / bn, (M + bm - 1) / bm);
}

void launch_i8(const float* x, const int8_t* codes, const float* scale,
               const float* bias, const float* rowsum, float* out, int M,
               int N, int K, cudaStream_t stream) {
  if (M <= kSmallM) {
    const dim3 grid = grid_of(M, N, 8, 32);
    quant_matmul_kernel<8, 32, 128, 1, 1><<<grid, 8 * 32, 0, stream>>>(
        x, codes, scale, bias, rowsum, out, M, N, K);
  } else {
    const dim3 grid = grid_of(M, N, 64, 64);
    quant_matmul_kernel<64, 64, 16, 4, 4><<<grid, 16 * 16, 0, stream>>>(
        x, codes, scale, bias, rowsum, out, M, N, K);
  }
}

template <int BITS>
void launch_packed(const float* x, const uint8_t* packed, const float* scale,
                   const float* bias, const float* rowsum, float* out, int M,
                   int N, int K, cudaStream_t stream) {
  if (M <= kSmallM) {
    const dim3 grid = grid_of(M, N, 8, 32);
    quant_matmul_packed_kernel<BITS, 8, 32, 128, 1, 1>
        <<<grid, 8 * 32, 0, stream>>>(
            x, packed, scale, bias, rowsum, out, M, N, K);
  } else {
    const dim3 grid = grid_of(M, N, 64, 64);
    quant_matmul_packed_kernel<BITS, 64, 64, 16, 4, 4>
        <<<grid, 16 * 16, 0, stream>>>(
            x, packed, scale, bias, rowsum, out, M, N, K);
  }
}

// ---------------------------------------------------------------------------
// K5 int_matmul and K6 int_matmul_packed: int8 x int8 GEMMs summed in int32
// ---------------------------------------------------------------------------
//
//     out[m, n] = eff_scale[n] * (qx @ codes)[m, n] + eff_bias[n] * rowsum[m]
//                 + cst[n]
//
// qx holds per-tensor activation codes, codes the weight codes (int8, or
// packed 2/4-bit fields as for K4); ops.py folds the two affine grids into
// eff_scale = sx * scale, eff_bias = sx * bias and
// cst = bx * (scale * colsum + K * bias), so out equals
// (qx * sx + bx) @ (codes * scale + bias) in exact arithmetic.
//
// Replaces: src/repro/kernels/quant_matmul/quant_matmul.py:
// int_matmul_pallas (kernel body _int_kernel) and int_matmul_packed_pallas
// (_int_packed_kernel). Those carry an int32 VMEM accumulator across a
// sequential K grid axis; here one thread block owns a BM x BN output tile,
// loops over K itself and keeps TM x TN int32 sums in registers.
//
// Two loaders for the activation: qx as int8 codes with rowsum given (the
// TPU kernel's contract), or (QUANT) fp32 x quantized in the loader on the
// grid [alpha, beta, s] with offset 2^(bits-1), exactly as
// core.quantizer.quantize_to_int does it (clip, subtract, IEEE divide,
// round half to even), the row sums of the codes taken with the same
// __dp4a as the products. The serving path takes the second: one launch
// per GEMM, no int8 copy of x in device memory.
//
// What bounds them on an H100: at decode (M = 8 slots) the bytes of the
// weight codes, as for K1/K4; at prefill (M up to 512) the int8 operations.
// What the design does about it:
//   * the products are __dp4a: four int8 pairs summed into an int32 per
//     instruction, exact in any order, so the accumulator equals the plain
//     version's fp64-summed codes bit for bit, and the epilogue is rounded
//     explicitly (__fadd_rn/__fmul_rn, no FMA contraction) in the plain
//     version's order: K5 is bit-equal to it, and K6 on pack(c) to K5 on c;
//   * both operands are staged in shared memory as 32-bit words of four
//     consecutive K codes (x transposed to K-major, codes gathered down a
//     column), so each inner step is two shared loads per dp4a pair;
//   * the K4 tile shapes: an 8-row tile at M <= 8, 64 x 64 with 4 x 4
//     register tiles above;
//   * ragged M/N/K edges and pack padding are zeroed on load (a zero code
//     adds nothing to a sum), and no packed row >= ceil(K/per) is read.
// The codes are still read a byte at a time; tensor-core IMMA/wgmma, TMA
// and split-K at M = 8 are later work.

// Activation code (gm, gk) at flat index idx.
template <bool QUANT>
__device__ __forceinline__ int load_act(const void* x, size_t idx,
                                        float alpha, float beta, float s,
                                        int offset) {
  if constexpr (QUANT) {
    const float v = static_cast<const float*>(x)[idx];
    const float c = fminf(fmaxf(v, alpha), beta);
    return static_cast<int>(rintf(__fdiv_rn(__fsub_rn(c, alpha), s))) -
           offset;
  } else {
    return static_cast<const int8_t*>(x)[idx];
  }
}

template <int BITS, bool QUANT, int BM, int BN, int BK, int TM, int TN>
__device__ __forceinline__ void int_gemm_tile(
    const void* __restrict__ x, const void* __restrict__ codes,
    const float* __restrict__ eff_scale, const float* __restrict__ eff_bias,
    const float* __restrict__ rowsum, const float* __restrict__ cst,
    const float* __restrict__ grid, int offset, float* __restrict__ out,
    int M, int N, int K) {
  static_assert(BK % 4 == 0, "K tile must be whole 4-code words");
  constexpr int KQ = BK / 4;
  constexpr int RT = BM / TM;
  constexpr int CT = BN / TN;
  constexpr int NT = RT * CT;
  __shared__ int xs[KQ][BM + 1];
  __shared__ int cs[KQ][BN];

  const int tid = threadIdx.x;
  const int ty = tid / CT;
  const int tx = tid % CT;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  float alpha = 0.f, beta = 0.f, s = 1.f;
  if constexpr (QUANT) {
    alpha = grid[0];
    beta = grid[1];
    s = grid[2];
  }

  int acc[TM][TN];
  int rs[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    rs[i] = 0;
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;
  }

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * KQ; i += NT) {
      const int r = i / KQ, q = i % KQ;
      const int gm = m0 + r;
      unsigned word = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gk = k0 + 4 * q + j;
        if (gm < M && gk < K)
          word |= (static_cast<unsigned>(load_act<QUANT>(
                       x, (size_t)gm * K + gk, alpha, beta, s, offset)) &
                   0xffu)
                  << (8 * j);
      }
      xs[q][r] = static_cast<int>(word);
    }
    for (int i = tid; i < KQ * BN; i += NT) {
      const int q = i / BN, c = i % BN;
      const int gn = n0 + c;
      unsigned word = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gk = k0 + 4 * q + j;
        if (gk < K && gn < N)
          word |= (static_cast<unsigned>(load_code_int<BITS>(codes, gk, gn,
                                                             N)) &
                   0xffu)
                  << (8 * j);
      }
      cs[q][c] = static_cast<int>(word);
    }
    __syncthreads();
#pragma unroll 8
    for (int q = 0; q < KQ; ++q) {
      int a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[q][ty + i * RT];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = cs[q][tx + j * CT];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
        if constexpr (QUANT) rs[i] = __dp4a(a[i], 0x01010101, rs[i]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = ty + i * RT + m0;
    if (m >= M) continue;
    float r;
    if constexpr (QUANT) {
      r = static_cast<float>(rs[i]);
    } else {
      r = rowsum[m];
    }
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + j * CT;
      if (n < N)
        out[(size_t)m * N + n] =
            __fadd_rn(__fadd_rn(__fmul_rn(static_cast<float>(acc[i][j]),
                                          eff_scale[n]),
                                __fmul_rn(r, eff_bias[n])),
                      cst[n]);
    }
  }
}

template <bool QUANT, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
int_matmul_kernel(const void* __restrict__ x,
                  const int8_t* __restrict__ codes,
                  const float* __restrict__ eff_scale,
                  const float* __restrict__ eff_bias,
                  const float* __restrict__ rowsum,
                  const float* __restrict__ cst,
                  const float* __restrict__ grid, int offset,
                  float* __restrict__ out, int M, int N, int K) {
  int_gemm_tile<8, QUANT, BM, BN, BK, TM, TN>(
      x, codes, eff_scale, eff_bias, rowsum, cst, grid, offset, out, M, N, K);
}

template <int BITS, bool QUANT, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
int_matmul_packed_kernel(const void* __restrict__ x,
                         const uint8_t* __restrict__ packed,
                         const float* __restrict__ eff_scale,
                         const float* __restrict__ eff_bias,
                         const float* __restrict__ rowsum,
                         const float* __restrict__ cst,
                         const float* __restrict__ grid, int offset,
                         float* __restrict__ out, int M, int N, int K) {
  int_gemm_tile<BITS, QUANT, BM, BN, BK, TM, TN>(
      x, packed, eff_scale, eff_bias, rowsum, cst, grid, offset, out, M, N,
      K);
}

// The int kernels' tiles: 8 x 32 with a 256-deep K tile at decode (one
// output a thread), 64 x 64 x 64 with 4 x 4 register tiles above.
template <int BITS, bool QUANT>
void launch_int(const void* x, const void* codes, const float* eff_scale,
                const float* eff_bias, const float* rowsum, const float* cst,
                const float* grid, int offset, float* out, int M, int N,
                int K, cudaStream_t stream) {
  if (M <= kSmallM) {
    const dim3 grd = grid_of(M, N, 8, 32);
    if constexpr (BITS == 8) {
      int_matmul_kernel<QUANT, 8, 32, 256, 1, 1><<<grd, 8 * 32, 0, stream>>>(
          x, static_cast<const int8_t*>(codes), eff_scale, eff_bias, rowsum,
          cst, grid, offset, out, M, N, K);
    } else {
      int_matmul_packed_kernel<BITS, QUANT, 8, 32, 256, 1, 1>
          <<<grd, 8 * 32, 0, stream>>>(
              x, static_cast<const uint8_t*>(codes), eff_scale, eff_bias,
              rowsum, cst, grid, offset, out, M, N, K);
    }
  } else {
    const dim3 grd = grid_of(M, N, 64, 64);
    if constexpr (BITS == 8) {
      int_matmul_kernel<QUANT, 64, 64, 64, 4, 4><<<grd, 16 * 16, 0, stream>>>(
          x, static_cast<const int8_t*>(codes), eff_scale, eff_bias, rowsum,
          cst, grid, offset, out, M, N, K);
    } else {
      int_matmul_packed_kernel<BITS, QUANT, 64, 64, 64, 4, 4>
          <<<grd, 16 * 16, 0, stream>>>(
              x, static_cast<const uint8_t*>(codes), eff_scale, eff_bias,
              rowsum, cst, grid, offset, out, M, N, K);
    }
  }
}

template <int BITS>
int launch_int_any(const void* x, int quant, const void* codes,
                   const float* eff_scale, const float* eff_bias,
                   const float* rowsum, const float* cst, const float* grid,
                   int act_bits, float* out, int M, int N, int K,
                   cudaStream_t stream) {
  if (quant) {
    if (act_bits < 2 || act_bits > 8)
      return static_cast<int>(cudaErrorInvalidValue);
    launch_int<BITS, true>(x, codes, eff_scale, eff_bias, rowsum, cst, grid,
                           1 << (act_bits - 1), out, M, N, K, stream);
  } else {
    launch_int<BITS, false>(x, codes, eff_scale, eff_bias, rowsum, cst, grid,
                            0, out, M, N, K, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M, K) fp32, codes (K, N) int8, scale/bias (N,) fp32, rowsum (M,) fp32,
// out (M, N) fp32; all contiguous, on the device of `stream`.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int quant_matmul_f32_i8(const float* x, const int8_t* codes,
                                   const float* scale, const float* bias,
                                   const float* rowsum, float* out, int M,
                                   int N, int K, void* stream) {
  launch_i8(x, codes, scale, bias, rowsum, out, M, N, K,
            static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// As quant_matmul_f32_i8, with codes (ceil(K/per), N) uint8 packing
// bits in {2, 4} per code (per = 8 / bits) and K the logical fan-in.
// Returns cudaErrorInvalidValue for other bits, else cudaGetLastError().
extern "C" int quant_matmul_f32_packed(const float* x, const uint8_t* packed,
                                       const float* scale, const float* bias,
                                       const float* rowsum, float* out, int M,
                                       int N, int K, int bits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bits == 2) {
    launch_packed<2>(x, packed, scale, bias, rowsum, out, M, N, K, s);
  } else if (bits == 4) {
    launch_packed<4>(x, packed, scale, bias, rowsum, out, M, N, K, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// K5. quant = 0: x is (M, K) int8 activation codes and rowsum (M,) fp32
// their row sums (grid unused). quant = 1: x is (M, K) fp32, quantized in
// the kernel on grid = [alpha, beta, s] (fp32, device) at act_bits in
// [2, 8], and the row sums are taken in the kernel (rowsum unused).
// codes (K, N) int8; eff_scale/eff_bias/cst (N,) fp32; out (M, N) fp32;
// all contiguous, on the device of `stream`. Returns
// cudaErrorInvalidValue for act_bits outside [2, 8] when quant, else
// cudaGetLastError() after the launch (0 = launched).
extern "C" int int_matmul_i8(const void* x, int quant, const int8_t* codes,
                             const float* eff_scale, const float* eff_bias,
                             const float* rowsum, const float* cst,
                             const float* grid, int act_bits, float* out,
                             int M, int N, int K, void* stream) {
  return launch_int_any<8>(x, quant, codes, eff_scale, eff_bias, rowsum, cst,
                           grid, act_bits, out, M, N, K,
                           static_cast<cudaStream_t>(stream));
}

// K6: as int_matmul_i8, with codes (ceil(K/per), N) uint8 packing bits in
// {2, 4} per code (per = 8 / bits) and K the logical fan-in. Returns
// cudaErrorInvalidValue for other bits.
extern "C" int int_matmul_packed_u8(const void* x, int quant,
                                    const uint8_t* packed,
                                    const float* eff_scale,
                                    const float* eff_bias,
                                    const float* rowsum, const float* cst,
                                    const float* grid, int act_bits,
                                    float* out, int M, int N, int K, int bits,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bits == 2)
    return launch_int_any<2>(x, quant, packed, eff_scale, eff_bias, rowsum,
                             cst, grid, act_bits, out, M, N, K, s);
  if (bits == 4)
    return launch_int_any<4>(x, quant, packed, eff_scale, eff_bias, rowsum,
                             cst, grid, act_bits, out, M, N, K, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
