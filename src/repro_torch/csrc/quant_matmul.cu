// K1 quant_matmul and K4 quant_matmul_packed: fused dequant GEMMs for
// Hopper (sm_90a). K5 int_matmul and K6 int_matmul_packed, the integer
// GEMMs, follow below them.
//
//     out[m, n] = scale[n] * (x @ codes)[m, n] + bias[n] * rowsum[m]
//
// which equals x @ (codes * scale + bias) in exact arithmetic: the weight is
// never widened to float in device memory. x is (M, K) bf16 (the serving
// path) or fp32. K1 reads int8 codes (K, N); K4 reads 2- or 4-bit codes
// packed along K into uint8 (ceil(K/per), N), byte i of a column holding
// codes i*per + j in bits [j*b, (j+1)*b), biased by 2^(b-1)
// (src/repro_torch/quant/pack.py).
//
// Replaces: src/repro/kernels/quant_matmul/quant_matmul.py:
// quant_matmul_pallas (kernel body _kernel) and quant_matmul_packed_pallas
// (_packed_kernel, unpacking through layout.py:unpack_tile). The TPU kernels
// walk a sequential K grid axis and accumulate into the revisited fp32
// output tile, applying the affine epilogue on the last K step. Here two
// paths, chosen by the wrapper from (M, N, K) alone and identical for K1
// and K4 (kernels/quant_matmul/quant_matmul.py: kernel_path, split_plan):
//
// stream:: (decode, M <= 8) bound by the bytes of `codes` (K*N, K*N/2 or
//   K*N/4): 2 FLOPs per code per row, below the card's fp32 ridge.
//   * a (N / 128, splits) grid, one wave of ~2 blocks an SM: each block
//     of 128 threads streams a chunk of K rows of 128 columns; the chunk is
//     a whole number of groups of 4 K rows (one packed row at 2 bits, two
//     at 4) and the split plan comes from the host, from (N, K) alone, so
//     it is the same at every bits;
//   * thread (slice, column group) owns 16 columns and K groups slice,
//     slice + 16, ... of the chunk in that order: 16-byte asynchronous
//     copies (cp.async), a row of 16 int8 codes or 16 columns of `per`
//     rows of packed bytes, into the thread's own ring of 4 groups in
//     shared memory: 3 groups in flight while one is summed, the first
//     issued before x is staged (no barrier: each thread reads only what
//     it copied);
//   * each code is widened once in registers, exactly: the (biased) byte
//     goes into the low byte of the float 2^23 by one byte permute, and one
//     subtraction takes off 2^23 + 128 (int8) or 2^23 + 2^(b-1) (packed
//     field ((byte >> j*b) & mask)). K1 and K4 thus feed the same floats in
//     the same K order into the same FMAs: K4 on pack(c) is K1 on c, bit
//     for bit;
//   * x (bf16 or fp32) is staged once a chunk in shared memory as fp32,
//     K-major with M rows side by side, read as float4 broadcasts (the
//     plan keeps a chunk within 4096 K rows);
//   * the 16 slices' sums are reduced in a fixed order (two butterfly
//     shuffles, then the four warps in turn); one split writes the
//     explicitly rounded epilogue fmaf(acc, scale, rowsum * bias) directly,
//     more write fp32 partials to a (splits, M, N) workspace that a second
//     launch (combine) adds in a fixed order (8 lanes of every 8th split,
//     then a pairwise tree) before the same epilogue. No atomics: two
//     calls give the same bits.
//
// tile:: (prefill, M > 8) bound by operations: bf16 tensor cores through
//   wgmma (m64n128k16, fp32 accumulators). wgmma has no int8 x bf16 form,
//   so the codes are widened to bf16 (exact for |code| <= 128) on their way
//   into shared memory:
//   * 384 threads a 128 x 128 output tile: two consumer warpgroups of 64
//     rows, one producer warpgroup; K steps of 64;
//   * the producer's first thread issues every TMA load: x tiles (bf16,
//     128-byte swizzle, K-major A) into a ring of 4 stages (3 with two x
//     terms) and the raw code tiles (64 x 128 int8, or 64/per packed rows)
//     into a ring of 4 raw stages, prefetched 3 K steps ahead;
//   * all 128 producer threads then unpack/widen a raw tile into bf16 and
//     store it in the MN-major, 128-byte-swizzled layout wgmma's B reads
//     (two 64-column boxes, as K7's V), zeroing codes past K so that K4's
//     pack padding enters as K1's zeros; they fence the writes to the async
//     proxy and arrive on the stage's full barrier beside the TMA bytes;
//   * consumers run 4 (or 8) wgmma a stage, keep one group in flight and
//     release the previous stage; K4 and K1 feed identical bf16 tiles into
//     the same instructions: bit-equal;
//   * fp32 x (the tests' and chip_smoke's random cases) goes in as two bf16
//     terms, hi = bf16(x) and lo = bf16(x - hi), both through the same tile
//     into the same accumulator: x is carried to 2^-18 |x| (the hi/lo
//     split K7 applies to its P); bf16 x is exact as one term;
//   * TMA needs 16-byte aligned rows: fp32 x, or bf16 x whose row is not a
//     multiple of 8 elements, is first written by prep_x as bf16 terms with
//     rows padded to a multiple of 8; codes whose row is not a multiple of
//     16 bytes are first copied by pad_codes into padded rows; both into
//     the wrapper's workspace, in the same call, and zeros pad them;
//   * ragged M/N/K edges: TMA zero-fills, the epilogue masks its stores; no
//     packed row >= ceil(K/per) is read (the tensor map ends there).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <type_traits>

#include "hopper.cuh"

namespace {

// Codes of byte j of `w` (in the low byte of 2^23) and the offset that
// leaves the code: 2^23 + 128 for int8 codes whose sign bit was flipped,
// 2^23 + 2^(b-1) for b-bit fields. Exact.
__device__ __forceinline__ float magic(uint32_t w, int j) {
  return __int_as_float(__byte_perm(w, 0x4B000000u, 0x7540u | j));
}

template <int BITS>
__device__ __forceinline__ float code_offset() {
  return 8388608.f + static_cast<float>(1 << (BITS - 1));
}

// The biased codes of K row `f` (0 <= f < 8/BITS) of a 4-byte word of codes:
// byte j of the result holds the code of column j plus the offset's bias.
template <int BITS>
__device__ __forceinline__ uint32_t fields(uint32_t w, int f) {
  if constexpr (BITS == 8) {
    return w ^ 0x80808080u;
  } else {
    constexpr uint32_t MASK = ((1u << BITS) - 1) * 0x01010101u;
    return (w >> (f * BITS)) & MASK;
  }
}

// Every kernel K1 and K4 launch is a template over one of these tags, so
// that its name carries its wrapper's (a profile charges it to K1 or K4).
struct quant_matmul_kernel;
struct quant_matmul_packed_kernel;
template <int BITS>
using Tag = std::conditional_t<BITS == 8, quant_matmul_kernel,
                               quant_matmul_packed_kernel>;

// ---------------------------------------------------------------------------
// stream: the decode path
// ---------------------------------------------------------------------------
namespace stream {

constexpr int CG = 8;          // column groups of a block
constexpr int COLS = 16;       // columns a thread owns: one 16-byte row load
constexpr int BN = CG * COLS;  // 128 columns a block
constexpr int KS = 16;         // K slices of a block
constexpr int NT = CG * KS;    // 128 threads
constexpr int GROUP = 4;       // K rows of a group: one packed row at 2 bits
constexpr int DEPTH = 4;       // groups of codes a thread has in flight + 1
constexpr int MAX_CHUNK_GROUPS = 1024;  // x of a chunk fits shared memory

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// 16 columns of one stored row of codes from column `col`, byte by byte up
// to N: rows that are not 16-byte aligned.
__device__ __forceinline__ uint4 load_row_bytes(
    const uint8_t* __restrict__ codes, int row, int N, int col) {
  const uint8_t* p = codes + (size_t)row * N + col;
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < COLS; ++j)
    if (col + j < N) w[j / 4] |= static_cast<uint32_t>(p[j]) << (8 * (j % 4));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// x[m][k0 .. k0 + 7] as fp32, zeros past K or for a row past M (`live`
// false); `wide`: one 16-byte load (bf16) or two (fp32), the rows being
// aligned for it.
__device__ __forceinline__ void load_x8(float (&v)[8], const void* x,
                                        int x_bf16, bool live, int m, int k0,
                                        int K, bool wide) {
  const size_t at = (size_t)m * K + k0;
  if (live && wide && k0 + 8 <= K) {
    if (x_bf16) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(
          static_cast<const __nv_bfloat16*>(x) + at));
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[2 * e] = __uint_as_float(w[e] << 16);
        v[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
      }
    } else {
      const float4* p =
          reinterpret_cast<const float4*>(static_cast<const float*>(x) + at);
      const float4 a = __ldg(p), b = __ldg(p + 1);
      v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
      v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const bool in = live && k0 + e < K;
    v[e] = !in ? 0.f
         : x_bf16 ? __bfloat162float(
                        static_cast<const __nv_bfloat16*>(x)[at + e])
                  : static_cast<const float*>(x)[at + e];
  }
}

// x of K row r of a staged group, M rows side by side.
template <int MR>
__device__ __forceinline__ void load_x(float (&xv)[MR], const float* p) {
  if constexpr (MR % 4 == 0) {
#pragma unroll
    for (int m = 0; m < MR; m += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + m);
      xv[m] = v.x;
      xv[m + 1] = v.y;
      xv[m + 2] = v.z;
      xv[m + 3] = v.w;
    }
  } else if constexpr (MR == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    xv[0] = v.x;
    xv[1] = v.y;
  } else {
    xv[0] = p[0];
  }
}

// acc[m][c] += x[m][k] * code[k][c] over the 4 K rows of one group, in K
// order; `raw` holds the group's 16-byte row loads (4 int8 rows, 2 rows of
// 4-bit bytes, or 1 row of 2-bit bytes); xg the group's staged x.
template <int MR, int BITS>
__device__ __forceinline__ void accumulate(float (&acc)[MR][COLS],
                                           const uint4 (&raw)[GROUP * BITS /
                                                              8],
                                           const float* xg) {
  constexpr int PER = 8 / BITS;
  const float off = code_offset<BITS>();
#pragma unroll
  for (int r = 0; r < GROUP; ++r) {
    float xv[MR];
    load_x<MR>(xv, xg + r * MR);
    const uint4 v = raw[r / PER];
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t f = fields<BITS>(w[q], r % PER);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float c = __fsub_rn(magic(f, j), off);
#pragma unroll
        for (int m = 0; m < MR; ++m)
          acc[m][4 * q + j] = fmaf(xv[m], c, acc[m][4 * q + j]);
      }
    }
  }
}

// One (column tile, split) of the stream: see the header.
// Shared memory of a stream block: each thread's ring of DEPTH groups of
// codes (after the walk, the warps' sums), then x for the whole chunk.
template <int MR, int BITS>
struct StreamSmem {
  static constexpr int L = GROUP * BITS / 8;   // 16-byte loads a group
  static constexpr int GS = GROUP * MR + 4;    // floats a staged group,
                                               // padded so that 4
                                               // neighbouring groups' float4
                                               // reads fall in distinct banks
  static constexpr int RING = DEPTH * L * NT;  // 16-byte slots
  static constexpr int RED = NT / 32 * MR * BN / 4;
  static constexpr int X_OFF = 16 * (RING > RED ? RING : RED);
  static int bytes(int chunk_groups) {
    return X_OFF + chunk_groups * GS * 4;
  }
};

template <class TAG, int MR, int BITS>
__global__ void __launch_bounds__(NT)
    kernel(const void* __restrict__ x, int x_bf16,
           const uint8_t* __restrict__ codes, const float* __restrict__ scale,
           const float* __restrict__ bias, const float* __restrict__ rowsum,
           float* __restrict__ out, float* __restrict__ ws, int M, int N,
           int K, int chunk_groups, int vec, int x_vec) {
  using S = StreamSmem<MR, BITS>;
  constexpr int PER = 8 / BITS;
  constexpr int L = S::L, GS = S::GS;
  extern __shared__ uint4 smem[];
  uint4* const ring = smem;
  float* const xs = reinterpret_cast<float*>(
      reinterpret_cast<uint8_t*>(smem) + S::X_OFF);

  const int tid = threadIdx.x;
  const int cg = tid % CG, slice = tid / CG;
  const int n0 = blockIdx.x * BN, col = n0 + cg * COLS;
  const int groups = (K + GROUP - 1) / GROUP;
  const int g_begin = blockIdx.y * chunk_groups;
  const int g_end = min(groups, g_begin + chunk_groups);
  const int rows = BITS == 8 ? K : (K + PER - 1) / PER;  // stored rows

  float acc[MR][COLS];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[m][c] = 0.f;

  // group g's rows into ring stage `st` (slot (st L + l) NT + tid): async
  // 16-byte copies, zeros past the split, K or N; unaligned rows byte by
  // byte. One commit group a call, empty or not
  auto issue = [&](int g, int st) {
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const int row = g * L + l;
      const bool ok = g < g_end && row < rows && col < N;
      uint4* slot = &ring[(st * L + l) * NT + tid];
      if (vec)
        cp_async16(smem_u32(slot), ok ? codes + (size_t)row * N + col : codes,
                   ok ? 16 : 0);
      else
        *slot = ok ? load_row_bytes(codes, row, N, col)
                   : make_uint4(0u, 0u, 0u, 0u);
    }
    cp_async_commit();
  };
  // the first DEPTH - 1 groups' codes are in flight while x is staged,
  // once, for the whole chunk
#pragma unroll
  for (int d = 0; d < DEPTH - 1; ++d) issue(g_begin + slice + d * KS, d);
  // x in pieces of 8 K rows, all MR rows of a piece loaded before any is
  // stored (16-byte loads where the rows allow)
  const int nrow = (g_end - g_begin) * GROUP;
  const bool wide = x_vec && (g_begin * GROUP) % 8 == 0;
  for (int kk0 = 8 * tid; kk0 < nrow; kk0 += 8 * NT) {
    const int k0 = g_begin * GROUP + kk0;
    float v[MR][8];
#pragma unroll
    for (int m = 0; m < MR; ++m) load_x8(v[m], x, x_bf16, m < M, m, k0, K,
                                          wide);
#pragma unroll
    for (int m = 0; m < MR; ++m)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int kk = kk0 + e;
        if (kk < nrow) xs[(kk / GROUP) * GS + (kk % GROUP) * MR + m] = v[m][e];
      }
  }
  __syncthreads();
  // step j: group g_begin + slice + 16 j, while the next DEPTH - 1 steps'
  // groups are in flight
  const int J = (g_end - g_begin + KS - 1) / KS;
  for (int j = 0; j < J; ++j) {
    const int g = g_begin + slice + j * KS;
    issue(g + (DEPTH - 1) * KS, (j + DEPTH - 1) % DEPTH);
    cp_async_wait<DEPTH - 1>();  // step j's group has landed
    if (g < g_end) {
      uint4 raw[L];
#pragma unroll
      for (int l = 0; l < L; ++l)
        raw[l] = ring[((j % DEPTH) * L + l) * NT + tid];
      accumulate<MR, BITS>(acc, raw, &xs[(g - g_begin) * GS]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every ring is drained: it holds the sums next
  float(*red)[MR][BN] = reinterpret_cast<float(*)[MR][BN]>(ring);

  // the 16 slices' sums: slices 4w .. 4w+3 sit in lanes 8 apart of warp w
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      float v = acc[m][c];
      v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 8));
      v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 16));
      acc[m][c] = v;
    }
  const int warp = tid / 32, lane = tid % 32;
  if (lane < CG) {
#pragma unroll
    for (int m = 0; m < MR; ++m)
#pragma unroll
      for (int c = 0; c < COLS; ++c) red[warp][m][lane * COLS + c] = acc[m][c];
  }
  __syncthreads();
  const bool direct = gridDim.y == 1;
  for (int i = tid; i < MR * BN; i += NT) {
    const int m = i / BN, c = i % BN, n = n0 + c;
    if (m >= M || n >= N) continue;
    float v = red[0][m][c];
#pragma unroll
    for (int w = 1; w < NT / 32; ++w) v = __fadd_rn(v, red[w][m][c]);
    if (direct)
      out[(size_t)m * N + n] = fmaf(v, scale[n], __fmul_rn(rowsum[m], bias[n]));
    else
      ws[((size_t)blockIdx.y * M + m) * N + n] = v;
  }
}

// out = the splits' partials summed in a fixed order, then the epilogue:
// a block takes 32 outputs (threadIdx.x) and 8 split lanes (threadIdx.y);
// lane y adds splits y, y + 8, ... in turn, and the 8 lanes' sums are
// added as ((0 + 1) + (2 + 3)) + ((4 + 5) + (6 + 7)).
constexpr int CX = 32, CY = 8;
template <class TAG>
__global__ void __launch_bounds__(CX * CY)
    combine(const float* __restrict__ ws, const float* __restrict__ scale,
            const float* __restrict__ bias, const float* __restrict__ rowsum,
            float* __restrict__ out, int M, int N, int splits) {
  __shared__ float part[CY][CX];
  const size_t mn = (size_t)M * N;
  const size_t i = (size_t)blockIdx.x * CX + threadIdx.x;
  const int y = threadIdx.y;
  float v = 0.f;
  if (i < mn) {
#pragma unroll 4
    for (int s = y; s < splits; s += CY) v = __fadd_rn(v, ws[s * mn + i]);
  }
  part[y][threadIdx.x] = v;
  __syncthreads();
  if (y == 0 && i < mn) {
    const float (*p)[CX] = part;
    const int x = threadIdx.x;
    const float lo = __fadd_rn(__fadd_rn(p[0][x], p[1][x]),
                               __fadd_rn(p[2][x], p[3][x]));
    const float hi = __fadd_rn(__fadd_rn(p[4][x], p[5][x]),
                               __fadd_rn(p[6][x], p[7][x]));
    const int m = static_cast<int>(i / N), n = static_cast<int>(i % N);
    out[i] = fmaf(__fadd_rn(lo, hi), scale[n], __fmul_rn(rowsum[m], bias[n]));
  }
}

// One stream launch at MR rows; the dynamic shared memory opt-in (to the
// most a block can use, once per device) lets a chunk's x take up to
// MAX_CHUNK_GROUPS groups.
template <int MR, int BITS>
cudaError_t launch_mr(dim3 grid, const void* x, int x_bf16,
                      const uint8_t* codes, const float* scale,
                      const float* bias, const float* rowsum, float* out,
                      float* ws, int M, int N, int K, int chunk_groups,
                      int vec, cudaStream_t stream) {
  // x's rows allow 16-byte loads of 8 elements from any multiple of 8
  const int x_vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    K % (x_bf16 ? 8 : 4) == 0;
  auto fn = kernel<Tag<BITS>, MR, BITS>;
  static std::atomic<std::uint64_t> opted{0};
  const cudaError_t err = opt_in_smem(fn, 232448, opted);
  if (err != cudaSuccess) return err;
  fn<<<grid, NT, StreamSmem<MR, BITS>::bytes(chunk_groups), stream>>>(
      x, x_bf16, codes, scale, bias, rowsum, out, ws, M, N, K, chunk_groups,
      vec, x_vec);
  return cudaGetLastError();
}

template <int BITS>
int launch(const void* x, int x_bf16, const uint8_t* codes,
           const float* scale, const float* bias, const float* rowsum,
           float* out, float* ws, int M, int N, int K, int splits, int chunk,
           cudaStream_t stream) {
  if (chunk <= 0 || chunk % GROUP || chunk / GROUP > MAX_CHUNK_GROUPS ||
      splits < 1 || splits > 65535 || (long long)splits * chunk < K ||
      (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = N % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(codes) % 16 == 0;
  const dim3 grid((N + BN - 1) / BN, splits);
  const int cgr = chunk / GROUP;
  cudaError_t err =
      M <= 1   ? launch_mr<1, BITS>(grid, x, x_bf16, codes, scale, bias,
                                    rowsum, out, ws, M, N, K, cgr, vec, stream)
      : M <= 2 ? launch_mr<2, BITS>(grid, x, x_bf16, codes, scale, bias,
                                    rowsum, out, ws, M, N, K, cgr, vec, stream)
      : M <= 4 ? launch_mr<4, BITS>(grid, x, x_bf16, codes, scale, bias,
                                    rowsum, out, ws, M, N, K, cgr, vec, stream)
               : launch_mr<8, BITS>(grid, x, x_bf16, codes, scale, bias,
                                    rowsum, out, ws, M, N, K, cgr, vec,
                                    stream);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long mn = (long long)M * N;
  if ((mn + CX - 1) / CX > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  combine<Tag<BITS>><<<static_cast<unsigned>((mn + CX - 1) / CX),
                       dim3(CX, CY), 0, stream>>>(ws, scale, bias, rowsum,
                                                  out, M, N, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace stream

// ---------------------------------------------------------------------------
// tile: the prefill path
// ---------------------------------------------------------------------------
namespace tile {

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int ROW = 128;           // bytes of one swizzled row: 64 bf16
constexpr int NT = 384;            // two consumer warpgroups, one producer
constexpr int RAW_STAGES = 4;      // raw code tiles in flight
constexpr int EMPTY_ARRIVALS = 8;  // one per consumer warp
constexpr int FULL_ARRIVALS = 5;   // the TMA issue, one per producer warp

// Shared memory from a 1024-byte aligned base: the x ring (STAGES x XT
// tiles of 128 rows x 128 bytes), the bf16 code ring (STAGES x two boxes
// of 64 K rows x 128 bytes), the raw ring (RAW_STAGES x RAW_ROWS x 128
// bytes), then the mbarriers: full [STAGES], empty [STAGES], raw
// [RAW_STAGES].
template <int BITS, bool HILO>
struct Layout {
  static constexpr int STAGES = HILO ? 3 : 4;
  static constexpr int XT = HILO ? 2 : 1;
  static constexpr int X_BYTES = BM * ROW;         // 16 KB
  static constexpr int B_BYTES = BK * BN * 2;      // 16 KB
  static constexpr int RAW_ROWS = BK * BITS / 8;   // 64, 32 or 16
  static constexpr int RAW_BYTES = RAW_ROWS * BN;  // 8, 4 or 2 KB
  static constexpr int B_OFF = STAGES * XT * X_BYTES;
  static constexpr int RAW_OFF = B_OFF + STAGES * B_BYTES;
  static constexpr int BAR_OFF = RAW_OFF + RAW_STAGES * RAW_BYTES;
  static constexpr int ALLOC = BAR_OFF + (2 * STAGES + RAW_STAGES) * 8 + 1024;
  static_assert(ALLOC <= 232448, "over the 227 KB a block can use");
};

// One TMA box of a 2-D map at (c0, c1) into shared memory; completion
// counted in bytes on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

#define F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define F16(i) F4(i), F4(i + 4), F4(i + 8), F4(i + 12)
#define F32(i) F16(i), F16(i + 16)

// D (+)= A B over one k16 slice: A (64 x 16) K-major and B (16 x 128)
// MN-major, both in shared memory.
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t da,
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
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : F32(0), F32(32)
      : "l"(da), "l"(db), "r"(accumulate));
}

#undef F32
#undef F16
#undef F4

// Widens one raw tile (RAW_ROWS x 128 bytes at `raw`, K rows k0 ..) into
// the bf16 tile at `bt`: K row r, column c at box c / 64, row r, 16-byte
// chunk ((c % 64) / 8) ^ (r % 8) (the 128-byte swizzle). Codes of K rows
// >= K are zeros. Run by the 128 producer threads, thread t.
template <int BITS>
__device__ __forceinline__ void widen(const uint8_t* raw, uint8_t* bt, int k0,
                                      int K, int t) {
  constexpr int PER = 8 / BITS;
  constexpr int RAW_ROWS = BK * BITS / 8;
  const float off = code_offset<BITS>();
#pragma unroll
  for (int j = 0; j < RAW_ROWS / 16; ++j) {
    const int it = t + 128 * j;
    const int p = it / 8, q = it % 8;  // raw row, 16-column chunk
    const uint4 v = *reinterpret_cast<const uint4*>(raw + p * BN + q * 16);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int f = 0; f < PER; ++f) {
      const int r = p * PER + f;  // K row in the tile
      uint32_t h[8];
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) {
        const uint32_t fw = fields<BITS>(w[qq], f);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(
            __fsub_rn(magic(fw, 0), off), __fsub_rn(magic(fw, 1), off));
        const __nv_bfloat162 hi = __floats2bfloat162_rn(
            __fsub_rn(magic(fw, 2), off), __fsub_rn(magic(fw, 3), off));
        h[2 * qq] = *reinterpret_cast<const uint32_t*>(&lo);
        h[2 * qq + 1] = *reinterpret_cast<const uint32_t*>(&hi);
      }
      if (k0 + r >= K) {
#pragma unroll
        for (int e = 0; e < 8; ++e) h[e] = 0u;
      }
      uint8_t* row = bt + (q / 4) * (BK * ROW) + r * ROW;
      const int ch = (q % 4) * 2;
      *reinterpret_cast<uint4*>(row + (((ch) ^ (r & 7)) << 4)) =
          make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(row + (((ch + 1) ^ (r & 7)) << 4)) =
          make_uint4(h[4], h[5], h[6], h[7]);
    }
  }
}

template <class TAG, int BITS, bool HILO>
__global__ void __launch_bounds__(NT, 1)
    kernel(const __grid_constant__ CUtensorMap xmap,
           const __grid_constant__ CUtensorMap xlo_map,
           const __grid_constant__ CUtensorMap cmap,
           const float* __restrict__ scale, const float* __restrict__ bias,
           const float* __restrict__ rowsum, float* __restrict__ out, int M,
           int N, int K) {
  using L = Layout<BITS, HILO>;
  constexpr int STAGES = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const sbase = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  const uint32_t base = smem_u32(sbase);
  const uint32_t x_s = base, b_s = base + L::B_OFF;
  const uint32_t raw_s = base + L::RAW_OFF, bars = base + L::BAR_OFF;
  // full: bars + 8 s; empty: + 8 (STAGES + s); raw: + 8 (2 STAGES + r)
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = (K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * s, FULL_ARRIVALS);
      mbar_init(bars + 8 * (STAGES + s), EMPTY_ARRIVALS);
    }
    for (int r = 0; r < RAW_STAGES; ++r)
      mbar_init(bars + 8 * (2 * STAGES + r), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // producer warpgroup: thread 0 issues every TMA load, all 128 widen
    const int t = threadIdx.x - 256;
    const bool issuer = t == 0;
    auto load_raw = [&](int i) {
      const int r = i % RAW_STAGES;
      const uint32_t bar = bars + 8 * (2 * STAGES + r);
      mbar_expect_tx(bar, L::RAW_BYTES);
      tma_load_2d(raw_s + r * L::RAW_BYTES, &cmap, n0, i * L::RAW_ROWS, bar);
    };
    if (issuer)
      for (int i = 0; i < min(nk, RAW_STAGES - 1); ++i) load_raw(i);
    for (int i = 0; i < nk; ++i) {
      const int s = i % STAGES, phase = (i / STAGES) & 1;
      const int r = i % RAW_STAGES, rphase = (i / RAW_STAGES) & 1;
      const uint32_t full = bars + 8 * s;
      if (issuer) {
        // slot (i - 1) % RAW_STAGES: widened by every producer thread
        // before the named barrier that ended step i - 1
        if (i + RAW_STAGES - 1 < nk) {
          fence_proxy_async();
          load_raw(i + RAW_STAGES - 1);
        }
      }
      mbar_wait(bars + 8 * (STAGES + s), phase ^ 1);
      if (issuer) {
        mbar_expect_tx(full, L::XT * L::X_BYTES);
        const uint32_t xt = x_s + s * L::XT * L::X_BYTES;
        tma_load_2d(xt, &xmap, i * BK, m0, full);
        if constexpr (HILO)
          tma_load_2d(xt + L::X_BYTES, &xlo_map, i * BK, m0, full);
      }
      mbar_wait(bars + 8 * (2 * STAGES + r), rphase);
      widen<BITS>(sbase + L::RAW_OFF + r * L::RAW_BYTES,
                  sbase + L::B_OFF + s * L::B_BYTES, i * BK, K, t);
      fence_proxy_async();
      __syncwarp();
      if ((t & 31) == 0) mbar_arrive(full);
      asm volatile("bar.sync 1, 128;" ::: "memory");
    }
  } else {
    // consumer warpgroup w: rows m0 + 64 w .. + 63
    const int w = threadIdx.x >> 7;
    const int lane = threadIdx.x & 31;
    float acc[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = 0.f;
    for (int i = 0; i < nk; ++i) {
      const int s = i % STAGES, phase = (i / STAGES) & 1;
      mbar_wait(bars + 8 * s, phase);
      const uint32_t xa = x_s + s * L::XT * L::X_BYTES + w * 64 * ROW;
      const uint32_t bt = b_s + s * L::B_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma(acc, desc(xa + kk * 32), desc(bt + kk * 16 * ROW, BK * ROW),
              i > 0 || kk > 0);
      if constexpr (HILO) {
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma(acc, desc(xa + L::X_BYTES + kk * 32),
                desc(bt + kk * 16 * ROW, BK * ROW), 1);
      }
      wgmma_commit();
      wgmma_wait_one();  // step i - 1's products are done: free its stage
      if (i > 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(bars + 8 * (STAGES + (i - 1) % STAGES));
      }
    }
    wgmma_wait_all();
#pragma unroll
    for (int e = 0; e < 64; ++e) pin(acc[e]);

    // element 4 j + e: row g (e < 2) or g + 8, column 8 j + 2 t4 + e % 2
    const int g = lane >> 2, t4 = lane & 3;
    const int row0 = m0 + 64 * w + 16 * ((threadIdx.x >> 5) & 3) + g;
    const int row1 = row0 + 8;
    const float rs0 = row0 < M ? rowsum[row0] : 0.f;
    const float rs1 = row1 < M ? rowsum[row1] : 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + 8 * j + 2 * t4 + e;
        if (n >= N) continue;
        const float sc = scale[n], bi = bias[n];
        if (row0 < M)
          out[(size_t)row0 * N + n] =
              fmaf(acc[4 * j + e], sc, __fmul_rn(rs0, bi));
        if (row1 < M)
          out[(size_t)row1 * N + n] =
              fmaf(acc[4 * j + 2 + e], sc, __fmul_rn(rs1, bi));
      }
  }
}

// x as bf16 rows of kp (a multiple of 8) elements, zeros past K: hi =
// bf16(x), and with `lo` lo = bf16(x - hi).
template <class TAG>
__global__ void __launch_bounds__(256)
    prep_x(const void* __restrict__ x, int x_bf16, int M, int K, int kp,
           __nv_bfloat16* __restrict__ hi, __nv_bfloat16* __restrict__ lo) {
  const size_t total = (size_t)M * kp;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int m = static_cast<int>(i / kp), k = static_cast<int>(i % kp);
    float v = 0.f;
    if (k < K) {
      const size_t at = (size_t)m * K + k;
      v = x_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(x)[at])
                 : static_cast<const float*>(x)[at];
    }
    const __nv_bfloat16 h = __float2bfloat16_rn(v);
    hi[i] = h;
    if (lo != nullptr) lo[i] = __float2bfloat16_rn(__fsub_rn(v, __bfloat162float(h)));
  }
}

// codes (rows, N) bytes into rows of np (a multiple of 16) bytes, zeros
// past N.
template <class TAG>
__global__ void __launch_bounds__(256)
    pad_codes(const uint8_t* __restrict__ codes, int rows, int N, int np,
              uint8_t* __restrict__ dst) {
  const size_t total = (size_t)rows * np;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int r = static_cast<int>(i / np), c = static_cast<int>(i % np);
    dst[i] = c < N ? codes[(size_t)r * N + c] : 0;
  }
}

// A 2-D map of `rows` rows of `cols` elements, `row_bytes` apart; boxes of
// box_cols x box_rows, zeros outside.
bool encode_2d(CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
               int cols, int rows, long long row_bytes, int box_cols,
               int box_rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

size_t round_up(size_t v, size_t to) { return (v + to - 1) / to * to; }

int blocks_for(size_t total) {
  return static_cast<int>(std::min<size_t>((total + 255) / 256, 4096));
}

// The tile path: x_prep / codes_prep say whether x and codes go through
// prep_x / pad_codes into `ws` first (the wrapper decides, from dtype,
// shapes and alignment; `ws` holds the prepared x, then the codes, each
// from a 256-byte boundary).
template <int BITS>
int launch(const void* x, int x_bf16, const uint8_t* codes,
           const float* scale, const float* bias, const float* rowsum,
           float* out, void* ws, long long ws_bytes, int M, int N, int K,
           int x_prep, int codes_prep, cudaStream_t stream) {
  constexpr int PER = 8 / BITS;
  const int rows = BITS == 8 ? K : (K + PER - 1) / PER;
  const bool hilo = !x_bf16;
  if (hilo && !x_prep) return static_cast<int>(cudaErrorInvalidValue);
  uint8_t* w = static_cast<uint8_t*>(ws);
  size_t used = 0;
  const void* xa = x;
  const void* xl = x;
  long long x_row = (long long)K * 2;
  if (x_prep) {
    const size_t kp = round_up(K, 8), term = round_up((size_t)M * kp * 2, 256);
    if (w == nullptr || (size_t)ws_bytes < (hilo ? 2 : 1) * term)
      return static_cast<int>(cudaErrorInvalidValue);
    __nv_bfloat16* hi = reinterpret_cast<__nv_bfloat16*>(w);
    __nv_bfloat16* lo = hilo ? reinterpret_cast<__nv_bfloat16*>(w + term)
                             : nullptr;
    prep_x<Tag<BITS>><<<blocks_for((size_t)M * kp), 256, 0, stream>>>(
        x, x_bf16, M, K, (int)kp, hi, lo);
    xa = hi;
    xl = hilo ? static_cast<const void*>(lo) : static_cast<const void*>(hi);
    x_row = (long long)kp * 2;
    used = (hilo ? 2 : 1) * term;
  }
  const uint8_t* cp = codes;
  long long c_row = N;
  if (codes_prep) {
    const size_t np = round_up(N, 16);
    if (w == nullptr || (size_t)ws_bytes < used + (size_t)rows * np)
      return static_cast<int>(cudaErrorInvalidValue);
    pad_codes<Tag<BITS>><<<blocks_for((size_t)rows * np), 256, 0, stream>>>(
        codes, rows, N, (int)np, w + used);
    cp = w + used;
    c_row = (long long)np;
  }
  if (reinterpret_cast<uintptr_t>(xa) % 16 || x_row % 16 ||
      reinterpret_cast<uintptr_t>(cp) % 16 || c_row % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xm, xlm, cm;
  if (!encode_2d(&xm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, xa, K, M, x_row, BK,
                 BM, CU_TENSOR_MAP_SWIZZLE_128B) ||
      (hilo && !encode_2d(&xlm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, xl, K, M,
                          x_row, BK, BM, CU_TENSOR_MAP_SWIZZLE_128B)) ||
      !encode_2d(&cm, CU_TENSOR_MAP_DATA_TYPE_UINT8, cp, N, rows, c_row, BN,
                 Layout<BITS, false>::RAW_ROWS, CU_TENSOR_MAP_SWIZZLE_NONE))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!hilo) xlm = xm;  // unread
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (hilo) {
    auto fn = kernel<Tag<BITS>, BITS, true>;
    constexpr int smem = Layout<BITS, true>::ALLOC;
    static std::atomic<std::uint64_t> opted{0};
    const cudaError_t err = opt_in_smem(fn, smem, opted);
    if (err != cudaSuccess) return static_cast<int>(err);
    fn<<<grid, NT, smem, stream>>>(xm, xlm, cm, scale, bias, rowsum, out, M,
                                   N, K);
  } else {
    auto fn = kernel<Tag<BITS>, BITS, false>;
    constexpr int smem = Layout<BITS, false>::ALLOC;
    static std::atomic<std::uint64_t> opted{0};
    const cudaError_t err = opt_in_smem(fn, smem, opted);
    if (err != cudaSuccess) return static_cast<int>(err);
    fn<<<grid, NT, smem, stream>>>(xm, xlm, cm, scale, bias, rowsum, out, M,
                                   N, K);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tile

template <int BITS>
int launch_fused(const void* x, int x_bf16, const void* codes,
                 const float* scale, const float* bias, const float* rowsum,
                 float* out, void* ws, long long ws_bytes, int M, int N,
                 int K, int path, int splits, int chunk, int x_prep,
                 int codes_prep, cudaStream_t stream) {
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  if (path == 0) {
    if (splits > 1 && ws_bytes < (long long)splits * M * N * 4)
      return static_cast<int>(cudaErrorInvalidValue);
    return stream::launch<BITS>(x, x_bf16, c, scale, bias, rowsum, out,
                                static_cast<float*>(ws), M, N, K, splits,
                                chunk, stream);
  }
  if (path == 1 && K > 0)
    return tile::launch<BITS>(x, x_bf16, c, scale, bias, rowsum, out, ws,
                              ws_bytes, M, N, K, x_prep, codes_prep, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// K5 int_matmul and K6 int_matmul_packed: int8 x int8 GEMMs summed in int32
// ---------------------------------------------------------------------------
//
//     out[m, n] = eff_scale[n] * (qx @ codes)[m, n] + eff_bias[n] * rowsum[m]
//                 + cst[n]
//
// qx holds per-tensor activation codes, codes the weight codes: int8 (K, N)
// for K5, packed 2/4-bit fields as for K4 for K6; ops.py folds the two
// affine grids into eff_scale = sx * scale, eff_bias = sx * bias and
// cst = bx * (scale * colsum + K * bias), so out equals
// (qx * sx + bx) @ (codes * scale + bias) in exact arithmetic.
//
// Replaces: src/repro/kernels/quant_matmul/quant_matmul.py:
// int_matmul_pallas (kernel body _int_kernel) and int_matmul_packed_pallas
// (_int_packed_kernel). Those carry an int32 VMEM accumulator across a
// sequential K grid axis.
//
// Two loaders for the activation: qx as int8 codes with rowsum given (the
// TPU kernel's contract), or (QUANT) fp32 x quantized on the grid
// [alpha, beta, s] with offset 2^(bits-1), exactly as
// core.quantizer.quantize_to_int does it (clip, subtract, IEEE divide,
// round half to even; quant_act), with the row sums of the codes taken in
// the kernel. Every sum is an int32 sum of integers, exact in any order (for
// K < 2^17: |a c| <= 2^14), and every epilogue is rounded explicitly
// (__fadd_rn/__fmul_rn, no FMA contraction) in the plain version's order
// (int_epilogue): K5 and K6 are bit-equal to their plain versions, and K6 on
// pack(c) to K5 on c, whatever the split or tile.
//
// K5 is K6's 8-bit case: one template over BITS 8, 4 and 2 on two paths,
// chosen by the wrapper from (M, N, K) alone, the same for K5 and K6
// (kernels/quant_matmul/quant_matmul.py: kernel_path, int_split_plan), one C
// entry (int_matmul_fused).
//
// istream:: (decode, M <= 8) bound by the bytes of the codes: a split-K
//   stream with K1/K4's structure (stream:: above), in one launch:
//   * a (N / 128, splits) grid of 128-thread blocks; a split is a whole
//     number of groups of 4 K rows (4 int8 rows, one packed row at 2 bits,
//     two at 4); thread (slice, column group) owns 16 columns and groups
//     slice, slice + 16, ... of its split, copied 16 bytes at a time
//     (cp.async) into its own ring of 8 groups in shared memory, 7 in
//     flight;
//   * activation row r of a group travels in the ring of thread (slice,
//     r) beside the codes (one 16-byte copy of fp32, 4 bytes of int8);
//     that thread turns it into one 32-bit word of 4 K codes (the fp32
//     loader quantizes them there) and adds it to row r's sum, and the 8
//     threads of a slice share their rows' words by shuffles: every
//     activation is loaded and quantized once a block, with no pass over
//     x before the codes stream;
//   * a 4 x 4 byte transpose (transpose4, 8 byte permutes) turns 4 K rows
//     of 4 columns into one word of 4 consecutive K codes a column. Int8
//     codes go in as they are and dp4a (s32 x s32) multiplies them with the
//     activation words. Packed fields are first shifted and masked 4 bytes
//     (4 columns) at a time to their biased unsigned codes (widen4);
//     dp4a.s32.u32 multiplies those, and the bias comes off once at the
//     end: sum(a (c + 2^(b-1))) - 2^(b-1) sum(a), exact in int32. At M 8 and
//     2 bits a byte costs ~12 instructions (8 dp4a): issue-bound at about
//     the bytes bound, the same finding as K4's FMA stream; mma.sync's
//     m16n8k32 would cut the dp4a but needs the codes in fragment order (a
//     shuffle a fragment), and a decode step is set by the per-GEMM
//     latency of its small GEMMs, not by either;
//   * one launch: each block splits its column tile's exact int32 partials
//     v into hi = v >> 12 and lo = v & 4095 and adds each into its plane of
//     the wrapper's workspace with atomics, 4 columns an atomic
//     (red.global.add.v4.f32), with the fp32 loader also its row sums (int32
//     atomics), then takes a ticket from its tile's counter; the last block
//     of a tile to arrive rebuilds 4096 hi + lo in int32, writes the
//     epilogue and zeroes the tile's planes, row sums and counter, so the
//     workspace is zero again for the next call (the same bits every call).
//     fp32 adds integers exactly below 2^24: the lo sums stay below 4096 x
//     4095 for at most MAX_SPLITS = 4096 splits, the hi sums below 2^19 for
//     K < 2^17, in any order, where a single plane of int8 sums (up to K x
//     2^14: 2^25 at K 2048) would round. One split writes the epilogue
//     directly. Per-element int32 atomics cost more than the rest of a
//     mid-size GEMM at M 8 (1024 a block, the splits of a tile on the same
//     addresses).
//   Measured on an H100: at M 8 (168-203 registers, 2 blocks an SM) the
//   stream is latency-bound, not bytes-bound: 9-16 us a GEMM of tinyllama's
//   int8 decode step, 8-15 us of its mixed 2/4-bit one, the heads at 0.48
//   (int8) and 0.15 (2-bit) of their bytes bound; the second plane costs
//   about 0.2 us a GEMM.
//
// itile:: (prefill, M > 8) bound by int8 operations: tensor cores through
//   wgmma (m64n128k32, s32 accumulators), K1/K4's tile skeleton (tile::):
//   * 384 threads a 128 x 128 output tile: two consumer warpgroups of 64
//     rows, one producer warpgroup; K steps of 128 codes (one 128-byte
//     swizzled row of int8);
//   * wgmma takes 8-bit operands K-major only: A, the activation codes
//     (M, K), is K-major as stored, loaded by TMA (128-byte swizzle); the
//     codes are N-contiguous ((K, N) as export lays them out, no second
//     copy), so the producer's first thread loads the raw tile by TMA (a
//     ring of 4, 3 ahead) and all 128 producer threads transpose it into
//     the K-major, 128-byte-swizzled int8 B tile (widen): int8 codes 16 K
//     rows x 4 columns at a time, read as words and transposed by
//     transpose4 into one 16-byte chunk a column; packed codes a column a
//     thread, 16/per bytes of it widened into one chunk (the `per` codes of
//     one byte are consecutive in K; the bias taken off bytewise);
//   * the fp32 loader quantizes x first (prep: a block a row) into the
//     wrapper's workspace as int8 rows padded to 16 bytes, with their int32
//     row sums; int8 x whose rows TMA cannot take is copied there the same
//     way; code rows not 16-byte aligned go through tile::pad_codes;
//   * the epilogue stages the fp32 tile in shared memory and writes it a
//     row at a time in 16-byte stores (written straight from the wgmma
//     fragments, half of every 32-byte sector would go to waste);
//   * ragged M/N/K: TMA zero-fills past M and K (a zero activation adds
//     nothing, whatever the code), the epilogue masks its stores, and no
//     code row >= ceil(K/per) is read.

// Every kernel K5 and K6 launch is a template over one of these tags, so
// that its name carries its wrapper's (a profile charges it to K5 or K6).
struct int_matmul_kernel;
struct int_matmul_packed_kernel;
template <int BITS>
using ITag = std::conditional_t<BITS == 8, int_matmul_kernel,
                                int_matmul_packed_kernel>;

// The activation code of fp32 v on the grid [alpha, beta, s]: clip,
// subtract, IEEE divide, round half to even, take off the offset.
__device__ __forceinline__ int quant_act(float v, float alpha, float beta,
                                         float s, int offset) {
  const float c = fminf(fmaxf(v, alpha), beta);
  return static_cast<int>(rintf(__fdiv_rn(__fsub_rn(c, alpha), s))) - offset;
}

// The plain version's epilogue, rounded as it rounds it.
__device__ __forceinline__ float int_epilogue(int acc, float r, float es,
                                              float eb, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(static_cast<float>(acc), es),
                             __fmul_rn(r, eb)),
                   c);
}

// d = c + the dot product of the four signed bytes of a (activation codes)
// with the four unsigned bytes of b (biased weight codes).
__device__ __forceinline__ int dp4a_su(uint32_t a, uint32_t b, int c) {
  int d;
  asm("dp4a.s32.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// The 4 x 4 byte transpose: f_j holds K row j of 4 columns (byte c: column
// c); col[c] gets column c's K rows 0..3 in bytes 0..3.
__device__ __forceinline__ void transpose4(uint32_t f0, uint32_t f1,
                                           uint32_t f2, uint32_t f3,
                                           uint32_t (&col)[4]) {
  const uint32_t t0 = __byte_perm(f0, f1, 0x5140);  // f0.0 f1.0 f0.1 f1.1
  const uint32_t t1 = __byte_perm(f2, f3, 0x5140);  // f2.0 f3.0 f2.1 f3.1
  const uint32_t t2 = __byte_perm(f0, f1, 0x7362);  // f0.2 f1.2 f0.3 f1.3
  const uint32_t t3 = __byte_perm(f2, f3, 0x7362);  // f2.2 f3.2 f2.3 f3.3
  col[0] = __byte_perm(t0, t1, 0x5410);
  col[1] = __byte_perm(t0, t1, 0x7632);
  col[2] = __byte_perm(t2, t3, 0x5410);
  col[3] = __byte_perm(t2, t3, 0x7632);
}

// The biased codes of 4 consecutive K rows of 4 columns. Byte c of w0 is
// column c's byte of a packed row: at 2 bits the group's one row (K rows
// 0-3 in bits 0-1, 2-3, 4-5, 6-7; w1 unused), at 4 bits the group's first
// row (K rows 0-1 in its nibbles) and w1 the second (K rows 2-3); then
// transpose4: col[c] = column c's K rows 0..3 in bytes 0..3.
template <int BITS>
__device__ __forceinline__ void widen4(uint32_t w0, uint32_t w1,
                                       uint32_t (&col)[4]) {
  if constexpr (BITS == 2) {
    transpose4(w0 & 0x03030303u, (w0 >> 2) & 0x03030303u,
               (w0 >> 4) & 0x03030303u, (w0 >> 6) & 0x03030303u, col);
  } else {
    transpose4(w0 & 0x0F0F0F0Fu, (w0 >> 4) & 0x0F0F0F0Fu, w1 & 0x0F0F0F0Fu,
               (w1 >> 4) & 0x0F0F0F0Fu, col);
  }
}

// ---------------------------------------------------------------------------
// istream: K5's and K6's decode path
// ---------------------------------------------------------------------------
namespace istream {

constexpr int CG = 8;          // column groups of a block (and x rows)
constexpr int COLS = 16;       // columns a thread owns: one 16-byte row load
constexpr int BN = CG * COLS;  // 128 columns a block
constexpr int KS = 16;         // K slices of a block
constexpr int NT = CG * KS;    // 128 threads
constexpr int GROUP = 4;       // K rows of a group: one packed row at 2 bits
constexpr int DEPTH = 8;       // groups a thread has in flight + 1
constexpr int WS_ROWS = 8;     // rows of a column tile's sums in the workspace

// A split's int32 partial v goes into the workspace as two fp32 integers,
// hi = v >> LO_BITS and lo = v & (2^LO_BITS - 1), each added exactly (below
// 2^24) in any order: lo sums stay below MAX_SPLITS x 4095 < 2^24, hi sums
// below 2^19 for K < 2^17 (|v| <= chunk x 2^14).
constexpr int LO_BITS = 12;
constexpr int MAX_SPLITS = 4096;

// The workspace of one launch over `tiles` column tiles, 4-byte words: the
// hi and the lo plane [tiles][WS_ROWS][BN] fp32 each, row sums
// [tiles][WS_ROWS] int32, arrival counters [tiles] int32; zero between
// calls.
long long ws_bytes_for(long long tiles) {
  return 4 * tiles * (1 + WS_ROWS + 2 * WS_ROWS * BN);
}

// Adds 4 fp32 to 4 consecutive words of global memory (16-byte aligned) in
// one atomic vector operation.
__device__ __forceinline__ void red_add_v4(float* p, const float (&v)[4]) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(p),
               "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3])
               : "memory");
}

// Shared memory of a block: each thread's ring of DEPTH groups, a group
// its L 16-byte code loads (4 at 8 bits, 2 at 4, 1 at 2) and one 16-byte
// slot of activations (after the walk the ring holds the warps' sums),
// then the warps' row sums [4][CG], the block's [CG] and the last-block
// flag. At 8 bits: 80 KB, two blocks an SM.
template <int MR, int BITS>
struct Smem {
  static constexpr int L = GROUP * BITS / 8;   // 16-byte code loads a group
  static constexpr int LX = L + 1;             // and the activations' slot
  static constexpr int RING = DEPTH * LX * NT;  // 16-byte slots
  static constexpr int RED = NT / 32 * MR * BN / 4;
  static constexpr int X_OFF = 16 * (RING > RED ? RING : RED);
  static constexpr int BYTES = X_OFF + 5 * CG * 4 + 16;
};

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

// Activations of row m, K rows k0 .. k0 + 3 (zeros past K), loaded one
// element at a time into a 16-byte slot: fp32 (QUANT) as 4 floats, int8
// as the slot's first 4 bytes. For rows that are not aligned for one
// asynchronous copy.
template <bool QUANT>
__device__ __forceinline__ uint4 load_x_slow(const void* x, int m, int k0,
                                             int K) {
  const size_t at = (size_t)m * K + k0;
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (k0 + e >= K) continue;
    if constexpr (QUANT)
      w[e] = __float_as_uint(static_cast<const float*>(x)[at + e]);
    else
      w[0] |= (static_cast<uint32_t>(static_cast<const uint8_t*>(x)[at + e]))
              << (8 * e);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// One activation word from its slot: K rows k0 .. k0 + 3 of one row as 4
// signed codes (byte e: K row k0 + e), the fp32 loader quantizing them;
// zeros past K.
template <bool QUANT>
__device__ __forceinline__ uint32_t act_word(uint4 v, int k0, int K,
                                             float alpha, float beta, float s,
                                             int offset) {
  if constexpr (!QUANT) {
    return v.x;
  } else {
    const float f[4] = {__uint_as_float(v.x), __uint_as_float(v.y),
                        __uint_as_float(v.z), __uint_as_float(v.w)};
    uint32_t word = 0u;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (k0 + e < K)
        word |= (static_cast<uint32_t>(quant_act(f[e], alpha, beta, s,
                                                 offset)) &
                 0xffu)
                << (8 * e);
    return word;
  }
}

// acc[m][c] += a[m][k] * code[k][c] over the 4 K rows of one group, the
// packed codes biased by 2^(b-1); `raw` holds the group's 16-byte row
// loads (4 rows of int8, one row of 2-bit bytes, two of 4-bit), xw the
// group's activation words, one a row.
template <int MR, int BITS>
__device__ __forceinline__ void accumulate(int (&acc)[MR][COLS],
                                           const uint4 (&raw)[GROUP * BITS /
                                                              8],
                                           const uint32_t (&xw)[MR]) {
  uint32_t w[GROUP * BITS / 8][4];
#pragma unroll
  for (int l = 0; l < GROUP * BITS / 8; ++l) {
    w[l][0] = raw[l].x, w[l][1] = raw[l].y, w[l][2] = raw[l].z;
    w[l][3] = raw[l].w;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t col[4];
    if constexpr (BITS == 8)
      transpose4(w[0][q], w[1][q], w[2][q], w[3][q], col);
    else
      widen4<BITS>(w[0][q], BITS == 4 ? w[GROUP * BITS / 8 - 1][q] : 0u,
                   col);
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int m = 0; m < MR; ++m)
        acc[m][4 * q + c] =
            BITS == 8 ? __dp4a(static_cast<int>(xw[m]),
                               static_cast<int>(col[c]), acc[m][4 * q + c])
                      : dp4a_su(xw[m], col[c], acc[m][4 * q + c]);
  }
}

// One (column tile, split) of the stream: see the header. Thread (slice,
// cg) streams its groups' codes and, for activation row cg, their
// activations through its ring; the 8 threads of a slice share their rows'
// words by shuffles, so every activation is loaded and quantized once a
// block, a group at a time, with the codes' loads in flight.
template <class TAG, int MR, int BITS, bool QUANT>
__global__ void __launch_bounds__(NT)
    kernel(const void* __restrict__ x, const uint8_t* __restrict__ codes,
           const float* __restrict__ eff_scale,
           const float* __restrict__ eff_bias,
           const float* __restrict__ rowsum, const float* __restrict__ cst,
           const float* __restrict__ grid, int offset,
           float* __restrict__ out, int* __restrict__ ws, int M, int N,
           int K, int chunk_groups, int vec, int x_vec) {
  using S = Smem<MR, BITS>;
  constexpr int PER = 8 / BITS, L = S::L, LX = S::LX;
  constexpr int BIAS = BITS == 8 ? 0 : 1 << (BITS - 1);
  extern __shared__ uint4 smem[];
  uint4* const ring = smem;
  int* const rsw = reinterpret_cast<int*>(reinterpret_cast<uint8_t*>(smem) +
                                          S::X_OFF);
  int* const rsb = rsw + 4 * CG;
  int* const last = rsb + CG;

  const int tid = threadIdx.x;
  const int cg = tid % CG, slice = tid / CG;
  const int warp = tid / 32, lane = tid % 32;
  const int tile_n = blockIdx.x;
  const int n0 = tile_n * BN, col = n0 + cg * COLS;
  const int groups = (K + GROUP - 1) / GROUP;
  const int g_begin = blockIdx.y * chunk_groups;
  const int g_end = min(groups, g_begin + chunk_groups);
  const int rows = (K + PER - 1) / PER;  // stored rows
  const bool xrow = cg < M;              // this thread loads row cg of x

  int acc[MR][COLS];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[m][c] = 0;

  // group g into ring stage `st` (slot (st LX + l) NT + tid): its packed
  // rows by async 16-byte copies, zeros past the split, K or N, unaligned
  // rows byte by byte; then row cg's activations of the group (16 bytes of
  // fp32, 4 of int8), zeros past the split or for a row past M. One commit
  // group a call, empty or not
  auto issue = [&](int g, int st) {
    const bool live = g < g_end;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const int row = g * L + l;
      const bool ok = live && row < rows && col < N;
      uint4* slot = &ring[(st * LX + l) * NT + tid];
      if (vec)
        stream::cp_async16(smem_u32(slot),
                           ok ? codes + (size_t)row * N + col : codes,
                           ok ? 16 : 0);
      else
        *slot = ok ? stream::load_row_bytes(codes, row, N, col)
                   : make_uint4(0u, 0u, 0u, 0u);
    }
    const bool ok = live && xrow;
    uint4* slot = &ring[(st * LX + L) * NT + tid];
    const size_t at = (size_t)cg * K + (size_t)g * GROUP;
    if (x_vec) {
      // K a multiple of 4: the group lies inside K
      if constexpr (QUANT)
        stream::cp_async16(smem_u32(slot),
                           ok ? static_cast<const float*>(x) + at : x,
                           ok ? 16 : 0);
      else
        cp_async4(smem_u32(slot), ok ? static_cast<const int8_t*>(x) + at : x,
                  ok ? 4 : 0);
    } else {
      *slot = ok ? load_x_slow<QUANT>(x, cg, g * GROUP, K)
                 : make_uint4(0u, 0u, 0u, 0u);
    }
    stream::cp_async_commit();
  };
#pragma unroll
  for (int d = 0; d < DEPTH - 1; ++d) issue(g_begin + slice + d * KS, d);

  float alpha = 0.f, beta = 0.f, s = 1.f;
  if constexpr (QUANT) {
    alpha = grid[0];
    beta = grid[1];
    s = grid[2];
  }
  int rs = 0;  // row cg's sum of the codes of this thread's groups
  // step j: group g_begin + slice + 16 j, while the next DEPTH - 1 steps'
  // groups are in flight; every lane runs every step (a group past the
  // split adds zeros), so the shuffles see the whole warp
  const int J = (g_end - g_begin + KS - 1) / KS;
  for (int j = 0; j < J; ++j) {
    const int g = g_begin + slice + j * KS;
    const int st = j % DEPTH;
    issue(g + (DEPTH - 1) * KS, (j + DEPTH - 1) % DEPTH);
    stream::cp_async_wait<DEPTH - 1>();  // step j's group has landed
    uint4 raw[L];
#pragma unroll
    for (int l = 0; l < L; ++l) raw[l] = ring[(st * LX + l) * NT + tid];
    const uint32_t word =
        g < g_end && xrow
            ? act_word<QUANT>(ring[(st * LX + L) * NT + tid], g * GROUP, K,
                              alpha, beta, s, offset)
            : 0u;
    rs = __dp4a(static_cast<int>(word), 0x01010101, rs);
    uint32_t xw[MR];
#pragma unroll
    for (int m = 0; m < MR; ++m)
      xw[m] = __shfl_sync(0xffffffffu, word, (lane & ~(CG - 1)) | m);
    accumulate<MR, BITS>(acc, raw, xw);
  }
  stream::cp_async_wait<0>();
  __syncthreads();  // every ring is drained: it holds the sums next
  int(*red)[MR][BN] = reinterpret_cast<int(*)[MR][BN]>(ring);

  // the 16 slices' sums: slices 4w .. 4w+3 sit in lanes 8 apart of warp w
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      int v = acc[m][c];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[m][c] = v;
    }
  rs += __shfl_xor_sync(0xffffffffu, rs, 8);
  rs += __shfl_xor_sync(0xffffffffu, rs, 16);
  if (lane < CG) {
#pragma unroll
    for (int m = 0; m < MR; ++m)
#pragma unroll
      for (int c = 0; c < COLS; ++c) red[warp][m][lane * COLS + c] = acc[m][c];
    rsw[warp * CG + lane] = rs;
  }
  __syncthreads();
  if (tid < CG)
    rsb[tid] = rsw[tid] + rsw[CG + tid] + rsw[2 * CG + tid] + rsw[3 * CG + tid];
  __syncthreads();

  // this split's exact sums, the bias taken off: direct to the epilogue
  // with one split, else as hi and lo into the workspace's two planes, 4
  // columns an atomic
  const int rsum = tid < CG ? rsb[tid] : 0;
  if (gridDim.y == 1) {
    for (int i = tid; i < MR * BN; i += NT) {
      const int m = i / BN, c = i % BN, n = n0 + c;
      if (m >= M || n >= N) continue;
      const int v = red[0][m][c] + red[1][m][c] + red[2][m][c] +
                    red[3][m][c] - BIAS * rsb[m];
      const float r = QUANT ? static_cast<float>(rsb[m]) : rowsum[m];
      out[(size_t)m * N + n] =
          int_epilogue(v, r, eff_scale[n], eff_bias[n], cst[n]);
    }
    return;
  }
  const size_t plane = (size_t)gridDim.x * WS_ROWS * BN;
  float* const hi_ws = reinterpret_cast<float*>(ws);
  float* const lo_ws = hi_ws + plane;
  int* const rs_ws = ws + 2 * plane;
  int* const cnt = rs_ws + (size_t)gridDim.x * WS_ROWS;
  for (int i = tid; i < MR * BN / 4; i += NT) {
    const int m = i / (BN / 4), c = 4 * (i % (BN / 4));
    if (m >= M) continue;
    float hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int v = n0 + c + e < N
                        ? red[0][m][c + e] + red[1][m][c + e] +
                              red[2][m][c + e] + red[3][m][c + e] -
                              BIAS * rsb[m]
                        : 0;
      hi[e] = static_cast<float>(v >> LO_BITS);  // arithmetic shift
      lo[e] = static_cast<float>(v & ((1 << LO_BITS) - 1));
    }
    const size_t at = ((size_t)tile_n * WS_ROWS + m) * BN + c;
    red_add_v4(&hi_ws[at], hi);
    red_add_v4(&lo_ws[at], lo);
  }
  if (QUANT && tid < M) atomicAdd(&rs_ws[tile_n * WS_ROWS + tid], rsum);
  __threadfence();
  __syncthreads();
  if (tid == 0) *last = atomicAdd(&cnt[tile_n], 1) == (int)gridDim.y - 1;
  __syncthreads();
  if (!*last) return;
  // the tile's last block: every split's sums are in; 2^12 hi + lo, the
  // epilogue, then the tile's slice of the workspace back to zero
  __threadfence();
  for (int i = tid; i < MR * BN / 4; i += NT) {
    const int m = i / (BN / 4), c = 4 * (i % (BN / 4));
    if (m >= M) continue;
    const size_t at = ((size_t)tile_n * WS_ROWS + m) * BN + c;
    float4* const ph = reinterpret_cast<float4*>(&hi_ws[at]);
    float4* const pl = reinterpret_cast<float4*>(&lo_ws[at]);
    const float4 h4 = __ldcg(ph), l4 = __ldcg(pl);
    *ph = make_float4(0.f, 0.f, 0.f, 0.f);
    *pl = make_float4(0.f, 0.f, 0.f, 0.f);
    const float hi[4] = {h4.x, h4.y, h4.z, h4.w};
    const float lo[4] = {l4.x, l4.y, l4.z, l4.w};
    const float r = QUANT
                        ? static_cast<float>(__ldcg(&rs_ws[tile_n * WS_ROWS + m]))
                        : rowsum[m];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = n0 + c + e;
      if (n < N)
        out[(size_t)m * N + n] = int_epilogue(
            static_cast<int>(hi[e]) * (1 << LO_BITS) +
                static_cast<int>(lo[e]),
            r, eff_scale[n], eff_bias[n], cst[n]);
    }
  }
  __syncthreads();
  if (QUANT && tid < M) rs_ws[tile_n * WS_ROWS + tid] = 0;
  if (tid == 0) cnt[tile_n] = 0;
}

template <int MR, int BITS, bool QUANT>
cudaError_t launch_mr(dim3 grid_dim, const void* x, const uint8_t* codes,
                      const float* es, const float* eb, const float* rowsum,
                      const float* cst, const float* grid, int offset,
                      float* out, int* ws, int M, int N, int K,
                      int chunk_groups, int vec, int x_vec,
                      cudaStream_t stream) {
  auto fn = kernel<ITag<BITS>, MR, BITS, QUANT>;
  constexpr int smem = Smem<MR, BITS>::BYTES;
  static std::atomic<std::uint64_t> opted{0};
  const cudaError_t err = opt_in_smem(fn, smem, opted);
  if (err != cudaSuccess) return err;
  fn<<<grid_dim, NT, smem, stream>>>(x, codes, es, eb, rowsum, cst, grid,
                                     offset, out, ws, M, N, K, chunk_groups,
                                     vec, x_vec);
  return cudaGetLastError();
}

template <int BITS, bool QUANT>
int launch(const void* x, const uint8_t* codes, const float* es,
           const float* eb, const float* rowsum, const float* cst,
           const float* grid, int offset, float* out, void* ws,
           long long ws_bytes, int M, int N, int K, int splits, int chunk,
           cudaStream_t stream) {
  // K = 0 at any M (kernel_path sends it here): no sums, the epilogue
  // alone, WS_ROWS rows a launch
  if (K == 0 && M > WS_ROWS) {
    for (int m0 = 0; m0 < M; m0 += WS_ROWS) {
      const int err = launch<BITS, QUANT>(
          x, codes, es, eb, rowsum == nullptr ? nullptr : rowsum + m0, cst,
          grid, offset, out + (size_t)m0 * N, ws, ws_bytes,
          M - m0 < WS_ROWS ? M - m0 : WS_ROWS, N, 0, splits, chunk, stream);
      if (err != 0) return err;
    }
    return 0;
  }
  const long long tiles = (N + BN - 1) / BN;
  if (M < 1 || M > WS_ROWS || chunk <= 0 || chunk % GROUP || splits < 1 ||
      splits > MAX_SPLITS || (long long)splits * chunk < K ||
      tiles > 0x7fffffffLL ||
      (splits > 1 && (ws == nullptr || ws_bytes < ws_bytes_for(tiles))))
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = N % 16 == 0 && reinterpret_cast<uintptr_t>(codes) % 16 == 0;
  // a group's activations, one asynchronous copy: 16 bytes of fp32 or 4 of
  // int8, every row starting aligned for it
  const int x_vec = K % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % (QUANT ? 16 : 4) == 0;
  const dim3 g(static_cast<unsigned>(tiles), splits);
  int* const w = static_cast<int*>(ws);
  const int cgr = chunk / GROUP;
#define MR_LAUNCH(MR)                                                        \
  launch_mr<MR, BITS, QUANT>(g, x, codes, es, eb, rowsum, cst, grid, offset, \
                             out, w, M, N, K, cgr, vec, x_vec, stream)
  const cudaError_t err = M <= 1   ? MR_LAUNCH(1)
                          : M <= 2 ? MR_LAUNCH(2)
                          : M <= 4 ? MR_LAUNCH(4)
                                   : MR_LAUNCH(8);
#undef MR_LAUNCH
  return static_cast<int>(err);
}

}  // namespace istream

// ---------------------------------------------------------------------------
// itile: K5's and K6's prefill path
// ---------------------------------------------------------------------------
namespace itile {

constexpr int BM = 128, BN = 128, BK = 128;  // BK: K codes (bytes) a stage
constexpr int ROW = 128;           // bytes of one swizzled row: 128 int8
constexpr int NT = 384;            // two consumer warpgroups, one producer
constexpr int STAGES = 4;          // A and B tiles in flight
constexpr int RAW_STAGES = 4;      // raw code tiles in flight
constexpr int EMPTY_ARRIVALS = 8;  // one per consumer warp
constexpr int FULL_ARRIVALS = 5;   // the TMA issue, one per producer warp
constexpr int OUT_LD = BN + 4;     // floats a row of the staged output tile

// Shared memory from a 1024-byte aligned base: the A ring (STAGES x 128
// rows x 128 bytes), the B ring (STAGES x 128 N rows x 128 bytes), the raw
// ring (RAW_STAGES x RAW_ROWS x 128 bytes), then the mbarriers: full
// [STAGES], empty [STAGES], raw [RAW_STAGES]. After the last K step the
// A and B rings hold the output tile (BM x OUT_LD fp32).
template <int BITS>
struct Layout {
  static constexpr int A_BYTES = BM * ROW;         // 16 KB
  static constexpr int B_BYTES = BN * ROW;         // 16 KB
  static constexpr int RAW_ROWS = BK * BITS / 8;   // 32, 64 or 128
  static constexpr int RAW_BYTES = RAW_ROWS * BN;  // 4, 8 or 16 KB
  static constexpr int B_OFF = STAGES * A_BYTES;
  static constexpr int RAW_OFF = B_OFF + STAGES * B_BYTES;
  static constexpr int BAR_OFF = RAW_OFF + RAW_STAGES * RAW_BYTES;
  static constexpr int ALLOC = BAR_OFF + (2 * STAGES + RAW_STAGES) * 8 + 1024;
  static_assert(ALLOC <= 232448, "over the 227 KB a block can use");
  static_assert(BM * OUT_LD * 4 <= RAW_OFF, "the output tile fits the rings");
};

#define R4(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3])
#define R16(i) R4(i), R4(i + 4), R4(i + 8), R4(i + 12)
#define R32(i) R16(i), R16(i + 16)

// D (+)= A B over one k32 slice: A (64 x 32) and B (128 x 32), both int8
// and K-major in shared memory; s32 sums.
__device__ __forceinline__ void wgmma_s8(uint32_t (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : R32(0), R32(32)
      : "l"(da), "l"(db), "r"(accumulate));
}

#undef R32
#undef R16
#undef R4

// Widens one raw tile (RAW_ROWS code rows x 128 columns at `raw`) into
// the int8 B tile at `bt`: column n is B row n, K code k of the tile at
// 16-byte chunk (k / 16) ^ (n % 8) of that row (the 128-byte swizzle). Run
// by the 128 producer threads, thread t.
//
// Int8 codes: the tile is 256 units of 16 K rows x 4 columns, two a
// thread: lane l takes column quad l, so that a warp's word loads of one
// row meet 32 banks, and chunk j = (2 w + u + (l / 2) % 4) % 8 of its unit
// u (w the thread's warp), so that the 8 lanes of each quarter-warp's
// 16-byte stores meet 8 distinct chunks; transpose4 turns 4 rows of the 4
// columns into 4 words of 4 K codes, one a column.
// Packed codes: thread t widens column t: 16/per bytes of it, read down
// the column, make one chunk.
template <int BITS>
__device__ __forceinline__ void widen(const uint8_t* raw, uint8_t* bt, int t) {
  if constexpr (BITS == 8) {
    const int lane = t & 31, w = t >> 5;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = (2 * w + u + ((lane >> 1) & 3)) & 7;
      const uint32_t* src =
          reinterpret_cast<const uint32_t*>(raw + 16 * j * BN) + lane;
      uint32_t v[16];
#pragma unroll
      for (int r = 0; r < 16; ++r) v[r] = src[r * (BN / 4)];
      uint32_t col[4][4];  // [K rows 4h .. 4h + 3][column]
#pragma unroll
      for (int h = 0; h < 4; ++h)
        transpose4(v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3],
                   col[h]);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int n = 4 * lane + c;
        *reinterpret_cast<uint4*>(bt + n * ROW + ((j ^ (n & 7)) << 4)) =
            make_uint4(col[0][c], col[1][c], col[2][c], col[3][c]);
      }
    }
    return;
  }
  // biased b-bit codes to signed int8, bytewise: (c + 128 - 2^(b-1)) ^ 0x80
  constexpr uint32_t TO_SIGNED = BITS == 2 ? 0x7E7E7E7Eu : 0x78787878u;
  uint8_t* const row = bt + t * ROW;
  const uint8_t* const colp = raw + t;
#pragma unroll
  for (int j = 0; j < BK / 16; ++j) {
    uint32_t w[4];
    if constexpr (BITS == 2) {
      // rows 4j .. 4j+3: K codes 16j + 4i + f in field f of byte i
      const uint8_t* p = colp + 4 * j * BN;
      const uint32_t b = static_cast<uint32_t>(p[0]) |
                         static_cast<uint32_t>(p[BN]) << 8 |
                         static_cast<uint32_t>(p[2 * BN]) << 16 |
                         static_cast<uint32_t>(p[3 * BN]) << 24;
      widen4<2>(b, 0u, w);
    } else {
      // rows 8j .. 8j+7: K codes 16j + 2i (low nibble), + 1 (high)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint8_t* p = colp + (8 * j + 4 * h) * BN;
        const uint32_t b = static_cast<uint32_t>(p[0]) |
                           static_cast<uint32_t>(p[BN]) << 8 |
                           static_cast<uint32_t>(p[2 * BN]) << 16 |
                           static_cast<uint32_t>(p[3 * BN]) << 24;
        const uint32_t lo = b & 0x0F0F0F0Fu, hi = (b >> 4) & 0x0F0F0F0Fu;
        w[2 * h] = __byte_perm(lo, hi, 0x5140);
        w[2 * h + 1] = __byte_perm(lo, hi, 0x7362);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) w[e] = (w[e] + TO_SIGNED) ^ 0x80808080u;
    *reinterpret_cast<uint4*>(row + ((j ^ (t & 7)) << 4)) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

template <class TAG, int BITS>
__global__ void __launch_bounds__(NT, 1)
    kernel(const __grid_constant__ CUtensorMap xmap,
           const __grid_constant__ CUtensorMap cmap,
           const float* __restrict__ eff_scale,
           const float* __restrict__ eff_bias,
           const float* __restrict__ rowsum, const int* __restrict__ rs_int,
           const float* __restrict__ cst, float* __restrict__ out, int M,
           int N, int K) {
  using L = Layout<BITS>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const sbase = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  const uint32_t base = smem_u32(sbase);
  const uint32_t a_s = base, b_s = base + L::B_OFF;
  const uint32_t raw_s = base + L::RAW_OFF, bars = base + L::BAR_OFF;
  // full: bars + 8 s; empty: + 8 (STAGES + s); raw: + 8 (2 STAGES + r)
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = (K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * s, FULL_ARRIVALS);
      mbar_init(bars + 8 * (STAGES + s), EMPTY_ARRIVALS);
    }
    for (int r = 0; r < RAW_STAGES; ++r)
      mbar_init(bars + 8 * (2 * STAGES + r), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // producer warpgroup: thread 0 issues every TMA load, all 128 widen
    const int t = threadIdx.x - 256;
    const bool issuer = t == 0;
    auto load_raw = [&](int i) {
      const int r = i % RAW_STAGES;
      const uint32_t bar = bars + 8 * (2 * STAGES + r);
      mbar_expect_tx(bar, L::RAW_BYTES);
      tile::tma_load_2d(raw_s + r * L::RAW_BYTES, &cmap, n0,
                        i * L::RAW_ROWS, bar);
    };
    if (issuer)
      for (int i = 0; i < min(nk, RAW_STAGES - 1); ++i) load_raw(i);
    for (int i = 0; i < nk; ++i) {
      const int s = i % STAGES, phase = (i / STAGES) & 1;
      const int r = i % RAW_STAGES, rphase = (i / RAW_STAGES) & 1;
      const uint32_t full = bars + 8 * s;
      if (issuer && i + RAW_STAGES - 1 < nk) {
        // slot (i - 1) % RAW_STAGES: widened by every producer thread
        // before the named barrier that ended step i - 1
        fence_proxy_async();
        load_raw(i + RAW_STAGES - 1);
      }
      mbar_wait(bars + 8 * (STAGES + s), phase ^ 1);
      if (issuer) {
        mbar_expect_tx(full, L::A_BYTES);
        tile::tma_load_2d(a_s + s * L::A_BYTES, &xmap, i * BK, m0, full);
      }
      mbar_wait(bars + 8 * (2 * STAGES + r), rphase);
      widen<BITS>(sbase + L::RAW_OFF + r * L::RAW_BYTES,
                  sbase + L::B_OFF + s * L::B_BYTES, t);
      fence_proxy_async();
      __syncwarp();
      if ((t & 31) == 0) mbar_arrive(full);
      asm volatile("bar.sync 1, 128;" ::: "memory");
    }
  } else {
    // consumer warpgroup w: rows m0 + 64 w .. + 63
    const int w = threadIdx.x >> 7;
    const int lane = threadIdx.x & 31;
    uint32_t acc[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = 0u;
    for (int i = 0; i < nk; ++i) {
      const int s = i % STAGES, phase = (i / STAGES) & 1;
      mbar_wait(bars + 8 * s, phase);
      const uint32_t xa = a_s + s * L::A_BYTES + w * 64 * ROW;
      const uint32_t bt = b_s + s * L::B_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)
        wgmma_s8(acc, desc(xa + kk * 32), desc(bt + kk * 32),
                 i > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait_one();  // step i - 1's products are done: free its stage
      if (i > 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(bars + 8 * (STAGES + (i - 1) % STAGES));
      }
    }
    wgmma_wait_all();
#pragma unroll
    for (int e = 0; e < 64; ++e) pin(acc[e]);

    // element 4 j + e: row g (e < 2) or g + 8, column 8 j + 2 t4 + e % 2;
    // the epilogue in registers, then the fp32 tile through shared memory
    // (the A and B rings, free once both consumer warpgroups are past
    // their last wgmma), rows padded to OUT_LD floats so that the
    // fragments' stores meet no bank twice, and out to global memory a
    // row at a time in 16-byte stores
    const int g = lane >> 2, t4 = lane & 3;
    const int r0 = 64 * w + 16 * ((threadIdx.x >> 5) & 3) + g, r1 = r0 + 8;
    auto row_sum = [&](int row) {
      return row >= M ? 0.f
             : rs_int != nullptr ? static_cast<float>(rs_int[row])
                                 : rowsum[row];
    };
    const float rs0 = row_sum(m0 + r0), rs1 = row_sum(m0 + r1);
    float* const tile = reinterpret_cast<float*>(sbase);
    asm volatile("bar.sync 2, 256;" ::: "memory");
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = 8 * j + 2 * t4;
      float v0[2], v1[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = min(n0 + c + e, N - 1);
        const float sc = eff_scale[n], bi = eff_bias[n], cc = cst[n];
        v0[e] = int_epilogue(static_cast<int>(acc[4 * j + e]), rs0, sc, bi,
                             cc);
        v1[e] = int_epilogue(static_cast<int>(acc[4 * j + 2 + e]), rs1, sc,
                             bi, cc);
      }
      *reinterpret_cast<float2*>(&tile[r0 * OUT_LD + c]) =
          make_float2(v0[0], v0[1]);
      *reinterpret_cast<float2*>(&tile[r1 * OUT_LD + c]) =
          make_float2(v1[0], v1[1]);
    }
    asm volatile("bar.sync 2, 256;" ::: "memory");
    const bool vec = N % 4 == 0;
    for (int i = threadIdx.x; i < BM * BN / 4; i += 256) {
      const int r = i / (BN / 4), c = 4 * (i % (BN / 4));
      const int m = m0 + r, n = n0 + c;
      if (m >= M || n >= N) continue;
      const float4 v = *reinterpret_cast<const float4*>(&tile[r * OUT_LD + c]);
      float* const o = out + (size_t)m * N + n;
      if (vec) {
        *reinterpret_cast<float4*>(o) = v;
      } else {
        const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (n + k < N) o[k] = e[k];
      }
    }
  }
}

// The activation codes of row blockIdx.x as int8 rows of kp (a multiple of
// 16) bytes, zeros past K: fp32 x quantized (QUANT) or int8 x copied; with
// `rs_out`, their int32 sum.
template <class TAG, bool QUANT>
__global__ void __launch_bounds__(256)
    prep(const void* __restrict__ x, const float* __restrict__ grid,
         int offset, int K, int kp, int8_t* __restrict__ dst,
         int* __restrict__ rs_out) {
  const size_t m = blockIdx.x;
  float alpha = 0.f, beta = 0.f, s = 1.f;
  if constexpr (QUANT) {
    alpha = grid[0];
    beta = grid[1];
    s = grid[2];
  }
  int rs = 0;
  for (int k = threadIdx.x; k < kp; k += 256) {
    int q = 0;
    if (k < K) {
      if constexpr (QUANT)
        q = quant_act(static_cast<const float*>(x)[m * K + k], alpha, beta,
                      s, offset);
      else
        q = static_cast<const int8_t*>(x)[m * K + k];
    }
    dst[m * kp + k] = static_cast<int8_t>(q);
    rs += q;
  }
#pragma unroll
  for (int o = 16; o > 0; o /= 2) rs += __shfl_xor_sync(0xffffffffu, rs, o);
  __shared__ int part[8];
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = rs;
  __syncthreads();
  if (threadIdx.x == 0 && rs_out != nullptr) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < 8; ++w) total += part[w];
    rs_out[m] = total;
  }
}

// The tile path: x_prep / codes_prep say whether x and codes go through
// prep / tile::pad_codes into `ws` first (the wrapper decides; the fp32
// loader always preps). `ws` holds the activation codes (M x kp bytes),
// their row sums (M int32), then the padded codes, each from a 256-byte
// boundary.
template <int BITS, bool QUANT>
int launch(const void* x, const uint8_t* codes, const float* es,
           const float* eb, const float* rowsum, const float* cst,
           const float* grid, int offset, float* out, void* ws,
           long long ws_bytes, int M, int N, int K, int x_prep,
           int codes_prep, cudaStream_t stream) {
  using TAG = ITag<BITS>;
  constexpr int PER = 8 / BITS;
  const int rows = (K + PER - 1) / PER;
  if (K <= 0 || (QUANT && !x_prep))
    return static_cast<int>(cudaErrorInvalidValue);
  uint8_t* w = static_cast<uint8_t*>(ws);
  size_t used = 0;
  const void* xa = x;
  long long x_row = K;
  const int* rs_int = nullptr;
  if (x_prep) {
    const size_t kp = tile::round_up(K, 16);
    const size_t xb = tile::round_up((size_t)M * kp, 256);
    const size_t rb = tile::round_up((size_t)M * 4, 256);
    if (w == nullptr || (size_t)ws_bytes < xb + rb)
      return static_cast<int>(cudaErrorInvalidValue);
    int* const rs = QUANT ? reinterpret_cast<int*>(w + xb) : nullptr;
    prep<TAG, QUANT><<<M, 256, 0, stream>>>(x, grid, offset, K, (int)kp,
                                            reinterpret_cast<int8_t*>(w), rs);
    xa = w;
    x_row = (long long)kp;
    rs_int = rs;
    used = xb + rb;
  }
  const uint8_t* cp = codes;
  long long c_row = N;
  if (codes_prep) {
    const size_t np = tile::round_up(N, 16);
    if (w == nullptr || (size_t)ws_bytes < used + (size_t)rows * np)
      return static_cast<int>(cudaErrorInvalidValue);
    tile::pad_codes<TAG>
        <<<tile::blocks_for((size_t)rows * np), 256, 0, stream>>>(
            codes, rows, N, (int)np, w + used);
    cp = w + used;
    c_row = (long long)np;
  }
  if (reinterpret_cast<uintptr_t>(xa) % 16 || x_row % 16 ||
      reinterpret_cast<uintptr_t>(cp) % 16 || c_row % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xm, cm;
  if (!tile::encode_2d(&xm, CU_TENSOR_MAP_DATA_TYPE_UINT8, xa, K, M, x_row,
                       BK, BM, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tile::encode_2d(&cm, CU_TENSOR_MAP_DATA_TYPE_UINT8, cp, N, rows, c_row,
                       BN, Layout<BITS>::RAW_ROWS,
                       CU_TENSOR_MAP_SWIZZLE_NONE))
    return static_cast<int>(cudaErrorInvalidValue);
  auto fn = kernel<TAG, BITS>;
  constexpr int smem = Layout<BITS>::ALLOC;
  static std::atomic<std::uint64_t> opted{0};
  const cudaError_t err = opt_in_smem(fn, smem, opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 g((N + BN - 1) / BN, (M + BM - 1) / BM);
  fn<<<g, NT, smem, stream>>>(xm, cm, es, eb, rowsum, rs_int, cst, out, M, N,
                              K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace itile

template <int BITS, bool QUANT>
int launch_int(const void* x, const uint8_t* codes, const float* es,
              const float* eb, const float* rowsum, const float* cst,
              const float* grid, int offset, float* out, int M, int N, int K,
              int path, int splits, int chunk, void* ws, long long ws_bytes,
              int x_prep, int codes_prep, cudaStream_t stream) {
  if (path == 0)
    return istream::launch<BITS, QUANT>(x, codes, es, eb, rowsum, cst, grid,
                                        offset, out, ws, ws_bytes, M, N, K,
                                        splits, chunk, stream);
  if (path == 1)
    return itile::launch<BITS, QUANT>(x, codes, es, eb, rowsum, cst, grid,
                                      offset, out, ws, ws_bytes, M, N, K,
                                      x_prep, codes_prep, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int BITS>
int launch_int_any(const void* x, int quant, const uint8_t* codes,
                  const float* es, const float* eb, const float* rowsum,
                  const float* cst, const float* grid, int act_bits,
                  float* out, int M, int N, int K, int path, int splits,
                  int chunk, void* ws, long long ws_bytes, int x_prep,
                  int codes_prep, cudaStream_t stream) {
  if (!quant)
    return launch_int<BITS, false>(x, codes, es, eb, rowsum, cst, grid, 0,
                                  out, M, N, K, path, splits, chunk, ws,
                                  ws_bytes, x_prep, codes_prep, stream);
  if (act_bits < 2 || act_bits > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_int<BITS, true>(x, codes, es, eb, rowsum, cst, grid,
                               1 << (act_bits - 1), out, M, N, K, path,
                               splits, chunk, ws, ws_bytes, x_prep,
                               codes_prep, stream);
}

}  // namespace


// K1 (bits 8: codes (K, N) int8) and K4 (bits 2 or 4: codes
// (ceil(K/per), N) uint8 packed along K, K the logical fan-in). x (M, K)
// bf16 (x_bf16 = 1) or fp32; scale/bias (N,) fp32; rowsum (M,) fp32; out
// (M, N) fp32; all contiguous, on the device of `stream`. path 0: the
// stream, `splits` splits of `chunk` K rows (a multiple of 4), a (splits,
// M, N) fp32 workspace when splits > 1; path 1: the wgmma tile, with
// x_prep / codes_prep as the wrapper decided them and `ws` holding what
// they need (see tile::launch). `ws_bytes` is the workspace's size.
// Returns cudaErrorInvalidValue for other bits or paths, a workspace too
// small or operands TMA cannot take unprepared, else cudaGetLastError()
// after the last launch (0 = launched).
extern "C" int quant_matmul_fused(const void* x, int x_bf16,
                                  const void* codes, int bits,
                                  const float* scale, const float* bias,
                                  const float* rowsum, float* out, void* ws,
                                  long long ws_bytes, int M, int N, int K,
                                  int path, int splits, int chunk,
                                  int x_prep, int codes_prep, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
#define FUSED(B)                                                          \
  launch_fused<B>(x, x_bf16, codes, scale, bias, rowsum, out, ws, ws_bytes, \
                  M, N, K, path, splits, chunk, x_prep, codes_prep, s)
  switch (bits) {
    case 8: return FUSED(8);
    case 4: return FUSED(4);
    case 2: return FUSED(2);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FUSED
}

// K5 (bits 8: codes (K, N) int8) and K6 (bits 2 or 4: codes
// (ceil(K/per), N) uint8 packing `bits` a code, per = 8 / bits;
// quant/pack.py), K the logical fan-in. quant = 0: x is (M, K) int8
// activation codes and rowsum (M,) fp32 their row sums (grid unused).
// quant = 1: x is (M, K) fp32, quantized in the kernel on grid = [alpha,
// beta, s] (fp32, device) at act_bits in [2, 8], and the row sums are taken
// in the kernel (rowsum unused). eff_scale/eff_bias/cst (N,) fp32; out
// (M, N) fp32; all contiguous, on the device of `stream`. path 0 (M <= 8
// or K = 0): the split-K stream, `splits` splits (at most 4096) of `chunk`
// K rows (a multiple of 4), and with splits > 1 `ws` the zeroed workspace
// of istream::ws_bytes_for(ceil(N / 128)) bytes that the launch leaves
// zeroed; path 1: the int8 wgmma tiles, with x_prep / codes_prep as the
// wrapper decided them (x_prep always with quant) and `ws` scratch for them
// (see itile::launch). `ws_bytes` is the workspace's size. Returns
// cudaErrorInvalidValue for other bits, paths or act_bits, a workspace too
// small or operands TMA cannot take unprepared, else cudaGetLastError()
// after the last launch (0 = launched).
extern "C" int int_matmul_fused(
    const void* x, int quant, const void* codes, const float* eff_scale,
    const float* eff_bias, const float* rowsum, const float* cst,
    const float* grid, int act_bits, float* out, int M, int N, int K,
    int bits, int path, int splits, int chunk, void* ws, long long ws_bytes,
    int x_prep, int codes_prep, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const uint8_t* c = static_cast<const uint8_t*>(codes);
#define INT(B)                                                              \
  launch_int_any<B>(x, quant, c, eff_scale, eff_bias, rowsum, cst, grid,    \
                    act_bits, out, M, N, K, path, splits, chunk, ws,        \
                    ws_bytes, x_prep, codes_prep, s)
  switch (bits) {
    case 8: return INT(8);
    case 4: return INT(4);
    case 2: return INT(2);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef INT
}
