// K1 quant_matmul: fused int8-dequant GEMM for Hopper (sm_90a).
//
//     out[m, n] = scale[n] * (x @ codes)[m, n] + bias[n] * rowsum[m]
//
// which equals x @ (codes * scale + bias) in exact arithmetic: the weight is
// never widened to float in device memory.
//
// Replaces: src/repro/kernels/quant_matmul/quant_matmul.py:quant_matmul_pallas
// (kernel body _kernel). The TPU kernel walks a sequential K grid axis and
// accumulates into the revisited fp32 output tile, applying the affine
// epilogue on the last K step. Here one thread block owns one BM x BN output
// tile and loops over K itself; the epilogue runs in registers before the
// only store.
//
// What bounds it on an H100: at decode (M = serving slots, 8) the work is a
// stream of int8 weight bytes with 2 FLOPs per byte per row, far below the
// card's ~20 FLOP/byte fp32 ridge: it is bound by the bytes of `codes`. At
// prefill (M = the padded prompt, up to 512) it is bound by fp32 FMAs.
// What the design does about it:
//   * codes are read as int8 (a quarter of fp32's bytes) and widened to
//     float only in shared memory, once per tile;
//   * x and codes tiles are staged in shared memory and reused by every
//     thread of the block; each thread keeps a TM x TN fp32 register tile;
//   * two tile shapes: M <= 8 takes an 8-row tile (one output per thread,
//     no idle rows at decode), larger M takes 64 x 64 tiles with 4 x 4
//     register tiles. Split-K, cp.async/TMA pipelining and tensor cores are
//     left for a later change; at M = 8 a block still reads its codes tile
//     with plain loads and few bytes in flight.
//   * ragged M/N/K edges are zero-filled on load (a ragged K tail would
//     otherwise add garbage to real sums) and masked on store.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
quant_matmul_kernel(const float* __restrict__ x,
                    const int8_t* __restrict__ codes,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias,
                    const float* __restrict__ rowsum,
                    float* __restrict__ out, int M, int N, int K) {
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
      cs[r][c] = (gk < K && gn < N)
                     ? static_cast<float>(codes[(size_t)gk * N + gn])
                     : 0.f;
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
      if (n < N) out[(size_t)m * N + n] = acc[i][j] * scale[n] + rs * bias[n];
    }
  }
}

template <int BM, int BN, int BK, int TM, int TN>
void launch(const float* x, const int8_t* codes, const float* scale,
            const float* bias, const float* rowsum, float* out, int M, int N,
            int K, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const dim3 block((BM / TM) * (BN / TN));
  quant_matmul_kernel<BM, BN, BK, TM, TN>
      <<<grid, block, 0, stream>>>(x, codes, scale, bias, rowsum, out, M, N, K);
}

}  // namespace

// x (M, K) fp32, codes (K, N) int8, scale/bias (N,) fp32, rowsum (M,) fp32,
// out (M, N) fp32; all contiguous, on the device of `stream`.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int quant_matmul_f32_i8(const float* x, const int8_t* codes,
                                   const float* scale, const float* bias,
                                   const float* rowsum, float* out, int M,
                                   int N, int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 8) {
    launch<8, 32, 128, 1, 1>(x, codes, scale, bias, rowsum, out, M, N, K, s);
  } else {
    launch<64, 64, 16, 4, 4>(x, codes, scale, bias, rowsum, out, M, N, K, s);
  }
  return static_cast<int>(cudaGetLastError());
}
