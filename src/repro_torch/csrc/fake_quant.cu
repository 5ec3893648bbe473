// K3 fake_quant: fused gated fake quantization for Hopper (sm_90a).
//
//     g    = max(gate[n], 0.5)                   (no pruning)
//     bits = T(g): g > 0, 1, 2, 3, 4  ->  2, 4, 8, 16, 32
//     beta = max(beta[n], 1e-8),  alpha = -beta (signed) or 0
//     s    = (beta - alpha) / (2^clip(bits, 2, 31) - 1)
//     q    = alpha + s * rint((clip(x, alpha, beta) - alpha) / s)
//     out  = bits >= 32 ? x : q
//
// over x (M, N) fp32 or bf16 with one gate and one beta per column (N,).
// The math is fp32; a bf16 x is widened exactly on load and the result
// rounded to nearest even on store, which is what casting to fp32, running
// the fp32 kernel and casting back gives.
//
// Replaces: src/repro/kernels/fake_quant/fake_quant.py:fake_quant_pallas
// (kernel body _kernel). The TPU kernel tiles (256 x 512) blocks of x into
// VMEM with the matching (512,) slices of gate and beta. Here one thread
// owns one column: it turns its gate and beta into (alpha, beta, s, pass)
// once, then walks its rows four at a time (four loads in flight before the
// first store); neighbouring threads take neighbouring columns, so every
// row segment is one coalesced access.
//
// Bit-equal to the plain version (core/quantizer.py:quantize), which is
// what training runs on the CPU:
//   * rintf rounds half to even, as torch.round and jnp.round do;
//   * both divides are IEEE (__fdiv_rn), and the file builds without
//     -use_fast_math;
//   * 2^b - 1 is formed exactly with ldexpf (b is an integer in [2, 31]),
//     as torch.exp2 gives it at those points;
//   * alpha + s*r is written __fadd_rn(alpha, __fmul_rn(s, r)) so nvcc
//     cannot contract it into an FMA the CPU version does not make;
//   * the clamps are written as compares, so a NaN propagates as it does
//     through torch.maximum/minimum.
//
// What bounds it on an H100: it reads each element once and writes it once
// with ~10 FLOPs between, far below the ~20 FLOP/byte fp32 ridge: bytes,
// by that count. Measured, the issue of its exact arithmetic (the
// per-element IEEE divide with its slow-path check most of all) holds it
// back at the small and bf16 shapes, and HBM at the large ones: 16-byte
// accesses, 2-D blocks and a grid of one wave made a CGMQ forward no
// faster (PERF.md, Findings), so the design stays one element an access.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = 4;  // rows a thread loads before it stores

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// One element on the grid of its column (alpha, beta, s), or x itself.
__device__ __forceinline__ float fq(float xv, float alpha, float beta,
                                    float s, bool pass) {
  if (pass) return xv;
  float xc = xv < alpha ? alpha : xv;
  xc = xc > beta ? beta : xc;
  const float r = rintf(__fdiv_rn(__fsub_rn(xc, alpha), s));
  return __fadd_rn(alpha, __fmul_rn(s, r));
}

template <typename T, bool SIGNED>
__global__ void __launch_bounds__(THREADS)
    fake_quant_kernel(const T* __restrict__ x, const float* __restrict__ gate,
                      const float* __restrict__ beta_in, T* __restrict__ out,
                      int M, int N) {
  const int col = blockIdx.x * THREADS + threadIdx.x;
  if (col >= N) return;
  const float gr = gate[col];
  const float g = gr < 0.5f ? 0.5f : gr;
  float bits = 0.f;
  if (g > 0.f) bits = 2.f;
  if (g > 1.f) bits = 4.f;
  if (g > 2.f) bits = 8.f;
  if (g > 3.f) bits = 16.f;
  if (g > 4.f) bits = 32.f;
  const float br = beta_in[col];
  const float beta = br < 1e-8f ? 1e-8f : br;
  const float alpha = SIGNED ? -beta : 0.f;
  const float span = __fsub_rn(beta, alpha);
  const float b_eff = bits < 2.f ? 2.f : (bits > 31.f ? 31.f : bits);
  const float nsteps = __fsub_rn(ldexpf(1.f, static_cast<int>(b_eff)), 1.f);
  const float s = __fdiv_rn(span, nsteps);
  const bool pass = bits >= 32.f;
  // ROWS loads in flight before the first store: one access per thread
  // and row alone leaves too few bytes in flight to cover HBM latency
  for (int row0 = blockIdx.y * ROWS; row0 < M; row0 += gridDim.y * ROWS) {
    float xv[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int row = row0 + r;
      xv[r] = row < M ? load_f32(x + static_cast<size_t>(row) * N + col)
                      : 0.f;
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int row = row0 + r;
      if (row < M) {
        store(out + static_cast<size_t>(row) * N + col,
              fq(xv[r], alpha, beta, s, pass));
      }
    }
  }
}

template <typename T>
int launch(const void* x, const float* gate, const float* beta, void* out,
           int M, int N, int is_signed, cudaStream_t stream) {
  const int gx = (N + THREADS - 1) / THREADS;
  // about 4096 blocks in all (132 SMs x 8 resident x ~4 waves); each thread
  // then walks M / gy rows of its column, ROWS at a time
  const int row_groups = (M + ROWS - 1) / ROWS;
  int gy = (4096 + gx - 1) / gx;
  gy = gy < row_groups ? gy : row_groups;
  gy = gy < 65535 ? gy : 65535;
  const dim3 grid(gx, gy);
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (is_signed) {
    fake_quant_kernel<T, true><<<grid, THREADS, 0, stream>>>(xt, gate, beta,
                                                             ot, M, N);
  } else {
    fake_quant_kernel<T, false><<<grid, THREADS, 0, stream>>>(xt, gate, beta,
                                                              ot, M, N);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: (M, N) contiguous, fp32 (is_bf16 = 0) or bf16 (is_bf16 = 1);
// gate, beta: (N,) fp32. M, N >= 1. Launches on `stream` without
// synchronising. Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int fake_quant(const void* x, const float* gate, const float* beta,
                          void* out, int M, int N, int is_signed, int is_bf16,
                          cudaStream_t stream) {
  if (is_bf16) {
    return launch<__nv_bfloat16>(x, gate, beta, out, M, N, is_signed, stream);
  }
  return launch<float>(x, gate, beta, out, M, N, is_signed, stream);
}
