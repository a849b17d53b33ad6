// Fused resident step of DPSVRG / DSPG for NVIDIA Hopper (sm_90a):
//
//     v   = g_now - g_snap + mu        (rule svrg, 4 input streams)
//           g                          (rule sgd,  2 input streams)
//     q   = x - alpha * v
//     z   = W @ q                      (gossip mix over the m node rows)
//     out = prox(z)                    (l1 soft-threshold at alpha*lam,
//                                       sql2 z / (1 + alpha*lam), or none)
//
// over contiguous row-major (m, d) float32 buffers, one row per node.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/fused_update/kernel.py:fused_step_kernel_call (body
// _make_fused_kernel, math in ref.py:fused_step_math).  Its plain PyTorch
// version is src/repro_torch/kernels/fused_update/ref.py:fused_step_math.
//
// What bounds it.  The step reads each input stream once and writes the
// output once: (streams + 1) * m * d * 4 bytes, 160 KiB for rule svrg at
// the paper's width (m = 8, d = 1024), against 2 * m * m * d flops for the
// mix.  At 2 m flops per 20 bytes it is memory-bound at every m this kernel
// takes (m <= 64), and at the paper's width the 160 KiB take about 0.05 us
// at 3.35 TB/s, so there one launch costs far more than the work: the step
// is launch-bound.  Fusing the five elementwise passes, the matrix product
// and the prox into one launch is what this kernel is for.
//
// Design.  The grid runs over column tiles of THREADS columns.  Each thread
// owns one column j, so in every row the threads of a warp read neighbouring
// addresses.  The block stages W (m*m floats) in shared memory; each thread
// forms q_k = x[k, j] - alpha * v[k, j] for all k < m into its own column of
// a shared (m, THREADS) tile, then computes z_i = sum_k W[i, k] q_k with
// float32 FMAs in k order, applies the prox and writes out[i, j] once.  The
// ragged column edge is masked.  Rule and prox kind are template parameters:
// six instantiations behind one C entry point with plain int selectors.
//
// Rounding.  The elementwise steps use the _rn intrinsics so that nvcc does
// not contract them into FMAs: v, q and the threshold alpha*lam round as the
// plain PyTorch version rounds them (alpha*lam is one float32 product, as in
// the reference, so a coordinate at the l1 threshold lands on the same
// side).  Only the mix accumulates with FMAs.
//
// alpha comes either by value or, when alpha_ptr is not null, from device
// memory: the resident runner keeps its staged step sizes on the card, so a
// step never waits for the host.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int MAX_M = 64;   // shared memory: (64*64 + 64*128) * 4 B = 48 KiB

enum Rule { kSvrg = 0, kSgd = 1 };
enum ProxKind { kL1 = 0, kSql2 = 1, kNone = 2 };

template <int RULE, int PROX>
__global__ void __launch_bounds__(THREADS)
fused_step_kernel(const float* __restrict__ w, const float* __restrict__ x,
                  const float* __restrict__ g0, const float* __restrict__ g1,
                  const float* __restrict__ g2, float* __restrict__ out,
                  int m, long long d, const float* __restrict__ alpha_ptr,
                  float alpha_val, float lam) {
  extern __shared__ float smem[];
  float* w_s = smem;           // (m, m) mixing matrix
  float* q_s = smem + m * m;   // (m, THREADS): column tid belongs to thread tid

  for (int e = threadIdx.x; e < m * m; e += THREADS) w_s[e] = w[e];

  const float alpha = alpha_ptr != nullptr ? *alpha_ptr : alpha_val;
  const long long j = (long long)blockIdx.x * THREADS + threadIdx.x;
  const int tid = threadIdx.x;
  if (j < d) {
    for (int k = 0; k < m; ++k) {
      const long long idx = (long long)k * d + j;
      float v;
      if (RULE == kSvrg) {
        v = __fadd_rn(__fsub_rn(g0[idx], g1[idx]), g2[idx]);
      } else {
        v = g0[idx];
      }
      q_s[k * THREADS + tid] = __fsub_rn(x[idx], __fmul_rn(alpha, v));
    }
  }
  __syncthreads();   // W is complete; each q column is private to its thread
  if (j >= d) return;

  const float t = __fmul_rn(alpha, lam);
  for (int i = 0; i < m; ++i) {
    float z = 0.0f;
    for (int k = 0; k < m; ++k) {
      z = fmaf(w_s[i * m + k], q_s[k * THREADS + tid], z);
    }
    float r;
    if (PROX == kL1) {
      // sign(z) * max(|z| - t, 0), as the plain version: NaN stays NaN
      const float sign = z > 0.0f ? 1.0f : (z < 0.0f ? -1.0f : z);
      r = __fmul_rn(sign, fmaxf(__fsub_rn(fabsf(z), t), 0.0f));
    } else if (PROX == kSql2) {
      r = __fdiv_rn(z, __fadd_rn(1.0f, t));
    } else {
      r = z;
    }
    out[(long long)i * d + j] = r;
  }
}

template <int RULE, int PROX>
void launch(const float* w, const float* x, const float* g0, const float* g1,
            const float* g2, float* out, int m, long long d,
            const float* alpha_ptr, float alpha_val, float lam,
            cudaStream_t stream) {
  const long long blocks = (d + THREADS - 1) / THREADS;
  const size_t smem = (size_t)(m * m + m * THREADS) * sizeof(float);
  fused_step_kernel<RULE, PROX><<<(unsigned)blocks, THREADS, smem, stream>>>(
      w, x, g0, g1, g2, out, m, d, alpha_ptr, alpha_val, lam);
}

template <int RULE>
int dispatch_prox(int prox, const float* w, const float* x, const float* g0,
                  const float* g1, const float* g2, float* out, int m,
                  long long d, const float* alpha_ptr, float alpha_val,
                  float lam, cudaStream_t stream) {
  switch (prox) {
    case kL1:
      launch<RULE, kL1>(w, x, g0, g1, g2, out, m, d, alpha_ptr, alpha_val,
                        lam, stream);
      return 0;
    case kSql2:
      launch<RULE, kSql2>(w, x, g0, g1, g2, out, m, d, alpha_ptr, alpha_val,
                          lam, stream);
      return 0;
    case kNone:
      launch<RULE, kNone>(w, x, g0, g1, g2, out, m, d, alpha_ptr, alpha_val,
                          lam, stream);
      return 0;
  }
  return -1;
}

}  // namespace

extern "C" {

int fused_step_max_m() { return MAX_M; }

// Returns 0 on success, cudaGetLastError() after the launch otherwise, and
// -1 for an unknown selector or a shape the kernel does not take.  g1 and g2
// are ignored (may be null) for rule sgd.
int fused_step_launch(const float* w, const float* x, const float* g0,
                      const float* g1, const float* g2, float* out, int m,
                      long long d, const float* alpha_ptr, float alpha_val,
                      float lam, int rule, int prox, void* stream) {
  if (m < 1 || m > MAX_M || d < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (rule == kSvrg) {
    rc = dispatch_prox<kSvrg>(prox, w, x, g0, g1, g2, out, m, d, alpha_ptr,
                              alpha_val, lam, s);
  } else if (rule == kSgd) {
    rc = dispatch_prox<kSgd>(prox, w, x, g0, g1, g2, out, m, d, alpha_ptr,
                             alpha_val, lam, s);
  } else {
    rc = -1;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

}  // extern "C"
