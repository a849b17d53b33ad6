// The DPSVRG inner-step elementwise pipeline for NVIDIA Hopper (sm_90a):
//
//   svrg_step:  q   = x - alpha * (g_now - g_snap + mu)
//   mix_prox:   z   = w_self * q_self + w_up * q_up + w_down * q_down
//               out = sign(z) * max(|z| - thresh, 0)
//
// over contiguous float32 buffers of any length n.
//
// Replaces the Pallas TPU kernels
// src/repro/kernels/fused_update/kernel.py:svrg_step_kernel_call (body
// _svrg_step_kernel) and :mix_prox_kernel_call (body _mix_prox_kernel).
// Their plain PyTorch versions are svrg_step_ref and mix_prox_ref in
// src/repro_torch/kernels/fused_update/ref.py.
//
// What bounds them.  Both are pure streaming passes: svrg_step reads four
// floats and writes one per element (20 bytes) for 4 flops, mix_prox reads
// three and writes one (16 bytes) for about 8 flops.  At under half a flop
// per byte they are bound by device memory at every size, so the design
// only has to keep enough bytes in flight: 2048 x 1024 elements (8 MiB a
// stream) take 12.5 and 10.0 us at 3.35 TB/s.
//
// Design.  The TPU kernels tile (rows, 1024) buffers into (8, 1024) blocks
// with rows % 8 == 0; nothing of that is carried over.  A grid-stride loop
// over the flat buffer, 256 threads a block and at most 8 blocks per SM (one
// resident wave), each thread moving 16-byte float4 loads and stores.  When
// every pointer is 16-byte aligned the body runs on float4 and a scalar
// tail finishes the last n % 4 elements; otherwise (a view at an odd
// offset) the whole pass is scalar.
//
// Rounding.  The arithmetic is written in the plain version's order with
// __fadd_rn / __fsub_rn / __fmul_rn, so nvcc contracts nothing into FMAs
// and every element equals the plain PyTorch version bit for bit.
//
// alpha comes either by value or, when alpha_ptr is not null, from device
// memory (a one-element float32 tensor), as in fused_step.cu.  mix_prox's
// weights and threshold likewise: by value, or, when scal_ptr is not null,
// as the four floats {w_self, w_up, w_down, thresh} in device memory, so a
// step whose weights come from staged tensors launches without a sync.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;   // 8 x 256 = 2048 threads: a full SM

__device__ __forceinline__ float svrg_q(float x, float gn, float gs, float mu,
                                        float alpha) {
  return __fsub_rn(x, __fmul_rn(alpha, __fadd_rn(__fsub_rn(gn, gs), mu)));
}

__device__ __forceinline__ float mix_soft(float qs, float qu, float qd,
                                          float ws, float wu, float wd,
                                          float t) {
  const float z = __fadd_rn(__fadd_rn(__fmul_rn(ws, qs), __fmul_rn(wu, qu)),
                            __fmul_rn(wd, qd));
  // sign(z) * max(|z| - t, 0), as the plain version
  const float sign = z > 0.0f ? 1.0f : (z < 0.0f ? -1.0f : z);
  return __fmul_rn(sign, fmaxf(__fsub_rn(fabsf(z), t), 0.0f));
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
svrg_step_kernel(const float* __restrict__ x, const float* __restrict__ gn,
                 const float* __restrict__ gs, const float* __restrict__ mu,
                 float* __restrict__ out, long long n,
                 const float* __restrict__ alpha_ptr, float alpha_val) {
  const float alpha = alpha_ptr != nullptr ? *alpha_ptr : alpha_val;
  const long long stride = (long long)gridDim.x * THREADS;
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  long long tail = 0;
  if (VEC) {
    const long long n4 = n / 4;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const float4* gn4 = reinterpret_cast<const float4*>(gn);
    const float4* gs4 = reinterpret_cast<const float4*>(gs);
    const float4* mu4 = reinterpret_cast<const float4*>(mu);
    float4* out4 = reinterpret_cast<float4*>(out);
    for (long long i = tid; i < n4; i += stride) {
      const float4 a = x4[i], b = gn4[i], c = gs4[i], d = mu4[i];
      float4 r;
      r.x = svrg_q(a.x, b.x, c.x, d.x, alpha);
      r.y = svrg_q(a.y, b.y, c.y, d.y, alpha);
      r.z = svrg_q(a.z, b.z, c.z, d.z, alpha);
      r.w = svrg_q(a.w, b.w, c.w, d.w, alpha);
      out4[i] = r;
    }
    tail = n4 * 4;
  }
  for (long long i = tail + tid; i < n; i += stride) {
    out[i] = svrg_q(x[i], gn[i], gs[i], mu[i], alpha);
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
mix_prox_kernel(const float* __restrict__ qs, const float* __restrict__ qu,
                const float* __restrict__ qd, float* __restrict__ out,
                long long n, const float* __restrict__ scal, float ws,
                float wu, float wd, float t) {
  if (scal != nullptr) {
    ws = scal[0];
    wu = scal[1];
    wd = scal[2];
    t = scal[3];
  }
  const long long stride = (long long)gridDim.x * THREADS;
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  long long tail = 0;
  if (VEC) {
    const long long n4 = n / 4;
    const float4* s4 = reinterpret_cast<const float4*>(qs);
    const float4* u4 = reinterpret_cast<const float4*>(qu);
    const float4* d4 = reinterpret_cast<const float4*>(qd);
    float4* out4 = reinterpret_cast<float4*>(out);
    for (long long i = tid; i < n4; i += stride) {
      const float4 a = s4[i], b = u4[i], c = d4[i];
      float4 r;
      r.x = mix_soft(a.x, b.x, c.x, ws, wu, wd, t);
      r.y = mix_soft(a.y, b.y, c.y, ws, wu, wd, t);
      r.z = mix_soft(a.z, b.z, c.z, ws, wu, wd, t);
      r.w = mix_soft(a.w, b.w, c.w, ws, wu, wd, t);
      out4[i] = r;
    }
    tail = n4 * 4;
  }
  for (long long i = tail + tid; i < n; i += stride) {
    out[i] = mix_soft(qs[i], qu[i], qd[i], ws, wu, wd, t);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

// Enough blocks for the work, at most one resident wave of the card.
unsigned grid_for(long long work) {
  static int max_blocks = 0;
  if (max_blocks == 0) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    max_blocks = (sms > 0 ? sms : 1) * BLOCKS_PER_SM;
  }
  long long blocks = (work + THREADS - 1) / THREADS;
  if (blocks > max_blocks) blocks = max_blocks;
  return (unsigned)(blocks > 0 ? blocks : 1);
}

}  // namespace

extern "C" {

// Each returns 0 on success, cudaGetLastError() after the launch otherwise,
// and -1 for a length the kernels do not take (n < 1).

int svrg_step_launch(const float* x, const float* g_now, const float* g_snap,
                     const float* mu, float* out, long long n,
                     const float* alpha_ptr, float alpha_val, void* stream) {
  if (n < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (aligned16(x) && aligned16(g_now) && aligned16(g_snap) &&
      aligned16(mu) && aligned16(out)) {
    svrg_step_kernel<true><<<grid_for(n / 4 > 0 ? n / 4 : n), THREADS, 0,
                             s>>>(x, g_now, g_snap, mu, out, n, alpha_ptr,
                                  alpha_val);
  } else {
    svrg_step_kernel<false><<<grid_for(n), THREADS, 0, s>>>(
        x, g_now, g_snap, mu, out, n, alpha_ptr, alpha_val);
  }
  return (int)cudaGetLastError();
}

int mix_prox_launch(const float* q_self, const float* q_up,
                    const float* q_down, float* out, long long n,
                    const float* scal_ptr, float w_self, float w_up,
                    float w_down, float thresh, void* stream) {
  if (n < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (aligned16(q_self) && aligned16(q_up) && aligned16(q_down) &&
      aligned16(out)) {
    mix_prox_kernel<true><<<grid_for(n / 4 > 0 ? n / 4 : n), THREADS, 0,
                            s>>>(q_self, q_up, q_down, out, n, scal_ptr,
                                 w_self, w_up, w_down, thresh);
  } else {
    mix_prox_kernel<false><<<grid_for(n), THREADS, 0, s>>>(
        q_self, q_up, q_down, out, n, scal_ptr, w_self, w_up, w_down,
        thresh);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
