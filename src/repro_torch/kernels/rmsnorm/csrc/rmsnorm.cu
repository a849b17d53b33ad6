// RMSNorm for NVIDIA Hopper (sm_90a):
//
//     y[r, :] = x[r, :] * rsqrt(mean(x[r, :]^2) + eps) * (1 + w)
//
// with float32 statistics; x, w and the output share one type, float32 or
// bf16.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/rmsnorm/kernel.py:rmsnorm_kernel_call (body _kernel).
// Its plain PyTorch version is
// src/repro_torch/kernels/rmsnorm/ref.py:rmsnorm_ref.
//
// What bounds it.  Each row is read once and written once, and w once:
// (2 * rows * d + d) * elem bytes against about 4 flops per element, so the
// kernel is bound by memory at every shape: 2560 float32 columns take
// 20 KiB a row, 6.1 ns at 3.35 TB/s.  At a decode step (a few rows) one
// launch costs far more than the work.
//
// Design.  One block of THREADS threads per row.  The block stages its row
// in shared memory (as x's type) while each thread sums its elements'
// squares in float32; a warp-shuffle reduction and one shared-memory step
// across the warps give the sum, then every thread scales its elements out
// of shared memory, so the row is read from device memory once.  Rows with
// d a multiple of the 16-byte vector (4 float32 or 8 bf16) whose start is
// 16-byte aligned use 16-byte loads and stores; other rows take the scalar
// loop, so ragged d needs no padding and rows need no padding to 8 (the
// TPU kernel's BLOCK_ROWS).  The row stride is an argument, so the last
// position of a batch of sequences, x[:, -1], is read in place.
//
// Rounding follows the plain version: r = rsqrt(sum / d + eps), then
// (x * r) * (1 + w), each in float32 (rsqrtf is within 2 ulp of the
// correctly rounded value).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_DEVICES = 64;
// dynamic shared memory a block may take: the SM's 227 KiB less the
// kernel's static 32 bytes of partial sums, rounded down
constexpr int MAX_SMEM = 227 * 1024 - 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ out, int d, long long x_row_stride,
               float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* row_s = reinterpret_cast<T*>(smem_raw);
  __shared__ float partial[WARPS];

  const long long r = blockIdx.x;
  const T* xr = x + r * x_row_stride;
  T* orow = out + r * (long long)d;
  const int tid = threadIdx.x;

  constexpr int V = 16 / sizeof(T);  // elements in one 16-byte vector
  float ss = 0.f;
  if (VEC) {
    const int nv = d / V;
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    uint4* sv = reinterpret_cast<uint4*>(row_s);
    for (int i = tid; i < nv; i += THREADS) {
      uint4 pack = xv[i];
      sv[i] = pack;
      const T* e = reinterpret_cast<const T*>(&pack);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float f = to_f32(e[k]);
        ss = fmaf(f, f, ss);
      }
    }
  } else {
    for (int i = tid; i < d; i += THREADS) {
      const T v = xr[i];
      row_s[i] = v;
      const float f = to_f32(v);
      ss = fmaf(f, f, ss);
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if ((tid & 31) == 0) partial[tid >> 5] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int k = 0; k < WARPS; ++k) total += partial[k];
  const float inv = rsqrtf(total / (float)d + eps);

  if (VEC) {
    const int nv = d / V;
    const uint4* sv = reinterpret_cast<const uint4*>(row_s);
    uint4* ov = reinterpret_cast<uint4*>(orow);
    for (int i = tid; i < nv; i += THREADS) {
      uint4 pack = sv[i];
      const T* e = reinterpret_cast<const T*>(&pack);
      uint4 res;
      T* o = reinterpret_cast<T*>(&res);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float wf = to_f32(w[i * V + k]);
        o[k] = from_f32<T>(__fmul_rn(__fmul_rn(to_f32(e[k]), inv),
                                     __fadd_rn(1.f, wf)));
      }
      ov[i] = res;
    }
  } else {
    for (int i = tid; i < d; i += THREADS) {
      const float wf = to_f32(w[i]);
      orow[i] = from_f32<T>(__fmul_rn(__fmul_rn(to_f32(row_s[i]), inv),
                                      __fadd_rn(1.f, wf)));
    }
  }
}

template <typename T>
int launch_typed(const void* x, const void* w, void* out, long long rows,
                 int d, long long x_row_stride, float eps,
                 cudaStream_t stream) {
  const size_t smem = (size_t)d * sizeof(T);
  constexpr int V = 16 / sizeof(T);
  const bool vec = (d % V == 0) && (x_row_stride % V == 0) &&
                   ((reinterpret_cast<uintptr_t>(x) & 15) == 0) &&
                   ((reinterpret_cast<uintptr_t>(out) & 15) == 0);
  auto kernel = vec ? rmsnorm_kernel<T, true> : rmsnorm_kernel<T, false>;
  if (smem > 48 * 1024) {
    // allow the widest row once per device and instantiation, so that a
    // launch captured into a CUDA graph later makes no attribute call
    static bool configured[2][MAX_DEVICES] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= MAX_DEVICES) return -1;
    if (!configured[vec][dev]) {
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 MAX_SMEM);
      if (err != cudaSuccess) return (int)err;
      configured[vec][dev] = true;
    }
  }
  kernel<<<(unsigned)rows, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out),
      d, x_row_stride, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The largest row the kernel takes: the row must fit in shared memory.
int rmsnorm_max_d(int elem_bytes) { return MAX_SMEM / elem_bytes; }

// x: rows of d elements, row r at x + r * x_row_stride (elements);
// w: (d,); out: contiguous (rows, d); all three of one type.  dtype:
// 0 = float32, 1 = bf16.  Returns 0, a CUDA error code, or -1 for a bad
// selector.
int rmsnorm_launch(const void* x, const void* w, void* out, long long rows,
                   int d, long long x_row_stride, float eps, int dtype,
                   void* stream) {
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_typed<float>(x, w, out, rows, d, x_row_stride, eps, s);
  if (dtype == 1)
    return launch_typed<__nv_bfloat16>(x, w, out, rows, d, x_row_stride, eps,
                                       s);
  return -1;
}

}  // extern "C"
