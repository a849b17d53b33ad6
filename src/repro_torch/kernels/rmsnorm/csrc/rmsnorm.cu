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
// kernel is bound by memory at every shape: a 2560-wide bf16 row moves
// 10 KiB, 3.1 ns at 3.35 TB/s.  What keeps it from that rate is latency:
// enough 16-byte loads must be in flight on every SM, and no thread may
// wait on a slower one.  At a decode step (a few rows) one launch costs far
// more than the work.
//
// Design (rmsnorm_regs).  A group of WPR warps owns a row and holds it in
// registers: lane l of the group takes the 16-byte vectors l, l + 32 WPR,
// ... (NV of them, NV a template parameter), so at the models' widths
// (2304, 2560, 3584 in either dtype) every lane does the same number of
// vectors, or one fewer (bf16 2304).  A lane issues all NV loads of the
// weight and of its row, as 16-byte vectors, before it sums a square (the
// row's loads and stores carry the streaming hint, .cs: x is read once and
// out is not read here again); the sum is reduced by warp shuffles, and
// across the group's warps by one shared-memory step and one
// __syncthreads.  Up to 640 vectors a row a lane holds at most 5 of them
// (7 at gemma2's 3584), since a warp does the arithmetic of its vectors in
// sequence and that sets the time of a launch of few rows (a warp a row of
// 256 vectors, 8 a lane, ran 11-17% slower at 1-133 bf16 rows than a block
// of 8 warps of one vector each; two warps of 4 run faster).  A block
// takes up to 256 / (32 WPR) rows, one a row group, and no more than the
// rows over the SMs, so rows are spread over every SM before a block takes
// a second one and a 4-row decode step launches no idle warp.
// Instantiations cover rows of up to 32 * MAX_WPR * MAX_NV vectors
// (launch_typed below): 2560 vectors, 20,480 bf16 or 10,240 float32.
//
// Wider rows, rows whose d is not a multiple of the vector (4 float32 or
// 8 bf16) and rows not 16-byte aligned take rmsnorm_two_pass: one block a
// row sums the squares in a first pass and reads the row again to scale it
// in a second, so the width has no limit but the entry point's
// (rmsnorm_max_d).  Wide rows of vectors take blocks of 1024 threads, so
// that few rows are in flight on an SM and the second pass finds its row
// in L2 (256-thread blocks kept four times the rows in flight and ran at
// 62% of the bound at 6144 rows, against 81-83%).  The row stride is an
// argument, so the last position of a batch of sequences, x[:, -1], is
// read in place.
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
// the widest register tile: MAX_WPR warps a row, MAX_NV vectors a lane
constexpr int MAX_NV = 10;
constexpr int MAX_WPR = WARPS;
constexpr int WIDE_THREADS = 1024;
// the widest row the entry point takes, in bytes (58,048 float32, 116,096
// bf16); the two-pass kernel itself has no limit
constexpr int MAX_ROW_BYTES = 227 * 1024 - 256;

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// (x * inv) * (1 + w) for the V elements of one 16-byte vector
template <typename T>
__device__ __forceinline__ uint4 scale_vec(uint4 xv, uint4 wv, float inv) {
  constexpr int V = 16 / sizeof(T);
  const T* e = reinterpret_cast<const T*>(&xv);
  const T* wk = reinterpret_cast<const T*>(&wv);
  uint4 res;
  T* o = reinterpret_cast<T*>(&res);
#pragma unroll
  for (int k = 0; k < V; ++k)
    o[k] = from_f32<T>(__fmul_rn(__fmul_rn(to_f32(e[k]), inv),
                                 __fadd_rn(1.f, to_f32(wk[k]))));
  return res;
}

template <typename T>
__device__ __forceinline__ float sum_squares(uint4 xv) {
  constexpr int V = 16 / sizeof(T);
  const T* e = reinterpret_cast<const T*>(&xv);
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const float f = to_f32(e[k]);
    ss = fmaf(f, f, ss);
  }
  return ss;
}

// Rows in registers: blockDim.x / (32 WPR) row groups a block, one row
// each; d / V <= 32 WPR NV vectors a row; x, w and out 16-byte aligned,
// x_row_stride a multiple of V.
template <typename T, int NV, int WPR>
__global__ void __launch_bounds__(THREADS)
rmsnorm_regs(const T* __restrict__ x, const T* __restrict__ w,
             T* __restrict__ out, long long rows, int d,
             long long x_row_stride, float eps) {
  constexpr int V = 16 / sizeof(T);
  constexpr int GT = 32 * WPR;             // threads of a row group
  __shared__ float partial[WARPS];
  const int nvec = d / V;
  const int g = threadIdx.x % GT;          // thread within its group
  const long long r = (long long)blockIdx.x * (blockDim.x / GT) +
                      threadIdx.x / GT;
  const bool live = r < rows;               // a group past the last row
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const uint4* xr = reinterpret_cast<const uint4*>(x + r * x_row_stride);
  const uint4* wp = reinterpret_cast<const uint4*>(w);

  uint4 xv[NV], wv[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int i = g + GT * j;
    wv[j] = i < nvec ? wp[i] : zero;
  }
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int i = g + GT * j;
    xv[j] = live && i < nvec ? __ldcs(xr + i) : zero;
  }
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) ss += sum_squares<T>(xv[j]);
  ss = warp_sum(ss);
  if (WPR > 1) {
    // every thread of the block meets the barrier, live or not
    if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = ss;
    __syncthreads();
    ss = 0.f;
    const int first = (threadIdx.x / GT) * WPR;
#pragma unroll
    for (int k = 0; k < WPR; ++k) ss += partial[first + k];
  }
  if (!live) return;
  const float inv = rsqrtf(ss / (float)d + eps);
  uint4* orow = reinterpret_cast<uint4*>(out + r * (long long)d);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int i = g + GT * j;
    if (i < nvec) __stcs(orow + i, scale_vec<T>(xv[j], wv[j], inv));
  }
}

// One block of NT threads a row, two passes over it: any d; VEC: 16-byte
// vectors (d a multiple of V, aligned rows), else elements.
template <typename T, bool VEC, int NT>
__global__ void __launch_bounds__(NT)
rmsnorm_two_pass(const T* __restrict__ x, const T* __restrict__ w,
                 T* __restrict__ out, int d, long long x_row_stride,
                 float eps) {
  constexpr int V = 16 / sizeof(T);
  __shared__ float partial[NT / 32];
  const long long r = blockIdx.x;
  const T* xr = x + r * x_row_stride;
  T* orow = out + r * (long long)d;
  const int tid = threadIdx.x;

  float ss = 0.f;
  if (VEC) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    for (int i = tid; i < d / V; i += NT) ss += sum_squares<T>(xv[i]);
  } else {
    for (int i = tid; i < d; i += NT) {
      const float f = to_f32(xr[i]);
      ss = fmaf(f, f, ss);
    }
  }
  ss = warp_sum(ss);
  if ((tid & 31) == 0) partial[tid >> 5] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int k = 0; k < NT / 32; ++k) total += partial[k];
  const float inv = rsqrtf(total / (float)d + eps);

  if (VEC) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    const uint4* wv = reinterpret_cast<const uint4*>(w);
    uint4* ov = reinterpret_cast<uint4*>(orow);
    for (int i = tid; i < d / V; i += NT)
      ov[i] = scale_vec<T>(xv[i], wv[i], inv);
  } else {
    for (int i = tid; i < d; i += NT)
      orow[i] = from_f32<T>(__fmul_rn(__fmul_rn(to_f32(xr[i]), inv),
                                      __fadd_rn(1.f, to_f32(w[i]))));
  }
}

template <typename T, int NV, int WPR>
int launch_regs(const T* x, const T* w, T* out, long long rows, int d,
                long long x_row_stride, float eps, int sms,
                cudaStream_t stream) {
  constexpr int MAX_GROUPS = WARPS / WPR;
  const long long per_sm = (rows + sms - 1) / sms;
  const int groups = per_sm < MAX_GROUPS ? (int)per_sm : MAX_GROUPS;
  const long long grid = (rows + groups - 1) / groups;
  if (grid > 0x7fffffffLL) return -1;
  rmsnorm_regs<T, NV, WPR><<<(unsigned)grid, groups * 32 * WPR, 0, stream>>>(
      x, w, out, rows, d, x_row_stride, eps);
  return (int)cudaGetLastError();
}

// The register tile for rows of nvec 16-byte vectors: the first (NV, WPR)
// of the ladder with 32 WPR NV >= nvec.  At the models' widths every lane does the same
// number of vectors but at bf16 2304 (288 vectors on 320 lanes' slots):
// bf16 2560 / 3584 = 320 / 448 vectors on (5, 2) / (7, 2), float32 2304 /
// 2560 / 3584 = 576 / 640 / 896 on (5, 4) / (5, 4) / (7, 4).  Wider rows,
// and rows that are not vectors, take the two-pass kernel.
template <typename T>
int launch_typed(const void* xp, const void* wp, void* op, long long rows,
                 int d, long long x_row_stride, float eps,
                 cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const T* x = static_cast<const T*>(xp);
  const T* w = static_cast<const T*>(wp);
  T* out = static_cast<T*>(op);
  const bool vec = (d % V == 0) && (x_row_stride % V == 0) &&
                   ((reinterpret_cast<uintptr_t>(x) & 15) == 0) &&
                   ((reinterpret_cast<uintptr_t>(w) & 15) == 0) &&
                   ((reinterpret_cast<uintptr_t>(out) & 15) == 0);
  const int nvec = d / V;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
#define RMS_REGS(NV, WPR)                                                   \
  if (nvec <= 32 * (WPR) * (NV))                                           \
    return launch_regs<T, NV, WPR>(x, w, out, rows, d, x_row_stride, eps,  \
                                   sms, stream);
  if (vec) {
    RMS_REGS(1, 1)
    RMS_REGS(2, 1)
    RMS_REGS(4, 1)
    RMS_REGS(4, 2)
    RMS_REGS(5, 2)
    RMS_REGS(7, 2)
    RMS_REGS(5, 4)
    RMS_REGS(7, 4)
    RMS_REGS(10, 4)
    RMS_REGS(MAX_NV, MAX_WPR)
  }
#undef RMS_REGS
  if (rows > 0x7fffffffLL) return -1;
  if (vec)
    rmsnorm_two_pass<T, true, WIDE_THREADS>
        <<<(unsigned)rows, WIDE_THREADS, 0, stream>>>(
            x, w, out, d, x_row_stride, eps);
  else
    rmsnorm_two_pass<T, false, THREADS><<<(unsigned)rows, THREADS, 0, stream>>>(
        x, w, out, d, x_row_stride, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The widest row the entry point takes.
int rmsnorm_max_d(int elem_bytes) { return MAX_ROW_BYTES / elem_bytes; }

// The widest row that rmsnorm_regs holds in registers (wider rows take the
// two-pass kernel): 32 * MAX_WPR warps * MAX_NV vectors of 16 bytes.
int rmsnorm_max_register_d(int elem_bytes) {
  return 32 * MAX_WPR * MAX_NV * (16 / elem_bytes);
}

// x: rows of d elements, row r at x + r * x_row_stride (elements);
// w: (d,); out: contiguous (rows, d); all three of one type.  dtype:
// 0 = float32, 1 = bf16.  Returns 0, a CUDA error code, or -1 for a bad
// selector or a row wider than rmsnorm_max_d.
int rmsnorm_launch(const void* x, const void* w, void* out, long long rows,
                   int d, long long x_row_stride, float eps, int dtype,
                   void* stream) {
  if (rows == 0) return 0;
  if (d < 1 || dtype < 0 || dtype > 1 ||
      d > rmsnorm_max_d(dtype == 0 ? 4 : 2))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_typed<float>(x, w, out, rows, d, x_row_stride, eps, s);
  return launch_typed<__nv_bfloat16>(x, w, out, rows, d, x_row_stride, eps,
                                     s);
}

}  // extern "C"
