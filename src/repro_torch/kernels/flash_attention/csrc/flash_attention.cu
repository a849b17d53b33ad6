// Flash attention forward for NVIDIA Hopper (sm_90a):
//
//     out[b, i, h, :] = softmax_j( mask( cap( q_i . k_j / sqrt(hd) ) ) ) v_j
//
// over the model's layout: q (B, Sq, H, hd), k and v (B, Sk, KV, hd), out
// (B, Sq, H, hd), all contiguous, float32 or bf16, with float32 running
// max, sum and accumulator.  Query head h reads kv head h / (H / KV)
// (grouped-query attention without repeating k and v).  The mask keeps key
// j for query i when j < Sk and, if causal, j <= i and, with a window w,
// j > i - w; cap is the optional logit softcap c * tanh(s / c).  A row with
// no key left gives 0, as the TPU kernel's guard on l does.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py:flash_attention_call (body
// _kernel) together with its wrapper's padding and scale correction
// (ops.py:flash_attention): ragged Sq, Sk and head_dim are masked here.
// Its plain PyTorch version is
// src/repro_torch/kernels/flash_attention/ref.py:attention_ref.
//
// What bounds it.  It reads q, k and v once and writes out once, and does
// 4 * hd flops per unmasked (query, key) pair of every head.  For a prefill
// of the serving path (h2o-danube: H = 32, KV = 8, hd = 80, L = 6144,
// causal, window 4096) that is 537 M pairs, 172 GFLOP against 157 MB: it is
// bound by operations.  This kernel runs them on the float32 cores (67
// TFLOP/s), not the tensor cores: a simple kernel that is right first;
// wgmma and bf16 tensor-core tiles are later work.
//
// Design.  One block of 8 warps per (q tile of BQ = 64 rows, head, batch).
// The TPU kernel's sequential kv grid axis becomes a loop inside the block
// over kv tiles of BK = 64 keys, staged in shared memory (converted to
// float32); kv tiles that the causal or window mask empties for the whole
// q tile are never visited (the TPU kernel's block skip), and a warp skips
// a tile that is empty for its own 8 rows.  Each warp owns 8 query rows.
// Scores: lane l computes the scores of keys l and l + 32 for all 8 rows,
// with 16-byte shared-memory loads (the q row is a broadcast; the k rows
// use a row stride of round_up(hd, 8) + 4 floats, which keeps the lanes'
// 16-byte loads free of bank conflicts).  The online softmax keeps m and l
// per row, replicated across the warp (shuffle reductions), and guards
// exp(m_prev - m_new) exactly as the TPU kernel does.  P goes through a
// per-warp shared tile; for P V each lane owns the head dims l + 32 i,
// i < NSLOT = ceil(hd / 32), so any head_dim up to 256 works, and dims past
// hd are masked.  Heavy q tiles (late, under the causal mask) are scheduled
// first.  Shared memory is (BQ + 2 BK) * stride * 4 + 16 KiB: 80 KiB at
// hd = 80, 211 KiB at hd = 256 (dynamic shared memory above 48 KiB).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int R = BQ / WARPS;   // query rows per warp
constexpr int KPL = BK / 32;    // keys per lane
constexpr int MAX_HD = 256;
constexpr float NEG_INF = -1e30f;
constexpr int MAX_DEVICES = 64;

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

__host__ __device__ __forceinline__ int row_stride(int hd) {
  return ((hd + 7) / 8) * 8 + 4;
}

__host__ __device__ __forceinline__ size_t smem_bytes(int hd) {
  return (size_t)(BQ + 2 * BK) * row_stride(hd) * sizeof(float) +
         (size_t)WARPS * R * BK * sizeof(float);
}

// Stage rows [row0, row0 + nrows) of one head of a (B, S, NH, hd) tensor
// into a (nrows, stride) float32 tile; rows past S and columns past hd are 0.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      int b, int row0, int nrows, int S,
                                      int NH, int head, int hd, int stride) {
  for (int e = threadIdx.x; e < nrows * stride; e += THREADS) {
    const int r = e / stride;
    const int c = e - r * stride;
    const int s = row0 + r;
    float val = 0.f;
    if (s < S && c < hd)
      val = to_f32(src[(((long long)b * S + s) * NH + head) * hd + c]);
    dst[e] = val;
  }
}

template <typename T, int NSLOT>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int H, int KV,
                 int Sq, int Sk, int hd, int causal, int window,
                 float softcap, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int stride = row_stride(hd);
  float* Qs = smem;
  float* Ks = Qs + BQ * stride;
  float* Vs = Ks + BK * stride;
  float* Ps = Vs + BK * stride;          // (WARPS, R, BK)

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int qt = gridDim.x - 1 - blockIdx.x;   // heavy (late) tiles first
  const int q0 = qt * BQ;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* Pw = Ps + warp * R * BK;

  stage(Qs, q, b, q0, BQ, Sq, H, h, hd, stride);

  const int wq0 = q0 + warp * R;                     // the warp's first row
  const int wq1 = min(wq0 + R - 1, Sq - 1);          // and its last
  const int blk_q1 = min(q0 + BQ - 1, Sq - 1);
  const int k_end = causal ? min(Sk, blk_q1 + 1) : Sk;
  int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  k_begin = (k_begin / BK) * BK;
  const int cols = ((hd + 3) / 4) * 4;

  float m[R], l[R], acc[R][NSLOT];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < NSLOT; ++i) acc[r][i] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();                                 // last tile's reads done
    stage(Ks, k, b, k0, BK, Sk, KV, kvh, hd, stride);
    stage(Vs, v, b, k0, BK, Sk, KV, kvh, hd, stride);
    __syncthreads();

    bool run = wq0 < Sq;
    if (causal) run = run && k0 <= wq1;
    if (window > 0) run = run && (k0 + BK - 1) > wq0 - window;
    if (!run) continue;                              // warp-uniform

    // ---- scores s[r][j] = q_r . k_(lane + 32 j) -------------------------
    float s[R][KPL];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < KPL; ++j) s[r][j] = 0.f;
    for (int c = 0; c < cols; c += 4) {
      float4 kv[KPL];
#pragma unroll
      for (int j = 0; j < KPL; ++j)
        kv[j] = *reinterpret_cast<const float4*>(
            &Ks[(lane + 32 * j) * stride + c]);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(
            &Qs[(warp * R + r) * stride + c]);
#pragma unroll
        for (int j = 0; j < KPL; ++j) {
          float a = s[r][j];
          a = fmaf(qv.x, kv[j].x, a);
          a = fmaf(qv.y, kv[j].y, a);
          a = fmaf(qv.z, kv[j].z, a);
          a = fmaf(qv.w, kv[j].w, a);
          s[r][j] = a;
        }
      }
    }

    // ---- mask, online softmax, P to shared memory -------------------------
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int qp = wq0 + r;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        const int kp = k0 + lane + 32 * j;
        float x = s[r][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        bool ok = kp < Sk && qp < Sq;
        if (causal) ok = ok && kp <= qp;
        if (window > 0) ok = ok && kp > qp - window;
        x = ok ? x : NEG_INF;
        s[r][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const bool live = m_new > NEG_INF / 2;
      const float alpha = m[r] > NEG_INF / 2 ? expf(m[r] - m_new) : 0.f;
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        const float p = live ? expf(s[r][j] - m_new) : 0.f;
        Pw[r * BK + lane + 32 * j] = p;
        psum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[r] = alpha * l[r] + psum;
#pragma unroll
      for (int i = 0; i < NSLOT; ++i) acc[r][i] *= alpha;
      m[r] = m_new;
    }
    __syncwarp();

    // ---- acc += P V: lane owns head dims lane + 32 i ----------------------
    for (int jj = 0; jj < BK; jj += 4) {
      float4 p4[R];
#pragma unroll
      for (int r = 0; r < R; ++r)
        p4[r] = *reinterpret_cast<const float4*>(&Pw[r * BK + jj]);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
#pragma unroll
        for (int i = 0; i < NSLOT; ++i) {
          const int dd = lane + 32 * i;
          const float vv = dd < hd ? Vs[(jj + t) * stride + dd] : 0.f;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float p = t == 0 ? p4[r].x : t == 1 ? p4[r].y
                          : t == 2 ? p4[r].z : p4[r].w;
            acc[r][i] = fmaf(p, vv, acc[r][i]);
          }
        }
      }
    }
    __syncwarp();
  }

  // ---- out = acc / l (0 for a row with no key) -----------------------------
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int qp = wq0 + r;
    if (qp >= Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    T* orow = out + (((long long)b * Sq + qp) * H + h) * hd;
#pragma unroll
    for (int i = 0; i < NSLOT; ++i) {
      const int dd = lane + 32 * i;
      if (dd < hd) orow[dd] = from_f32<T>(acc[r][i] / denom);
    }
  }
}

template <typename T, int NSLOT>
int launch_nslot(const void* q, const void* k, const void* v, void* out,
                 int B, int H, int KV, int Sq, int Sk, int hd, int causal,
                 int window, float softcap, float scale, cudaStream_t s) {
  const size_t smem = smem_bytes(hd);
  auto kernel = flash_fwd_kernel<T, NSLOT>;
  // Allow the largest tile this instantiation uses (hd = 32 * NSLOT), once
  // per device: the first launch on a device sets it, so a launch captured
  // into a CUDA graph later makes no attribute call.
  static bool configured[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return -1;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes(32 * NSLOT));
    if (err != cudaSuccess) return (int)err;
    configured[dev] = true;
  }
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kernel<<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), H, KV, Sq, Sk, hd,
      causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_typed(const void* q, const void* k, const void* v, void* out,
                 int B, int H, int KV, int Sq, int Sk, int hd, int causal,
                 int window, float softcap, float scale, cudaStream_t s) {
#define FLASH_CASE(N)                                                        \
  case N:                                                                    \
    return launch_nslot<T, N>(q, k, v, out, B, H, KV, Sq, Sk, hd, causal,    \
                              window, softcap, scale, s);
  switch ((hd + 31) / 32) {
    FLASH_CASE(1)
    FLASH_CASE(2)
    FLASH_CASE(3)
    FLASH_CASE(4)
    FLASH_CASE(5)
    FLASH_CASE(6)
    FLASH_CASE(7)
    FLASH_CASE(8)
    default:
      return -1;
  }
#undef FLASH_CASE
}

}  // namespace

extern "C" {

int flash_attention_max_head_dim() { return MAX_HD; }

// q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd); out: (B, Sq, H, hd); all
// contiguous.  dtype: 0 = float32, 1 = bf16.  window <= 0: no window;
// softcap <= 0: no softcap.  Returns 0, a CUDA error code, or -1 for
// arguments the kernel does not take.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int B, int H, int KV, int Sq, int Sk,
                           int hd, int causal, int window, float softcap,
                           float scale, int dtype, void* stream) {
  if (hd < 1 || hd > MAX_HD || KV < 1 || H % KV != 0) return -1;
  if (B == 0 || H == 0 || Sq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_typed<float>(q, k, v, out, B, H, KV, Sq, Sk, hd, causal,
                               window, softcap, scale, s);
  if (dtype == 1)
    return launch_typed<__nv_bfloat16>(q, k, v, out, B, H, KV, Sq, Sk, hd,
                                       causal, window, softcap, scale, s);
  return -1;
}

}  // extern "C"
