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
// output once: (streams + 1) * m * d * 4 bytes, against 2 * m * m * d flops
// for the mix.  At 2 m flops per 20 bytes it is memory-bound at every m
// this kernel takes (m <= 64).
//   * At the paper's width (m = 8, d = 1024, rule svrg) the 160 KiB take
//     about 0.05 us at 3.35 TB/s: the launch bounds the step.  What is left
//     to the kernel is its own latency chain, so a block brings its whole
//     tile in ONE round of loads (the stream tiles, W and alpha together),
//     and the work spreads over many blocks, 32 there, not 8.
//   * At large d, (8, 131072) for example, the bytes bound it: every SM
//     needs enough loads in flight, which many small blocks give.
//
// Layout.  A block owns a tile of COLS = 32 columns of all m rows.  Its
// threads form a (rows x TX) grid: thread (ty, tx) holds VEC consecutive
// columns, VEC = 4 (16-byte vector loads and stores, used when d % 4 == 0
// and every stream is 16-byte aligned; d = 1000 takes it, with a last tile
// of 8 columns) or VEC = 1 (the scalar path for the rest), so TX = COLS /
// VEC and the lanes of a warp read neighbouring addresses of a row.
//   1. Thread (ty, tx) loads its VEC columns of row k = ty (and k = ty +
//      ROWS, ... when m > ROWS) from every stream, while the block loads W
//      (m*m floats) into shared memory and every thread reads alpha: all
//      loads of the tile are in flight at once.  It forms q[k, :] and
//      stores it into a shared (m, COLS) tile.
//   2. After one barrier, thread (ty, tx) computes z[i, :] for the same
//      rows i from W's row i and the whole q tile, applies the prox and
//      writes its VEC outputs with one store.
// Loads and stores carry no cache hint: with streaming (evict-first)
// stores, writing each call's new output buffer took a third longer at
// (8, 131072) on the H100 (benchmarks/pt_fused_step_ab.py, PERF.md).
// The node count m is a template parameter for the common counts 8 and 16
// (one row a thread; the k loops unroll fully) and a runtime value for the
// other m <= 64 (32 row threads, each over up to 2 rows: the row loop still
// unrolls, guarded; with 4 rows a thread one instantiation spilled).  Rule, prox and VEC are template parameters too:
// 3 x 2 x 2 x 3 = 36 instantiations behind one C entry point with plain int
// selectors.  The ragged column edge is masked at VEC granularity.
//
// Rounding.  The elementwise steps use the _rn intrinsics so that nvcc does
// not contract them into FMAs: v, q and the threshold alpha*lam round as the
// plain PyTorch version rounds them (alpha*lam is one float32 product, as in
// the reference, so a coordinate at the l1 threshold lands on the same
// side).  Only the mix accumulates with FMAs, fmaf(W[i,k], q[k], z) from
// z = 0 in k order.  Every output is therefore the same bits whatever the
// layout, m instantiation or VEC.
//
// alpha comes either by value or, when alpha_ptr is not null, from device
// memory: the resident runner keeps its staged step sizes on the card, so a
// step never waits for the host.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_M = 64;
constexpr int COLS = 32;        // columns of a block's tile
constexpr int GEN_ROWS = 32;    // row threads of the runtime-m instantiation
constexpr int GEN_REPS = MAX_M / GEN_ROWS;   // rows a thread holds, at most

enum Rule { kSvrg = 0, kSgd = 1 };
enum ProxKind { kL1 = 0, kSql2 = 1, kNone = 2 };

template <int VEC> struct Vec;
template <> struct Vec<4> { using T = float4; };
template <> struct Vec<1> { using T = float; };

__device__ __forceinline__ float lane(const float4& v, int c) {
  return c == 0 ? v.x : (c == 1 ? v.y : (c == 2 ? v.z : v.w));
}
__device__ __forceinline__ float lane(const float& v, int) { return v; }
__device__ __forceinline__ void set_lane(float4& v, int c, float f) {
  if (c == 0) v.x = f; else if (c == 1) v.y = f; else if (c == 2) v.z = f;
  else v.w = f;
}
__device__ __forceinline__ void set_lane(float& v, int, float f) { v = f; }

template <int VEC>
__device__ __forceinline__ typename Vec<VEC>::T load(const float* p) {
  return *reinterpret_cast<const typename Vec<VEC>::T*>(p);
}

template <int RULE>
__device__ __forceinline__ float step_q(float x, float g0, float g1, float g2,
                                        float alpha) {
  const float v = RULE == kSvrg ? __fadd_rn(__fsub_rn(g0, g1), g2) : g0;
  return __fsub_rn(x, __fmul_rn(alpha, v));
}

template <int PROX>
__device__ __forceinline__ float apply_prox(float z, float t) {
  if (PROX == kL1) {
    // sign(z) * max(|z| - t, 0), as the plain version: NaN stays NaN
    const float sign = z > 0.0f ? 1.0f : (z < 0.0f ? -1.0f : z);
    return __fmul_rn(sign, fmaxf(__fsub_rn(fabsf(z), t), 0.0f));
  } else if (PROX == kSql2) {
    return __fdiv_rn(z, __fadd_rn(1.0f, t));
  }
  return z;
}

// z[c] += W[i, k] * q[k, tx * VEC + c], one FMA a column, in k order
template <int VEC>
__device__ __forceinline__ void mix_term(const float* w_s, const float* q_s,
                                         int i, int m, int k, int tx,
                                         float* z) {
  using T = typename Vec<VEC>::T;
  const float wik = w_s[i * m + k];
  const T q = *reinterpret_cast<const T*>(&q_s[k * COLS + tx * VEC]);
#pragma unroll
  for (int c = 0; c < VEC; ++c) z[c] = fmaf(wik, lane(q, c), z[c]);
}

// M > 0: m == M, ROWS = M row threads, one row each.  M == 0: runtime m,
// ROWS = GEN_ROWS row threads, row k = ty + r * GEN_ROWS for r < GEN_REPS.
template <int M> struct Rows {
  static constexpr int kRows = M;
  static constexpr int kReps = 1;
  static constexpr int kTile = M;        // rows of the shared tiles
};
template <> struct Rows<0> {
  static constexpr int kRows = GEN_ROWS;
  static constexpr int kReps = GEN_REPS;
  static constexpr int kTile = MAX_M;
};

template <int M, int VEC>
__host__ __device__ constexpr int threads_of() {
  return Rows<M>::kRows * (COLS / VEC);
}

template <int M, int VEC, int RULE, int PROX>
__global__ void __launch_bounds__(Rows<M>::kRows * (COLS / VEC))
fused_step_kernel(const float* __restrict__ w, const float* __restrict__ x,
                  const float* __restrict__ g0, const float* __restrict__ g1,
                  const float* __restrict__ g2, float* __restrict__ out,
                  int m_arg, long long d, const float* __restrict__ alpha_ptr,
                  float alpha_val, float lam) {
  using T = typename Vec<VEC>::T;
  constexpr int TX = COLS / VEC;
  constexpr int ROWS = Rows<M>::kRows;
  constexpr int REPS = Rows<M>::kReps;
  constexpr int TILE = Rows<M>::kTile;
  constexpr int THREADS = threads_of<M, VEC>();
  const int m = M > 0 ? M : m_arg;

  __shared__ __align__(16) float w_s[TILE * TILE];
  __shared__ __align__(16) float q_s[TILE * COLS];

  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const long long j = (long long)blockIdx.x * COLS + (long long)tx * VEC;
  const bool live = j < d;     // d % VEC == 0 on the vector path

  // ---- one round of loads: alpha, W and every stream of the tile --------
  const float alpha = alpha_ptr != nullptr ? __ldg(alpha_ptr) : alpha_val;
  T xr[REPS], a0[REPS], a1[REPS], a2[REPS];
#pragma unroll
  for (int r = 0; r < REPS; ++r) {
    const int k = ty + r * ROWS;
    if (live && (M > 0 || k < m)) {
      const long long idx = (long long)k * d + j;
      xr[r] = load<VEC>(x + idx);
      a0[r] = load<VEC>(g0 + idx);
      if (RULE == kSvrg) {
        a1[r] = load<VEC>(g1 + idx);
        a2[r] = load<VEC>(g2 + idx);
      }
    }
  }
  if constexpr (M > 0) {
    // at most two floats of W a thread: held in registers until q is formed
    constexpr int W_PER = (M * M + THREADS - 1) / THREADS;
    float w_r[W_PER];
#pragma unroll
    for (int r = 0; r < W_PER; ++r) {
      const int e = threadIdx.x + r * THREADS;
      w_r[r] = e < M * M ? __ldg(w + e) : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < W_PER; ++r) {
      const int e = threadIdx.x + r * THREADS;
      if (e < M * M) w_s[e] = w_r[r];
    }
  } else {
#pragma unroll 4
    for (int e = threadIdx.x; e < m * m; e += THREADS) w_s[e] = __ldg(w + e);
  }

  // ---- q into the shared tile ---------------------------------------------
#pragma unroll
  for (int r = 0; r < REPS; ++r) {
    const int k = ty + r * ROWS;
    if (live && (M > 0 || k < m)) {
      T q;
#pragma unroll
      for (int c = 0; c < VEC; ++c) {
        const float s1 = RULE == kSvrg ? lane(a1[r], c) : 0.0f;
        const float s2 = RULE == kSvrg ? lane(a2[r], c) : 0.0f;
        set_lane(q, c, step_q<RULE>(lane(xr[r], c), lane(a0[r], c), s1, s2,
                                    alpha));
      }
      *reinterpret_cast<T*>(&q_s[k * COLS + tx * VEC]) = q;
    }
  }
  __syncthreads();
  if (!live) return;

  // ---- z = W q over the tile, the prox, one store per row ----------------
  const float t = __fmul_rn(alpha, lam);
#pragma unroll
  for (int r = 0; r < REPS; ++r) {
    const int i = ty + r * ROWS;
    if (M == 0 && i >= m) break;
    float z[VEC];
#pragma unroll
    for (int c = 0; c < VEC; ++c) z[c] = 0.0f;
    if constexpr (M > 0) {
#pragma unroll
      for (int k = 0; k < M; ++k) mix_term<VEC>(w_s, q_s, i, M, k, tx, z);
    } else {
#pragma unroll 4
      for (int k = 0; k < m; ++k) mix_term<VEC>(w_s, q_s, i, m, k, tx, z);
    }
    T o;
#pragma unroll
    for (int c = 0; c < VEC; ++c) set_lane(o, c, apply_prox<PROX>(z[c], t));
    *reinterpret_cast<T*>(out + (long long)i * d + j) = o;
  }
}

template <int M, int VEC, int RULE, int PROX>
void launch(const float* w, const float* x, const float* g0, const float* g1,
            const float* g2, float* out, int m, long long d,
            const float* alpha_ptr, float alpha_val, float lam,
            cudaStream_t stream) {
  const long long blocks = (d + COLS - 1) / COLS;
  fused_step_kernel<M, VEC, RULE, PROX>
      <<<(unsigned)blocks, threads_of<M, VEC>(), 0, stream>>>(
          w, x, g0, g1, g2, out, m, d, alpha_ptr, alpha_val, lam);
}

template <int M, int VEC, int RULE>
int dispatch_prox(int prox, const float* w, const float* x, const float* g0,
                  const float* g1, const float* g2, float* out, int m,
                  long long d, const float* alpha_ptr, float alpha_val,
                  float lam, cudaStream_t stream) {
  switch (prox) {
    case kL1:
      launch<M, VEC, RULE, kL1>(w, x, g0, g1, g2, out, m, d, alpha_ptr,
                                alpha_val, lam, stream);
      return 0;
    case kSql2:
      launch<M, VEC, RULE, kSql2>(w, x, g0, g1, g2, out, m, d, alpha_ptr,
                                  alpha_val, lam, stream);
      return 0;
    case kNone:
      launch<M, VEC, RULE, kNone>(w, x, g0, g1, g2, out, m, d, alpha_ptr,
                                  alpha_val, lam, stream);
      return 0;
  }
  return -1;
}

template <int M, int VEC>
int dispatch_rule(int rule, int prox, const float* w, const float* x,
                  const float* g0, const float* g1, const float* g2,
                  float* out, int m, long long d, const float* alpha_ptr,
                  float alpha_val, float lam, cudaStream_t stream) {
  if (rule == kSvrg)
    return dispatch_prox<M, VEC, kSvrg>(prox, w, x, g0, g1, g2, out, m, d,
                                        alpha_ptr, alpha_val, lam, stream);
  if (rule == kSgd)
    return dispatch_prox<M, VEC, kSgd>(prox, w, x, g0, g1, g2, out, m, d,
                                       alpha_ptr, alpha_val, lam, stream);
  return -1;
}

template <int VEC>
int dispatch_m(int rule, int prox, const float* w, const float* x,
               const float* g0, const float* g1, const float* g2, float* out,
               int m, long long d, const float* alpha_ptr, float alpha_val,
               float lam, cudaStream_t stream) {
  switch (m) {
    case 8:
      return dispatch_rule<8, VEC>(rule, prox, w, x, g0, g1, g2, out, m, d,
                                   alpha_ptr, alpha_val, lam, stream);
    case 16:
      return dispatch_rule<16, VEC>(rule, prox, w, x, g0, g1, g2, out, m, d,
                                    alpha_ptr, alpha_val, lam, stream);
    default:
      return dispatch_rule<0, VEC>(rule, prox, w, x, g0, g1, g2, out, m, d,
                                   alpha_ptr, alpha_val, lam, stream);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

__global__ void noop_kernel() {}

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
  const bool vec = d % 4 == 0 && aligned16(x) && aligned16(g0) &&
                   aligned16(out) &&
                   (rule != kSvrg || (aligned16(g1) && aligned16(g2)));
  const int rc = vec ? dispatch_m<4>(rule, prox, w, x, g0, g1, g2, out, m, d,
                                     alpha_ptr, alpha_val, lam, s)
                     : dispatch_m<1>(rule, prox, w, x, g0, g1, g2, out, m, d,
                                     alpha_ptr, alpha_val, lam, s);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

// An empty kernel on one block: the launch floor that fused_step's time is
// read against.
int fused_step_noop_launch(void* stream) {
  noop_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
