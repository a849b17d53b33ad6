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
// causal, window 4096) that is 537 M pairs, 172 GFLOP against 157 MB (79
// MB in bf16): it is bound by operations, 2.56 ms at the 67 TFLOP/s of the
// float32 cores, 0.174 ms at the 989 TFLOP/s of the bf16 tensor cores.
//
// Two kernels behind one entry point, chosen by dtype:
//
// float32: flash_fwd_f32, on the CUDA cores (there is no float32
// tensor-core product that keeps float32's precision; 3xTF32 is not
// tried).  Every product is an FFMA, and an SM issues at most one warp
// instruction a cycle per scheduler, so each shared-memory load, shuffle
// or exponential in the inner loops takes the slot of an FFMA: the design
// keeps the ratio of loads to FFMAs low, as an SGEMM does.
//   * One block of 256 threads per (q tile of BQ rows, head, batch): BQ =
//     128 up to hd_pad 128, 64 above; hd_pad = round_up(hd, 16), so the
//     models' head dims (64, 80, 128, 256) compute no padding.  The TPU
//     kernel's sequential kv grid axis is a loop over kv tiles of BK keys,
//     64 up to hd_pad 112, 32 above.  Thread (ty, tx) = (threadIdx / 16,
//     threadIdx % 16) owns the TM = BQ / 16 query rows ty TM .., the keys
//     tx + 16 j, j < BK / 16, of every tile, and the head dims tx + 16 i,
//     i < hd_pad / 16, of the output: the 16 threads of a row are one
//     half-warp.
//   * S = Q K^T as register micro-tiles: per 4 head dims a thread loads
//     TM 16-byte rows of Q (a broadcast over its half-warp) and BK / 16 of
//     K and does TM BK / 4 FFMAs (12 loads for 128 FFMAs at TM = 8, BK =
//     64).  Q, K and V keep the model's row layout (hd contiguous), rows
//     hd_pad + 4 floats apart, so the 16-byte loads of 8 neighbouring rows
//     hit distinct banks.
//   * The online softmax runs on the register tile in the exp2 domain
//     (one FFMA folds the scale and the max, then the bare MUFU.EX2): the
//     row max is reduced over the row's 16 threads by shuffles; each thread
//     keeps its own share of the row sum, reduced once at the end.  The
//     softcap is a uniform branch outside the per-element loop; the mask is
//     applied only on tiles that straddle the diagonal, the window edge or
//     the ragged Sk; the accumulator is rescaled only when some row of the
//     warp has a new max.  The guards are the TPU kernel's: m_new >
//     NEG_INF / 2, alpha = 0 on a row's first live tile, 0 for a row with
//     no key.
//   * O += P V: P goes to shared memory transposed (key-major; 16-byte
//     stores) and stays inside the half-warp that owns the rows, so a
//     __syncwarp orders it.  Per key a thread loads TM / 4 16-byte
//     vectors of P and hd_pad / 16 scalars of V (16 consecutive floats per
//     half-warp) and does TM hd_pad / 16 FFMAs (7 loads for 40 FFMAs at hd
//     80).
//   * K/V tiles arrive in a ring of two stages by 16-byte cp.async (.cg)
//     copies: tile t + 1's copies are issued right after the one barrier
//     of tile t, so they land while tile t is computed; rows past Sk and
//     chunks past hd are zero-filled by a source size of 0.  hd % 4 != 0
//     or a misaligned operand takes ordinary loads into the same layout.
//   * kv tiles that the causal or window mask empties for the whole q tile
//     are never visited (the TPU kernel's block skip), a warp skips a tile
//     that is empty for its own rows, and heavy q tiles (late, under the
//     causal mask) are scheduled first.
//   * Shared memory: (BQ + 4 BK) (hd_pad + 4) + BK (BQ + 4) floats,
//     159 KiB at hd 80, 203.5 KiB at hd 256: one block of 8 warps an SM,
//     whose registers are not capped (228 a thread at hd 80; no
//     instantiation spills).  Two blocks an SM, with 32-key tiles and 128
//     registers, spilled and ran slower.
//
// bf16: flash_fwd_wgmma, on the tensor cores.  Both products are Hopper's
// warpgroup MMA (wgmma.mma_async, bf16 operands, float32 accumulators in
// registers).  One block of two warpgroups (256 threads) per (q tile of
// BQ = 128 rows, head, batch); each warpgroup owns 64 query rows.  The kv
// loop, the block skip and the heavy-first order are the float32 kernel's,
// over tiles of BK = 64 keys, and a warpgroup skips a tile that is empty
// for its own 64 rows.
//   * Shared memory holds Q (128 rows) and a ring of K/V stages (64 rows
//     each; three stages up to hd_pad 128, two above), every row padded
//     with zeros to hd_pad = round_up(hd, 16), in the descriptors'
//     no-swizzle ("interleave") layout: 8-row x 16-byte core matrices of
//     128 contiguous bytes, the core matrices of one 8-row group side by
//     side.  No swizzle mode is used because the 32-,
//     64- and 128-byte swizzles want rows of 16, 32 or 64 bf16 and hd_pad
//     is 80 or 160 at the models' head dims; the interleaved layout takes
//     any multiple of 8 and its 128-byte core matrices are read without
//     bank conflicts.  hd = 256: 64 KiB of Q + 2 x 2 x 32 KiB of K/V =
//     192 KiB of the 227 KiB a block may use.
//   * K/V tiles arrive by cp.async (16 bytes, .cg), not TMA: a thread puts
//     each 16-byte chunk straight into its core-matrix slot, rows past Sk
//     and chunks past hd are zero-filled by a source size of 0 (so no
//     stale or NaN data reaches P V), and no tensor map
//     (cuTensorMapEncodeTiled on the host, strides in multiples of 16
//     bytes) is needed per call.  The copies of tile
//     t + stages - 1 are issued before the products of tile t; one barrier
//     per tile both publishes tile t (after fence.proxy.async, since wgmma
//     reads shared memory through the async proxy) and frees tile t - 1's
//     stage for them.  Each thread's chunks keep one position in every
//     tile, so their offsets are computed once.
//     hd % 8 != 0 or a misaligned operand takes ordinary loads instead.
//   * S = Q K^T: m64n64k16, A = Q and B = K from shared memory, both
//     K-major (hd contiguous), hd_pad / 16 steps (5 at hd = 80).
//   * The softmax runs in the accumulator's registers: each thread holds
//     two rows (r and r + 8 of its warp's 16) x 16 keys, row max and sum
//     over the row's four threads by quad shuffles, in the exp2 domain.
//     The mask is applied only on tiles that straddle the diagonal, the
//     window edge or the ragged Sk; the guards are the float32 kernel's
//     (m_new > NEG_INF / 2, alpha = 0 on a row's first live tile).  exp2
//     is the bare MUFU.EX2 (ex2.approx.ftz), and the accumulator is
//     rescaled only when some row of the warp has a new max.
//   * O += P V: m64n(hd_pad)k16 with A = P from registers, rounded to bf16
//     (the accumulator layout of S is the A-operand layout of P, four
//     registers per 16 keys), and B = V from shared memory, MN-major (hd
//     contiguous), read through the transpose bit.  l sums the unrounded
//     p, so the output's error over the float32 formula is at most 2^-9 of
//     sum_j p_j |v_j| / l from P plus its own rounding to bf16
//     (ref.py:bf16_bound).
//   * Epilogue: out = acc / max(l, 1e-30), rounded once to bf16, masked to
//     Sq and hd.
// Registers: acc is hd_pad / 2 floats a thread (128 at hd = 256), S 32.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_HD = 256;
constexpr float NEG_INF = -1e30f;
constexpr int MAX_DEVICES = 64;

// ===========================================================================
// float32: flash_fwd_f32, on the CUDA cores (see the header)
// ===========================================================================

namespace cc {

constexpr int THREADS = 256;
constexpr int STAGES = 2;               // K/V tiles in the ring
// keys per K/V tile: 64 up to hd_pad 112, 32 above, which keeps hd_pad 128
// and 256 within the 227 KiB a block may use
template <int HDP>
__host__ __device__ constexpr int bk() {
  return HDP <= 112 ? 64 : 32;
}
constexpr float LOG2E = 1.4426950408889634f;

// query rows per thread (TM) and per block (BQ = 16 TM): 128-row blocks up
// to hd_pad 128, 64-row blocks above, which keeps hd 256 within 227 KiB
template <int HDP>
__host__ __device__ constexpr int tm() {
  return HDP <= 128 ? 8 : 4;
}

template <int HDP>
__host__ __device__ constexpr int bq() {
  return 16 * tm<HDP>();
}

// Q (BQ rows), the K and V ring (STAGES x BK rows each), rows of hd_pad + 4
// floats, and P^T (BK rows of BQ + 4 floats)
template <int HDP>
__host__ __device__ constexpr size_t smem_bytes() {
  return ((size_t)(bq<HDP>() + 2 * STAGES * bk<HDP>()) * (HDP + 4) +
          (size_t)bk<HDP>() * (bq<HDP>() + 4)) * sizeof(float);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// 2^x on the special-function unit (MUFU.EX2, relative error ~2^-22);
// x below -126 gives 0, as a probability that small should.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Rows [row0, row0 + ROWS) of one head of a (B, S, heads, hd) tensor into
// a (ROWS, hd_pad + 4) float32 tile; rows past S and columns past hd are
// zeros.  vec (hd % 4 == 0, 16-byte aligned operands): 16-byte cp.async
// copies, which the caller commits, zero-filled by a source size of 0;
// else ordinary loads and stores.  A thread's chunks sit at the same
// places in every tile (a fixed trip count), so their offsets are
// computed once.
template <int ROWS, int HDP>
__device__ __forceinline__ void load_rows(float* dst,
                                          const float* __restrict__ src,
                                          long long row_stride, int row0,
                                          int S, int hd, bool vec) {
  constexpr int LD = HDP + 4;
  if (vec) {
    constexpr int HC = HDP / 4;   // 16-byte chunks of a row
    constexpr int CHUNKS = ROWS * HC;
    constexpr int PER_THREAD = (CHUNKS + THREADS - 1) / THREADS;
    const uint32_t base = smem_addr(dst);
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
      const int e = threadIdx.x + i * THREADS;
      if (CHUNKS % THREADS == 0 || e < CHUNKS) {
        const int r = e / HC;
        const int c = e - r * HC;
        const int s = row0 + r;
        const bool ok = s < S && 4 * c < hd;
        // a 32-bit offset from the tile's first row (r < 128 rows of at
        // most 65,535 heads x 256 dims), so the offsets a thread keeps
        // across the kv loop take one register each
        const float* p = src + (long long)row0 * row_stride +
                         (uint32_t)(r * (uint32_t)row_stride + 4 * c);
        cp_async16(base + 4 * (r * LD + 4 * c), ok ? p : src, ok ? 16 : 0);
      }
    }
    return;
  }
  for (int e = threadIdx.x; e < ROWS * HDP; e += THREADS) {
    const int r = e / HDP;
    const int c = e - r * HDP;
    const int s = row0 + r;
    dst[r * LD + c] =
        s < S && c < hd ? src[(long long)s * row_stride + c] : 0.f;
  }
}

// one block an SM, stated: without it ptxas caps hd_pad 144-240 at 128
// registers (two blocks) and spills
template <int HDP>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out, int H,
              int KV, int Sq, int Sk, int hd, int causal, int window,
              float softcap, float scale, int vec) {
  constexpr int TM = tm<HDP>();
  constexpr int BQ = bq<HDP>();
  constexpr int BK = bk<HDP>();
  constexpr int TN = BK / 16;      // keys per thread in S = Q K^T
  constexpr int LD = HDP + 4;      // row stride of Q, K and V, floats
  constexpr int PLD = BQ + 4;      // row stride of P^T
  constexpr int TD = HDP / 16;     // head dims per thread in O
  // P V unrolled in steps of 32 keys up to hd_pad 128, of 8 above (TM =
  // 4, up to 16 head dims a thread): a 64-key tile unrolled whole ran
  // slower at hd 80
  constexpr int PV_UNROLL = HDP <= 128 ? 32 : 8;
  extern __shared__ __align__(16) float smem_cc[];
  float* Qs = smem_cc;
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + STAGES * BK * LD;
  float* Pt = Vs + STAGES * BK * LD;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heavy (late) first
  const int kvh = h / (H / KV);
  const int tx = threadIdx.x & 15;   // keys tx + 16 j of S, dims tx + 16 i
  const int ty = threadIdx.x >> 4;   // rows ty TM .. ty TM + TM - 1
  const int warp = threadIdx.x >> 5;
  const int row0 = q0 + ty * TM;                     // this thread's rows
  const int wq0 = q0 + warp * 2 * TM;                // and its warp's
  const int wq1 = min(wq0 + 2 * TM - 1, Sq - 1);
  const int blk_q1 = min(q0 + BQ - 1, Sq - 1);
  const int k_end = causal ? min(Sk, blk_q1 + 1) : Sk;
  int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  k_begin = (k_begin / BK) * BK;
  const int ntiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  // each operand's row 0 of this (batch, head)
  const float* qh = q + ((long long)b * Sq * H + h) * hd;
  const float* kh = k + ((long long)b * Sk * KV + kvh) * hd;
  const float* vh = v + ((long long)b * Sk * KV + kvh) * hd;
  const long long q_stride = (long long)H * hd;
  const long long kv_stride = (long long)KV * hd;
  // prologue: Q with K/V tile 0 in one copy group
  load_rows<BQ, HDP>(Qs, qh, q_stride, q0, Sq, hd, vec);
  if (ntiles > 0) {
    load_rows<BK, HDP>(Ks, kh, kv_stride, k_begin, Sk, hd, vec);
    load_rows<BK, HDP>(Vs, vh, kv_stride, k_begin, Sk, hd, vec);
  }
  cp_async_commit();

  // The scores go to the exp2 domain as x * mult: x is s itself, or
  // tanh(s * scale / softcap) under a softcap.
  const float mult = softcap > 0.f ? softcap * LOG2E : scale * LOG2E;
  const float cap_in = softcap > 0.f ? scale / softcap : 0.f;
  float o[TM][TD];
  float m[TM], l[TM];   // row maxima (exp2 domain); this thread's row sums
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < TD; ++i) o[r][i] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = k_begin + t * BK;
    const float* Kt = Ks + (t % STAGES) * BK * LD;
    const float* Vt = Vs + (t % STAGES) * BK * LD;
    cp_async_wait_all();
    __syncthreads();   // tile t is in; every warp is done with tile t - 1
    if (t + 1 < ntiles) {   // into the stage that tile t - 1 used
      const int st = (t + 1) % STAGES;
      load_rows<BK, HDP>(Ks + st * BK * LD, kh, kv_stride, k0 + BK, Sk, hd,
                         vec);
      load_rows<BK, HDP>(Vs + st * BK * LD, vh, kv_stride, k0 + BK, Sk, hd,
                         vec);
    }
    cp_async_commit();

    bool run = wq0 < Sq;
    if (causal) run = run && k0 <= wq1;
    if (window > 0) run = run && (k0 + BK - 1) > wq0 - window;
    if (!run) continue;   // warp-uniform

    // ---- S = Q K^T: TM rows x TN keys a thread, 16-byte loads along hd ----
    float s[TM][TN];
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[r][j] = 0.f;
#pragma unroll
    for (int c = 0; c < HDP; c += 4) {
      float4 kf[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j)
        kf[j] = *reinterpret_cast<const float4*>(Kt + (tx + 16 * j) * LD + c);
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const float4 qf =
            *reinterpret_cast<const float4*>(Qs + (ty * TM + r) * LD + c);
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          float a = s[r][j];
          a = fmaf(qf.x, kf[j].x, a);
          a = fmaf(qf.y, kf[j].y, a);
          a = fmaf(qf.z, kf[j].z, a);
          a = fmaf(qf.w, kf[j].w, a);
          s[r][j] = a;
        }
      }
    }

    // ---- softcap, mask, online softmax --------------------------------------
    if (softcap > 0.f) {
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int j = 0; j < TN; ++j) s[r][j] = tanhf(s[r][j] * cap_in);
    }
    if (k0 + BK > Sk || (causal && k0 + BK - 1 > wq0) ||
        (window > 0 && k0 <= wq1 - window)) {   // the tile straddles an edge
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const int qp = row0 + r;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int kp = k0 + tx + 16 * j;
          bool ok = kp < Sk;
          if (causal) ok = ok && kp <= qp;
          if (window > 0) ok = ok && kp > qp - window;
          s[r][j] = ok ? s[r][j] : NEG_INF;
        }
      }
    }
    bool moved = false;
    float alpha[TM];
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      float mx = s[r][0];
#pragma unroll
      for (int j = 1; j < TN; ++j) mx = fmaxf(mx, s[r][j]);
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)   // the row's 16 threads
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx > NEG_INF / 2 ? mx * mult : NEG_INF);
      alpha[r] = m[r] > NEG_INF / 2 ? fast_exp2(m[r] - m_new) : 0.f;
      moved = moved || alpha[r] != 1.f;
      // a row with no live key yet: every x is NEG_INF and p = 2^-huge = 0
      const float msub = m_new > NEG_INF / 2 ? m_new : 0.f;
      m[r] = m_new;
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        s[r][j] = fast_exp2(fmaf(s[r][j], mult, -msub));
        psum += s[r][j];
      }
      l[r] = alpha[r] * l[r] + psum;
    }
    // P^T to shared memory: the rows of a thread are its half-warp's, so
    // the exchange stays inside the warp
#pragma unroll
    for (int j = 0; j < TN; ++j)
#pragma unroll
      for (int r = 0; r < TM; r += 4)
        *reinterpret_cast<float4*>(Pt + (tx + 16 * j) * PLD + ty * TM + r) =
            make_float4(s[r][j], s[r + 1][j], s[r + 2][j], s[r + 3][j]);
    // the accumulator needs rescaling only where a row's max moved
    if (__any_sync(0xffffffffu, moved)) {
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int i = 0; i < TD; ++i) o[r][i] *= alpha[r];
    }
    __syncwarp();

    // ---- O += P V: TM rows x TD head dims (tx + 16 i) a thread -----------
#pragma unroll PV_UNROLL
    for (int kk = 0; kk < BK; ++kk) {
      float p[TM];
#pragma unroll
      for (int r = 0; r < TM; r += 4) {
        const float4 pf =
            *reinterpret_cast<const float4*>(Pt + kk * PLD + ty * TM + r);
        p[r] = pf.x;
        p[r + 1] = pf.y;
        p[r + 2] = pf.z;
        p[r + 3] = pf.w;
      }
#pragma unroll
      for (int i = 0; i < TD; ++i) {
        const float vv = Vt[kk * LD + tx + 16 * i];
#pragma unroll
        for (int r = 0; r < TM; ++r) o[r][i] = fmaf(p[r], vv, o[r][i]);
      }
    }
  }
  cp_async_wait_all();   // no copy outlives the block

  // ---- out = acc / l (0 for a row with no key) -----------------------------
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    float lsum = l[r];
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
      lsum += __shfl_xor_sync(0xffffffffu, lsum, off);
    const int qp = row0 + r;
    if (qp >= Sq) continue;
    const float denom = fmaxf(lsum, 1e-30f);
    float* orow = out + (((long long)b * Sq + qp) * H + h) * hd;
#pragma unroll
    for (int i = 0; i < TD; ++i) {
      const int dd = tx + 16 * i;
      if (dd < hd) orow[dd] = o[r][i] / denom;
    }
  }
}

template <int HDP>
int launch_hdp(const void* q, const void* k, const void* v, void* out, int B,
               int H, int KV, int Sq, int Sk, int hd, int causal, int window,
               float softcap, float scale, cudaStream_t s) {
  constexpr size_t smem = smem_bytes<HDP>();
  static_assert(smem <= 227 * 1024, "a block takes at most 227 KiB");
  auto kernel = flash_fwd_f32<HDP>;
  // once per device: a launch captured into a CUDA graph later makes no
  // attribute call
  static bool configured[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return -1;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured[dev] = true;
  }
  const uintptr_t addr_bits = reinterpret_cast<uintptr_t>(q) |
                              reinterpret_cast<uintptr_t>(k) |
                              reinterpret_cast<uintptr_t>(v);
  const int vec = hd % 4 == 0 && addr_bits % 16 == 0;
  dim3 grid((Sq + bq<HDP>() - 1) / bq<HDP>(), H, B);
  kernel<<<grid, THREADS, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), H, KV, Sq, Sk,
      hd, causal, window, softcap, scale, vec);
  return (int)cudaGetLastError();
}

// one instantiation per hd_pad = round_up(hd, 16)
int launch_f32(const void* q, const void* k, const void* v, void* out, int B,
               int H, int KV, int Sq, int Sk, int hd, int causal, int window,
               float softcap, float scale, cudaStream_t s) {
#define FLASH_CC_CASE(N)                                                    \
  case N / 16:                                                              \
    return launch_hdp<N>(q, k, v, out, B, H, KV, Sq, Sk, hd, causal, window, \
                         softcap, scale, s);
  switch ((hd + 15) / 16) {
    FLASH_CC_CASE(16)
    FLASH_CC_CASE(32)
    FLASH_CC_CASE(48)
    FLASH_CC_CASE(64)
    FLASH_CC_CASE(80)
    FLASH_CC_CASE(96)
    FLASH_CC_CASE(112)
    FLASH_CC_CASE(128)
    FLASH_CC_CASE(144)
    FLASH_CC_CASE(160)
    FLASH_CC_CASE(176)
    FLASH_CC_CASE(192)
    FLASH_CC_CASE(208)
    FLASH_CC_CASE(224)
    FLASH_CC_CASE(240)
    FLASH_CC_CASE(256)
    default:
      return -1;
  }
#undef FLASH_CC_CASE
}

}  // namespace cc

// ===========================================================================
// bf16: flash_fwd_wgmma, on the tensor cores (see the header)
// ===========================================================================

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int BQ = 128;                 // query rows per block
constexpr int BK = 64;                  // keys per K/V tile
constexpr int THREADS = (BQ / 64) * 128;  // one warpgroup per 64 rows
constexpr float LOG2E = 1.4426950408889634f;

// K/V stages of the ring: three up to hd_pad 128 (two blocks of 80 KiB
// share an SM at hd 80), two above, which keeps hd 256 within 227 KiB
template <int HDP>
__host__ __device__ constexpr int stages() {
  return HDP <= 128 ? 3 : 2;
}

template <int HDP>
constexpr size_t smem_bytes() {
  return (size_t)(BQ + 2 * stages<HDP>() * BK) * HDP * sizeof(bf16);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Matrix descriptor of a wgmma operand in shared memory, no swizzle:
// k_stride and mn_stride are the bytes between neighbouring core matrices
// along K (the leading-dimension offset) and along M or N (the
// stride-dimension offset).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr,
                                              uint32_t k_stride,
                                              uint32_t mn_stride) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         (uint64_t)((k_stride >> 4) & 0x3FFF) << 16 |
         (uint64_t)((mn_stride >> 4) & 0x3FFF) << 32;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// shared-memory writes of this thread (cp.async or st.shared) become
// visible to the async proxy, through which wgmma reads its operands
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous products.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// 2^x on the special-function unit (MUFU.EX2, relative error ~2^-22);
// x below -126 gives 0, as a probability that small should.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return (uint32_t)__bfloat16_as_ushort(v.x) |
         (uint32_t)__bfloat16_as_ushort(v.y) << 16;
}

#define WG_F8(d, i)                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// S (64 x 64 a warpgroup) += Q (64 x 16) K (64 x 16)^T, both operands from
// shared memory, K-major.
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : WG_F8(d, 0), WG_F8(d, 8), WG_F8(d, 16), WG_F8(d, 24)
      : "l"(da), "l"(db), "r"(1));
}

// O (64 x N a warpgroup) += P (64 x 16, bf16 in four registers a thread)
// V (16 x N, shared memory, MN-major: the transpose bit).  The operands
// other than the accumulator come first (%0-%5), so that the accumulator's
// registers are %6 on for every N; WG_Rk names the k-th eight of them.
template <int N>
__device__ __forceinline__ void wgmma_pv(float (&d)[N / 2], uint32_t (&a)[4],
                                         uint64_t db);

#define WG_R0 "%6, %7, %8, %9, %10, %11, %12, %13"
#define WG_R1 ", %14, %15, %16, %17, %18, %19, %20, %21"
#define WG_R2 ", %22, %23, %24, %25, %26, %27, %28, %29"
#define WG_R3 ", %30, %31, %32, %33, %34, %35, %36, %37"
#define WG_R4 ", %38, %39, %40, %41, %42, %43, %44, %45"
#define WG_R5 ", %46, %47, %48, %49, %50, %51, %52, %53"
#define WG_R6 ", %54, %55, %56, %57, %58, %59, %60, %61"
#define WG_R7 ", %62, %63, %64, %65, %66, %67, %68, %69"
#define WG_R8 ", %70, %71, %72, %73, %74, %75, %76, %77"
#define WG_R9 ", %78, %79, %80, %81, %82, %83, %84, %85"
#define WG_R10 ", %86, %87, %88, %89, %90, %91, %92, %93"
#define WG_R11 ", %94, %95, %96, %97, %98, %99, %100, %101"
#define WG_R12 ", %102, %103, %104, %105, %106, %107, %108, %109"
#define WG_R13 ", %110, %111, %112, %113, %114, %115, %116, %117"
#define WG_R14 ", %118, %119, %120, %121, %122, %123, %124, %125"
#define WG_R15 ", %126, %127, %128, %129, %130, %131, %132, %133"

#define WG_PV(N, ACC, ...)                                                \
  template <>                                                             \
  __device__ __forceinline__ void wgmma_pv<N>(                            \
      float(&d)[N / 2], uint32_t(&a)[4], uint64_t db) {                   \
    int one = 1;                                                          \
    asm volatile(                                                         \
        "{\n"                                                             \
        ".reg .pred p;\n"                                                 \
        "setp.ne.b32 p, %5, 0;\n"                                         \
        "wgmma.mma_async.sync.aligned.m64n" #N                            \
        "k16.f32.bf16.bf16 {" ACC "}, {%0, %1, %2, %3}, %4, p, 1, 1, 1;\n" \
        "}\n"                                                             \
        : "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3]), "+l"(db),       \
          "+r"(one), __VA_ARGS__);                                        \
  }

#define WG_A1 WG_R0
#define WG_A2 WG_A1 WG_R1
#define WG_A3 WG_A2 WG_R2
#define WG_A4 WG_A3 WG_R3
#define WG_A5 WG_A4 WG_R4
#define WG_A6 WG_A5 WG_R5
#define WG_A7 WG_A6 WG_R6
#define WG_A8 WG_A7 WG_R7
#define WG_A9 WG_A8 WG_R8
#define WG_A10 WG_A9 WG_R9
#define WG_A11 WG_A10 WG_R10
#define WG_A12 WG_A11 WG_R11
#define WG_A13 WG_A12 WG_R12
#define WG_A14 WG_A13 WG_R13
#define WG_A15 WG_A14 WG_R14
#define WG_A16 WG_A15 WG_R15

#define WG_D1 WG_F8(d, 0)
#define WG_D2 WG_D1, WG_F8(d, 8)
#define WG_D3 WG_D2, WG_F8(d, 16)
#define WG_D4 WG_D3, WG_F8(d, 24)
#define WG_D5 WG_D4, WG_F8(d, 32)
#define WG_D6 WG_D5, WG_F8(d, 40)
#define WG_D7 WG_D6, WG_F8(d, 48)
#define WG_D8 WG_D7, WG_F8(d, 56)
#define WG_D9 WG_D8, WG_F8(d, 64)
#define WG_D10 WG_D9, WG_F8(d, 72)
#define WG_D11 WG_D10, WG_F8(d, 80)
#define WG_D12 WG_D11, WG_F8(d, 88)
#define WG_D13 WG_D12, WG_F8(d, 96)
#define WG_D14 WG_D13, WG_F8(d, 104)
#define WG_D15 WG_D14, WG_F8(d, 112)
#define WG_D16 WG_D15, WG_F8(d, 120)

WG_PV(16, WG_A1, WG_D1)
WG_PV(32, WG_A2, WG_D2)
WG_PV(48, WG_A3, WG_D3)
WG_PV(64, WG_A4, WG_D4)
WG_PV(80, WG_A5, WG_D5)
WG_PV(96, WG_A6, WG_D6)
WG_PV(112, WG_A7, WG_D7)
WG_PV(128, WG_A8, WG_D8)
WG_PV(144, WG_A9, WG_D9)
WG_PV(160, WG_A10, WG_D10)
WG_PV(176, WG_A11, WG_D11)
WG_PV(192, WG_A12, WG_D12)
WG_PV(208, WG_A13, WG_D13)
WG_PV(224, WG_A14, WG_D14)
WG_PV(240, WG_A15, WG_D15)
WG_PV(256, WG_A16, WG_D16)

// Copy rows [row0, row0 + ROWS) of one head of a (B, S, NH, hd) bf16
// tensor to `dst` in the core-matrix layout; `src` points at the head's
// row 0 and rows are `row_stride` elements apart.  The 16-byte chunk of
// tile row r, columns [8c, 8c + 8), lies at byte 16 * ((r / 8 * HC + c) *
// 8 + r % 8), so that consecutive threads fill whole core matrices, and a
// thread's chunks are the same for every tile (a fixed trip count keeps
// their offsets out of the kv loop).  Rows past S and columns past hd are
// zeros.  vec (hd % 8 == 0, 16-byte aligned operands): cp.async, which the
// caller commits; else ordinary loads and stores.
template <int ROWS, int HC>
__device__ __forceinline__ void load_tile(unsigned char* dst,
                                          const bf16* __restrict__ src,
                                          long long row_stride, int row0,
                                          int S, int hd, bool vec) {
  constexpr int CHUNKS = ROWS * HC;
  constexpr int PER_THREAD = (CHUNKS + THREADS - 1) / THREADS;
  const uint32_t dst_addr = smem_addr(dst);
  if (vec) {
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
      const int e = threadIdx.x + i * THREADS;
      if (CHUNKS % THREADS == 0 || e < CHUNKS) {
        const int c = (e >> 3) % HC;
        const int s = row0 + (e >> 3) / HC * 8 + (e & 7);
        const bool ok = s < S && 8 * c < hd;
        const bf16* p = src + (long long)s * row_stride + 8 * c;
        cp_async16(dst_addr + 16 * e, ok ? p : src, ok ? 16 : 0);
      }
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const int e = threadIdx.x + i * THREADS;
    if (CHUNKS % THREADS == 0 || e < CHUNKS) {
      const int c = (e >> 3) % HC;
      const int s = row0 + (e >> 3) / HC * 8 + (e & 7);
      const bf16* p = src + (long long)min(s, S - 1) * row_stride + 8 * c;
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = 8 * c + 2 * j;
        const uint32_t lo =
            s < S && col < hd ? __bfloat16_as_ushort(p[2 * j]) : 0u;
        const uint32_t hi =
            s < S && col + 1 < hd ? __bfloat16_as_ushort(p[2 * j + 1]) : 0u;
        w[j] = lo | hi << 16;
      }
      *reinterpret_cast<uint4*>(dst + 16 * e) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

template <int HDP>
__global__ void __launch_bounds__(THREADS, HDP <= 96 ? 2 : 1)
flash_fwd_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ out, int H,
                int KV, int Sq, int Sk, int hd, int causal, int window,
                float softcap, float scale, int vec) {
  constexpr int HC = HDP / 8;          // 16-byte chunks of a row
  constexpr int GROUP = HC * 128;      // bytes of an 8-row group
  constexpr int TILE = BK * HDP * 2;   // bytes of a K or V tile
  constexpr int STAGES = stages<HDP>();
  extern __shared__ __align__(128) unsigned char smem_tc[];
  unsigned char* Qs = smem_tc;
  unsigned char* Ks = Qs + BQ * HDP * 2;
  unsigned char* Vs = Ks + STAGES * TILE;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heavy (late) first
  const int kvh = h / (H / KV);
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int quad = lane & 3;
  const int wq0 = q0 + 64 * wg;                      // the warpgroup's rows
  const int wq1 = min(wq0 + 63, Sq - 1);
  const int row0 = wq0 + 16 * warp + (lane >> 2);    // this thread's: row0,
                                                     // row0 + 8
  const int blk_q1 = min(q0 + BQ - 1, Sq - 1);
  const int k_end = causal ? min(Sk, blk_q1 + 1) : Sk;
  int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  k_begin = (k_begin / BK) * BK;
  const int ntiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  // each operand's row 0 of this (batch, head)
  const bf16* qh = q + ((long long)b * Sq * H + h) * hd;
  const bf16* kh = k + ((long long)b * Sk * KV + kvh) * hd;
  const bf16* vh = v + ((long long)b * Sk * KV + kvh) * hd;
  const long long q_stride = (long long)H * hd;
  const long long kv_stride = (long long)KV * hd;
  // prologue: Q with K/V tile 0 in one copy group, then tiles 1 ..
  // STAGES - 2 in a group each
  load_tile<BQ, HC>(Qs, qh, q_stride, q0, Sq, hd, vec);
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < ntiles) {
      load_tile<BK, HC>(Ks + t * TILE, kh, kv_stride, k_begin + t * BK, Sk,
                        hd, vec);
      load_tile<BK, HC>(Vs + t * TILE, vh, kv_stride, k_begin + t * BK, Sk,
                        hd, vec);
    }
    cp_async_commit();
  }

  // The scores go to the exp2 domain as x * mult: x is s itself, or
  // tanh(s * scale / softcap) under a softcap.
  const float mult = softcap > 0.f ? softcap * LOG2E : scale * LOG2E;
  const float cap_in = softcap > 0.f ? scale / softcap : 0.f;
  const uint32_t q_addr = smem_addr(Qs) + wg * 8 * GROUP;
  float o[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};   // row maxima, exp2 domain
  float l[2] = {0.f, 0.f};           // this thread's share of the row sums

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = k_begin + t * BK;
    const int st = t % STAGES;
    // tile t has landed once at most STAGES - 2 younger groups are pending
    cp_async_wait<STAGES - 2>();
    fence_async_proxy();
    __syncthreads();   // tile t is in; every warpgroup is done with t - 1
    {
      // refill the stage that tile t - 1 used with tile t + STAGES - 1
      const int tn = t + STAGES - 1;
      if (tn < ntiles) {
        load_tile<BK, HC>(Ks + (tn % STAGES) * TILE, kh, kv_stride,
                          k_begin + tn * BK, Sk, hd, vec);
        load_tile<BK, HC>(Vs + (tn % STAGES) * TILE, vh, kv_stride,
                          k_begin + tn * BK, Sk, hd, vec);
      }
      cp_async_commit();   // possibly empty: the group count stays regular
    }

    bool run = wq0 < Sq;
    if (causal) run = run && k0 <= wq1;
    if (window > 0) run = run && (k0 + BK - 1) > wq0 - window;
    if (!run) continue;   // warpgroup-uniform

    // ---- S = Q K^T on the tensor cores -----------------------------------
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    reg_fence(s);
    wgmma_fence();
    const uint32_t k_addr = smem_addr(Ks + st * TILE);
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk)
      wgmma_qk(s, make_desc(q_addr + 256 * kk, 128, GROUP),
               make_desc(k_addr + 256 * kk, 128, GROUP));
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(s);

    // ---- softcap, mask, online softmax -------------------------------------
    // s[4j + 2hh + e]: row row0 + 8 hh, key k0 + 8 j + 2 quad + e
    if (softcap > 0.f) {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = tanhf(s[i] * cap_in);
    }
    if (k0 + BK > Sk || (causal && k0 + BK - 1 > wq0) ||
        (window > 0 && k0 <= wq1 - window)) {   // the tile straddles an edge
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int qp = row0 + 8 * ((i >> 1) & 1);
        const int kp = k0 + 8 * (i >> 2) + 2 * quad + (i & 1);
        bool ok = kp < Sk;
        if (causal) ok = ok && kp <= qp;
        if (window > 0) ok = ok && kp > qp - window;
        s[i] = ok ? s[i] : NEG_INF;
      }
    }
    float alpha[2], msub[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * hh], s[4 * j + 2 * hh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hh], mx > NEG_INF / 2 ? mx * mult : NEG_INF);
      alpha[hh] = m[hh] > NEG_INF / 2 ? fast_exp2(m[hh] - m_new) : 0.f;
      // a row with no live key yet: every x is NEG_INF and p = 2^-huge = 0
      msub[hh] = m_new > NEG_INF / 2 ? m_new : 0.f;
      m[hh] = m_new;
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * hh + e;
          s[i] = fast_exp2(fmaf(s[i], mult, -msub[hh]));
          psum += s[i];
        }
      }
      l[hh] = alpha[hh] * l[hh] + psum;
    }
    // the accumulator needs rescaling only where a row's max moved
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int j = 0; j < HDP / 8; ++j) {
        o[4 * j] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }
    }

    // ---- O += P V: P in registers as bf16, V through the transpose bit ----
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
    reg_fence(o);
    wgmma_fence();
    const uint32_t v_addr = smem_addr(Vs + st * TILE);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_pv<HDP>(o, pa[kk], make_desc(v_addr + 2 * GROUP * kk, GROUP, 128));
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(o);
  }
  cp_async_wait<0>();   // no copy outlives the block

  // ---- out = acc / l (0 for a row with no key) -----------------------------
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float lsum = l[hh];
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
    const int qp = row0 + 8 * hh;
    if (qp >= Sq) continue;
    const float inv = 1.f / fmaxf(lsum, 1e-30f);
    bf16* orow = out + (((long long)b * Sq + qp) * H + h) * hd;
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j) {
      const int c = 8 * j + 2 * quad;
      const float x0 = o[4 * j + 2 * hh] * inv;
      const float x1 = o[4 * j + 2 * hh + 1] * inv;
      if ((hd & 1) == 0 && c < hd) {
        *reinterpret_cast<__nv_bfloat162*>(orow + c) =
            __floats2bfloat162_rn(x0, x1);
      } else {
        if (c < hd) orow[c] = __float2bfloat16_rn(x0);
        if (c + 1 < hd) orow[c + 1] = __float2bfloat16_rn(x1);
      }
    }
  }
}

template <int HDP>
int launch_hdp(const void* q, const void* k, const void* v, void* out, int B,
               int H, int KV, int Sq, int Sk, int hd, int causal, int window,
               float softcap, float scale, cudaStream_t s) {
  constexpr size_t smem = smem_bytes<HDP>();
  auto kernel = flash_fwd_wgmma<HDP>;
  // once per device, so that a launch captured into a CUDA graph later
  // makes no attribute call
  static bool configured[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return -1;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured[dev] = true;
  }
  const uintptr_t addr_bits = reinterpret_cast<uintptr_t>(q) |
                              reinterpret_cast<uintptr_t>(k) |
                              reinterpret_cast<uintptr_t>(v);
  const int vec = hd % 8 == 0 && addr_bits % 16 == 0;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kernel<<<grid, THREADS, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), H, KV, Sq, Sk,
      hd, causal, window, softcap, scale, vec);
  return (int)cudaGetLastError();
}

int launch_bf16(const void* q, const void* k, const void* v, void* out, int B,
                int H, int KV, int Sq, int Sk, int hd, int causal, int window,
                float softcap, float scale, cudaStream_t s) {
#define FLASH_TC_CASE(N)                                                    \
  case N / 16:                                                              \
    return launch_hdp<N>(q, k, v, out, B, H, KV, Sq, Sk, hd, causal, window, \
                         softcap, scale, s);
  switch ((hd + 15) / 16) {
    FLASH_TC_CASE(16)
    FLASH_TC_CASE(32)
    FLASH_TC_CASE(48)
    FLASH_TC_CASE(64)
    FLASH_TC_CASE(80)
    FLASH_TC_CASE(96)
    FLASH_TC_CASE(112)
    FLASH_TC_CASE(128)
    FLASH_TC_CASE(144)
    FLASH_TC_CASE(160)
    FLASH_TC_CASE(176)
    FLASH_TC_CASE(192)
    FLASH_TC_CASE(208)
    FLASH_TC_CASE(224)
    FLASH_TC_CASE(240)
    FLASH_TC_CASE(256)
    default:
      return -1;
  }
#undef FLASH_TC_CASE
}

}  // namespace tc
}  // namespace

extern "C" {

int flash_attention_max_head_dim() { return MAX_HD; }

// q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd); out: (B, Sq, H, hd); all
// contiguous.  dtype: 0 = float32 (flash_fwd_f32), 1 = bf16
// (flash_fwd_wgmma).  window <= 0: no window; softcap <= 0: no softcap.
// Returns 0, a CUDA error code, or -1 for arguments the kernel does not
// take.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int B, int H, int KV, int Sq, int Sk,
                           int hd, int causal, int window, float softcap,
                           float scale, int dtype, void* stream) {
  if (hd < 1 || hd > MAX_HD || KV < 1 || H % KV != 0) return -1;
  if (B == 0 || H == 0 || Sq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return cc::launch_f32(q, k, v, out, B, H, KV, Sq, Sk, hd, causal,
                          window, softcap, scale, s);
  if (dtype == 1)
    return tc::launch_bf16(q, k, v, out, B, H, KV, Sq, Sk, hd, causal,
                           window, softcap, scale, s);
  return -1;
}

}  // extern "C"
