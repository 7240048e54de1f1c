// FlashAttention-2 backward for NVIDIA Hopper (sm_90a), CUDA C++: two
// kernels, launched one after the other on the caller's stream.
//
// Replaces the Pallas TPU kernels of tensorflowonspark_tpu/ops/flash_attention.py
// launched by `_flash_bwd`:
// - flash_bwd_dq_kernel  <- `_bwd_dq_kernel`:
//     dQ = scale * sum_k P o (dO V^T - delta) K, P = exp(scale Q K^T - L)
//   recomputed from the forward's fp32 row logsumexp L (`_recompute_p`).
//   It also computes delta = rowsum(dO o O) for its query rows (the JAX
//   package leaves that to XLA) and writes it for the second kernel.
// - flash_bwd_dkv_sm90_kernel (bf16) and flash_bwd_dkv_kernel (fp32)
//   <- `_bwd_dkv_kernel`:
//     dV = sum_q P^T dO,  dK = scale * sum_q dS^T Q,  dS = P o (dO V^T - delta).
// Gradients are written in the inputs' dtype; every sum is fp32.  The dK/dV
// entry point picks its kernel by dtype: bf16 on the tensor cores, fp32 on
// the CUDA cores (TF32 products would miss the fp32 tolerance of 1e-4).
//
// Common design (not a block-by-block copy of the TPU kernels): the TPU
// kernels carry dQ (or dK, dV) in VMEM scratch across a sequential third
// grid axis; CUDA blocks run in no order.  So one block per (batch*head,
// 64-row query tile) loops over the key tiles for dQ, and one block per
// (batch*head, 64-row key tile) loops over the query tiles for dK and dV,
// the accumulators in registers for the whole loop.  FlashAttention-2's
// split into two kernels needs no atomics, so the gradients are the same
// from run to run.  Causal: the dQ loop stops at the diagonal key tile, the
// dK/dV loop starts at the diagonal query tile; only the diagonal (and a
// ragged last) tile is masked; the longest loops are scheduled first.
// Inputs are read through their (batch, seq, head) strides with a
// contiguous head_dim, so Q, K and V can be views into one fused QKV
// projection output and dO any such view: no copy before the launch.
//
// What bounds them on this card: at the training shape ([8, 1024, 16, 64],
// bf16, causal) the dQ kernel does 2.6e10 FLOP over 102 MB (q, k, v, O, dO
// and L in; dQ and delta out), the dK/dV kernel 3.4e10 FLOP over 102 MB;
// the H100 SXM data sheet (989 TFLOP/s bf16 tensor cores, 3.35 TB/s HBM)
// bounds them at about 30 us (by bytes) and 35 us (by operations).  On fp32
// FMAs (67 TFLOP/s) their own floor is 0.4 ms and 0.5 ms per call.
//
// bf16 dK/dV, flash_bwd_dkv_sm90_kernel<D>, D = 32, 64, 128: one warpgroup
// (128 threads) per key tile.  K and V are copied in once; Q and dO tiles
// pass through a two-stage ring in shared memory (cp.async, the next tile
// in flight while the tensor cores work on this one), L and delta of its 64
// queries beside them.  S^T = K Q^T and dP^T = V dO^T are SS wgmmas
// (m64n64k16) into fp32 registers; P^T = exp(scale S^T - L) and dS^T = P^T o
// (dP^T - delta) are computed there, packed to bf16 and fed as the register
// A operand of dV += P^T dO and dK += dS^T Q (RS wgmma m64nDk16, dO and Q as
// MN-major B operands): no P or dS tile passes through shared memory.  dK
// is scaled once at the end.  Helpers in flash_sm90.cuh.  ptxas (sm_90a):
// 136 / 178 / 255 registers at D = 32 / 64 / 128, D = 128 spilling 32
// bytes; shared memory 26 / 50 / 98 KB.
//
// dQ (fp32 and bf16) and fp32 dK/dV, the FMA kernels, D = 64, 128 (the
// wrapper pads 32 to 64): tiles staged in dynamic shared memory as fp32 (Q
// pre-multiplied by the scale), rows padded by 4 floats so the float4 reads
// of the inner products are bank-conflict free; 256 threads as a 16x16
// grid, thread (ty, tx) owning rows 4ty..4ty+3 of its block's tile and
// 4 x D/16 gradient columns; P and dS reach the second product through
// shared memory.  The dK/dV block holds 104 KB at D=64, 170 KB at D=128.
// ptxas: dQ 128 registers at D = 64 (36-40 bytes of spill), 168 at D = 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_sm90.cuh"

namespace {

constexpr int kBlock = 64;  // rows of every query and key tile
constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Strides {
  long long batch, seq, head;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;     // dQ kernel only
  const void* dout;
  const float* lse;  // [batch * heads, seq_len]
  float* delta;      // [batch * heads, seq_len]: written by dQ, read by dK/dV
  void* dq;
  void* dk;
  void* dv;
  int batch, seq_len, heads;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  float scale;
  int causal;
};

template <int D>
struct Layout {
  static constexpr int kLd = D + 4;        // row pitch of the Q/K/V/dO tiles, floats
  static constexpr int kLdS = kBlock + 4;  // row pitch of the P/dS tiles, floats
  static constexpr size_t kDqBytes = sizeof(float) * (4 * kBlock * kLd + kBlock * kLdS);
  static constexpr size_t kDkvBytes = sizeof(float) * (4 * kBlock * kLd + 2 * kBlock * kLdS);
};

// Copy rows [row0, row0 + kBlock) of one (batch, head) slice into a padded
// fp32 tile, times `mul`, zero-filling rows past the sequence end.
// Consecutive threads read consecutive head_dim elements (coalesced).
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, const T* __restrict__ src,
                                          long long row_stride, int row0, int seq_len,
                                          float mul) {
  constexpr int kLd = Layout<D>::kLd;
  for (int idx = threadIdx.x; idx < kBlock * D; idx += kThreads) {
    const int r = idx / D;
    const int c = idx % D;
    const int row = row0 + r;
    float x = 0.f;
    if (row < seq_len) x = to_float(src[row * row_stride + c]) * mul;
    dst[r * kLd + c] = x;
  }
}

// out[i][j] = sum_d a[4ty+i][d] * b[tx+16j][d], both tiles of pitch D+4.
template <int D>
__device__ __forceinline__ void dot_rows(float (&out)[4][4], const float* __restrict__ a,
                                         const float* __restrict__ b, int ty, int tx) {
  constexpr int kLd = Layout<D>::kLd;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + (ty * 4 + i) * kLd + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * kLd + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        out[i][j] = fmaf(av[i].x, bv[j].x, out[i][j]);
        out[i][j] = fmaf(av[i].y, bv[j].y, out[i][j]);
        out[i][j] = fmaf(av[i].z, bv[j].z, out[i][j]);
        out[i][j] = fmaf(av[i].w, bv[j].w, out[i][j]);
      }
  }
}

// acc[i][4jj+c] += sum_r w[4ty+i][r] * x[r][64jj + 4tx + c]: w of pitch
// kBlock+4 (a P or dS tile), x of pitch D+4.
template <int D>
__device__ __forceinline__ void accum_rows(float (&acc)[4][D / 16], const float* __restrict__ w,
                                           const float* __restrict__ x, int ty, int tx) {
  constexpr int kLd = Layout<D>::kLd;
  constexpr int kLdS = Layout<D>::kLdS;
  constexpr int kNj = D / 64;
#pragma unroll 2
  for (int r = 0; r < kBlock; r += 4) {
    float4 wv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      wv[i] = *reinterpret_cast<const float4*>(w + (ty * 4 + i) * kLdS + r);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float* xrow = x + (r + u) * kLd + tx * 4;
      float4 xv[kNj];
#pragma unroll
      for (int jj = 0; jj < kNj; ++jj) xv[jj] = *reinterpret_cast<const float4*>(xrow + jj * 64);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float wu = u == 0 ? wv[i].x : u == 1 ? wv[i].y : u == 2 ? wv[i].z : wv[i].w;
#pragma unroll
        for (int jj = 0; jj < kNj; ++jj) {
          acc[i][jj * 4 + 0] = fmaf(wu, xv[jj].x, acc[i][jj * 4 + 0]);
          acc[i][jj * 4 + 1] = fmaf(wu, xv[jj].y, acc[i][jj * 4 + 1]);
          acc[i][jj * 4 + 2] = fmaf(wu, xv[jj].z, acc[i][jj * 4 + 2]);
          acc[i][jj * 4 + 3] = fmaf(wu, xv[jj].w, acc[i][jj * 4 + 3]);
        }
      }
    }
  }
}

// Write rows 4ty+i (those below seq_len) of a gradient tile starting at row0.
template <typename T, int D>
__device__ __forceinline__ void store_rows(void* base, const Strides& s, int b, int h, int row0,
                                           int seq_len, const float (&acc)[4][D / 16], int ty,
                                           int tx) {
  constexpr int kNj = D / 64;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    if (row >= seq_len) continue;
    T* out = static_cast<T*>(base) + b * s.batch + row * s.seq + h * s.head;
#pragma unroll
    for (int jj = 0; jj < kNj; ++jj)
#pragma unroll
      for (int c = 0; c < 4; ++c) out[jj * 64 + tx * 4 + c] = from_float<T>(acc[i][jj * 4 + c]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, D == 64 ? 2 : 1) flash_bwd_dq_kernel(const Params p) {
  constexpr int kLd = Layout<D>::kLd;
  constexpr int kLdS = Layout<D>::kLdS;

  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // scale * Q
  float* do_s = q_s + kBlock * kLd;
  float* k_s = do_s + kBlock * kLd;
  float* v_s = k_s + kBlock * kLd;
  float* ds_s = v_s + kBlock * kLd;

  const int n_q = (p.seq_len + kBlock - 1) / kBlock;
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.x)) * kBlock;  // longest rows first
  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const long long stat0 = static_cast<long long>(bh) * p.seq_len;

  const T* qp = static_cast<const T*>(p.q) + b * p.qs.batch + h * p.qs.head;
  const T* kp = static_cast<const T*>(p.k) + b * p.ks.batch + h * p.ks.head;
  const T* vp = static_cast<const T*>(p.v) + b * p.vs.batch + h * p.vs.head;
  const T* op = static_cast<const T*>(p.o) + b * p.os.batch + h * p.os.head;
  const T* dop = static_cast<const T*>(p.dout) + b * p.dos.batch + h * p.dos.head;

  load_tile<T, D>(q_s, qp, p.qs.seq, q0, p.seq_len, p.scale);
  load_tile<T, D>(do_s, dop, p.dos.seq, q0, p.seq_len, 1.f);
  __syncthreads();

  // L and delta = rowsum(dO o O) of this thread's four rows; the 16 lanes
  // of a half-warp share a row and split its columns.
  float lse[4], dlt[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    float sum = 0.f;
    if (row < p.seq_len) {
      const T* orow = op + row * p.os.seq;
      for (int c = tx; c < D; c += 16) sum = fmaf(do_s[(ty * 4 + i) * kLd + c], to_float(orow[c]), sum);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    dlt[i] = sum;
    lse[i] = row < p.seq_len ? p.lse[stat0 + row] : 0.f;
    if (tx == 0 && row < p.seq_len) p.delta[stat0 + row] = sum;
  }

  float acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;

  const int k_end = p.causal ? min(p.seq_len, q0 + kBlock) : p.seq_len;
  const int n_k = (k_end + kBlock - 1) / kBlock;
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * kBlock;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(k_s, kp, p.ks.seq, k0, p.seq_len, 1.f);
    load_tile<T, D>(v_s, vp, p.vs.seq, k0, p.seq_len, 1.f);
    __syncthreads();

    float s[4][4], dp[4][4];
    dot_rows<D>(s, q_s, k_s, ty, tx);    // S = (scale Q) K^T
    dot_rows<D>(dp, do_s, v_s, ty, tx);  // dP = dO V^T

    // Only the diagonal tile (causal) and a ragged last tile need a mask.
    const bool need_mask =
        (p.causal && k0 + kBlock - 1 > q0) || k0 + kBlock > p.seq_len || q0 + kBlock > p.seq_len;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool keep =
            !need_mask || (row < p.seq_len && col < p.seq_len && (!p.causal || col <= row));
        const float pv = keep ? expf(s[i][j] - lse[i]) : 0.f;
        ds_s[(ty * 4 + i) * kLdS + tx + 16 * j] = pv * (dp[i][j] - dlt[i]);
      }
    }
    __syncthreads();
    accum_rows<D>(acc, ds_s, k_s, ty, tx);  // acc += dS K
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] *= p.scale;
  store_rows<T, D>(p.dq, p.dqs, b, h, q0, p.seq_len, acc, ty, tx);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, D == 64 ? 2 : 1) flash_bwd_dkv_kernel(const Params p) {
  constexpr int kLdS = Layout<D>::kLdS;
  constexpr int kLd = Layout<D>::kLd;

  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);
  float* v_s = k_s + kBlock * kLd;
  float* q_s = v_s + kBlock * kLd;  // scale * Q
  float* do_s = q_s + kBlock * kLd;
  float* pt_s = do_s + kBlock * kLd;  // P^T: key rows x query columns
  float* dst_s = pt_s + kBlock * kLdS;  // dS^T

  const int k0 = blockIdx.x * kBlock;  // causal: the first key tiles have the longest loops
  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const long long stat0 = static_cast<long long>(bh) * p.seq_len;

  const T* qp = static_cast<const T*>(p.q) + b * p.qs.batch + h * p.qs.head;
  const T* kp = static_cast<const T*>(p.k) + b * p.ks.batch + h * p.ks.head;
  const T* vp = static_cast<const T*>(p.v) + b * p.vs.batch + h * p.vs.head;
  const T* dop = static_cast<const T*>(p.dout) + b * p.dos.batch + h * p.dos.head;

  load_tile<T, D>(k_s, kp, p.ks.seq, k0, p.seq_len, 1.f);
  load_tile<T, D>(v_s, vp, p.vs.seq, k0, p.seq_len, 1.f);

  float dk[4][D / 16], dv[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      dk[i][c] = 0.f;
      dv[i][c] = 0.f;
    }

  const int n_q = (p.seq_len + kBlock - 1) / kBlock;
  for (int qt = p.causal ? blockIdx.x : 0; qt < n_q; ++qt) {
    const int q0 = qt * kBlock;
    __syncthreads();  // the previous tile's readers are done (and K, V are visible)
    load_tile<T, D>(q_s, qp, p.qs.seq, q0, p.seq_len, p.scale);
    load_tile<T, D>(do_s, dop, p.dos.seq, q0, p.seq_len, 1.f);
    // L and delta of this thread's query columns tx+16j
    float lq[4], dq_delta[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = q0 + tx + 16 * j;
      lq[j] = col < p.seq_len ? p.lse[stat0 + col] : 0.f;
      dq_delta[j] = col < p.seq_len ? p.delta[stat0 + col] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
    dot_rows<D>(s, k_s, q_s, ty, tx);    // S^T = K (scale Q)^T
    dot_rows<D>(dp, v_s, do_s, ty, tx);  // dP^T = V dO^T

    const bool need_mask =
        (p.causal && q0 < k0 + kBlock - 1) || q0 + kBlock > p.seq_len || k0 + kBlock > p.seq_len;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = q0 + tx + 16 * j;  // query row
        const bool keep =
            !need_mask || (key < p.seq_len && col < p.seq_len && (!p.causal || key <= col));
        const float pv = keep ? expf(s[i][j] - lq[j]) : 0.f;
        pt_s[(ty * 4 + i) * kLdS + tx + 16 * j] = pv;
        dst_s[(ty * 4 + i) * kLdS + tx + 16 * j] = pv * (dp[i][j] - dq_delta[j]);
      }
    }
    __syncthreads();
    accum_rows<D>(dv, pt_s, do_s, ty, tx);   // dV += P^T dO
    accum_rows<D>(dk, dst_s, q_s, ty, tx);   // dK += dS^T (scale Q)
  }

  store_rows<T, D>(p.dk, p.dks, b, h, k0, p.seq_len, dk, ty, tx);
  store_rows<T, D>(p.dv, p.dvs, b, h, k0, p.seq_len, dv, ty, tx);
}

// ---- bf16 dK/dV: the tensor-core kernel ----------------------------------

template <int D>
struct Sm90Layout {
  using Tile = flash_sm90::Tile<D>;
  // K, V, two stages of (Q, dO), two stages of (L, delta) for 64 queries;
  // 1 KB of slack to align the first tile
  static constexpr size_t kBytes = 6 * Tile::kBytes + 2 * 2 * kBlock * sizeof(float) + 1024;
};

template <int D>
__global__ void __launch_bounds__(flash_sm90::kThreads) flash_bwd_dkv_sm90_kernel(const Params p) {
  namespace fs = flash_sm90;
  using Tile = fs::Tile<D>;
  using bf16 = __nv_bfloat16;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = fs::align_1024(smem_raw);
  const uint32_t k_s = fs::smem_addr(base);
  const uint32_t v_s = k_s + Tile::kBytes;
  const uint32_t qdo_s = v_s + Tile::kBytes;  // stage s: Q at qdo_s + 2 s kBytes, dO after it
  float* stat_s = reinterpret_cast<float*>(base + 6 * Tile::kBytes);  // [2][L 64, delta 64]

  const int k0 = blockIdx.x * kBlock;  // causal: the first key tiles have the longest loops
  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int tid = threadIdx.x;
  const long long stat0 = static_cast<long long>(bh) * p.seq_len;
  const bf16* qp = static_cast<const bf16*>(p.q) + b * p.qs.batch + h * p.qs.head;
  const bf16* kp = static_cast<const bf16*>(p.k) + b * p.ks.batch + h * p.ks.head;
  const bf16* vp = static_cast<const bf16*>(p.v) + b * p.vs.batch + h * p.vs.head;
  const bf16* dop = static_cast<const bf16*>(p.dout) + b * p.dos.batch + h * p.dos.head;

  // thread t < 64 carries L of query q0 + t, thread 64 + t delta of it
  auto load_stat = [&](int q0) {
    const int col = q0 + (tid & (kBlock - 1));
    if (col >= p.seq_len) return 0.f;
    return tid < kBlock ? p.lse[stat0 + col] : p.delta[stat0 + col];
  };

  const int n_q = (p.seq_len + kBlock - 1) / kBlock;
  const int qt0 = p.causal ? static_cast<int>(blockIdx.x) : 0;
  fs::load_tile<D>(k_s, kp, p.ks.seq, k0, p.seq_len);
  fs::load_tile<D>(v_s, vp, p.vs.seq, k0, p.seq_len);
  fs::load_tile<D>(qdo_s, qp, p.qs.seq, qt0 * kBlock, p.seq_len);
  fs::load_tile<D>(qdo_s + Tile::kBytes, dop, p.dos.seq, qt0 * kBlock, p.seq_len);
  fs::cp_async_commit();
  float stat_next = load_stat(qt0 * kBlock);

  const float score_mul = p.scale * fs::kLog2e;
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) {
    dk[e] = 0.f;
    dv[e] = 0.f;
  }

  for (int qt = qt0; qt < n_q; ++qt) {
    const int q0 = qt * kBlock;
    const int st = (qt - qt0) & 1;
    stat_s[st * 2 * kBlock + tid] = stat_next;
    fs::cp_async_wait_all();
    fs::fence_proxy_async();
    __syncthreads();  // tile qt and its L, delta are in; every thread is done with qt - 1
    if (qt + 1 < n_q) {  // fill the other stage while this one is in the tensor cores
      const uint32_t next = qdo_s + (st ^ 1) * 2 * Tile::kBytes;
      fs::load_tile<D>(next, qp, p.qs.seq, q0 + kBlock, p.seq_len);
      fs::load_tile<D>(next + Tile::kBytes, dop, p.dos.seq, q0 + kBlock, p.seq_len);
      stat_next = load_stat(q0 + kBlock);
    }
    fs::cp_async_commit();
    const uint32_t q_s = qdo_s + st * 2 * Tile::kBytes;
    const uint32_t do_s = q_s + Tile::kBytes;
    const float* lq = stat_s + st * 2 * kBlock;
    const float* dlt = lq + kBlock;

    // S^T = K Q^T and dP^T = V dO^T: SS, K = D; rows are keys, columns queries
    float s[32], dp[32];
    fs::fence_regs(s);
    fs::fence_regs(dp);
    fs::wgmma_fence();
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      fs::wgmma_ss_m64n64(s, fs::desc_k_major<D>(k_s, k), fs::desc_k_major<D>(q_s, k), k > 0);
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      fs::wgmma_ss_m64n64(dp, fs::desc_k_major<D>(v_s, k), fs::desc_k_major<D>(do_s, k), k > 0);
    fs::wgmma_commit();
    fs::wgmma_wait_all();
    fs::fence_regs(s);
    fs::fence_regs(dp);

    // P^T = exp(scale S^T - L), dS^T = P^T o (dP^T - delta), in fp32
    const bool need_mask =
        (p.causal && q0 < k0 + kBlock - 1) || q0 + kBlock > p.seq_len || k0 + kBlock > p.seq_len;
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int c = fs::frag_col(e);
      const bool keep =
          !need_mask || fs::attended(q0 + c, k0 + fs::frag_row(e), p.seq_len, p.causal);
      const float pv = keep ? exp2f(s[e] * score_mul - lq[c] * fs::kLog2e) : 0.f;
      s[e] = pv;
      dp[e] = pv * (dp[e] - dlt[c]);
    }

    // dV += P^T dO and dK += dS^T Q: RS, bf16 A from registers, B MN-major,
    // K = 64 queries
    uint32_t a_p[4][4], a_ds[4][4];
    fs::to_a_fragments(s, a_p);
    fs::to_a_fragments(dp, a_ds);
    fs::fence_regs(dv);
    fs::fence_regs(dk);
    fs::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fs::wgmma_rs<D>(dv, a_p[kk], fs::desc_mn_major<D>(do_s, kk), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fs::wgmma_rs<D>(dk, a_ds[kk], fs::desc_mn_major<D>(q_s, kk), 1);
    fs::wgmma_commit();
    fs::wgmma_wait_all();
    fs::fence_regs(dv);
    fs::fence_regs(dk);
    fs::fence_regs(a_p);
    fs::fence_regs(a_ds);
  }

  // the scale of dK once, at the end
  fs::store_rows<D>(static_cast<bf16*>(p.dk) + b * p.dks.batch + h * p.dks.head, p.dks.seq, k0,
                    p.seq_len, dk, p.scale, p.scale);
  fs::store_rows<D>(static_cast<bf16*>(p.dv) + b * p.dvs.batch + h * p.dvs.head, p.dvs.seq, k0,
                    p.seq_len, dv, 1.f, 1.f);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, const Params& p, cudaStream_t stream,
                   int threads = kThreads) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.seq_len + kBlock - 1) / kBlock, p.batch * p.heads);
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_sm90(const Params& p, cudaStream_t stream) {
  return launch(flash_bwd_dkv_sm90_kernel<D>, Sm90Layout<D>::kBytes, p, stream,
                flash_sm90::kThreads);
}

template <typename T, int D>
cudaError_t launch_dq(const Params& p, cudaStream_t stream) {
  return launch(flash_bwd_dq_kernel<T, D>, Layout<D>::kDqBytes, p, stream);
}

template <typename T, int D>
cudaError_t launch_dkv(const Params& p, cudaStream_t stream) {
  return launch(flash_bwd_dkv_kernel<T, D>, Layout<D>::kDkvBytes, p, stream);
}

Params make_params(int batch, int seq_len, int heads, float scale, int causal) {
  Params p = {};
  p.batch = batch;
  p.seq_len = seq_len;
  p.heads = heads;
  p.scale = scale;
  p.causal = causal;
  return p;
}

Strides strides_at(const long long* s, int i) { return {s[3 * i], s[3 * i + 1], s[3 * i + 2]}; }

}  // namespace

// All tensors: [batch, seq_len, heads, head_dim] with a contiguous head_dim,
// their (batch, seq, head) strides given in elements, three per tensor in
// the order of the pointer arguments.  lse, delta: contiguous fp32
// [batch * heads, seq_len].  dtype: 0 = float32, 1 = bfloat16 (of every
// tensor but lse and delta).  head_dim: 64 or 128 for the FMA kernels (dQ;
// dK/dV in float32), 32, 64 or 128 for the tensor-core kernel (dK/dV in
// bfloat16; every base pointer and stride 16-byte aligned).  Each returns
// the cudaError_t of its launch (0 on success).

// dQ and delta.  strides: q, k, v, o, dout, dq (18 values).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                            const void* dout, const void* lse, void* delta, void* dq, int batch,
                            int seq_len, int heads, int head_dim, const long long* strides,
                            float scale, int causal, int dtype, void* stream) {
  Params p = make_params(batch, seq_len, heads, scale, causal);
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.dq = dq;
  p.qs = strides_at(strides, 0);
  p.ks = strides_at(strides, 1);
  p.vs = strides_at(strides, 2);
  p.os = strides_at(strides, 3);
  p.dos = strides_at(strides, 4);
  p.dqs = strides_at(strides, 5);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64) return launch_dq<float, 64>(p, st);
  if (dtype == 0 && head_dim == 128) return launch_dq<float, 128>(p, st);
  if (dtype == 1 && head_dim == 64) return launch_dq<__nv_bfloat16, 64>(p, st);
  if (dtype == 1 && head_dim == 128) return launch_dq<__nv_bfloat16, 128>(p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dK and dV from the delta the dQ kernel wrote.  strides: q, k, v, dout,
// dk, dv (18 values).
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dk, void* dv, int batch,
                             int seq_len, int heads, int head_dim, const long long* strides,
                             float scale, int causal, int dtype, void* stream) {
  Params p = make_params(batch, seq_len, heads, scale, causal);
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(const_cast<void*>(delta));
  p.dk = dk;
  p.dv = dv;
  p.qs = strides_at(strides, 0);
  p.ks = strides_at(strides, 1);
  p.vs = strides_at(strides, 2);
  p.dos = strides_at(strides, 3);
  p.dks = strides_at(strides, 4);
  p.dvs = strides_at(strides, 5);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64) return launch_dkv<float, 64>(p, st);
  if (dtype == 0 && head_dim == 128) return launch_dkv<float, 128>(p, st);
  if (dtype == 1 && head_dim == 32) return launch_dkv_sm90<32>(p, st);
  if (dtype == 1 && head_dim == 64) return launch_dkv_sm90<64>(p, st);
  if (dtype == 1 && head_dim == 128) return launch_dkv_sm90<128>(p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
