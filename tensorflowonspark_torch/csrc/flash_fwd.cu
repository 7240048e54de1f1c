// FlashAttention-2 forward for NVIDIA Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` of
// tensorflowonspark_tpu/ops/flash_attention.py (launched by `_flash_fwd`).
// It computes what that kernel computes: for every (batch, head) the
// attention output O = softmax(scale * Q K^T) V in the input dtype and the
// per-row logsumexp L = m + log(max(l, 1e-30)) in fp32, causal or not, with
// the running max m, running sum l and the output accumulator all in fp32.
// The entry point picks the kernel by dtype: bf16 runs on the tensor cores
// (flash_fwd_sm90_kernel), fp32 on the CUDA cores (flash_fwd_kernel), since
// TF32 products would miss the fp32 tolerance of 1e-4.
//
// Common design (not a block-by-block copy of the TPU kernel): one thread
// block per (batch*head, 64-row query tile).  The TPU kernel's sequential
// third grid axis and its VMEM scratch carry have no counterpart across
// CUDA blocks, so the loop over K/V tiles runs inside the block and (m, l,
// O) live in registers for the whole loop.  Causal: the key loop stops at
// the diagonal tile; only the diagonal (and a ragged last) tile is masked;
// query tiles are scheduled longest first.  Inputs are read through their
// (batch, seq, head) strides with a contiguous head_dim, so Q, K and V can
// be views into one fused QKV projection output: no copy before the launch.
//
// What bounds it on this card: at the training shape ([8, 1024, 16, 64],
// bf16, causal) the work is 17.2 GFLOP over 67.6 MB of unique bytes, which
// the H100 SXM data sheet (989 TFLOP/s bf16 tensor cores, 3.35 TB/s HBM)
// bounds at 20 us, by bytes (17 us by operations).  An FMA kernel cannot
// come near: 67 TFLOP/s of fp32 FMAs put its own floor at 0.26 ms.
//
// bf16, flash_fwd_sm90_kernel<D>, D = 32, 64, 128: one warpgroup (128
// threads) per query tile.  Q is copied in once; K/V tiles pass through a
// two-stage ring in shared memory, the next tile's cp.async copies in
// flight while the tensor cores work on this one.  S = Q K^T is an SS wgmma
// (m64n64k16, D/16 steps) into fp32 registers; the scale is applied to the
// fp32 scores (times log2 e, so the softmax runs on exp2f; L is converted
// back to natural-log units).  P is packed to bf16 in registers and O +=
// P V is an RS wgmma (m64nDk16, 4 steps) with V as the MN-major B operand:
// no P tile passes through shared memory.  Helpers in flash_sm90.cuh.
// ptxas (sm_90a): 90 / 127 / 189 registers at D = 32 / 64 / 128, no spills;
// shared memory 21 / 41 / 81 KB (Q and two K/V stages, 1 KB for alignment).
//
// fp32, flash_fwd_kernel<D>, D = 64, 128 (the wrapper pads 32 to 64): 256
// threads as a 16x16 grid, thread (ty, tx) owning query rows 4ty..4ty+3; Q
// (times the scale) and each K/V tile staged in shared memory as fp32 rows
// padded by 4 floats, P through shared memory to the P V product.  ptxas:
// 128 registers; D = 128 spills 28 bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_sm90.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

struct Strides {
  long long batch, seq, head;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int batch, seq_len, heads;
  Strides qs, ks, vs, os;
  float scale;
  int causal;
};

template <int D>
struct Layout {
  static constexpr int kLd = D + 4;         // row pitch of the Q/K/V tiles, floats
  static constexpr int kLdP = kBlockK + 4;  // row pitch of the P tile, floats
  static constexpr int kFloats = kBlockQ * kLd + 2 * kBlockK * kLd + kBlockQ * kLdP;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

// Copy rows [row0, row0 + rows) of one (batch, head) slice into a padded fp32
// tile, zero-filling rows past the sequence end.  Consecutive threads read
// consecutive head_dim elements, so the global reads coalesce.
template <int D>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, const float* __restrict__ src,
                                          long long row_stride, int row0, int rows, int seq_len,
                                          float mul) {
  constexpr int kLd = Layout<D>::kLd;
  for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
    const int r = idx / D;
    const int c = idx % D;
    const int row = row0 + r;
    float x = 0.f;
    if (row < seq_len) x = src[row * row_stride + c] * mul;
    dst[r * kLd + c] = x;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2) flash_fwd_kernel(const Params p) {
  constexpr int kLd = Layout<D>::kLd;
  constexpr int kLdP = Layout<D>::kLdP;
  constexpr int kNj = D / 64;  // 64-wide output column slices per thread row

  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* k_s = q_s + kBlockQ * kLd;
  float* v_s = k_s + kBlockK * kLd;
  float* p_s = v_s + kBlockK * kLd;

  const int n_q = (p.seq_len + kBlockQ - 1) / kBlockQ;
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.x)) * kBlockQ;  // longest rows first
  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  const float* qp = static_cast<const float*>(p.q) + b * p.qs.batch + h * p.qs.head;
  const float* kp = static_cast<const float*>(p.k) + b * p.ks.batch + h * p.ks.head;
  const float* vp = static_cast<const float*>(p.v) + b * p.vs.batch + h * p.vs.head;

  load_tile<D>(q_s, qp, p.qs.seq, q0, kBlockQ, p.seq_len, p.scale);

  float m[4], l[4], acc[4][4 * kNj];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * kNj; ++c) acc[i][c] = 0.f;
  }

  const int k_end = p.causal ? min(p.seq_len, q0 + kBlockQ) : p.seq_len;
  const int n_k = (k_end + kBlockK - 1) / kBlockK;

  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // the previous tile's readers are done (and Q is visible)
    load_tile<D>(k_s, kp, p.ks.seq, k0, kBlockK, p.seq_len, 1.f);
    load_tile<D>(v_s, vp, p.vs.seq, k0, kBlockK, p.seq_len, 1.f);
    __syncthreads();

    // S = (scale Q) K^T for rows 4ty+i, key columns tx+16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(q_s + (ty * 4 + i) * kLd + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(k_s + (tx + 16 * j) * kLd + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // Only the diagonal tile (causal) and a ragged last tile need a mask.
    const bool need_mask =
        (p.causal && k0 + kBlockK - 1 > q0) || (k0 + kBlockK > p.seq_len);
    bool keep[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = q0 + ty * 4 + i;
        const int col = k0 + tx + 16 * j;
        keep[i][j] = !need_mask || (col < p.seq_len && (!p.causal || col <= row));
        if (!keep[i][j]) s[i][j] = kNegInf;
      }

    // Online softmax: rescale the running statistics and accumulator.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pv = keep[i][j] ? expf(s[i][j] - m_new) : 0.f;
        s[i][j] = pv;
        rs += pv;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * kNj; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) p_s[(ty * 4 + i) * kLdP + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

    // acc += P V for rows 4ty+i, columns 64jj + 4tx + (0..3)
#pragma unroll 2
    for (int kk = 0; kk < kBlockK; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(p_s + (ty * 4 + i) * kLdP + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vrow = v_s + (kk + u) * kLd + tx * 4;
        float4 vv[kNj];
#pragma unroll
        for (int jj = 0; jj < kNj; ++jj) vv[jj] = *reinterpret_cast<const float4*>(vrow + jj * 64);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pu = u == 0 ? pv[i].x : u == 1 ? pv[i].y : u == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int jj = 0; jj < kNj; ++jj) {
            acc[i][jj * 4 + 0] = fmaf(pu, vv[jj].x, acc[i][jj * 4 + 0]);
            acc[i][jj * 4 + 1] = fmaf(pu, vv[jj].y, acc[i][jj * 4 + 1]);
            acc[i][jj * 4 + 2] = fmaf(pu, vv[jj].z, acc[i][jj * 4 + 2]);
            acc[i][jj * 4 + 3] = fmaf(pu, vv[jj].w, acc[i][jj * 4 + 3]);
          }
        }
      }
    }
  }

  // Epilogue: O = acc / l in the input dtype, L = m + log(l) in fp32.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= p.seq_len) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    const float inv = 1.f / lc;
    float* orow = static_cast<float*>(p.o) + b * p.os.batch + row * p.os.seq + h * p.os.head;
#pragma unroll
    for (int jj = 0; jj < kNj; ++jj)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        orow[jj * 64 + tx * 4 + c] = acc[i][jj * 4 + c] * inv;
    if (tx == 0) p.lse[static_cast<long long>(bh) * p.seq_len + row] = m[i] + logf(lc);
  }
}

template <int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = Layout<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.seq_len + kBlockQ - 1) / kBlockQ, p.batch * p.heads);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---- bf16: the tensor-core kernel ----------------------------------------

template <int D>
struct Sm90Layout {
  using Tile = flash_sm90::Tile<D>;
  // Q, then two stages of (K, V); 1 KB of slack to align the first tile
  static constexpr size_t kBytes = 5 * Tile::kBytes + 1024;
};

template <int D>
__global__ void __launch_bounds__(flash_sm90::kThreads) flash_fwd_sm90_kernel(const Params p) {
  namespace fs = flash_sm90;
  using Tile = fs::Tile<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = fs::smem_addr(fs::align_1024(smem_raw));
  const uint32_t kv_s = q_s + Tile::kBytes;  // stage s: K at kv_s + 2 s kBytes, V after it

  const int n_q = (p.seq_len + kBlockQ - 1) / kBlockQ;
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.x)) * kBlockQ;  // longest rows first
  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  using bf16 = __nv_bfloat16;
  const bf16* qp = static_cast<const bf16*>(p.q) + b * p.qs.batch + h * p.qs.head;
  const bf16* kp = static_cast<const bf16*>(p.k) + b * p.ks.batch + h * p.ks.head;
  const bf16* vp = static_cast<const bf16*>(p.v) + b * p.vs.batch + h * p.vs.head;

  const int k_end = p.causal ? min(p.seq_len, q0 + kBlockQ) : p.seq_len;
  const int n_k = (k_end + kBlockK - 1) / kBlockK;

  fs::load_tile<D>(q_s, qp, p.qs.seq, q0, p.seq_len);
  fs::load_tile<D>(kv_s, kp, p.ks.seq, 0, p.seq_len);
  fs::load_tile<D>(kv_s + Tile::kBytes, vp, p.vs.seq, 0, p.seq_len);
  fs::cp_async_commit();

  // scores in log2 units: S * scale * log2(e), so the softmax runs on exp2
  const float score_mul = p.scale * fs::kLog2e;
  float m[2] = {kNegInf, kNegInf};  // running max of the thread's two rows
  float l[2] = {0.f, 0.f};          // this thread's share of their running sums
  float o[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) o[e] = 0.f;

  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * kBlockK;
    fs::cp_async_wait_all();
    fs::fence_proxy_async();
    __syncthreads();  // tile kt is in; every thread is done with tile kt - 1
    if (kt + 1 < n_k) {  // fill the other stage while this one is in the tensor cores
      const uint32_t next = kv_s + ((kt + 1) & 1) * 2 * Tile::kBytes;
      fs::load_tile<D>(next, kp, p.ks.seq, k0 + kBlockK, p.seq_len);
      fs::load_tile<D>(next + Tile::kBytes, vp, p.vs.seq, k0 + kBlockK, p.seq_len);
    }
    fs::cp_async_commit();
    const uint32_t k_s = kv_s + (kt & 1) * 2 * Tile::kBytes;
    const uint32_t v_s = k_s + Tile::kBytes;

    // S = Q K^T: SS, K = D
    float s[32];
    fs::fence_regs(s);
    fs::wgmma_fence();
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      fs::wgmma_ss_m64n64(s, fs::desc_k_major<D>(q_s, k), fs::desc_k_major<D>(k_s, k), k > 0);
    fs::wgmma_commit();
    fs::wgmma_wait_all();
    fs::fence_regs(s);

    // Scale in fp32, mask the diagonal or ragged tile, online softmax.
    const bool need_mask = (p.causal && k0 + kBlockK - 1 > q0) || (k0 + kBlockK > p.seq_len);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int key = k0 + fs::frag_col(e);
      float x = s[e] * score_mul;
      if (need_mask && (key >= p.seq_len || (p.causal && key > q0 + fs::frag_row(e)))) x = kNegInf;
      s[e] = x;
      mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], x);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // the 4 lanes of a quad share a row
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      // key 0 is in every row's first tile, so m is finite and masked
      // entries give exp2f(-1e30 - m) = 0
      const float pv = exp2f(s[e] - m[(e >> 1) & 1]);
      s[e] = pv;
      l[(e >> 1) & 1] += pv;
    }
#pragma unroll
    for (int e = 0; e < D / 2; ++e) o[e] *= alpha[(e >> 1) & 1];

    // O += P V: RS, P from registers in bf16, V MN-major, K = 64 keys
    uint32_t a[4][4];
    fs::to_a_fragments(s, a);
    fs::fence_regs(o);
    fs::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fs::wgmma_rs<D>(o, a[kk], fs::desc_mn_major<D>(v_s, kk), 1);
    fs::wgmma_commit();
    fs::wgmma_wait_all();
    fs::fence_regs(o);
    fs::fence_regs(a);
  }

  // Epilogue: O = acc / l in bf16, L = m ln 2 + ln l in natural-log units.
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float lc = fmaxf(l[r], 1e-30f);
    inv[r] = 1.f / lc;
    const int row = q0 + fs::frag_row(2 * r);
    if ((threadIdx.x & 3) == 0 && row < p.seq_len)
      p.lse[static_cast<long long>(bh) * p.seq_len + row] = m[r] * fs::kLn2 + logf(lc);
  }
  bf16* op = static_cast<bf16*>(p.o) + b * p.os.batch + h * p.os.head;
  fs::store_rows<D>(op, p.os.seq, q0, p.seq_len, o, inv[0], inv[1]);
}

template <int D>
cudaError_t launch_sm90(const Params& p, cudaStream_t stream) {
  const size_t smem = Sm90Layout<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_sm90_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.seq_len + kBlockQ - 1) / kBlockQ, p.batch * p.heads);
  flash_fwd_sm90_kernel<D><<<grid, flash_sm90::kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: [batch, seq_len, heads, head_dim] with a contiguous head_dim and
// the (batch, seq, head) strides given in elements, in the order q, k, v, o
// (12 values).  lse: contiguous fp32 [batch * heads, seq_len].
// dtype: 0 = float32 (head_dim 64 or 128, the FMA kernel), 1 = bfloat16
// (head_dim 32, 64 or 128, the tensor-core kernel; every base pointer and
// stride 16-byte aligned).  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                         int batch, int seq_len, int heads, int head_dim,
                         const long long* strides, float scale, int causal, int dtype,
                         void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.batch = batch;
  p.seq_len = seq_len;
  p.heads = heads;
  p.qs = {strides[0], strides[1], strides[2]};
  p.ks = {strides[3], strides[4], strides[5]};
  p.vs = {strides[6], strides[7], strides[8]};
  p.os = {strides[9], strides[10], strides[11]};
  p.scale = scale;
  p.causal = causal;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64) return launch<64>(p, st);
  if (dtype == 0 && head_dim == 128) return launch<128>(p, st);
  if (dtype == 1 && head_dim == 32) return launch_sm90<32>(p, st);
  if (dtype == 1 && head_dim == 64) return launch_sm90<64>(p, st);
  if (dtype == 1 && head_dim == 128) return launch_sm90<128>(p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
