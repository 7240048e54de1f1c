// FlashAttention-2 forward for NVIDIA Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` of
// tensorflowonspark_tpu/ops/flash_attention.py (launched by `_flash_fwd`).
// It computes what that kernel computes: for every (batch, head) the
// attention output O = softmax(scale * Q K^T) V in the input dtype and the
// per-row logsumexp L = m + log(max(l, 1e-30)) in fp32, causal or not, with
// the running max m, running sum l and the output accumulator all in fp32.
//
// Design (not a block-by-block copy of the TPU kernel):
// - One thread block per (batch*head, 64-row query tile).  The TPU kernel's
//   sequential third grid axis and its VMEM scratch carry have no
//   counterpart across CUDA blocks, so the loop over K/V tiles runs inside
//   the block and (m, l, acc) live in registers for the whole loop.
// - Causal: the key loop stops at the diagonal tile; only the diagonal (and
//   a ragged last) tile is masked.  Query tiles are scheduled longest first.
// - Q is loaded once (pre-multiplied by the scale, as the TPU kernel does);
//   each K/V tile is staged in shared memory as fp32, rows padded by 4
//   floats so the float4 reads of the inner products are bank-conflict free.
// - 256 threads as a 16x16 grid: thread (ty, tx) owns query rows 4ty..4ty+3.
//   It computes 4x4 scores (key columns tx+16j) and 4 x D/16 outputs
//   (columns 4tx.. of each 64-wide slice).  Row max and row sum are reduced
//   over the 16 lanes of a half-warp with shuffles; P goes through shared
//   memory to the P.V product.
// - Inputs are read through their (batch, seq, head) strides with a
//   contiguous head_dim, so Q, K and V can be views into one fused QKV
//   projection output: no copy before the launch.
//
// What bounds it on this card: at the serving shape ([4, 1024, 16, 64],
// bf16, causal) the work is 8.6 GFLOP over 33.8 MB of unique bytes, which
// the H100 SXM data sheet (989 TFLOP/s bf16 tensor cores, 3.35 TB/s HBM)
// bounds at about 10 us, by memory.  This first kernel does its products
// as fp32 FMAs on the CUDA cores (67 TFLOP/s peak), so its own floor is
// about 0.13 ms per call and it is bound by FMA issue and shared-memory
// reads, not by memory.  Moving the two products to the tensor cores
// (mma.sync, then wgmma with TMA-fed tiles) is the next step for speed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

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
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, const T* __restrict__ src,
                                          long long row_stride, int row0, int rows, int seq_len,
                                          float mul) {
  constexpr int kLd = Layout<D>::kLd;
  for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
    const int r = idx / D;
    const int c = idx % D;
    const int row = row0 + r;
    float x = 0.f;
    if (row < seq_len) x = to_float(src[row * row_stride + c]) * mul;
    dst[r * kLd + c] = x;
  }
}

template <typename T, int D>
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

  const T* qp = static_cast<const T*>(p.q) + b * p.qs.batch + h * p.qs.head;
  const T* kp = static_cast<const T*>(p.k) + b * p.ks.batch + h * p.ks.head;
  const T* vp = static_cast<const T*>(p.v) + b * p.vs.batch + h * p.vs.head;

  load_tile<T, D>(q_s, qp, p.qs.seq, q0, kBlockQ, p.seq_len, p.scale);

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
    load_tile<T, D>(k_s, kp, p.ks.seq, k0, kBlockK, p.seq_len, 1.f);
    load_tile<T, D>(v_s, vp, p.vs.seq, k0, kBlockK, p.seq_len, 1.f);
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
    T* orow = static_cast<T*>(p.o) + b * p.os.batch + row * p.os.seq + h * p.os.head;
#pragma unroll
    for (int jj = 0; jj < kNj; ++jj)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        orow[jj * 64 + tx * 4 + c] = from_float<T>(acc[i][jj * 4 + c] * inv);
    if (tx == 0) p.lse[static_cast<long long>(bh) * p.seq_len + row] = m[i] + logf(lc);
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = Layout<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.seq_len + kBlockQ - 1) / kBlockQ, p.batch * p.heads);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: [batch, seq_len, heads, head_dim] with a contiguous head_dim and
// the (batch, seq, head) strides given in elements, in the order q, k, v, o
// (12 values).  lse: contiguous fp32 [batch * heads, seq_len].
// dtype: 0 = float32, 1 = bfloat16.  head_dim: 64 or 128.
// Returns the cudaError_t of the launch (0 on success).
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
  if (dtype == 0 && head_dim == 64) return launch<float, 64>(p, st);
  if (dtype == 0 && head_dim == 128) return launch<float, 128>(p, st);
  if (dtype == 1 && head_dim == 64) return launch<__nv_bfloat16, 64>(p, st);
  if (dtype == 1 && head_dim == 128) return launch<__nv_bfloat16, 128>(p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
