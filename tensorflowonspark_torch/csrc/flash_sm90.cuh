// Hopper (sm_90a) building blocks of the port's tensor-core flash kernels:
// the bf16 forward (csrc/flash_fwd.cu) and the bf16 dK/dV kernel
// (csrc/flash_bwd.cu).  Both are one warpgroup (128 threads) per 64-row tile
// whose products all have that tile's rows as M, so the score tile stays in
// registers and feeds the next product as its A operand.
//
// - Tiles: 64 rows x D bf16 (D = 32, 64 or 128), copied from device memory
//   with cp.async (16 bytes a thread, zero-filled past the sequence end) into
//   shared memory in the layout wgmma reads: 128-byte rows with the 128 B
//   swizzle at D >= 64 (two 64-column blocks at D = 128), 64-byte rows with
//   the 64 B swizzle at D = 32.  Row-major [rows][D] serves as the K-major
//   operand of a score product (K = D) and as the MN-major B operand of an
//   accumulation product (K = the tile's rows, N = D).
// - Products: wgmma m64n64k16 with A and B in shared memory (SS) for a
//   score tile; wgmma m64nDk16 with A in registers (RS) for a D-wide
//   accumulation; fp32 accumulators in registers.
// - Accumulator fragment of m64nN (thread t = 32 w + l of the warpgroup):
//   element e sits at row 16 w + l / 4 + 8 ((e >> 1) & 1) and column
//   8 (e >> 2) + 2 (l % 4) + (e & 1).  Elements 8 kk .. 8 kk + 7 of a
//   64-column score tile are exactly the A fragment of the k16 step kk of
//   the next product, so packing them to bf16 pairs is all the conversion.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash_sm90 {

constexpr int kRows = 64;        // rows of every tile: wgmma's M
constexpr int kThreads = 128;    // one warpgroup
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte aligned address at or after p (the 128 B swizzle
// repeats every 1024 bytes; descriptors assume tiles start on it).
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024u - (smem_addr(p) & 1023u)) & 1023u);
}

// ---- a 64-row bf16 tile in shared memory --------------------------------

template <int D>
struct Tile {
  static_assert(D == 32 || D == 64 || D == 128, "head_dim 32, 64 or 128");
  static constexpr int kRowBytes = D >= 64 ? 128 : 64;
  static constexpr int kBlockBytes = kRows * kRowBytes;  // one 64-column block
  static constexpr int kBytes = kRows * D * 2;
  static constexpr int kChunks = D / 8;                  // 16-byte chunks per row
  static constexpr uint64_t kLayout = D >= 64 ? 1 : 2;   // descriptor: 128 B / 64 B swizzle
  static constexpr uint32_t kAtomBytes = 8 * kRowBytes;  // 8 rows: one swizzle atom

  // byte offset of chunk c (8 bf16 values) of row r
  __device__ static __forceinline__ uint32_t offset(int r, int c) {
    if (D >= 64) return (c >> 3) * kBlockBytes + r * 128 + (((c & 7) ^ (r & 7)) << 4);
    return r * 64 + (((c & 3) ^ ((r >> 1) & 3)) << 4);
  }
};

__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo_bytes, uint32_t sbo_bytes,
                                              uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo_bytes >> 4) << 16) |
         (static_cast<uint64_t>(sbo_bytes >> 4) << 32) | (layout << 62);
}

// The tile at `tile` as a K-major operand (rows = M or N, K = D), at k16
// step k: 32 bytes further along the row, the second column block from k = 4.
template <int D>
__device__ __forceinline__ uint64_t desc_k_major(uint32_t tile, int k) {
  using T = Tile<D>;
  const uint32_t addr = tile + (k >> 2) * T::kBlockBytes + (k & 3) * 32;
  return make_desc(addr, 16, T::kAtomBytes, T::kLayout);
}

// The tile at `tile` as an MN-major B operand (K = its rows, N = D), at k16
// step k: 16 rows further down.  LBO steps between 64-column blocks, SBO
// between 8-row groups.
template <int D>
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t tile, int k) {
  using T = Tile<D>;
  const uint32_t addr = tile + k * 16 * T::kRowBytes;
  return make_desc(addr, T::kBlockBytes, T::kAtomBytes, T::kLayout);
}

// ---- asynchronous copies ------------------------------------------------

__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// cp.async writes through the generic proxy; wgmma reads through the async one.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Copy rows [row0, row0 + 64) of one (batch, head) slice of a
// [batch, seq, heads, D] bf16 tensor (rows `row_stride` elements apart) into
// the swizzled tile at `tile`; rows at or past seq_len are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(uint32_t tile, const __nv_bfloat16* src,
                                          long long row_stride, int row0, int seq_len) {
  using T = Tile<D>;
#pragma unroll
  for (int it = 0; it < kRows * T::kChunks / kThreads; ++it) {
    const int i = it * kThreads + static_cast<int>(threadIdx.x);
    const int r = i / T::kChunks;
    const int c = i % T::kChunks;
    const int row = row0 + r;
    const bool in = row < seq_len;
    cp_async_16(tile + T::offset(r, c), src + (in ? row : 0) * row_stride + c * 8, in ? 16 : 0);
  }
}

// ---- wgmma --------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or reuse of registers that an
// asynchronous wgmma owns across the fence, commit and wait above.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64]: A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate)
      : "memory");
}

// D[64 x 32] (+)= A[64 x 16] B[16 x 32]: A from registers (four bf16x2 per thread), B from
// shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_m64n32(float (&d)[16], const uint32_t (&a)[4],
                                               uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
      ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate)
      : "memory");
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64]: A from registers (four bf16x2 per thread), B from
// shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate)
      : "memory");
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128]: A from registers (four bf16x2 per thread), B from
// shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_m64n128(float (&d)[64], const uint32_t (&a)[4],
                                               uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate)
      : "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc_b,
                                         int accumulate) {
  if constexpr (N == 32) wgmma_rs_m64n32(d, a, desc_b, accumulate);
  if constexpr (N == 64) wgmma_rs_m64n64(d, a, desc_b, accumulate);
  if constexpr (N == 128) wgmma_rs_m64n128(d, a, desc_b, accumulate);
}

// ---- fragments ----------------------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A 64 x 64 fp32 score fragment as the four k16 A fragments of the next
// product, rounded to bf16.
__device__ __forceinline__ void to_a_fragments(const float (&s)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
}

// Row (0 or 1 of the thread's two rows) and column of fragment element e,
// relative to the tile.
__device__ __forceinline__ int frag_row(int e) {
  const int t = threadIdx.x;
  return 16 * (t >> 5) + ((t & 31) >> 2) + 8 * ((e >> 1) & 1);
}
__device__ __forceinline__ int frag_col(int e) {
  return 8 * (e >> 2) + 2 * (threadIdx.x & 3) + (e & 1);
}

// ---- masks --------------------------------------------------------------

// Whether (query, key) is attended: both inside the sequence and, causal,
// the key not after the query.
__device__ __forceinline__ bool attended(int query, int key, int seq_len, int causal) {
  return query < seq_len && key < seq_len && (!causal || key <= query);
}

// Store fragment pairs (e, e + 1) of an m64nD accumulator times `mul` as
// bf16 into rows row0.. of a [batch, seq, heads, D] slice, rows below seq_len.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, long long row_stride, int row0,
                                           int seq_len, const float (&acc)[D / 2], float mul0,
                                           float mul1) {
#pragma unroll
  for (int e = 0; e < D / 2; e += 2) {
    const int row = row0 + frag_row(e);
    if (row >= seq_len) continue;
    const float mul = ((e >> 1) & 1) ? mul1 : mul0;
    *reinterpret_cast<__nv_bfloat162*>(base + row * row_stride + frag_col(e)) =
        __floats2bfloat162_rn(acc[e] * mul, acc[e + 1] * mul);
  }
}

}  // namespace flash_sm90
