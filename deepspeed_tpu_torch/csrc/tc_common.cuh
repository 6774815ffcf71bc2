// Tensor-core building blocks of the Hopper kernels: the attention bodies
// (flash_tc.cuh, walked densely by flash_fwd.cu / flash_bwd.cu and over a
// block-sparse layout by sparse_flash.cu; paged_tc.cuh, the paged decode and
// packed-context kernels of paged_decode.cu / ctx_attention.cu) and the
// dequant-matmuls (quant_matmul.cu): cp.async tile loads into the 128-byte-
// swizzled shared-memory layout that wgmma's descriptors read, the
// descriptors, the wgmma.mma_async forms the kernels issue (SS: both operands
// in shared memory, A K-major or, for the paged decode's O^T = V^T P^T,
// MN-major; RS: A from registers, B MN-major for attention's P V, K-major
// for the dequant-matmuls), the accumulator -> A-fragment
// conversion, quad reductions, the segment-range scan behind the tile skip,
// and the few plain helpers every kernel takes (bf16, the full warp mask,
// allow_smem).
//
// A tile [R rows][HD] bf16 in shared memory is HD / 64 column chunks, each
// [R][64] (128 bytes a row) and 1024-byte aligned; inside a chunk the 16-byte
// group c of row r sits at group c ^ (r % 8) -- the 128 B swizzle
// (Swizzle<3,4,3>), so the 8 lanes that write or read one 16-byte column of 8
// rows hit 8 different banks.  The same tile is read two ways:
//   - K-major (the contraction runs over HD): descriptor start = chunk base +
//     64-row block + 32 bytes per k16 step inside the 128-byte row, SBO 1024
//     (8 rows x 128 B), LBO unused;
//   - MN-major (the contraction runs over the rows, HD is N: `tnspB`): start =
//     chunk base + 16 rows (2048 B) per k16 step, LBO = the chunk stride
//     (R x 128 B: the next 64 columns of N), SBO 1024 (the next 8 rows).
//
// The fp32 accumulator of m64nN: thread t of the warpgroup (w = t / 32,
// l = t % 32) holds d[4 j + 2 r + c] = element (row 16 w + l / 4 + 8 r,
// column 8 j + 2 (l % 4) + c).  A row lives in the 4 lanes of a quad, so a
// row reduction is two xor shuffles.  The register A fragment of the k16 step
// kk is the bf16 pairs of accumulator columns 16 kk .. 16 kk + 15, in the
// order (row, col), (row + 8, col), (row, col + 8), (row + 8, col + 8).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace dst {

typedef __nv_bfloat16 bf16;
constexpr unsigned kFull = 0xffffffffu;  // every lane of a warp

// Lets `kernel` launch with `bytes` of dynamic shared memory (above 48 KB
// only after this call).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

namespace tc {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// shared memory, cp.async
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory rounded up to 1024 bytes (the swizzle atom): the
// kernels ask for 1 KB more than they use.
__device__ __forceinline__ bf16* align_1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return reinterpret_cast<bf16*>(p + ((1024u - (a & 1023u)) & 1023u));
}

// 16 bytes global -> shared, zero-filled when !valid (src is then not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Makes this thread's completed shared-memory writes visible to the async
// proxy (wgmma reads its operands through it); a barrier follows.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Element offset of (row r, 16-byte group gcol) in a swizzled tile of R rows.
template <int R>
__device__ __forceinline__ int swz(int r, int gcol) {
  return (gcol >> 3) * R * 64 + r * 64 + (((gcol & 7) ^ (r & 7)) << 3);
}

// Rows row0 .. row0 + R - 1 of a [rows][stride] bf16 array (HD used columns
// from `src`) into a swizzled tile; rows at or beyond `nvalid` (counted from
// row0) are zero-filled.  Every thread of the block calls it; the trip count
// is static, so each thread's row step folds to a constant.
template <int R, int HD, int NT>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, size_t stride, int row0,
                                          int nvalid) {
  constexpr int G = HD / 8;  // 16-byte groups a row
  static_assert((R * G) % NT == 0 && NT % G == 0, "tile not a whole number of passes");
  const int r0 = threadIdx.x / G, gcol = threadIdx.x % G;
  const bf16* from = src + static_cast<size_t>(row0 + r0) * stride + gcol * 8;
#pragma unroll
  for (int i = 0; i < R * G / NT; ++i) {
    const int r = r0 + i * (NT / G);
    cp_async16(smem_u32(dst + swz<R>(r, gcol)),
               r < nvalid ? from + static_cast<size_t>(i) * (NT / G) * stride : src, r < nvalid);
  }
}

// `n` floats src[i * stride] (i < nvalid, else 0) into dst[0 .. n).
template <int NT>
__device__ __forceinline__ void load_floats(float* dst, const float* src, size_t stride, int n,
                                            int nvalid) {
  for (int i = threadIdx.x; i < n; i += NT) {
    const bool ok = i < nvalid;
    cp_async4(smem_u32(dst + i), ok ? src + static_cast<size_t>(i) * stride : src, ok);
  }
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// K-major operand: rows row .. row + 63 (A) or the whole tile (B) of a tile of
// R rows, k16 step kk of the contraction over its columns.
template <int R>
__device__ __forceinline__ uint64_t desc_k(const bf16* tile, int row, int kk) {
  return desc_sw128(smem_u32(tile + (kk >> 2) * R * 64 + row * 64 + (kk & 3) * 16), 16, 1024);
}

// MN-major B operand: rows 16 kk .. 16 kk + 15 of a tile of R rows as the
// contraction, columns from chunk `chunk0` on as N.
template <int R>
__device__ __forceinline__ uint64_t desc_mn(const bf16* tile, int kk, int chunk0) {
  return desc_sw128(smem_u32(tile + chunk0 * R * 64 + kk * 16 * 64), R * 128, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x N] (+)= A[64 x 16] . B[16 x N], both from shared memory, B K-major;
// A K-major (TA = 0) or MN-major (TA = 1: paged_tc.cuh's decode reads V as
// V^T); acc = 0 overwrites d.  TA is wgmma's trans-a immediate.
template <int N, int TA>
struct WgmmaSS;
// d[64 x N] (+)= A[64 x 16] (registers) . B[16 x N]: B MN-major (TB = 1,
// attention's P V) or K-major (TB = 0, the dequant-matmuls: A the decoded
// weight, B the activations, whose rows run along the contraction).  TB is
// wgmma's trans-b immediate.
template <int N, int TB>
struct WgmmaRs;

template <int TA>
struct WgmmaSS<8, TA> {
  static __device__ __forceinline__ void run(float (&d)[4], uint64_t da, uint64_t db,
                                             int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3"
        "}, %4, %5, p, 1, 1, %7, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(da), "l"(db), "r"(acc), "n"(TA));
  }
};

template <int TA>
struct WgmmaSS<16, TA> {
  static __device__ __forceinline__ void run(float (&d)[8], uint64_t da, uint64_t db,
                                             int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, %11, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(acc), "n"(TA));
  }
};

template <int TA>
struct WgmmaSS<64, TA> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t da, uint64_t db,
                                             int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, %35, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(acc), "n"(TA));
  }
};

template <int TA>
struct WgmmaSS<128, TA> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t da, uint64_t db,
                                             int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, %67, 0;\n}\n"
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
        : "l"(da), "l"(db), "r"(acc), "n"(TA));
  }
};

template <int TB>
struct WgmmaRs<16, TB> {
  static __device__ __forceinline__ void run(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc),
          "n"(TB));
  }
};

template <int TB>
struct WgmmaRs<64, TB> {
  static __device__ __forceinline__ void run(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc),
          "n"(TB));
  }
};

template <int TB>
struct WgmmaRs<128, TB> {
  static __device__ __forceinline__ void run(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
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
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc),
          "n"(TB));
  }
};

template <int TB>
struct WgmmaRs<256, TB> {
  static __device__ __forceinline__ void run(float (&d)[128], const uint32_t (&a)[4],
                                             uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
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
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
          "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
          "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
          "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc),
          "n"(TB));
  }
};

template <int N, int TA = 0>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int acc) {
  WgmmaSS<N, TA>::run(d, da, db, acc);
}

template <int N, int TB = 1>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                                         int acc) {
  WgmmaRs<N, TB>::run(d, a, db, acc);
}

// ---------------------------------------------------------------------------
// fragments and reductions
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of k16 step kk from an fp32 accumulator (columns 16 kk ..).
template <int N>
__device__ __forceinline__ void acc_to_a(const float (&d)[N], int kk, uint32_t (&a)[4]) {
  a[0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

// [min, max] of the segment ids seg[lo .. hi) over the warp (every lane gets
// it; an empty range gives min > max).  The kernels skip a pair of tiles
// whose ranges do not meet: conservative, since the mask stays exact.
__device__ __forceinline__ void seg_range(const int* seg, int lo, int hi, int* mn, int* mx) {
  int a = 0x7fffffff, b = -0x7fffffff - 1;
  for (int i = lo + static_cast<int>(threadIdx.x % 32); i < hi; i += 32) {
    const int v = seg[i];
    a = min(a, v);
    b = max(b, v);
  }
  *mn = __reduce_min_sync(kFull, a);
  *mx = __reduce_max_sync(kFull, b);
}

// 2^x on the MUFU unit (flush-to-zero; 2^-inf = 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The score transform shared by the kernels.  Without a soft cap a raw score
// r becomes the base-2 logit r * mul (mul = scale * log2 e), fused into the
// exp2's FMA; with one, logit = cap log2 e tanh(r scale / cap) and its
// derivative factor 1 - tanh^2 (flash_kernel.py:131), and mul = 1.
struct ScoreMap {
  float mul, scale_over_cap, cap_log2e, inv_cap_log2e;
  bool capped;
  __device__ ScoreMap(float scale, float cap)
      : mul(cap > 0.f ? 1.f : scale * kLog2e),
        scale_over_cap(cap > 0.f ? scale / cap : 0.f),
        cap_log2e(cap * kLog2e),
        inv_cap_log2e(cap > 0.f ? 1.f / (cap * kLog2e) : 0.f),
        capped(cap > 0.f) {}
  // in place, with a cap: raw -> cap log2 e tanh(raw scale / cap)
  template <int N>
  __device__ __forceinline__ void apply_cap(float (&x)[N]) const {
    if (!capped) return;
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = cap_log2e * tanhf(x[i] * scale_over_cap);
  }
  // 1 - tanh^2 of a capped logit x (1 without a cap)
  __device__ __forceinline__ float dcap(float x) const {
    const float t = x * inv_cap_log2e;
    return capped ? 1.f - t * t : 1.f;
  }
};

}  // namespace tc
}  // namespace dst
