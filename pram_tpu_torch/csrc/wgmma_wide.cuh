// Wide wgmma products for Hopper: a warpgroup's 64 x N accumulator (N =
// 128 or 256) in registers, the s8 x s8 -> s32 and bf16 x bf16 -> f32
// products that fill it from two shared-memory descriptors, and the
// register hand-over between warpgroups (setmaxnreg). Shared by the conv
// tile (conv_tile.cuh, kernels 18 and 19) and the residual-MLP tile
// (mlp_tile.cuh, kernels 2 and 16) and the residual-MLP backward (mlp_bwd.cu,
// kernel 15), whose products read MN-major operands too (mma_t).

#pragma once

#include <stdint.h>

namespace {

namespace wgw {

// a 64 x N accumulator over a warpgroup (attention_wgmma.cuh's layout,
// N / 8 blocks of 8 columns)
template <typename T, int N>
struct Acc {
  T d[N / 2];
};

template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int K>
__device__ __forceinline__ void mma_wait_group() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(K) : "memory");
}

#define WGW_K8(c, k, i)                                                     \
  k(c.d[i]), k(c.d[i + 1]), k(c.d[i + 2]), k(c.d[i + 3]), k(c.d[i + 4]),    \
      k(c.d[i + 5]), k(c.d[i + 6]), k(c.d[i + 7])
#define WGW_K64(c, k, i)                                                    \
  WGW_K8(c, k, i), WGW_K8(c, k, i + 8), WGW_K8(c, k, i + 16),               \
      WGW_K8(c, k, i + 24), WGW_K8(c, k, i + 32), WGW_K8(c, k, i + 40),     \
      WGW_K8(c, k, i + 48), WGW_K8(c, k, i + 56)
#define WGW_R64                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"
#define WGW_R128                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "  \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "  \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "  \
  "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "      \
  "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "      \
  "%122, %123, %124, %125, %126, %127}"

// c (+)= A B^T over 32 bytes of K: A [64 x 32 bytes] and B [N x 32 bytes],
// both K-major in shared memory; accumulate 0 overwrites c
__device__ __forceinline__ void mma(Acc<int, 256>& c, uint64_t da, uint64_t db,
                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " WGW_R128
      ", %128, %129, p;\n}\n"
      : WGW_K64(c, "+r", 0), WGW_K64(c, "+r", 64)
      : "l"(da), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void mma(Acc<int, 128>& c, uint64_t da, uint64_t db,
                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " WGW_R64
      ", %64, %65, p;\n}\n"
      : WGW_K64(c, "+r", 0)
      : "l"(da), "l"(db), "r"(accumulate));
}
// bf16: TA = 1 and / or TB = 1 read A and / or B MN-major (wgmma's
// transpose bits, which bf16 takes and s8 does not)
template <int TA, int TB>
__device__ __forceinline__ void mma_t(Acc<float, 256>& c, uint64_t da,
                                      uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " WGW_R128
      ", %128, %129, p, 1, 1, %131, %132;\n}\n"
      : WGW_K64(c, "+f", 0), WGW_K64(c, "+f", 64)
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}
__device__ __forceinline__ void mma(Acc<float, 256>& c, uint64_t da,
                                    uint64_t db, int accumulate) {
  mma_t<0, 0>(c, da, db, accumulate);
}
__device__ __forceinline__ void mma(Acc<float, 128>& c, uint64_t da,
                                    uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WGW_R64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WGW_K64(c, "+f", 0)
      : "l"(da), "l"(db), "r"(accumulate));
}

// keeps the compiler from touching accumulator registers across the
// asynchronous products
template <int N>
__device__ __forceinline__ void reg_fence(Acc<int, N>& c) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) asm volatile("" : "+r"(c.d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(Acc<float, N>& c) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) asm volatile("" : "+f"(c.d[i])::"memory");
}

}  // namespace wgw

}  // namespace
