// Kernel 3's branch-free reciprocal (csrc/pnp.cu:score::rcp_rn) against
// __frcp_rn, bit for bit, for every float of either sign with magnitude in
// [2^-20, 2^126), which holds the kernel's guarded depths (|zs| >= 1e-6),
// and, for the record, below and above that range. On a card with nvcc,
// from the root of the checkout (the binary goes to its gitignored build
// directory):
//     mkdir -p pram_tpu_torch/_build && nvcc -gencode arch=compute_90a,code=sm_90a \
//         -O3 -o pram_tpu_torch/_build/check_score_rcp scripts/check_score_rcp.cu \
//         && pram_tpu_torch/_build/check_score_rcp
// Exits 1 if any float of the kernel's range differs.
#include <cstdint>
#include <cstdio>
#include <cstring>
__device__ __forceinline__ float rcp_rn(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return __fmaf_rn(r, __fmaf_rn(-x, r, 1.0f), r);
}
__global__ void check(uint32_t lo, uint32_t hi, unsigned long long* bad, uint32_t* first) {
  for (uint64_t i = lo + blockIdx.x * (uint64_t)blockDim.x + threadIdx.x; i < hi;
       i += (uint64_t)gridDim.x * blockDim.x) {
    for (uint32_t sign = 0; sign < 2; ++sign) {
      const float x = __uint_as_float((uint32_t)i | (sign << 31));
      if (__float_as_uint(rcp_rn(x)) != __float_as_uint(__frcp_rn(x))) {
        atomicAdd(bad, 1ull);
        atomicMin(first, (uint32_t)i);
      }
    }
  }
}
int main() {
  unsigned long long* bad;
  uint32_t* first;
  cudaMallocManaged(&bad, 8);
  cudaMallocManaged(&first, 4);
  const float edges[4] = {1.17549435e-38f /* 2^-126 */, 9.53674316e-07f /* 2^-20 */,
                          8.50705917e+37f /* 2^126 */, 3.40282347e+38f /* the largest */};
  const char* names[3] = {"[2^-126, 2^-20)", "[2^-20, 2^126)", "[2^126, max]"};
  int rc = 0;
  for (int r = 0; r < 3; ++r) {
    uint32_t lo, hi;
    memcpy(&lo, &edges[r], 4);
    memcpy(&hi, &edges[r + 1], 4);
    hi += r == 2;
    *bad = 0;
    *first = 0xffffffffu;
    check<<<132 * 16, 256>>>(lo, hi, bad, first);
    cudaError_t e = cudaDeviceSynchronize();
    printf("rcp check %s, both signs: %s, %u floats a sign, %llu differ, first magnitude 0x%08x\n",
           names[r], cudaGetErrorString(e), hi - lo, *bad, *first);
    if (r == 1 && (*bad || e != cudaSuccess)) rc = 1;
  }
  return rc;
}
