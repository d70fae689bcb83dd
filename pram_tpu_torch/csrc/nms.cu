// Score-map non-maximum suppression, for Hopper (f32 or bf16 maps).
//
// Replaces pram_tpu/ops/nms_pallas.py:102 simple_nms_pallas (_nms_kernel):
// the whole simple_nms chain of pram_tpu/ops/nms.py in one pass over the map,
//     max_mask = s == maxpool(s)
//     repeat num_iters times:
//         supp     = maxpool(max_mask) > 0
//         supp_s   = where(supp, 0, s)
//         max_mask |= (supp_s == maxpool(supp_s)) & ~supp
//     out = where(max_mask, s, 0)
// with maxpool a (2R+1) x (2R+1) window, stride 1, and positions outside the
// image counting as -inf (the plain max_pool_2d's padding; the TPU kernel pads
// with zeros, which is the same only for non-negative maps).
//
// What bounds it: at 32 x 480 x 640 the map is read once and written once
// (39 MB in bf16), 0.012 ms at 3.35 TB/s; the cheapest exact form of the
// chain is ~28 operations a pixel (three float pools at ~3 max a pixel a
// direction, two binary pools as word operations, the tests and masks),
// 0.004 ms, so the bytes bind. As in the TPU kernel, no intermediate
// reaches device memory.
//
// The design. A block owns one (image, TH x TW output tile) and loads it
// with a halo of (1 + 2 * num_iters) * R pixels on all four sides: each pool
// leaves R more pixels of the border of the loaded region wrong, so after
// the chain exactly the tile is right; each stage computes only the rows
// still right (the region shrinks by R a stage). The loaded region is LW =
// 256 columns (four 64-column words) by TH + 2 * halo rows, TH = 56: at
// SFD2's R = 4, num_iters = 2 (halo 20) a 56 x 216 tile, 2.03x the output
// loaded, 3 x 9 tiles an image.
//   - S, the scores, are kept once in the input type (bf16 holds the main
//     path's values exactly), loaded by cp.async where W is even (pixel
//     pairs, 4 or 8 bytes) and plainly where it is odd; positions outside
//     the image are set to -inf by coordinate.
//   - The masks are bits: a word pair {E, O} holds 32 column pairs of a
//     row, E bit l the even pixel 2l of them and O bit l the odd one. The
//     binary pools (supp) are dilations: down the column an OR of 2R + 1
//     words, along the row ORs of funnel shifts by 0..R/2 pairs of E and O
//     across neighbouring words. Bits outside the image are kept 0.
//   - The float pools run on pixel pairs (bf16x2 or float2), one scratch
//     plane V in the input type: down the column a thread takes a pair and
//     8 rows, the window's maximum composed from doubling spans (45 max for
//     16 outputs at R = 4); along the row a thread takes a word pair (32
//     pairs of a row, lanes on consecutive rows), 8 pairs a step from
//     16-byte loads: the maxima a0(p) of the R pairs from p - R/2, m(p) =
//     max(max(a0(p), pair p + R/2), (a0(p).hi, a0(p + 1).lo)) (the odd
//     half's window stitched by one byte permute), and s == m gathered into
//     E and O by one set.eq and one LOP3 a pair: ~7 operations for 2 pixels
//     at R = 4. supp_s = where(supp, 0, s) is formed as the column pass
//     loads it, from S and the supp bits; the re-detection needs no supp_s
//     at the compare, since it is masked by ~supp.
//   - S and V rows are 132 pairs (528 bytes in bf16), so that the row
//     pass's lanes, a row apart, hit distinct banks. Shared memory: bf16
//     108 KB a block (two blocks an SM), f32 207 KB.
//   - Arrays indexed in unrolled loops stay in registers only where every
//     loop's trip count is a constant: a level of the doubling spans is a
//     template (double_span), not an inner loop bounded by the outer one's
//     counter, which nvcc left unrolled and put on the stack.
// Max and equality are exact, so the result agrees with the plain version
// bit for bit, for maps without NaN.
//
// Layouts: scores [B, H, W] and out [B, H, W], f32 or bf16, contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NT = 512;          // threads of a block
constexpr int NWARP = NT / 32;
constexpr int NWD = 4;           // {E, O} word pairs of a loaded row
constexpr int LP = 32 * NWD;     // pixel pairs of a loaded row
constexpr int LW = 2 * LP;       // pixels of a loaded row
constexpr int TH = 56;           // output rows of a block
constexpr int CH = 8;            // rows a thread emits in a column pass
constexpr int PADP = 2;          // pairs of padding on each side of a row of V (R / 2)
constexpr int VP = LP + 2 * PADP;  // pairs a row of S and V: 528 bytes in bf16, so that
                                   // lanes on consecutive rows hit distinct banks
constexpr int CP = 8;            // pairs a step of the row pass
constexpr size_t MAX_SMEM = 232448;

typedef __nv_bfloat16 bf16;

// Pixel pairs of each type: max, the (a.hi, b.lo) stitch, zeroing of
// halves, -inf, the halves, equality masks, 16-byte loads.
struct PairBF16 {
  typedef unsigned P;
  typedef bf16 T;
  static __device__ __forceinline__ P pmax(P a, P b) {
    __nv_bfloat162 r = __hmax2(*reinterpret_cast<__nv_bfloat162*>(&a),
                               *reinterpret_cast<__nv_bfloat162*>(&b));
    return *reinterpret_cast<unsigned*>(&r);
  }
  static __device__ __forceinline__ P stitch(P a, P b) { return __byte_perm(a, b, 0x5432); }
  static __device__ __forceinline__ P keep(P a, unsigned klo, unsigned khi) {
    return a & ((klo ? 0x0000FFFFu : 0u) | (khi ? 0xFFFF0000u : 0u));
  }
  static __device__ __forceinline__ P ninf() { return 0xFF80FF80u; }
  static __device__ __forceinline__ T ninf_t() { return __ushort_as_bfloat16(0xFF80); }
  static __device__ __forceinline__ T first(P a) { return __ushort_as_bfloat16(a & 0xFFFFu); }
  static __device__ __forceinline__ T second(P a) { return __ushort_as_bfloat16(a >> 16); }
  // 0xFFFF in each half where a == b (as floats: +0 == -0)
  static __device__ __forceinline__ unsigned eq(P a, P b) {
    unsigned d;
    asm("set.eq.u32.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  // N pairs from p, 16-byte aligned, N a multiple of 4
  template <int N>
  static __device__ __forceinline__ void load(const P* p, P (&x)[N]) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[q];
      x[4 * q] = v.x;
      x[4 * q + 1] = v.y;
      x[4 * q + 2] = v.z;
      x[4 * q + 3] = v.w;
    }
  }
};

struct PairF32 {
  typedef float2 P;
  typedef float T;
  static __device__ __forceinline__ P pmax(P a, P b) {
    return make_float2(fmaxf(a.x, b.x), fmaxf(a.y, b.y));
  }
  static __device__ __forceinline__ P stitch(P a, P b) { return make_float2(a.y, b.x); }
  static __device__ __forceinline__ P keep(P a, unsigned klo, unsigned khi) {
    return make_float2(klo ? a.x : 0.f, khi ? a.y : 0.f);
  }
  static __device__ __forceinline__ P ninf() { return make_float2(-INFINITY, -INFINITY); }
  static __device__ __forceinline__ T ninf_t() { return -INFINITY; }
  static __device__ __forceinline__ T first(P a) { return a.x; }
  static __device__ __forceinline__ T second(P a) { return a.y; }
  static __device__ __forceinline__ unsigned eq(P a, P b) {
    return (a.x == b.x ? 0x0000FFFFu : 0u) | (a.y == b.y ? 0xFFFF0000u : 0u);
  }
  template <int N>
  static __device__ __forceinline__ void load(const P* p, P (&x)[N]) {
#pragma unroll
    for (int q = 0; q < N / 2; ++q) {
      const float4 v = reinterpret_cast<const float4*>(p)[q];
      x[2 * q] = make_float2(v.x, v.y);
      x[2 * q + 1] = make_float2(v.z, v.w);
    }
  }
};

template <typename T> struct PairOf;
template <> struct PairOf<bf16> { typedef PairBF16 type; };
template <> struct PairOf<float> { typedef PairF32 type; };

__host__ __device__ inline size_t smem_bytes(int lh, size_t elem) {
  return (size_t)2 * lh * VP * 2 * elem +
         (size_t)3 * lh * NWD * sizeof(uint2) + NWD * sizeof(uint2);
}

// bit l of the word pair {E, O} moved to l - s: the bits of pairs p + s,
// across the neighbouring words xl (k - 1) and xr (k + 1)
__device__ __forceinline__ unsigned shifted(unsigned xl, unsigned x, unsigned xr, int s) {
  return s > 0 ? __funnelshift_r(x, xr, s) : s < 0 ? __funnelshift_l(xl, x, -s) : x;
}

// w[i] = max(w[i], w[i + SPAN]) in place: after SPAN = 1, 2, .., w[i] is
// the max of the 2 SPAN values from i. (A level a template, with a constant
// trip count, so that w stays in registers.)
template <typename Op, int SPAN, typename P, int N>
__device__ __forceinline__ void double_span(P (&w)[N]) {
#pragma unroll
  for (int i = 0; i + 2 * SPAN <= N; ++i) w[i] = Op::pmax(w[i], w[i + SPAN]);
}

__device__ __forceinline__ void cp_async(void* smem, const void* gmem, int bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (bytes == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst), "l"(gmem));
}

template <typename T, int R>
__global__ void __launch_bounds__(NT, sizeof(T) == 2 ? 2 : 1)
nms_kernel(const T* __restrict__ scores, T* __restrict__ out, int H, int W,
           int num_iters, int halo) {
  static_assert(R == 2 || R == 4, "radii 2 and 4");
  typedef typename PairOf<T>::type Op;
  typedef typename Op::P P;
  extern __shared__ __align__(16) unsigned char smem[];
  const int LH = TH + 2 * halo, TW = LW - 2 * halo;
  T* S = reinterpret_cast<T*>(smem);                        // [LH, 2 VP]
  const P* S2 = reinterpret_cast<const P*>(S);              // [LH, VP]
  P* V = reinterpret_cast<P*>(S + (size_t)LH * 2 * VP) + PADP;  // [LH, VP]
  uint2* MM = reinterpret_cast<uint2*>(V - PADP + (size_t)LH * VP);  // max_mask [LH, NWD]
  uint2* SP = MM + LH * NWD;                                // supp
  uint2* TB = SP + LH * NWD;                                // column pass of a dilation
  uint2* CV = TB + LH * NWD;                                // columns inside the image [NWD]

  const int b = blockIdx.z;
  const int ty0 = blockIdx.y * TH, tx0 = blockIdx.x * TW;
  const int gy0 = ty0 - halo, gx0 = tx0 - halo;  // gx0 is even
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const T* src = scores + (size_t)b * H * W;

  // the scores with the halo, -inf outside the image
  if ((W & 1) == 0) {
    for (int it = tid; it < LH * LP; it += NT) {
      const int y = it / LP, p = it % LP;
      const int gy = gy0 + y, gx = gx0 + 2 * p;
      P* dst = reinterpret_cast<P*>(S) + y * VP + p;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        cp_async(dst, src + (size_t)gy * W + gx, sizeof(P));
      else
        *dst = Op::ninf();
    }
    asm volatile("cp.async.wait_all;\n" ::);
  } else {
    for (int it = tid; it < LH * LW; it += NT) {
      const int y = it / LW, x = it % LW;
      const int gy = gy0 + y, gx = gx0 + x;
      S[y * 2 * VP + x] = gy >= 0 && gy < H && gx >= 0 && gx < W ? src[(size_t)gy * W + gx] : Op::ninf_t();
    }
  }
  for (int it = tid; it < LH * 2 * PADP; it += NT) {
    const int y = it / (2 * PADP), q = it % (2 * PADP);
    V[y * VP + (q < PADP ? q - PADP : LP + q - PADP)] = Op::ninf();
  }
  if (tid < NWD) {
    unsigned e = 0, o = 0;
    for (int l = 0; l < 32; ++l) {
      const int gx = gx0 + 64 * tid + 2 * l;
      e |= (unsigned)(gx >= 0 && gx < W) << l;
      o |= (unsigned)(gx + 1 >= 0 && gx + 1 < W) << l;
    }
    CV[tid] = make_uint2(e, o);
  }
  __syncthreads();
  auto row_in = [&](int y) { return gy0 + y >= 0 && gy0 + y < H; };

  // A float pool over rows [mg, LH - mg): detection (SUPP false) on s, or
  // a re-detection on supp_s; updates max_mask.
  auto float_stage = [&](int mg, auto supp_tag) {
    constexpr bool SUPP = decltype(supp_tag)::value;
    const int r0 = mg, r1 = LH - mg;
    // column pass into V, a thread a pair and CH rows (the last run ends at
    // r1, overlapping the one before: r1 - r0 >= TH >= CH)
    const int runs = (r1 - r0 + CH - 1) / CH;
    for (int it = tid; it < runs * LP; it += NT) {
      const int p = it % LP, y0 = min(r0 + (it / LP) * CH, r1 - CH);
      const int k = p >> 5, l = p & 31;
      constexpr int NWIN = CH + 2 * R;
      P w[NWIN];
      const P* col = S2 + (y0 - R) * VP + p;
      const uint2* spc = SP + (y0 - R) * NWD + k;
#pragma unroll
      for (int i = 0; i < NWIN; ++i) {
        P a = col[i * VP];
        if (SUPP) {
          const uint2 sp = spc[i * NWD];
          a = Op::keep(a, ~sp.x >> l & 1u, ~sp.y >> l & 1u);
        }
        w[i] = a;
      }
      // w[i] = max over 2R rows from i, by doubling spans, in place
      double_span<Op, 1>(w);
      double_span<Op, 2>(w);
      if (R == 4) double_span<Op, 4>(w);
      P* vc = V + y0 * VP + p;
#pragma unroll
      for (int j = 0; j < CH; ++j) vc[j * VP] = Op::pmax(w[j], w[j + 1]);
    }
    __syncthreads();
    // row pass: a thread a word pair of a row, lanes on consecutive rows,
    // CP pairs a step from 16-byte loads: pair p's window max from the
    // maxima a0(p) of the R pairs from p - R/2 and a0(p + 1), the compares
    // gathered into bit j and 16 + j of acc by one LOP3 a pair
    const int nrow = r1 - r0;
    for (int it = tid; it < nrow * NWD; it += NT) {
      const int k = it / nrow, y = r0 + (it - k * nrow);
      unsigned e = 0, o = 0;
#pragma unroll
      for (int c = 0; c < 32 / CP; ++c) {
        const int p0 = 32 * k + CP * c;
        P x[CP + 2 * PADP], s2[CP];  // V pairs p0 - PADP .., S pairs p0 ..
        Op::load(V + y * VP + p0 - PADP, x);
        Op::load(S2 + y * VP + p0, s2);
        P m2[CP + 2 * PADP - 1];
#pragma unroll
        for (int i = 0; i + 1 < CP + 2 * PADP; ++i) m2[i] = Op::pmax(x[i], x[i + 1]);
        P a0[CP + 1];  // a0[j]: the R pairs from p0 + j - R/2
#pragma unroll
        for (int j = 0; j <= CP; ++j)
          a0[j] = R == 4 ? Op::pmax(m2[j + PADP - 2], m2[j + PADP]) : m2[j + PADP - 1];
        unsigned acc = 0;
#pragma unroll
        for (int j = 0; j < CP; ++j) {
          const P m = Op::pmax(Op::pmax(a0[j], x[j + PADP + R / 2]), Op::stitch(a0[j], a0[j + 1]));
          acc |= Op::eq(s2[j], m) & (0x00010001u << j);
        }
        e |= (acc & 0xFFFFu) << (CP * c);
        o |= (acc >> 16) << (CP * c);
      }
      const uint2 cv = row_in(y) ? CV[k] : make_uint2(0u, 0u);
      uint2* mm = MM + y * NWD + k;
      if (SUPP) {
        const uint2 sp = SP[y * NWD + k];
        *mm = make_uint2(mm->x | (e & ~sp.x & cv.x), mm->y | (o & ~sp.y & cv.y));
      } else {
        *mm = make_uint2(e & cv.x, o & cv.y);
      }
    }
    __syncthreads();
  };

  // supp = dilation of max_mask over rows [mg, LH - mg), 0 outside the image
  auto binary_stage = [&](int mg) {
    const int r0 = mg, r1 = LH - mg;
    for (int it = tid; it < (r1 - r0) * NWD; it += NT) {
      const int y = r0 + it / NWD, k = it % NWD;
      uint2 acc = MM[(y - R) * NWD + k];
#pragma unroll
      for (int d = 1 - R; d <= R; ++d) {
        const uint2 x = MM[(y + d) * NWD + k];
        acc.x |= x.x;
        acc.y |= x.y;
      }
      TB[y * NWD + k] = acc;
    }
    __syncthreads();
    for (int it = tid; it < (r1 - r0) * NWD; it += NT) {
      const int y = r0 + it / NWD, k = it % NWD;
      const uint2 t = TB[y * NWD + k];
      const uint2 tl = k > 0 ? TB[y * NWD + k - 1] : make_uint2(0u, 0u);
      const uint2 tr = k < NWD - 1 ? TB[y * NWD + k + 1] : make_uint2(0u, 0u);
      unsigned e = 0, o = 0;
#pragma unroll
      for (int s = -R / 2; s <= R / 2; ++s) {
        const unsigned se = shifted(tl.x, t.x, tr.x, s), so = shifted(tl.y, t.y, tr.y, s);
        e |= se;  // even pixel 2l from even pixels 2(l + s)
        o |= so;  // odd from odd
        if (s < R / 2) e |= so;   // even 2l from odd 2(l + s) + 1
        if (s > -R / 2) o |= se;  // odd 2l + 1 from even 2(l + s)
      }
      const uint2 cv = row_in(y) ? CV[k] : make_uint2(0u, 0u);
      SP[y * NWD + k] = make_uint2(e & cv.x, o & cv.y);
    }
    __syncthreads();
  };

  int mg = R;
  float_stage(mg, std::false_type());
  for (int iter = 0; iter < num_iters; ++iter) {
    mg += R;
    binary_stage(mg);
    mg += R;
    float_stage(mg, std::true_type());
  }

  // out = where(max_mask, s, 0) over the tile
  T* dst = out + (size_t)b * H * W;
  for (int ty = warp; ty < TH && ty0 + ty < H; ty += NWARP) {
    const int gy = ty0 + ty, y = halo + ty;
    for (int q = lane; q < TW / 2 && tx0 + 2 * q < W; q += 32) {
      const int gx = tx0 + 2 * q, p = halo / 2 + q;
      const uint2 w = MM[y * NWD + (p >> 5)];
      const P v = Op::keep(S2[y * VP + p], w.x >> (p & 31) & 1u, w.y >> (p & 31) & 1u);
      T* o = dst + (size_t)gy * W + gx;
      if ((W & 1) == 0) {
        *reinterpret_cast<P*>(o) = v;
      } else {
        o[0] = Op::first(v);
        if (gx + 1 < W) o[1] = Op::second(v);
      }
    }
  }
}

template <typename T, int R>
int launch(const void* scores, void* out, int B, int H, int W, int num_iters,
           cudaStream_t stream) {
  const int halo = (1 + 2 * num_iters) * R;
  const int LH = TH + 2 * halo, TW = LW - 2 * halo;
  const size_t smem = smem_bytes(LH, sizeof(T));
  if (TW < 2 || smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  auto kern = nms_kernel<T, R>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  kern<<<grid, NT, smem, stream>>>(static_cast<const T*>(scores),
                                   static_cast<T*>(out), H, W, num_iters, halo);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* scores, void* out, int B, int H, int W, int radius,
             int num_iters, cudaStream_t s) {
  switch (radius) {
    // SFD2's radius 4, and 2 for the tests' smaller maps
    case 2: return launch<T, 2>(scores, out, B, H, W, num_iters, s);
    case 4: return launch<T, 4>(scores, out, B, H, W, num_iters, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int pram_nms(const void* scores, void* out, int B, int H, int W,
                        int radius, int num_iters, int is_bf16, void* stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  if (num_iters < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<bf16>(scores, out, B, H, W, radius, num_iters, s)
                 : dispatch<float>(scores, out, B, H, W, radius, num_iters, s);
}
