// Device copies of core/xla_math.py: float32 exp, atan2 / atan, sin and cos
// as the JAX package's CPU build evaluates them, bit for bit.
//
//   exp_f32    XLA CPU's inlined polynomial (Cephes expf) with the fused
//              multiply-adds LLVM forms in it;
//   atan2_f32  glibc 2.36's __ieee754_atan2f and atanf (fdlibm float code,
//              no fused multiply-adds), every special branch kept;
//   sin_f32 / cos_f32
//              glibc 2.36's sinf / cosf, the variant an FMA + AVX2 CPU
//              runs: double arithmetic with double fused multiply-adds, the
//              integer reduction of 4/pi above 120.
//
// XLA runs its float32 code with denormals flushed (FTZ and DAZ); flush()
// applies that where the functions' results or operands can be subnormal.
// Every float operation is an _rn intrinsic (__fmaf_rn / __fma_rn where
// the CPU code fuses), so nvcc's contraction flag cannot change a bit; the
// including source builds with -fmad=false all the same. A NaN result is
// the canonical quiet NaN 0x7fc00000, as in the plain versions.

#pragma once

#include <stdint.h>

namespace xla_math {

// the tables, in constant memory: atanf's atan(0.5), atan(1), atan(1.5) and
// atan(inf) as high and low parts; the cosine polynomial c0..c4 of
// __sincosf_table; __inv_pio4, 4/pi in 32-bit words at every 8-bit offset
__constant__ uint32_t kAtanHi[4] = {0x3EED6338u, 0x3F490FDAu, 0x3F7B985Eu, 0x3FC90FDAu};
__constant__ uint32_t kAtanLo[4] = {0x31AC3769u, 0x33222168u, 0x33140FB4u, 0x33A22168u};
__constant__ uint64_t kCosC[5] = {0x3FF0000000000000ull, 0xBFDFFFFFFD0C621Cull,
                                  0x3FA55553E1068F19ull, 0xBF56C087E89A359Dull,
                                  0x3EF99343027BF8C3ull};
__constant__ uint32_t kInvPio4[24] = {
    0xa2u, 0xa2f9u, 0xa2f983u, 0xa2f9836eu, 0xf9836e4eu, 0x836e4e44u, 0x6e4e4415u, 0x4e441529u,
    0x441529fcu, 0x1529fc27u, 0x29fc2757u, 0xfc2757d1u, 0x2757d1f5u, 0x57d1f534u, 0xd1f534ddu,
    0xf534ddc0u, 0x34ddc0dbu, 0xddc0db62u, 0xc0db6295u, 0xdb629599u, 0x6295993cu, 0x95993c43u,
    0x993c4390u, 0x3c439041u};

__device__ __forceinline__ float canonical_nan() { return __int_as_float(0x7fc00000); }

// the float64 of a bit pattern
__device__ __forceinline__ double f64(uint64_t bits) {
  return __longlong_as_double(static_cast<long long>(bits));
}

// a subnormal float to zero of its sign (XLA's FTZ / DAZ)
__device__ __forceinline__ float flush(float x) {
  return fabsf(x) < 1.17549435082228750797e-38f ? __fmul_rn(x, 0.0f) : x;
}

// ---- exp ------------------------------------------------------------------

__device__ __forceinline__ float exp_f32(float x) {
  x = flush(x);
  if (isnan(x)) return canonical_nan();
  const float lo = __int_as_float(0xC2AF999A), hi = __int_as_float(0x42B1999A);
  x = x < lo ? lo : x;
  x = x > hi ? hi : x;
  float n = floorf(__fmaf_rn(x, __int_as_float(0x3FB8AA3B), 0.5f));
  n = fminf(fmaxf(n, -127.0f), 127.0f);
  float r = __fmaf_rn(-n, __int_as_float(0x3F318000), x);
  r = __fmaf_rn(-n, __int_as_float(0xB95E8083), r);
  float p = __fmaf_rn(r, __int_as_float(0x39506967), __int_as_float(0x3AB743CE));
  p = __fmaf_rn(r, p, __int_as_float(0x3C088908));
  p = __fmaf_rn(r, p, __int_as_float(0x3D2AA9C1));
  p = __fmaf_rn(r, p, __int_as_float(0x3E2AAAAA));
  p = __fmaf_rn(r, p, 0.5f);
  const float y = __fadd_rn(__fmaf_rn(p, __fmul_rn(r, r), r), 1.0f);
  const float scale = __int_as_float((static_cast<int>(n) + 127) << 23);
  return flush(__fmul_rn(y, scale));
}

// ---- atan2 / atan -----------------------------------------------------------

// glibc's atanf (fdlibm) of a float that is not NaN
__device__ __forceinline__ float atanf_glibc(float x) {
  const uint32_t hx = __float_as_uint(x), ix = hx & 0x7fffffffu;
  const bool neg = hx >> 31;
  if (ix >= 0x4c000000u) {  // |x| >= 2^25
    if (ix > 0x7f800000u) return x;
    return neg ? __int_as_float(0xBFC90FDB)   // -atanhi[3] - atanlo[3], folded
               : __int_as_float(0x3FC90FDB);  //  atanlo[3] + atanhi[3]
  }
  int id;
  float r;
  if (ix < 0x3ee00000u) {
    if (ix < 0x31000000u) return x;  // |x| < 2^-29
    id = -1;
    r = x;
  } else {
    const float a = fabsf(x);
    if (ix < 0x3f980000u) {
      if (ix < 0x3f300000u) {
        id = 0;
        r = __fdiv_rn(__fsub_rn(__fadd_rn(a, a), 1.0f), __fadd_rn(a, 2.0f));
      } else {
        id = 1;
        r = __fdiv_rn(__fsub_rn(a, 1.0f), __fadd_rn(a, 1.0f));
      }
    } else if (ix < 0x401c0000u) {
      id = 2;
      r = __fdiv_rn(__fsub_rn(a, 1.5f), __fadd_rn(__fmul_rn(a, 1.5f), 1.0f));
    } else {
      id = 3;
      r = __fdiv_rn(-1.0f, a);
    }
  }
  const float z = __fmul_rn(r, r), w = __fmul_rn(z, z);
  float s1 = __fmul_rn(__int_as_float(0x3C8569D7), w);
  s1 = __fmul_rn(__fadd_rn(s1, __int_as_float(0x3D4BDA59)), w);
  s1 = __fmul_rn(__fadd_rn(s1, __int_as_float(0x3D886B35)), w);
  s1 = __fmul_rn(__fadd_rn(s1, __int_as_float(0x3DBA2E6E)), w);
  s1 = __fmul_rn(__fadd_rn(s1, __int_as_float(0x3E124925)), w);
  s1 = __fmul_rn(__fadd_rn(s1, __int_as_float(0x3EAAAAAB)), z);
  float s2 = __fmul_rn(__int_as_float(0xBD15A221), w);
  s2 = __fmul_rn(__fadd_rn(s2, __int_as_float(0xBD6EF16B)), w);
  s2 = __fmul_rn(__fadd_rn(s2, __int_as_float(0xBD9D8795)), w);
  s2 = __fmul_rn(__fadd_rn(s2, __int_as_float(0xBDE38E38)), w);
  s2 = __fmul_rn(__fadd_rn(s2, __int_as_float(0xBE4CCCCD)), w);
  const float q = __fmul_rn(__fadd_rn(s1, s2), r);
  if (id < 0) return __fsub_rn(r, q);
  const float big = __fsub_rn(__uint_as_float(kAtanHi[id]),
                              __fsub_rn(__fsub_rn(q, __uint_as_float(kAtanLo[id])), r));
  return neg ? -big : big;
}

// glibc 2.36's atan2f(y, x) with XLA's flushed division
__device__ __forceinline__ float atan2_f32(float y, float x) {
  const uint32_t hx = __float_as_uint(x), hy = __float_as_uint(y);
  const uint32_t ix = hx & 0x7fffffffu, iy = hy & 0x7fffffffu;
  if (ix > 0x7f800000u || iy > 0x7f800000u) return canonical_nan();
  if (hx == 0x3f800000u) return atanf_glibc(y);
  const uint32_t m = ((hx >> 30) & 2u) | (hy >> 31);
  const float pi = __int_as_float(0x40490FDB), tiny = __int_as_float(0x0DA24260);
  const float pi_lo_neg = __int_as_float(0x33BBBD2E);
  // the folded constants: pi + tiny, -pi - tiny, pi/2 + tiny, -pi/2 - tiny
  const float pi_t = __fadd_rn(tiny, pi), npi_t = __fsub_rn(-pi, tiny);
  const float pio2_t = __fadd_rn(tiny, __int_as_float(0x3FC90FDB));
  const float npio2_t = __fsub_rn(__int_as_float(0xBFC90FDB), tiny);
  if (iy == 0) {
    if (m < 2) return y;
    return m == 2 ? pi_t : npi_t;
  }
  if (ix == 0) return (hy >> 31) ? npio2_t : pio2_t;
  if (ix == 0x7f800000u) {
    const float pio4 = __int_as_float(0x3F490FDB);
    if (iy == 0x7f800000u) {
      switch (m) {
        case 0: return __fadd_rn(tiny, pio4);
        case 1: return __fsub_rn(__int_as_float(0xBF490FDB), tiny);
        case 2: return __fadd_rn(__fmul_rn(3.0f, pio4), tiny);
        default: return __fsub_rn(__fmul_rn(-3.0f, pio4), tiny);
      }
    }
    switch (m) {
      case 0: return 0.0f;
      case 1: return -0.0f;
      case 2: return pi_t;
      default: return npi_t;
    }
  }
  if (iy == 0x7f800000u) return (hy >> 31) ? npio2_t : pio2_t;
  const int k = (static_cast<int>(iy) - static_cast<int>(ix)) >> 23;
  float z;
  if (k > 60) {
    z = __fsub_rn(__int_as_float(0x3FC90FDB), __int_as_float(0x333BBD2E));
  } else if ((hx >> 31) && k < -60) {
    z = 0.0f;
  } else {
    z = atanf_glibc(flush(fabsf(__fdiv_rn(flush(y), flush(x)))));
  }
  float out;
  switch (m) {
    case 0: out = z; break;
    case 1: out = -z; break;
    case 2: out = __fsub_rn(pi, __fadd_rn(pi_lo_neg, z)); break;
    default: out = __fsub_rn(__fadd_rn(z, pi_lo_neg), pi); break;
  }
  return isnan(out) ? canonical_nan() : out;
}

__device__ __forceinline__ float atan_f32(float x) { return atan2_f32(x, 1.0f); }

// ---- sin / cos ----------------------------------------------------------------

// glibc 2.36's __sincosf_table (sign, 2/pi * 2^24, pi/2, then the cosine
// c0..c4 and sine s1..s3 polynomials; the second table negates the cosine's)
__device__ __forceinline__ double sincos_c(int i, bool negate) {
  const double v = f64(kCosC[i]);
  return negate ? -v : v;
}

__device__ __forceinline__ double sin_poly(double x, double x2) {
  const double s1 = f64(0xBFC555545995A603ull), s2 = f64(0x3F81107605230BC4ull);
  const double s3 = f64(0xBF2994EB3774CF24ull);
  const double s1p = __fma_rn(x2, s3, s2);
  const double x3 = __dmul_rn(x2, x);
  const double x5 = __dmul_rn(x2, x3);
  return __fma_rn(s1p, x5, __fma_rn(x3, s1, x));
}

__device__ __forceinline__ double cos_poly(double x2, bool negate) {
  const double x4 = __dmul_rn(x2, x2);
  const double c1p = __fma_rn(x2, sincos_c(1, negate), sincos_c(0, negate));
  const double c2p = __fma_rn(x2, sincos_c(4, negate), sincos_c(3, negate));
  const double x6 = __dmul_rn(x2, x4);
  return __fma_rn(c2p, x6, __fma_rn(x4, sincos_c(2, negate), c1p));
}

// glibc's reduce_large: |x| >= 120 (float bits xi) reduced by pi/2 with the
// 192-bit table of 4/pi, in integers; returns the remainder, sets *np
__device__ __forceinline__ double reduce_large(uint32_t xi, int* np) {
  const uint32_t* arr = &kInvPio4[(xi >> 26) & 15];
  const int shift = (xi >> 23) & 7;
  xi = (xi & 0xffffffu) | 0x800000u;
  xi <<= shift;
  uint64_t res0 = static_cast<uint32_t>(xi * arr[0]);
  const uint64_t res1 = static_cast<uint64_t>(xi) * arr[4];
  const uint64_t res2 = static_cast<uint64_t>(xi) * arr[8];
  res0 = (res2 >> 32) | (res0 << 32);
  res0 += res1;
  const uint64_t n = (res0 + (1ull << 61)) >> 62;
  res0 -= n << 62;
  *np = static_cast<int>(n);
  return __dmul_rn(__ll2double_rn(static_cast<long long>(res0)), f64(0x3C1921FB54442D18ull));
}

__device__ __forceinline__ float sincos_f32(float y, bool cosine) {
  const uint32_t bits = __float_as_uint(y);
  const uint32_t top = (bits >> 20) & 0x7ffu;
  if (top > 0x7f7u) return canonical_nan();
  const double x = static_cast<double>(y);
  if (top <= 0x3f3u) {  // |y| < pi/4
    if (top <= 0x397u) return cosine ? 1.0f : y;
    const double x2 = __dmul_rn(x, x);
    return __double2float_rn(cosine ? cos_poly(x2, false) : sin_poly(x, x2));
  }
  double r;
  int n, quad;
  if (top <= 0x42eu) {  // |y| < 120
    const double t = __dmul_rn(x, f64(0x41645F306DC9C883ull));
    n = (static_cast<int>(t) + 0x800000) >> 24;
    r = __fma_rn(-static_cast<double>(n), f64(0x3FF921FB54442D18ull), x);
    quad = n;
  } else {
    r = reduce_large(bits, &n);
    quad = n + static_cast<int>(bits >> 31);
  }
  const double r2 = __dmul_rn(r, r);
  const bool use_cos = cosine ? (n & 1) == 0 : (n & 1) == 1;
  const double out = use_cos ? cos_poly(r2, (quad & 2) != 0)
                             : sin_poly(((quad + 1) & 2) ? -r : r, r2);  // sign {1, -1, -1, 1}
  return __double2float_rn(out);
}

__device__ __forceinline__ float sin_f32(float y) { return sincos_f32(y, false); }
__device__ __forceinline__ float cos_f32(float y) { return sincos_f32(y, true); }

}  // namespace xla_math
