// elt16.cuh: the 16-bit element types of the attention and scan kernels'
// 16-bit forms, bf16 (__nv_bfloat16) and fp16 (__half), as the traits that
// the forms' templates take (flash_attention.cu, flash_attention_wgmma.cu,
// paged_attention.cu, rwkv6_scan.cu). Conversions go through the
// intrinsics only (no implicit __half or __nv_bfloat16 arithmetic or
// conversion), and every conversion to fp32 is exact.
//
// The hi/lo split (split2) of fp32 softmax weights P in [0, 1]: hi is P
// rounded to the type, lo the rounding error rounded again. bf16 keeps 16
// mantissa bits of each weight; fp16 keeps 22 where lo is a normal fp16
// value, and where lo falls below 2^-14 it is a subnormal (absolute steps of
// 2^-24) or underflows to zero, which bounds each weight's error by 2^-25.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

template <typename T>
struct Elt16;

template <>
struct Elt16<__nv_bfloat16> {
  using T2 = __nv_bfloat162;
  static __device__ __forceinline__ float to_f(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 from_f(float x) {
    return __float2bfloat16(x);
  }
  static __device__ __forceinline__ T2 pack(float a, float b) {
    return __floats2bfloat162_rn(a, b);
  }
  static __device__ __forceinline__ float2 unpack(T2 x) {
    return __bfloat1622float2(x);
  }
};

template <>
struct Elt16<__half> {
  using T2 = __half2;
  static __device__ __forceinline__ float to_f(__half x) {
    return __half2float(x);
  }
  static __device__ __forceinline__ __half from_f(float x) {
    return __float2half_rn(x);
  }
  static __device__ __forceinline__ T2 pack(float a, float b) {
    return __floats2half2_rn(a, b);
  }
  static __device__ __forceinline__ float2 unpack(T2 x) {
    return __half22float2(x);
  }
};

// (a, b) rounded to a pair of T, a in the low half, as 32 bits
template <typename T>
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const typename Elt16<T>::T2 v = Elt16<T>::pack(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// a pair of T (the low half first) as fp32, exact
template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t u) {
  return Elt16<T>::unpack(*reinterpret_cast<const typename Elt16<T>::T2*>(&u));
}

// (x0, x1) = hi + lo as pairs of T (x0 in the low half): hi rounded to
// nearest, lo the rounding error rounded again (the note above)
template <typename T>
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const typename Elt16<T>::T2 h = Elt16<T>::pack(x0, x1);
  const float2 f = Elt16<T>::unpack(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack2<T>(x0 - f.x, x1 - f.y);
}

// c (16 x 8, fp32) += a (16 x 16, T) . b (16 x 8, T) on mma.sync m16n8k16
// with fp32 accumulation: a product of two T values is exact in fp32
template <typename T>
__device__ __forceinline__ void mma16(float* c, const uint32_t* a,
                                      const uint32_t* b) {
  if constexpr (std::is_same<T, __half>::value)
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  else
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
