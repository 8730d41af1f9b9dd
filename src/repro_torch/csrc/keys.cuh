// Total-order float keys shared by the port's CUDA kernels (topk.cu,
// segmented.cu): the device side of encode_key_values / decode_key_values
// in repro_torch/kernels/common.py. NaN -> the canonical quiet NaN, above
// +inf; -0.0 below +0.0; 16-bit floats widen to int32 keys. I32 (the top-k
// kernels' integer rows) is its own key.
#pragma once

#include <stdint.h>

namespace repro_keys {

enum DType { F32 = 0, BF16 = 1, F16 = 2, I32 = 3 };

template <int DT> struct Bits { using T = uint16_t; };
template <> struct Bits<F32> { using T = uint32_t; };
template <> struct Bits<I32> { using T = uint32_t; };

// encode_key_values (kernels/common.py): float bits -> int32 key
template <int DT>
__device__ __forceinline__ int32_t encode_key(typename Bits<DT>::T bits) {
  if constexpr (DT == I32) {
    return (int32_t)bits;
  } else if constexpr (DT == F32) {
    int32_t y = (int32_t)bits;
    if ((bits & 0x7fffffffu) > 0x7f800000u) y = 0x7fc00000;  // canonical qNaN
    return y < 0 ? (y ^ 0x7fffffff) : y;
  } else {
    const uint32_t b = bits;
    const uint32_t inf = DT == BF16 ? 0x7f80u : 0x7c00u;
    int16_t y = (int16_t)bits;
    if ((b & 0x7fffu) > inf) y = (int16_t)(DT == BF16 ? 0x7fc0 : 0x7e00);
    if (y < 0) y = (int16_t)(y ^ 0x7fff);
    return (int32_t)y;  // widen to int32
  }
}

// tie_signed_zeros (kernels/common.py), where `on` (nan_policy="unsafe"):
// -0.0's key -1 becomes +0.0's 0, so that the two tie as raw floats do (no
// other float encodes to -1)
__device__ __forceinline__ int32_t tie_zero(int32_t k, int on) {
  return on && k == -1 ? 0 : k;
}

// decode_key_values: the 16-bit keys narrow with wrap-around first
template <int DT>
__device__ __forceinline__ typename Bits<DT>::T decode_key(int32_t k) {
  if constexpr (DT == I32) {
    return (uint32_t)k;
  } else if constexpr (DT == F32) {
    return (uint32_t)(k < 0 ? (k ^ 0x7fffffff) : k);
  } else {
    int16_t y = (int16_t)(uint16_t)(k & 0xffff);
    if (y < 0) y = (int16_t)(y ^ 0x7fff);
    return (uint16_t)y;
  }
}

// whether a value's sign bit is clear
template <int DT>
__device__ __forceinline__ bool sign_clear(typename Bits<DT>::T bits) {
  if constexpr (DT == F32 || DT == I32) return !(bits >> 31);
  else return !(bits >> 15);
}

}  // namespace repro_keys
