// Cell types of the Sinnamon sketch and the CSR store, and their exact
// decode to f32.  Shared by every kernel that reads sketch cells or stored
// values, so that all of them decode a cell to the same float.
#pragma once

#include <stdint.h>

struct Bf16 { uint16_t bits; };
struct F8E4M3 { uint8_t bits; };

__device__ __forceinline__ float to_f32(float c) { return c; }

__device__ __forceinline__ float to_f32(Bf16 c) {
  return __uint_as_float(static_cast<uint32_t>(c.bits) << 16);
}

// e4m3fn -> f32, exact, subnormals included (codes 0x7f/0xff, NaN, are
// never stored: cells saturate at +-448).
__device__ __forceinline__ float to_f32(F8E4M3 c) {
  const uint32_t b = c.bits;
  const uint32_t e = (b >> 3) & 0xFu;
  const uint32_t mant = b & 0x7u;
  float mag;
  if (e == 0) {
    mag = static_cast<float>(mant) * 0.001953125f;        // mant * 2^-9
  } else {
    mag = __uint_as_float(((e + 120u) << 23) | (mant << 20));
  }
  return __uint_as_float(__float_as_uint(mag) | ((b & 0x80u) << 24));
}
