// Modular arithmetic shared by the Spiral kernels.
//
// Residues are uint32 below the CRT moduli P_I, B_I < 2^28 (the tensors are
// int32 on the PyTorch side; every value is nonnegative).  Products are
// exact u32 x u32 -> u64, reduced with a Barrett step against
// mu = floor((2^64 - 1) / p): for any x < 2^64 the quotient estimate
// __umul64hi(x, mu) is short by less than 2, so r = x - q*p < 2p, and the
// conditional subtractions make it canonical.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace spiral {

constexpr uint32_t P_I = 268369921u;   // 2^28 - 2^16 + 1
constexpr uint32_t B_I = 249561089u;   // 2^28 - 2^21 - 2^12 + 1
constexpr uint64_t MU_P = 0xFFFFFFFFFFFFFFFFull / P_I;
constexpr uint64_t MU_B = 0xFFFFFFFFFFFFFFFFull / B_I;
constexpr uint32_t P_INV_MOD_B = 97389680u;   // P_I^{-1} mod B_I

struct Mod {
  uint32_t p;
  uint64_t mu;

  __device__ __forceinline__ uint32_t reduce(uint64_t x) const {
    uint64_t r = x - __umul64hi(x, mu) * p;
    if (r >= p) r -= p;
    if (r >= p) r -= p;
    return (uint32_t)r;
  }
  __device__ __forceinline__ uint32_t mul(uint32_t a, uint32_t b) const {
    return reduce((uint64_t)a * b);
  }
  __device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) const {
    uint32_t s = a + b;
    return s >= p ? s - p : s;
  }
  __device__ __forceinline__ uint32_t sub(uint32_t a, uint32_t b) const {
    return a >= b ? a - b : a + p - b;
  }
};

__device__ __forceinline__ Mod mod_of(int li) {
  return li ? Mod{B_I, MU_B} : Mod{P_I, MU_P};
}

// Garner lift of (x mod P_I, y mod B_I) to the value in [0, Q), Q < 2^56.
__device__ __forceinline__ uint64_t lift(uint32_t x, uint32_t y) {
  const Mod mb = mod_of(1);
  const uint32_t xb = x >= B_I ? x - B_I : x;
  const uint32_t t = mb.mul(mb.sub(y, xb), P_INV_MOD_B);
  return (uint64_t)x + (uint64_t)P_I * t;
}

// Gadget digit width for a gadget of `dim` digits (params.get_bits_per).
__device__ __forceinline__ int bits_per(int dim) {
  return dim == 56 ? 1 : 56 / dim + 1;
}

inline int log2_exact(int d) {
  int l = 0;
  while ((1 << l) < d) ++l;
  return l;
}

}  // namespace spiral
