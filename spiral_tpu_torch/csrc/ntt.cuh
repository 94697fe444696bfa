// Negacyclic NTT of one length-d polynomial held in shared memory, as
// device functions the NTT, fold and expansion kernels share.
//
// Tables (spiral_tpu_torch/arith/tables.py NttTables.packed, (10, d) int32):
// row li*4 + 0 twist psi^i, + 1 untwist d^{-1} psi^{-i}, + 2 omega^k,
// + 3 omega^{-k}; row 8 pos_of_slot, row 9 slot_of_pos.
//
// ntt_dif takes x_i psi^i in natural order and leaves X[bitrev(pos)] at pos
// (X[k] = sum_i x_i psi^{(2k+1) i}); ntt_dit_inv undoes it up to the untwist.
// JAX's mxu engine stores X[k] at slot j with pos_of_slot[j] = bitrev(k), so
// a kernel that multiplies pointwise against mxu-order operands reads them at
// slot_of_pos[pos] and never permutes its own data.
//
// Both are called by every thread of a block of d/2 threads (or fewer: the
// butterfly loop strides by blockDim.x); the caller syncs before the first
// stage, and each stage ends with __syncthreads().
#pragma once

#include "common.cuh"

namespace spiral {

static __device__ inline void ntt_dif(uint32_t* a, const uint32_t* omega,
                                      const Mod md, int d, int logd) {
  const int half = d >> 1;
  for (int s = 0; s < logd; ++s) {
    const int lt = logd - 1 - s;   // butterfly span t = 2^lt
    for (int b = threadIdx.x; b < half; b += blockDim.x) {
      const int j = b & ((1 << lt) - 1);
      const int i0 = ((b >> lt) << (lt + 1)) + j;
      const int i1 = i0 + (1 << lt);
      const uint32_t l = a[i0], r = a[i1];
      a[i0] = md.add(l, r);
      a[i1] = md.mul(md.sub(l, r), omega[j << s]);
    }
    __syncthreads();
  }
}

static __device__ inline void ntt_dit_inv(uint32_t* a,
                                          const uint32_t* omega_inv,
                                          const Mod md, int d, int logd) {
  const int half = d >> 1;
  for (int s = logd - 1; s >= 0; --s) {
    const int lt = logd - 1 - s;
    for (int b = threadIdx.x; b < half; b += blockDim.x) {
      const int j = b & ((1 << lt) - 1);
      const int i0 = ((b >> lt) << (lt + 1)) + j;
      const int i1 = i0 + (1 << lt);
      const uint32_t u = a[i0];
      const uint32_t v = md.mul(a[i1], omega_inv[j << s]);
      a[i0] = md.add(u, v);
      a[i1] = md.sub(u, v);
    }
    __syncthreads();
  }
}

}  // namespace spiral
