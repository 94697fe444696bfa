// Negacyclic NTT of one length-d polynomial held in shared memory, the
// radix-2 network of K8b-1 (fold_mxu.cu), its last user.  K1, K3-K7, K4
// and K8a run the register core of ntt_reg.cuh instead.
//
// Tables (spiral_tpu_torch/arith/tables.py NttTables.packed, int32 rows):
// row li*4 + 0 twist psi^i, + 1 untwist d^{-1} psi^{-i}, + 2 omega^k,
// + 3 omega^{-k}; row 8 pos_of_slot, row 9 slot_of_pos.  Rows 1 and 3
// belonged to the radix-2 inverse, which no kernel runs any more.
//
// ntt_dif takes x_i psi^i in natural order and leaves X[bitrev(pos)] at pos
// (X[k] = sum_i x_i psi^{(2k+1) i}).  JAX's mxu engine stores X[k] at slot
// j with pos_of_slot[j] = bitrev(k), so a kernel that multiplies pointwise
// against mxu-order operands reads them at slot_of_pos[pos] and never
// permutes its own data.
//
// It is called by every thread of a block of d/2 threads (or fewer: the
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

}  // namespace spiral
