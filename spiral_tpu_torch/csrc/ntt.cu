// K1: batched negacyclic NTT over both CRT moduli, in the JAX mxu slot order.
//
// Replaces the Pallas NTT, spiral_tpu/arith/ntt_pallas.py
// CrtNttPallas._run (kernel _make_kernel with _fwd_body / _inv_body), which
// splits d = 16 x 128 into 7-bit int8 limb matmuls for the TPU's matrix
// unit.  Here one block of d/2 threads transforms one polynomial for one
// modulus: radix-2 butterflies on the d residues in shared memory with exact
// 64-bit products, and the mxu-order permutation applied on the store
// (forward) or the load (inverse).
//
// Bound on the H100: each butterfly stage is a __syncthreads() round over
// 8 KB of shared memory and a 64-bit Barrett multiply per butterfly, so it
// is latency- and integer-issue-bound, not bandwidth-bound (8 KB in and out
// of device memory per polynomial).  Larger radices and keeping several
// polynomials per block are the obvious next steps.
#include "ntt.cuh"

using namespace spiral;

__global__ void ntt_kernel(const uint32_t* __restrict__ in,
                           uint32_t* __restrict__ out,
                           const uint32_t* __restrict__ tab, int d, int logd,
                           int inverse) {
  extern __shared__ uint32_t a[];
  const int poly = blockIdx.x;   // flattened (..., 2) index: limb = poly & 1
  const int li = poly & 1;
  const Mod md = mod_of(li);
  const uint32_t* x = in + (size_t)poly * d;
  uint32_t* y = out + (size_t)poly * d;
  const uint32_t* pos_of_slot = tab + 8 * d;
  if (!inverse) {
    const uint32_t* twist = tab + (li * 4 + 0) * d;
    for (int i = threadIdx.x; i < d; i += blockDim.x)
      a[i] = md.mul(x[i], twist[i]);
    __syncthreads();
    ntt_dif(a, tab + (li * 4 + 2) * d, md, d, logd);
    for (int j = threadIdx.x; j < d; j += blockDim.x) y[j] = a[pos_of_slot[j]];
  } else {
    for (int j = threadIdx.x; j < d; j += blockDim.x) a[pos_of_slot[j]] = x[j];
    __syncthreads();
    ntt_dit_inv(a, tab + (li * 4 + 3) * d, md, d, logd);
    const uint32_t* untwist = tab + (li * 4 + 1) * d;
    for (int i = threadIdx.x; i < d; i += blockDim.x)
      y[i] = md.mul(a[i], untwist[i]);
  }
}

extern "C" int spiral_ntt(const void* in, void* out, const void* tab,
                          int n_polys, int d, int inverse, void* stream) {
  const int threads = d / 2 < 1024 ? d / 2 : 1024;
  ntt_kernel<<<n_polys, threads, d * sizeof(uint32_t),
               (cudaStream_t)stream>>>(
      (const uint32_t*)in, (uint32_t*)out, (const uint32_t*)tab, d,
      log2_exact(d), inverse);
  return (int)cudaGetLastError();
}
