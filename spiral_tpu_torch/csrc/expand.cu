// K4: one expansion key switch.
//
// For ct n and CRT limb li, with c = tau_t(INTT(cv[n])) given in the
// coefficient domain and W (2 x m) in the NTT domain:
//   out[n, r] = cv[n, r] + sum_k W[r, k] * NTT(digit_k(c row 0))
//   out[n, 1] += NTT(c row 1)
// with unsigned base-2^bits digits (spiral_tpu/core/gadget.py
// gadget_invert_impl; m = 8 gives 8-bit digits, m = 56 one-bit digits).
//
// Replaces the Pallas key-switch spiral_tpu/server/expand_pallas.py
// _keyswitch_call (kernel _make_keyswitch_kernel), which forms int8 digits
// with a bias and contracts them in limb matmuls.  One block of d/2 threads
// per (ct, limb) walks the m digit polys through one 8 KB shared buffer
// (digits -> twist -> radix-2 NTT), multiply-accumulates each slot against W
// read at the slot's mxu index into two u64 accumulators per slot, then
// transforms row 1 of c the same way and writes cv + acc in mxu order.  The
// automorphism stays a gather outside (server/expand.py).
//
// Bound on the H100: m + 1 NTTs of d = 2048 per block, each 11
// __syncthreads() stages; early rounds run only a few blocks.
#include "ntt.cuh"

using namespace spiral;

__global__ void __launch_bounds__(1024)
expand_keyswitch_kernel(const uint32_t* __restrict__ cv,
                        const uint32_t* __restrict__ ca,
                        const uint32_t* __restrict__ W,
                        uint32_t* __restrict__ out,
                        const uint32_t* __restrict__ tab, int m, int d,
                        int logd) {
  extern __shared__ uint32_t a[];
  const int n = blockIdx.x, li = blockIdx.y;
  const Mod md = mod_of(li);
  const int half = d >> 1, tid = threadIdx.x;
  const int bits = bits_per(m);
  const uint64_t mask = bits < 32 ? (1ull << bits) - 1 : 0xFFFFFFFFull;
  const uint32_t* twist = tab + (li * 4 + 0) * d;
  const uint32_t* omega = tab + (li * 4 + 2) * d;
  const int slot[2] = {(int)tab[9 * d + tid], (int)tab[9 * d + tid + half]};
  // (N, 2, 1, 2, d): row r, limb l of ct n at ((n*2 + r)*2 + l)*d
  const uint32_t* c0 = ca + (size_t)n * 4 * d;
  const uint32_t* c1 = ca + ((size_t)n * 4 + 2 + li) * d;

  uint64_t v[2];
  for (int e = 0; e < 2; ++e) {
    const int i = tid + e * half;
    v[e] = lift(c0[i], c0[d + i]);
  }
  uint64_t acc[2][2] = {};
  for (int k = 0; k < m; ++k) {
    const int sh = k * bits;
    for (int e = 0; e < 2; ++e) {
      const int i = tid + e * half;
      const uint64_t dg = sh < 64 ? (v[e] >> sh) & mask : 0;
      a[i] = md.mul(md.reduce(dg), twist[i]);
    }
    __syncthreads();
    ntt_dif(a, omega, md, d, logd);
    for (int r = 0; r < 2; ++r) {
      const uint32_t* wr = W + ((size_t)(r * m + k) * 2 + li) * d;
      for (int e = 0; e < 2; ++e)
        acc[r][e] += (uint64_t)a[tid + e * half] * wr[slot[e]];
    }
    __syncthreads();
    if (k % 64 == 63)   // keep the sums below 2^63
      for (int r = 0; r < 2; ++r)
        for (int e = 0; e < 2; ++e) acc[r][e] = md.reduce(acc[r][e]);
  }
  for (int e = 0; e < 2; ++e) {
    const int i = tid + e * half;
    a[i] = md.mul(c1[i], twist[i]);
  }
  __syncthreads();
  ntt_dif(a, omega, md, d, logd);
  for (int e = 0; e < 2; ++e) acc[1][e] += a[tid + e * half];
  for (int r = 0; r < 2; ++r) {
    for (int e = 0; e < 2; ++e) {
      const size_t idx = ((size_t)n * 4 + r * 2 + li) * d + slot[e];
      out[idx] = md.add(cv[idx], md.reduce(acc[r][e]));
    }
  }
}

extern "C" int spiral_expand_keyswitch(const void* cv, const void* ca,
                                       const void* W, void* out,
                                       const void* tab, int N, int m, int d,
                                       void* stream) {
  if (d < 64 || d > 2048 || m < 1) return (int)cudaErrorInvalidValue;
  dim3 grid(N, 2);
  expand_keyswitch_kernel<<<grid, d / 2, d * sizeof(uint32_t),
                            (cudaStream_t)stream>>>(
      (const uint32_t*)cv, (const uint32_t*)ca, (const uint32_t*)W,
      (uint32_t*)out, (const uint32_t*)tab, m, d, log2_exact(d));
  return (int)cudaGetLastError();
}
