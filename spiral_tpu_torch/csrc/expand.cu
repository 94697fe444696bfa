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
// automorphism that makes c is K8a below, a launch of its own.
//
// Bound on the H100: m + 1 NTTs of d = 2048 per block, each 11
// __syncthreads() stages; early rounds run only a few blocks.
//
// K8a: the inverse NTT and tau_t of one expansion round in one launch.
//
// For poly n (the flattened (..., 2) index, limb n & 1) in the NTT domain
// (mxu order): c = INTT(x[n]), then out[(i*t) mod d] = (-1)^((i*t)/d) c[i].
// Replaces the Pallas kernel spiral_tpu/server/expand_pallas.py _auto_call
// (kernel _make_auto_kernel, SPIRAL_AUTO=matmul), which ran tau_t as an
// int8 +/-1 permutation matmul over four 7-bit limb planes because Mosaic
// has no lane gather.  Here one block of d/2 threads per (poly, limb) runs
// K1's inverse network in shared memory and scatters each untwisted
// coefficient to its image on the store: t is odd, so i -> i*t mod d is a
// bijection, and the index and sign come from i*t, with no table and no
// matmul.  Bound on the H100: as K1's inverse (11 __syncthreads() stages
// of 64-bit Barrett products per poly), with one launch per round instead
// of K1, two index-table copies and three elementwise launches.
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

__global__ void inv_ntt_automorph_kernel(const uint32_t* __restrict__ in,
                                         uint32_t* __restrict__ out,
                                         const uint32_t* __restrict__ tab,
                                         int d, int logd, int t) {
  extern __shared__ uint32_t a[];
  const int poly = blockIdx.x, li = poly & 1;
  const Mod md = mod_of(li);
  const uint32_t* x = in + (size_t)poly * d;
  uint32_t* y = out + (size_t)poly * d;
  const uint32_t* pos_of_slot = tab + 8 * d;
  for (int j = threadIdx.x; j < d; j += blockDim.x) a[pos_of_slot[j]] = x[j];
  __syncthreads();
  ntt_dit_inv(a, tab + (li * 4 + 3) * d, md, d, logd);
  const uint32_t* untwist = tab + (li * 4 + 1) * d;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const uint32_t v = md.mul(a[i], untwist[i]);
    const long long it = (long long)i * t;
    y[it & (d - 1)] = ((it >> logd) & 1) && v ? md.p - v : v;
  }
}

// K8a: in, out (n_polys = N*2, d), in NTT, out coefficient domain; t odd.
extern "C" int spiral_inv_ntt_automorph(const void* in, void* out,
                                        const void* tab, int n_polys, int d,
                                        int t, void* stream) {
  if (d < 64 || d > 2048 || (d & (d - 1)) || !(t & 1) || n_polys < 1)
    return (int)cudaErrorInvalidValue;
  inv_ntt_automorph_kernel<<<n_polys, d / 2, d * sizeof(uint32_t),
                             (cudaStream_t)stream>>>(
      (const uint32_t*)in, (uint32_t*)out, (const uint32_t*)tab, d,
      log2_exact(d), t);
  return (int)cudaGetLastError();
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
