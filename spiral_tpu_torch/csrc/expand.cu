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
// with a bias and contracts them in limb matmuls.
//
// Bound on the H100: the m + 1 NTTs of d = 2048 per (ct, limb), integer
// multiplies and latency; an expansion round has 2^r cts, so its early
// rounds have almost no parallelism to give (m = 56: 57 NTTs for each of
// 2 (ct, limb) pairs in round 0).  The design spreads the m + 1 polys of one
// (ct, limb) over a thread-block cluster of C blocks: block c of the
// cluster takes items c, c + C, ... (item k < m is digit k of c row 0, item
// m is c row 1), two at a time through the register NTT of ntt_reg.cuh,
// and keeps per-slot sums for both output rows in u64 registers (slot
// t + e*d/8 of thread t, the operand W read coalesced).  It then leaves
// its sums, reduced mod p, in its shared memory; after a cluster barrier
// each block adds up a 1/C share of the 2d (row, slot) words over the
// cluster's blocks through distributed shared memory, adds cv and writes
// out.  The sum is exact, so the result does not depend on block order.
// C = ceil((m + 1) / 3), at most 8 (the portable cluster size): 3 at m 8
// and 6 at m 16 give each block 3 items (two steps of the two-poly core),
// and m 56 gives 8 blocks of 7-8 items, so round 0 runs 16 blocks of at
// most 4 steps instead of 2 blocks of 57 NTTs in sequence.
//
// K8a: the inverse NTT and tau_t of one expansion round in one launch.
//
// For poly n (the flattened (..., 2) index, limb n & 1) in the NTT domain
// (mxu order): c = INTT(x[n]), then out[(i*t) mod d] = (-1)^((i*t)/d) c[i].
// Replaces the Pallas kernel spiral_tpu/server/expand_pallas.py _auto_call
// (kernel _make_auto_kernel, SPIRAL_AUTO=matmul), which ran tau_t as an
// int8 +/-1 permutation matmul over four 7-bit limb planes because Mosaic
// has no lane gather.  Here it is K1's inverse (ntt.cu) on the register
// core of ntt_reg.cuh, with the same grid and teams: slots in coalesced,
// `from_slots`, `inverse`, d^{-1}, canonical; then tau_t through shared
// memory, with no table and no matmul.  t is odd, so i -> i*t mod d is a
// bijection: each thread writes coefficient i to word (i*t) mod d of the
// exchange buffer the last pass did not read, negated when (i*t) / d is
// odd (0 stays 0), and after the team's barrier the row is read back and
// stored coalesced.  The buffer is unswizzled: the 32 words a warp writes
// at once are t apart mod d, and t odd puts them in 32 distinct banks.
// Bound on the H100: as K1's inverse (integer issue and barrier latency;
// the bytes, 8 KB in and out per poly, take 0.005 ms at round 8), with one
// launch per round instead of K1, two index-table copies and three
// elementwise launches.
#include <type_traits>

#include "ntt_reg.cuh"

using namespace spiral;

template <int L>
__global__ void __launch_bounds__(1 << (L - 3), 2)
expand_keyswitch_kernel(const uint32_t* __restrict__ cv,
                        const uint32_t* __restrict__ ca,
                        const uint32_t* __restrict__ W,
                        uint32_t* __restrict__ out,
                        const uint32_t* __restrict__ tab, int m, int C) {
  using S = reg::Sched<L>;
  constexpr int D = S::D, T = S::T;
  extern __shared__ uint32_t sm[];   // exchange buffers, then twiddles
  uint2* tw = reinterpret_cast<uint2*>(sm + 2 * reg::NP_MAX * D);
  reg::cg::cluster_group cluster = reg::cg::this_cluster();
  const int c = cluster.block_rank();
  const int n = blockIdx.x / C, li = blockIdx.y, t = threadIdx.x;
  const Mod md = mod_of(li);
  reg::load_twiddles<L>(tw, tab, reg::ROW_REG + 4 * li, t);
  uint32_t pos[4];
  reg::load_slot_positions<L>(pos, tab, t);
  const int bits = bits_per(m);
  const uint64_t mask = bits < 32 ? (1ull << bits) - 1 : 0xFFFFFFFFull;
  // (N, 2, 1, 2, d): row r, limb l of ct n at ((n*2 + r)*2 + l)*d
  const uint32_t* c0 = ca + (size_t)n * 4 * D;
  const uint32_t* c1 = ca + ((size_t)n * 4 + 2 + li) * D;
  uint64_t v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = lift(c0[e * T + t], c0[D + e * T + t]);
  uint64_t acc[2][8] = {};
  int par = 0;
  __syncthreads();

  auto step = [&](auto np, int k0) {
    constexpr int NP = decltype(np)::value;
    uint32_t x[NP][8];
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      const int k = k0 + q * C;
      const int sh = k * bits;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (k == m) {
          x[q][e] = c1[e * T + t];
        } else {
          const uint64_t dg = sh < 64 ? (v[e] >> sh) & mask : 0;
          x[q][e] = bits <= 29 ? (uint32_t)dg : md.reduce(dg);  // < 4p
        }
      }
    }
    reg::forward<L, NP>(x, sm, par, tw, md.p, t);
    reg::to_slots<L, NP>(x, sm, par, pos, t);
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      const int k = k0 + q * C;
      if (k == m) {
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[1][e] += reg::canon(x[q][e], md.p);
        continue;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint32_t* wr = W + ((size_t)(r * m + k) * 2 + li) * D + t;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          acc[r][e] += (uint64_t)reg::canon(x[q][e], md.p) * wr[e * T];
      }
    }
  };
  for (int k = c; k <= m; k += 2 * C) {
    if (k + C <= m)
      step(std::integral_constant<int, 2>{}, k);
    else
      step(std::integral_constant<int, 1>{}, k);
  }

  __syncthreads();   // every slot read of the last exchange is done
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int e = 0; e < 8; ++e) sm[r * D + e * T + t] = md.reduce(acc[r][e]);
  cluster.sync();
  for (int u = c * T + t; u < 2 * D; u += C * T) {
    const int r = u >> L, j = u & (D - 1);
    const size_t idx = ((size_t)n * 4 + r * 2 + li) * D + j;
    // C partial sums below p and cv: below 9p < 2^32
    out[idx] = md.reduce(reg::cluster_sum(cluster, sm, C, u) + cv[idx]);
  }
  cluster.sync();    // no block leaves while its shared memory is read
}

template <int L>
__global__ void __launch_bounds__(reg::Batch<L>::THREADS,
                                  reg::Batch<L>::MIN_BLOCKS)
inv_ntt_automorph_kernel(const uint32_t* __restrict__ in,
                         uint32_t* __restrict__ out,
                         const uint32_t* __restrict__ tab, int t_auto,
                         int per_limb) {
  constexpr int D = 1 << L, T = D / 8;
  const uint32_t ta = (uint32_t)t_auto & (2 * D - 1);   // tau_t mod 2d
  // coefficient i = e*d/8 + t goes to (i*t) mod d, negated when (i*t) / d
  // is odd; the buffer is the one the last exchange did not read,
  // unswizzled: t is odd, so a warp's 32 stores hit 32 banks
  auto finish = [&](auto& x, uint32_t* sm, int& par, uint32_t p, int t) {
    using X = std::remove_reference_t<decltype(x)>;
    constexpr int NP = std::extent<X>::value;
    uint32_t* img = sm + par * reg::NP_MAX * D;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const uint32_t it = (uint32_t)(e * T + t) * ta;
      const bool neg = (it >> L) & 1;
#pragma unroll
      for (int q = 0; q < NP; ++q)
        img[q * D + (it & (D - 1))] = neg && x[q][e] ? p - x[q][e] : x[q][e];
    }
    reg::team_sync<L>();
#pragma unroll
    for (int q = 0; q < NP; ++q)
#pragma unroll
      for (int e = 0; e < 8; ++e) x[q][e] = img[q * D + e * T + t];
    par ^= 1;
  };
  reg::batched_ntt<L, true>(in, out, tab, per_limb, finish);
}

// K8a: in, out (n_polys = N*2, d), in NTT, out coefficient domain; t odd.
extern "C" int spiral_inv_ntt_automorph(const void* in, void* out,
                                        const void* tab, int n_polys, int d,
                                        int t, void* stream) {
  if (!(t & 1) || n_polys < 2 || n_polys % 2)
    return (int)cudaErrorInvalidValue;
  const auto* a = (const uint32_t*)in;
  const auto* tb = (const uint32_t*)tab;
  auto* o = (uint32_t*)out;
  switch (d) {
    case 256: return reg::launch_limbs<8, inv_ntt_automorph_kernel<8>>(
        n_polys / 2, stream, a, o, tb, t);
    case 2048: return reg::launch_limbs<11, inv_ntt_automorph_kernel<11>>(
        n_polys / 2, stream, a, o, tb, t);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int spiral_expand_keyswitch(const void* cv, const void* ca,
                                       const void* W, void* out,
                                       const void* tab, int N, int m, int d,
                                       void* stream) {
  // at m <= 1024 a block sums at most 129 products below 2^56 per slot
  if (m < 1 || m > 1024 || N < 1) return (int)cudaErrorInvalidValue;
  const int C = (m + 3) / 3 < 8 ? (m + 3) / 3 : 8;
  const dim3 grid(C * N, 2);
  const auto* a = (const uint32_t*)cv;
  const auto* b = (const uint32_t*)ca;
  const auto* w = (const uint32_t*)W;
  const auto* tb = (const uint32_t*)tab;
  auto* o = (uint32_t*)out;
  switch (d) {
    case 256: return reg::launch_clusters<8>(expand_keyswitch_kernel<8>, grid,
                                             C, stream, a, b, w, o, tb, m, C);
    case 2048: return reg::launch_clusters<11>(expand_keyswitch_kernel<11>,
                                               grid, C, stream, a, b, w, o, tb,
                                               m, C);
    default: return (int)cudaErrorInvalidValue;
  }
}
