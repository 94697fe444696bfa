// K1: batched negacyclic NTT over both CRT moduli, in the JAX mxu slot order.
//
// Replaces the Pallas NTT, spiral_tpu/arith/ntt_pallas.py
// CrtNttPallas._run (kernel _make_kernel with _fwd_body / _inv_body), which
// splits d = 16 x 128 into 7-bit int8 limb matmuls for the TPU's matrix
// unit.  Here the transform is the register core of ntt_reg.cuh.
//
// Layout: the input (..., 2, d) is n_polys rows, row 2j + li poly j of
// limb li.  Limb li is blockIdx.y, so a block loads one limb's twiddles
// (the (w, w') pairs of psi_rev or psi_inv_rev, 16 KB at d = 2048) into
// shared memory once, and its teams of d/8 threads walk their share of the
// limb's polys two at a time (a lone last poly alone).  The grid is one
// wave of the card (ntt_reg.cuh launch_limbs): at d = 2048 one team per
// block of 48 KB of shared memory, four blocks per SM; at d = 256 a team is
// one warp and a block holds eight.  Every row is read and written
// coalesced: thread t holds entries t + e*d/8.
//   Forward: load the coefficients (any 32-bit word: reduced below 2p on
//   the load), run `forward` (the psi twist is merged into psi_rev), read
//   the result back in slot order (`to_slots`), make it canonical, store.
//   Inverse: load the slots, `from_slots`, `inverse` (the untwist is merged
//   into psi_inv_rev), multiply by d^{-1} (entry 0 of the psi_inv_rev row),
//   make it canonical, store.
//
// Bound on the H100: the bytes are 8 KB in and out per poly (0.0075 ms for
// the 768 x 2 polys of a spiral_20_256 first-dim output at 3.35 TB/s); the
// work is 11 stages of Shoup butterflies (three 32-bit multiplies each)
// and 4 shared-memory exchanges per poly, so the kernel is bound by
// integer issue and barrier latency.  Small launches (one poly per limb,
// the query's and the expansion's) are latency: one step of one team.
#include "ntt_reg.cuh"

using namespace spiral;

template <int L, bool INV>
__global__ void __launch_bounds__(reg::Batch<L>::THREADS,
                                  reg::Batch<L>::MIN_BLOCKS)
ntt_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
           const uint32_t* __restrict__ tab, int per_limb) {
  reg::batched_ntt<L, INV>(in, out, tab, per_limb,
                           [](auto&, uint32_t*, int&, uint32_t, int) {});
}

template <int L>
static int launch_ntt(const void* in, void* out, const void* tab,
                      int per_limb, int inverse, void* stream) {
  const auto* a = (const uint32_t*)in;
  const auto* tb = (const uint32_t*)tab;
  auto* o = (uint32_t*)out;
  return inverse ? reg::launch_limbs<L, ntt_kernel<L, true>>(per_limb, stream,
                                                              a, o, tb)
                 : reg::launch_limbs<L, ntt_kernel<L, false>>(per_limb,
                                                               stream, a, o,
                                                               tb);
}

// in, out (n_polys = N*2, d): rows alternate the limbs.
extern "C" int spiral_ntt(const void* in, void* out, const void* tab,
                          int n_polys, int d, int inverse, void* stream) {
  if (n_polys < 2 || n_polys % 2) return (int)cudaErrorInvalidValue;
  switch (d) {
    case 256: return launch_ntt<8>(in, out, tab, n_polys / 2, inverse, stream);
    case 2048: return launch_ntt<11>(in, out, tab, n_polys / 2, inverse,
                                     stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
