// Register-resident negacyclic NTT for Hopper: the core of the batched NTT
// K1 (ntt.cu), of the expansion's inverse NTT + automorphism K8a and key
// switch K4 (expand.cu), of the fold template K3/K5/K6 (fold.cu), of the
// packing K7 (pack.cu) and of the mxu fold's digit NTTs K8b-1
// (fold_mxu.cu): every NTT of the port's kernels.
//
// It replaces no TPU kernel of its own: the Pallas kernels that these
// kernels replace (spiral_tpu/arith/ntt_pallas.py CrtNttPallas._run,
// server/expand_pallas.py _auto_call and _keyswitch_call, fold_pallas.py
// _fold_round_call and _fold_ntt_call) ran their NTTs as int8 matmuls on
// the MXU; here they are butterflies on the CUDA cores.
//
// A radix-2 network that keeps one poly in shared memory with d/2 threads
// (the port's first NTT) runs 11 __syncthreads() stages at d = 2048, a
// twiddle read from device memory and a 64-bit Barrett product per
// butterfly; a block that walks dozens of digit polys through it is a
// latency chain.  Here a team of d/8 threads holds NP polys at once, 8
// coefficients of each in registers per thread, and runs radix-8 passes in
// registers (stages 3p .. 3p+2 in pass p; at d = 2048 passes of 3, 3, 3
// and 2 stages), with one exchange through shared memory between passes:
// 4 barriers per NTT instead of 11, shared by the NP polys.  A team of 256
// threads (d = 2048) is its block and syncs with __syncthreads(); a team
// of one warp (d = 256) syncs with __syncwarp(), so a block may hold
// several teams that run apart, each on its own exchange buffers (the `sm`
// base the core takes).
//
// Arithmetic: every multiply by a fixed operand is a Shoup product,
//   a*w - umulhi(a, w')*p  in [0, 2p),  w' = floor(w * 2^32 / p),
// three 32-bit multiplies, with w' computed on the host.  p < 2^28, so
// Harvey's lazy butterflies keep values in [0, 4p) (forward) or [0, 2p)
// (inverse) in u32, and callers make them canonical once at the end.
//
// The transform: the forward NTT is Cooley-Tukey with the psi powers
// merged into the twiddles (stage s, group i: psi_rev[2^s + i],
// psi_rev[k] = psi^bitrev(k)), natural order in, X[bitrev(pos)] at pos out,
// the radix-2 decimation in frequency's order (arith/ntt.py forward_plain),
// with no twist pass.  The inverse is Gentleman-Sande with psi_inv_rev[k]
// = psi^-bitrev(k), then one Shoup product by d^{-1}: the untwist is
// merged too.  Twiddles sit in
// shared memory as (w, w') pairs, loaded once per block; the pass of thread
// t reads the 2^k pairs of stage k at psi_rev[2^s + (high << k)], contiguous
// and shared by the threads of one group.
//
// Table rows (arith/tables.py NttTables.packed, ROW_POS and ROW_REG there
// too): row 0 pos_of_slot; 1 + 4*li + 0 psi_rev, + 1 its Shoup
// companions, + 2 psi_inv_rev with entry 0 (never a twiddle) holding
// d^{-1}, + 3 their companions.
//
// Slot order: after the forward passes the team writes its values to
// shared memory at their positions and reads them back at pos_of_slot, so
// thread t holds slots t + e*d/8: the key and query operands (mxu order)
// are then read coalesced.  The inverse starts with the opposite exchange.
//
// Shared memory: 2 buffers x NP polys x d words per team, alternated so
// that one barrier per exchange suffices (an exchange writes the buffer the
// last one did not read), then d (w, w') pairs for the block: 24 d bytes
// for one team at NP = 2 (48 KB at d = 2048).  Word i of a buffer lives at
// i ^ g((i >> 5) & 7), g(x) = (x << 2) ^ x: every pass's store and load,
// and the slot reads, are then free of bank conflicts at d = 2048.
//
// Inputs: `forward` takes words below 4p and `inverse` below 2p;
// `load_polys` brings any 32-bit word below 2p on the load.
#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace spiral {
namespace reg {

namespace cg = cooperative_groups;

constexpr int ROW_POS = 0;    // pos_of_slot
constexpr int ROW_REG = 1;    // first row of this core's twiddles
constexpr int NP_MAX = 2;     // polys in flight per team

template <int L>
struct Sched {
  static constexpr int D = 1 << L;
  static constexpr int T = D / 8;              // threads of a team
  static constexpr int NPASS = (L + 2) / 3;
  __host__ __device__ static constexpr int R(int p) {   // stages of pass p
    return p < NPASS - 1 ? 3 : L - 3 * (NPASS - 1);
  }
  __host__ __device__ static constexpr int B(int p) {   // its lowest bit
    return L - 3 * p - R(p);
  }
  static constexpr int SMEM = (2 * NP_MAX * D) * 4 + D * 8;
};

// The barrier of one team (see the header).
template <int L>
__device__ __forceinline__ void team_sync() {
  if constexpr (Sched<L>::T == 32)
    __syncwarp();
  else
    __syncthreads();
}

__device__ __forceinline__ int swz(int i) {
  const int x = (i >> 5) & 7;
  return i ^ ((x << 2) ^ x);
}

// Index of register j of thread t in pass P: the pass works on index bits
// B .. B+R-1; a thread holds 8 >> R groups of 2^R elements that differ in
// those bits only.
template <int L, int P>
__device__ __forceinline__ int pass_index(int t, int j) {
  constexpr int R = Sched<L>::R(P), b = Sched<L>::B(P), G = 8 >> R;
  const int gid = t * G + (j >> R);
  return ((gid >> b) << (b + R)) | ((j & ((1 << R) - 1)) << b) |
         (gid & ((1 << b) - 1));
}

__device__ __forceinline__ uint32_t shoup(uint32_t a, uint2 w, uint32_t p) {
  return a * w.x - __umulhi(a, w.y) * p;
}

// Cooley-Tukey butterfly, x in [0, 4p), y < 2^32 -> both in [0, 4p).
__device__ __forceinline__ void ct(uint32_t& x, uint32_t& y, uint2 w,
                                   uint32_t p) {
  const uint32_t p2 = 2 * p;
  const uint32_t u = x >= p2 ? x - p2 : x;
  const uint32_t v = shoup(y, w, p);
  x = u + v;
  y = u - v + p2;
}

// Gentleman-Sande butterfly, x, y in [0, 2p) -> both in [0, 2p).
__device__ __forceinline__ void gs(uint32_t& x, uint32_t& y, uint2 w,
                                   uint32_t p) {
  const uint32_t p2 = 2 * p;
  const uint32_t u = x + y;
  y = shoup(x - y + p2, w, p);
  x = u >= p2 ? u - p2 : u;
}

// [0, 4p) -> [0, p)
__device__ __forceinline__ uint32_t canon(uint32_t x, uint32_t p) {
  x = x >= 2 * p ? x - 2 * p : x;
  return x >= p ? x - p : x;
}

// One pass over NP polys: in the thread's group h (8 >> R of them), stage
// k pairs registers e and e + span (span = 2^(R-1-k)) with the twiddle of
// group (high << k) + (e >> (R - k)) of stage s = 3P + k.  Loop bounds are
// compile-time constants, so every register index is one.
template <int L, int P, bool INV, int NP>
__device__ __forceinline__ void pass(uint32_t (&x)[NP][8], const uint2* tw,
                                     uint32_t p, int t) {
  constexpr int R = Sched<L>::R(P), b = Sched<L>::B(P), M = 1 << R;
  constexpr int G = 8 >> R;
#pragma unroll
  for (int h = 0; h < G; ++h) {
    const int high = (t * G + h) >> b;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int k = INV ? R - 1 - i : i, span = M >> (k + 1);
      const uint2* w = tw + (1 << (3 * P + k)) + (high << k);
#pragma unroll
      for (int e = 0; e < M; ++e) {
        if (e & span) continue;
        const uint2 wk = w[e >> (R - k)];
#pragma unroll
        for (int q = 0; q < NP; ++q) {
          uint32_t& lo = x[q][h * M + e];
          uint32_t& hi = x[q][h * M + e + span];
          if (INV)
            gs(lo, hi, wk, p);
          else
            ct(lo, hi, wk, p);
        }
      }
    }
  }
}

// Registers in the layout of pass PA -> shared memory -> layout of pass PB.
template <int L, int PA, int PB, int NP>
__device__ __forceinline__ void exchange(uint32_t (&x)[NP][8], uint32_t* sm,
                                         int& par, int t) {
  constexpr int D = Sched<L>::D;
  uint32_t* buf = sm + par * NP_MAX * D;
#pragma unroll
  for (int q = 0; q < NP; ++q)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      buf[q * D + swz(pass_index<L, PA>(t, j))] = x[q][j];
  team_sync<L>();
#pragma unroll
  for (int q = 0; q < NP; ++q)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      x[q][j] = buf[q * D + swz(pass_index<L, PB>(t, j))];
  par ^= 1;
}

// Forward NTT of NP polys: x[q][e] holds coefficient e*d/8 + t (any value
// below 4p) -> the transform in the last pass's layout, in [0, 4p).
template <int L, int NP, int P = 0>
__device__ __forceinline__ void forward(uint32_t (&x)[NP][8], uint32_t* sm,
                                        int& par, const uint2* tw,
                                        uint32_t p, int t) {
  pass<L, P, false, NP>(x, tw, p, t);
  if constexpr (P + 1 < Sched<L>::NPASS) {
    exchange<L, P, P + 1, NP>(x, sm, par, t);
    forward<L, NP, P + 1>(x, sm, par, tw, p, t);
  }
}

// Inverse NTT (without the d^{-1}) of values in [0, 2p) in the last pass's
// layout -> coefficient e*d/8 + t in x[q][e], in [0, 2p).
template <int L, int NP, int P = Sched<L>::NPASS - 1>
__device__ __forceinline__ void inverse(uint32_t (&x)[NP][8], uint32_t* sm,
                                        int& par, const uint2* tw,
                                        uint32_t p, int t) {
  pass<L, P, true, NP>(x, tw, p, t);
  if constexpr (P > 0) {
    exchange<L, P, P - 1, NP>(x, sm, par, t);
    inverse<L, NP, P - 1>(x, sm, par, tw, p, t);
  }
}

// pos holds the swizzled pos_of_slot[t + e*d/8] as 16-bit halves
__device__ __forceinline__ int slot_pos(const uint32_t (&pos)[4], int e) {
  return (pos[e >> 1] >> (16 * (e & 1))) & 0xFFFF;
}

template <int L>
__device__ __forceinline__ void load_slot_positions(uint32_t (&pos)[4],
                                                    const uint32_t* tab,
                                                    int t) {
  constexpr int D = Sched<L>::D, T = Sched<L>::T;
  const uint32_t* row = tab + ROW_POS * D + t;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    pos[e] = swz(row[2 * e * T]) | (swz(row[(2 * e + 1) * T]) << 16);
}

// The (w, w') pairs of table rows `row`, `row` + 1 into shared memory, by
// the NT threads of a block (thread t).
template <int L, int NT = Sched<L>::T>
__device__ __forceinline__ void load_twiddles(uint2* tw, const uint32_t* tab,
                                              int row, int t) {
  constexpr int D = Sched<L>::D;
  for (int i = t; i < D; i += NT)
    tw[i] = make_uint2(tab[row * D + i], tab[(row + 1) * D + i]);
}

// Forward layout -> slots: x[q][e] becomes slot t + e*d/8.
template <int L, int NP>
__device__ __forceinline__ void to_slots(uint32_t (&x)[NP][8], uint32_t* sm,
                                         int& par, const uint32_t (&pos)[4],
                                         int t) {
  constexpr int D = Sched<L>::D, LAST = Sched<L>::NPASS - 1;
  uint32_t* buf = sm + par * NP_MAX * D;
#pragma unroll
  for (int q = 0; q < NP; ++q)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      buf[q * D + swz(pass_index<L, LAST>(t, j))] = x[q][j];
  team_sync<L>();
#pragma unroll
  for (int q = 0; q < NP; ++q)
#pragma unroll
    for (int e = 0; e < 8; ++e) x[q][e] = buf[q * D + slot_pos(pos, e)];
  par ^= 1;
}

// Slots -> the inverse's first layout: x[q][e] holds slot t + e*d/8.
template <int L, int NP>
__device__ __forceinline__ void from_slots(uint32_t (&x)[NP][8], uint32_t* sm,
                                           int& par,
                                           const uint32_t (&pos)[4], int t) {
  constexpr int D = Sched<L>::D, LAST = Sched<L>::NPASS - 1;
  uint32_t* buf = sm + par * NP_MAX * D;
#pragma unroll
  for (int q = 0; q < NP; ++q)
#pragma unroll
    for (int e = 0; e < 8; ++e) buf[q * D + slot_pos(pos, e)] = x[q][e];
  team_sync<L>();
#pragma unroll
  for (int q = 0; q < NP; ++q)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      x[q][j] = buf[q * D + swz(pass_index<L, LAST>(t, j))];
  par ^= 1;
}

// Any 32-bit word -> the same residue in [0, 2p): a Shoup product by 1,
// whose companion floor(2^32 / p) is `one` (below the lazy bounds of both
// `forward` and `inverse`).
__device__ __forceinline__ uint32_t reduce_word(uint32_t a, uint32_t p,
                                                uint32_t one) {
  return a - __umulhi(a, one) * p;
}

// ---- the batched kernels K1 and K8a: polys of one limb of a (..., 2, d)
// tensor, poly j of limb li in row 2j + li ----

template <int L>
struct Batch {
  static constexpr int T = Sched<L>::T, D = Sched<L>::D;
  static constexpr int W = T == 32 ? 8 : 1;     // teams per block
  static constexpr int THREADS = W * T;
  static constexpr int MIN_BLOCKS = 4;          // per SM: 64 registers
  static constexpr int SMEM = W * 2 * NP_MAX * D * 4 + D * 8;
};

// Row entries e*d/8 + t of polys j .. j+NP-1 of limb li, reduced below 2p.
template <int L, int NP>
__device__ __forceinline__ void load_polys(uint32_t (&x)[NP][8],
                                           const uint32_t* in, int j, int li,
                                           int t) {
  constexpr int D = Sched<L>::D, T = Sched<L>::T;
  const uint32_t p = li ? B_I : P_I;
  const uint32_t one = li ? 0xFFFFFFFFu / B_I : 0xFFFFFFFFu / P_I;
#pragma unroll
  for (int q = 0; q < NP; ++q) {
    const uint32_t* row = in + (size_t)(2 * (j + q) + li) * D + t;
#pragma unroll
    for (int e = 0; e < 8; ++e) x[q][e] = reduce_word(row[e * T], p, one);
  }
}

template <int L, int NP>
__device__ __forceinline__ void store_polys(const uint32_t (&x)[NP][8],
                                            uint32_t* out, int j, int li,
                                            int t) {
  constexpr int D = Sched<L>::D, T = Sched<L>::T;
#pragma unroll
  for (int q = 0; q < NP; ++q) {
    uint32_t* row = out + (size_t)(2 * (j + q) + li) * D + t;
#pragma unroll
    for (int e = 0; e < 8; ++e) row[e * T] = x[q][e];
  }
}

// Team g of G walks steps g, g + G, ...: step s takes polys 2s and 2s + 1
// of the limb (NP = 2), or poly 2s alone when it is the limb's last.
template <typename Step>
__device__ __forceinline__ void limb_steps(int per_limb, int g, int G,
                                           Step step) {
  for (int s = g; 2 * s < per_limb; s += G) {
    if (2 * s + 1 < per_limb)
      step(std::integral_constant<int, 2>{}, 2 * s);
    else
      step(std::integral_constant<int, 1>{}, 2 * s);
  }
}

// The body of K1 and K8a, in block (x, li) of a launch_limbs grid: load
// limb li's twiddles (psi_rev, or psi_inv_rev when INV) once; then each
// team walks its steps: load NP polys reduced below 2p, transform them
// (forward, to slots, canonical; or from slots, inverse, d^{-1},
// canonical), hand them to finish(x, sm, par, p, t), store them.
template <int L, bool INV, typename Finish>
__device__ __forceinline__ void batched_ntt(const uint32_t* __restrict__ in,
                                            uint32_t* __restrict__ out,
                                            const uint32_t* __restrict__ tab,
                                            int per_limb, Finish finish) {
  using B = Batch<L>;
  constexpr int D = B::D, T = B::T;
  extern __shared__ uint32_t smem[];   // per team: exchange buffers; twiddles
  uint2* tw = reinterpret_cast<uint2*>(smem + B::W * 2 * NP_MAX * D);
  const int team = threadIdx.x / T, t = threadIdx.x % T, li = blockIdx.y;
  uint32_t* sm = smem + team * 2 * NP_MAX * D;
  const uint32_t p = li ? B_I : P_I;
  const int row = ROW_REG + 4 * li + (INV ? 2 : 0);
  load_twiddles<L, B::THREADS>(tw, tab, row, threadIdx.x);
  uint32_t pos[4];
  load_slot_positions<L>(pos, tab, t);
  const uint2 d_inv = make_uint2(tab[row * D], tab[(row + 1) * D]);
  int par = 0;
  __syncthreads();

  limb_steps(per_limb, blockIdx.x * B::W + team, gridDim.x * B::W,
             [&](auto np, int j) {
    constexpr int NP = decltype(np)::value;
    uint32_t x[NP][8];
    load_polys<L, NP>(x, in, j, li, t);
    if constexpr (INV) {
      from_slots<L, NP>(x, sm, par, pos, t);
      inverse<L, NP>(x, sm, par, tw, p, t);
#pragma unroll
      for (int q = 0; q < NP; ++q)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const uint32_t r = shoup(x[q][e], d_inv, p);   // [0, 2p)
          x[q][e] = r >= p ? r - p : r;
        }
    } else {
      forward<L, NP>(x, sm, par, tw, p, t);
      to_slots<L, NP>(x, sm, par, pos, t);
#pragma unroll
      for (int q = 0; q < NP; ++q)
#pragma unroll
        for (int e = 0; e < 8; ++e) x[q][e] = canon(x[q][e], p);
    }
    finish(x, sm, par, p, t);
    store_polys<L, NP>(x, out, j, li, t);
  });
}

// Launch K over grid (x, 2), blockIdx.y the limb, args then per_limb.  The
// blocks the card holds at once (occupancy x SMs, found at the first
// launch) are split between the limbs, and cut to the steps of a limb:
// each block loads the twiddles once and loops over its steps.
template <int L, auto K, typename... Args>
static int launch_limbs(int per_limb, void* stream, Args... args) {
  using B = Batch<L>;
  static const int wave = [] {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, K, B::THREADS,
                                                  B::SMEM);
    return sms * per_sm;
  }();
  const int need = ((per_limb + 1) / 2 + B::W - 1) / B::W;
  const int share = wave / 2 > 1 ? wave / 2 : 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(need < share ? need : share, 2);
  cfg.blockDim = dim3(B::THREADS);
  cfg.dynamicSmemBytes = B::SMEM;
  cfg.stream = (cudaStream_t)stream;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, K, args..., per_limb);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// Sum of word i over the shared memory of the cluster's first n blocks.
__device__ __forceinline__ uint32_t cluster_sum(cg::cluster_group& cl,
                                                uint32_t* sm, int n, int i) {
  uint32_t s = 0;
  for (int b = 0; b < n; ++b) s += cl.map_shared_rank(sm, b)[i];
  return s;
}

// Launch a kernel of this core over a grid of clusters of `cluster` blocks
// along x, d/8 threads each, with Sched<L>::SMEM bytes of shared memory.
template <int L, typename... Params, typename... Args>
static int launch_clusters(void (*kernel)(Params...), dim3 grid, int cluster,
                           void* stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(Sched<L>::T);
  cfg.dynamicSmemBytes = Sched<L>::SMEM;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

}  // namespace reg
}  // namespace spiral
