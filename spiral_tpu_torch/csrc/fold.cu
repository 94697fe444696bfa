// K3, K5 and K6: one GSW fold round, signed (Spiral) or unsigned (pack),
// for one query or for a batch of B queries.
//
// For output ct o, column col and CRT limb li:
//   out[o, r, col] = INTT( sum_kk q_neg[r, kk] * NTT(G^-1(cts[2o]))[kk, col]
//                        + q_pos[r, kk] * NTT(G^-1(cts[2o+1]))[kk, col] )
// with row kk = k*N1 + j holding digit k of input row j.  The kernel is a
// template on the row count N1 and the digit form:
//   K3 (N1 = 3, signed): Spiral's matrix cts, n2 columns; G^-1 is
//     split_and_crt's signed base-2^bits digits with carry
//     (spiral_tpu/core/gadget.py gadget_invert_signed_impl).
//   K6 (N1 = 2, unsigned): the pack variant's scalar cts, one column, the
//     out_n^2 trials flattened into the output-ct index (pairs never cross
//     a trial); G^-1 is the unsigned digits (lift >> k*bits) & mask
//     (gadget_invert_impl), reduced mod p.
// Both digit widths of the presets run here: 7-bit at t_gsw = 9 and 8-bit
// at t_gsw = 8 (and 6-bit at t_gsw = 11, spiral_24_256).
//   K5 is either form over B queries in one launch: the output cts of all
//     queries flatten into o, output ct o belongs to query o / m_per_q and
//     reads that query's q block (B, N1, m2, 2, d), as the Pallas batched
//     round's `i // spq` index map does (spiral_tpu/server/fold_pallas.py
//     _fold_round_call_batch).  A pair (2o, 2o+1) never crosses a query.
//     K3 and K6 are the same kernel with m_per_q = m_out (one q block).
//
// Replaces the Pallas fold kernel spiral_tpu/server/fold_pallas.py
// _fold_round_call (kernel _make_fold_kernel; signed=True for Spiral,
// signed=False through fold_pack_rounds_fused for the pack), which keeps all
// m2*n2 digit polys in VMEM and contracts them in int8 limb matmuls with a
// bias correction.  Digits here are exact residues, so no bias correction
// is needed.
//
// Bound on the H100: the digit NTTs' integer multiplies, 2*N1*t_gsw + N1
// NTTs of d = 2048 per (o, col, li) (57 for K3 at t_gsw 9, 38 for K6), and
// their latency: the digit tensor of one (o, col, li) does not fit a
// block's shared memory, and walking its polys one at a time through one
// block made every round that fits one wave take the same time whatever
// its size.  The design spreads one (o, col, li) over a thread-block
// cluster of 2*N1 blocks, one per input row (src, j) (6 for K3 and the
// Spiral K5, 4 for K6 and the pack K5).  A block lifts its row once, forms
// its t_gsw digits two at a time (the signed carry chains run in order
// across them), transforms them with the register NTT of ntt_reg.cuh, and
// multiply-accumulates each slot into the N1 output rows (slot t + e*d/8 of
// thread t, q read coalesced), u64 sums in registers.  It leaves the sums,
// reduced mod p, in its shared memory; after a cluster barrier block r < N1
// adds up output row r over the cluster through distributed shared memory
// and runs that row's inverse NTT (the untwist is merged into it), so the
// N1 inverse NTTs run on N1 blocks at once.  The sum is exact, so the
// result does not depend on block order.  Round 1 at spiral_20_256 runs
// 1,536 blocks of 9 digit NTTs (and three of them one inverse each) instead
// of 256 blocks of 57 NTTs in sequence.
#include <type_traits>

#include "ntt_reg.cuh"

using namespace spiral;

template <int L, int N1, bool SIGNED>
__global__ void __launch_bounds__(1 << (L - 3), 2)
fold_round_kernel(const uint32_t* __restrict__ cts,
                  const uint32_t* __restrict__ q_neg,
                  const uint32_t* __restrict__ q_pos,
                  uint32_t* __restrict__ out,
                  const uint32_t* __restrict__ tab, int n2, int t_gsw,
                  int m_per_q) {
  using S = reg::Sched<L>;
  constexpr int D = S::D, T = S::T, C = 2 * N1;
  extern __shared__ uint32_t sm[];   // exchange buffers, then twiddles
  uint2* tw = reinterpret_cast<uint2*>(sm + 2 * reg::NP_MAX * D);
  reg::cg::cluster_group cluster = reg::cg::this_cluster();
  const int c = cluster.block_rank();
  const int src = c / N1, jr = c % N1;
  const int o = blockIdx.x / C, col = blockIdx.y, li = blockIdx.z;
  const int t = threadIdx.x;
  const Mod md = mod_of(li);
  const int m2 = t_gsw * N1;
  const uint32_t* q = (src ? q_pos : q_neg) +
                      (size_t)(o / m_per_q) * N1 * m2 * 2 * D;
  const uint32_t* in =
      cts + (((size_t)(2 * o + src) * N1 + jr) * n2 + col) * 2 * D;
  reg::load_twiddles<L>(tw, tab, reg::ROW_REG + 4 * li, t);
  uint32_t pos[4];
  reg::load_slot_positions<L>(pos, tab, t);
  const int bits = bits_per(t_gsw);
  const uint64_t mask = (1ull << bits) - 1;   // t_gsw >= 2: bits <= 29
  const uint32_t half_z = 1u << (bits - 1);
  const uint32_t z_mod = md.reduce(1ull << bits);
  const int h = t_gsw / 2;   // the two carry chains: [0, h) and [h, t_gsw)
  uint64_t v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = lift(in[e * T + t], in[D + e * T + t]);
  uint32_t carry = 0;        // bit e: the carry of coefficient e*d/8 + t
  uint64_t acc[N1][8] = {};
  int par = 0;
  __syncthreads();

  auto step = [&](auto np, int k0) {
    constexpr int NP = decltype(np)::value;
    uint32_t x[NP][8];
#pragma unroll
    for (int qq = 0; qq < NP; ++qq) {
      const int k = k0 + qq, sh = k * bits;
      if (SIGNED && (k == 0 || k == h)) carry = 0;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const uint32_t piece = sh < 64 ? (uint32_t)((v[e] >> sh) & mask) : 0u;
        if constexpr (SIGNED) {
          const uint32_t pc = piece + ((carry >> e) & 1);
          const bool sgn = pc > half_z && (k >= h || k < h - 1);
          carry = (carry & ~(1u << e)) | ((uint32_t)sgn << e);
          if (bits <= 27) {          // pc <= 2^bits < p: digit pc - 2^bits
            x[qq][e] = sgn ? pc + (md.p - (1u << bits)) : pc;   // <= p
          } else {
            const uint32_t r = md.reduce(pc);
            x[qq][e] = sgn ? md.sub(r, z_mod) : r;
          }
        } else {
          x[qq][e] = piece;          // < 2^29 < 4p
        }
      }
    }
    reg::forward<L, NP>(x, sm, par, tw, md.p, t);
    reg::to_slots<L, NP>(x, sm, par, pos, t);
#pragma unroll
    for (int qq = 0; qq < NP; ++qq) {
      const int kk = (k0 + qq) * N1 + jr;
      uint32_t y[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) y[e] = reg::canon(x[qq][e], md.p);
#pragma unroll
      for (int r = 0; r < N1; ++r) {
        const uint32_t* qr = q + ((size_t)(r * m2 + kk) * 2 + li) * D + t;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[r][e] += (uint64_t)y[e] * qr[e * T];
      }
    }
  };
  // at most t_gsw <= 56 products below 2^56 in a sum
  for (int k = 0; k < t_gsw; k += 2) {
    if (k + 1 < t_gsw)
      step(std::integral_constant<int, 2>{}, k);
    else
      step(std::integral_constant<int, 1>{}, k);
  }

  __syncthreads();   // every slot read of the last exchange is done
#pragma unroll
  for (int r = 0; r < N1; ++r)
#pragma unroll
    for (int e = 0; e < 8; ++e) sm[r * D + e * T + t] = md.reduce(acc[r][e]);
  cluster.sync();
  uint32_t y[1][8];
  if (c < N1) {
#pragma unroll
    for (int e = 0; e < 8; ++e)   // C sums below p: below 8p < 2^31
      y[0][e] = md.reduce(reg::cluster_sum(cluster, sm, C, c * D + e * T + t));
  }
  cluster.sync();    // no block leaves or writes while its memory is read
  if (c >= N1) return;

  // output row r = c: the inverse NTT of the summed slots
  const int row = reg::ROW_REG + 4 * li + 2;
  reg::load_twiddles<L>(tw, tab, row, t);
  const uint2 d_inv = make_uint2(tab[row * D], tab[(row + 1) * D]);
  reg::from_slots<L>(y, sm, par, pos, t);   // its barrier covers tw too
  reg::inverse<L, 1>(y, sm, par, tw, md.p, t);
  uint32_t* dst = out + ((((size_t)o * N1 + c) * n2 + col) * 2 + li) * D + t;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const uint32_t r = reg::shoup(y[0][e], d_inv, md.p);   // [0, 2p)
    dst[e * T] = r >= md.p ? r - md.p : r;
  }
}

template <int N1, bool SIGNED>
static int launch_fold(const void* cts, const void* q_neg, const void* q_pos,
                       void* out, const void* tab, int B, int m_out, int n2,
                       int t_gsw, int d, void* stream) {
  if (t_gsw < 2 || t_gsw > 56 || B < 1 || m_out < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(2 * N1 * B * m_out, n2, 2);
  const auto* c = (const uint32_t*)cts;
  const auto* qn = (const uint32_t*)q_neg;
  const auto* qp = (const uint32_t*)q_pos;
  const auto* tb = (const uint32_t*)tab;
  auto* o = (uint32_t*)out;
  switch (d) {
    case 256: return reg::launch_clusters<8>(
        fold_round_kernel<8, N1, SIGNED>, grid, 2 * N1, stream, c, qn, qp, o,
        tb, n2, t_gsw, m_out);
    case 2048: return reg::launch_clusters<11>(
        fold_round_kernel<11, N1, SIGNED>, grid, 2 * N1, stream, c, qn, qp, o,
        tb, n2, t_gsw, m_out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K3: cts (2*m_out, 3, n2, 2, d) -> out (m_out, 3, n2, 2, d).
extern "C" int spiral_fold_round(const void* cts, const void* q_neg,
                                 const void* q_pos, void* out,
                                 const void* tab, int m_out, int n1, int n2,
                                 int t_gsw, int d, void* stream) {
  if (n1 != 3) return (int)cudaErrorInvalidValue;
  return launch_fold<3, true>(cts, q_neg, q_pos, out, tab, 1, m_out, n2,
                              t_gsw, d, stream);
}

// K6: cts (2*m_out, 2, 1, 2, d) -> out (m_out, 2, 1, 2, d), m_out summed
// over the trials.
extern "C" int spiral_fold_pack_round(const void* cts, const void* q_neg,
                                      const void* q_pos, void* out,
                                      const void* tab, int m_out, int t_gsw,
                                      int d, void* stream) {
  return launch_fold<2, false>(cts, q_neg, q_pos, out, tab, 1, m_out, 1,
                               t_gsw, d, stream);
}

// K5, Spiral form: cts (B, 2*m_out, 3, n2, 2, d), q_neg/q_pos
// (B, 3, 3*t_gsw, 2, d) -> out (B, m_out, 3, n2, 2, d).
extern "C" int spiral_fold_round_batch(const void* cts, const void* q_neg,
                                       const void* q_pos, void* out,
                                       const void* tab, int B, int m_out,
                                       int n1, int n2, int t_gsw, int d,
                                       void* stream) {
  if (n1 != 3) return (int)cudaErrorInvalidValue;
  return launch_fold<3, true>(cts, q_neg, q_pos, out, tab, B, m_out, n2,
                              t_gsw, d, stream);
}

// K5, pack form: cts (B, T, 2*m, 2, 1, 2, d), q_neg/q_pos
// (B, 2, 2*t_gsw, 2, d) -> out (B, T, m, 2, 1, 2, d), with m_out = T*m the
// outputs of one query.
extern "C" int spiral_fold_pack_round_batch(const void* cts,
                                            const void* q_neg,
                                            const void* q_pos, void* out,
                                            const void* tab, int B,
                                            int m_out, int t_gsw, int d,
                                            void* stream) {
  return launch_fold<2, false>(cts, q_neg, q_pos, out, tab, B, m_out, 1,
                               t_gsw, d, stream);
}
