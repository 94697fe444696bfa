// K9: composition (scalar cts -> matrix cts) and conversion (Regev cts ->
// GSW cts, q_pos and q_neg), one launch each.
//
// For scalar ct n (rows 0 and 1, NTT domain, mxu slot order) and CRT limb
// li, with g_k = NTT(digit_k(INTT(row 0))) the m_conv = 4 unsigned
// base-2^15 digits of the Garner lift (spiral_tpu/core/gadget.py
// gadget_invert_impl, as K4 forms them):
//   composition  out[n, r, c] = sum_k W[r, 2k + c] * g_k
//                               + [(r, c) in {(1, 0), (2, 1)}] row 1,
//   conversion   the same six polys, then with h_k the digits of row 1,
//                V_r = sum_k V[r, k] * g_k + V[r, m_conv + k] * h_k,
//                column i*3 + 0 of GSW row r is V_r and columns i*3 + 1 + c
//                are out[r, c] (i the ct's index among the t_gsw of its
//                GSW ct, server/convert.py regev_to_gsw_batch), the GSW cts
//                in reverse order (the flip of pir.py) as q_pos, and
//                q_neg = G2 - q_pos.
//
// K9 replaces no Pallas kernel: the JAX package runs this stage as XLA
// matmuls around its NTT kernel (spiral_tpu/server/convert.py).  The plain
// version forms every product as a broadcast int64 tensor in device memory
// and sums it there (core/poly.py matmul_raw); here every product and sum
// stays in registers.
//
// Bound on the H100: bytes, each input ct read and each output poly written
// once: at dim0 256 the composition reads 8.4 MB and writes 25.2 MB, and
// the conversion of nu_2 t_gsw = 63 cts reads 2.1 MB and writes 2 x 9.3 MB
// (q_pos, q_neg); the NTTs' products (10 NTTs of d = 2048 per ct for the
// composition, 20 for the conversion) take a quarter to a third of that
// time at the card's integer multiply rate.
//
// Design: K4's (expand.cu), a thread-block cluster per ct on the register
// NTT core of ntt_reg.cuh.  The lift needs both limbs of a coefficient, so
// block (h, li) of a ct's cluster runs the inverse NTT of row h in limb li
// (d/8 threads, 8 coefficients each in registers), leaves the coefficients
// in its shared memory and, after a cluster barrier, reads the other limb's
// through distributed shared memory: each inverse runs once, on the block
// that needs it, at the same time as the other limb's.  The block then
// forms its row's 4 digits, transforms them two at a time (the forward
// twiddles loaded over the inverse ones) and keeps the 4 transforms in
// registers (slot t + e*d/8 of thread t), so each output poly is 4 u64
// products summed and reduced once, with W read coalesced.  The
// composition's cluster is the 2 limb blocks (h = 0); the conversion's
// adds the 2 blocks of row 1: the row-0 blocks write the six polys, every
// block leaves its share of the three V sums in shared memory, and after a
// cluster barrier the two blocks of a limb add up half of them each.
// The NTT latency chain: a block runs 3 NTT steps (one inverse, two digit
// pairs) and its limb twin and row twin run theirs at the same time, so a
// ct's 10 (composition) or 20 (conversion) NTTs take 3 steps of latency;
// 2 blocks an SM (launch bounds) hide each other's barriers.
#include "ntt_reg.cuh"

using namespace spiral;

namespace {

constexpr int N0 = 2, N1 = 3, M_CONV = 4;

template <int L, bool CONV>
__global__ void __launch_bounds__(1 << (L - 3), 2)
compose_convert_kernel(const uint32_t* __restrict__ cv,
                       const uint32_t* __restrict__ W,
                       const uint32_t* __restrict__ V,
                       const uint32_t* __restrict__ G2,
                       uint32_t* __restrict__ out,
                       uint32_t* __restrict__ out_neg,
                       const uint32_t* __restrict__ tab, int nu2, int t_gsw) {
  using S = reg::Sched<L>;
  constexpr int D = S::D, T = S::T, C = CONV ? 4 : 2, M = M_CONV;
  extern __shared__ uint32_t sm[];   // exchange buffers, then twiddles
  uint2* tw = reinterpret_cast<uint2*>(sm + 2 * reg::NP_MAX * D);
  reg::cg::cluster_group cluster = reg::cg::this_cluster();
  const int c = cluster.block_rank(), li = c & 1, h = c >> 1;
  const int n = blockIdx.x / C, t = threadIdx.x;
  const Mod md = mod_of(li);
  const uint32_t one = 0xFFFFFFFFu / md.p;
  const uint32_t* ct = cv + (size_t)n * 4 * D;   // its (2, 1, 2, d) words
  const int inv_row = reg::ROW_REG + 4 * li + 2;
  reg::load_twiddles<L>(tw, tab, inv_row, t);
  const uint2 d_inv = make_uint2(tab[inv_row * D], tab[(inv_row + 1) * D]);
  uint32_t pos[4];
  reg::load_slot_positions<L>(pos, tab, t);
  uint32_t x[1][8];
#pragma unroll
  for (int e = 0; e < 8; ++e)
    x[0][e] = reg::reduce_word(ct[(2 * h + li) * D + e * T + t], md.p, one);
  int par = 0;
  __syncthreads();

  reg::from_slots<L, 1>(x, sm, par, pos, t);
  reg::inverse<L, 1>(x, sm, par, tw, md.p, t);
  // coefficient e*d/8 + t, canonical, into the buffer the last exchange
  // did not read, for the other limb's block
  uint32_t* coef = sm + par * reg::NP_MAX * D;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const uint32_t r = reg::shoup(x[0][e], d_inv, md.p);
    x[0][e] = r >= md.p ? r - md.p : r;
    coef[e * T + t] = x[0][e];
  }
  cluster.sync();    // coefficients in place; the inverse twiddles unread
  const uint32_t* other = cluster.map_shared_rank(coef, c ^ 1);
  uint64_t v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const uint32_t y = other[e * T + t];
    v[e] = li ? lift(y, x[0][e]) : lift(x[0][e], y);
  }
  reg::load_twiddles<L>(tw, tab, reg::ROW_REG + 4 * li, t);
  cluster.sync();    // the other block read coef; forward twiddles in place

  constexpr int BITS = 56 / M + 1;   // bits_per(4) = 15: digits below p
  constexpr uint64_t MASK = (1ull << BITS) - 1;
  uint32_t g[M][8];
#pragma unroll
  for (int k0 = 0; k0 < M; k0 += 2) {
    uint32_t y[2][8];
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        y[q][e] = (uint32_t)((v[e] >> ((k0 + q) * BITS)) & MASK);
    reg::forward<L, 2>(y, sm, par, tw, md.p, t);
    reg::to_slots<L, 2>(y, sm, par, pos, t);
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int e = 0; e < 8; ++e) g[k0 + q][e] = reg::canon(y[q][e], md.p);
  }

  // the ct's place in the output: composition (N, n1, n0, 2, d); conversion
  // GSW ct jf (reversed within its query), columns i*3 .. i*3 + 2
  const int m2 = (N0 + 1) * t_gsw;
  size_t base, col0 = 0;
  if constexpr (CONV) {
    const int q = n / (nu2 * t_gsw), j = n % (nu2 * t_gsw) / t_gsw;
    const size_t jf = (size_t)q * nu2 + nu2 - 1 - j;
    base = jf * N1 * m2;
    col0 = (size_t)(n % t_gsw) * (N0 + 1);
  } else {
    base = (size_t)n * N1 * N0;
  }
  auto emit = [&](size_t poly, int r, int col, const uint64_t (&acc)[8]) {
    uint32_t* o = out + (poly * 2 + li) * D + t;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const uint32_t val = md.reduce(acc[e]);
      o[e * T] = val;
      if constexpr (CONV) {
        const uint32_t* gp = G2 + (((size_t)r * m2 + col) * 2 + li) * D + t;
        out_neg[(poly * 2 + li) * D + t + e * T] = md.sub(gp[e * T], val);
      }
    }
  };

  if (h == 0) {
    const uint32_t* c1 = ct + (2 + li) * D + t;   // row 1, added as is
#pragma unroll
    for (int r = 0; r < N1; ++r)
#pragma unroll
      for (int cc = 0; cc < N0; ++cc) {
        uint64_t acc[8] = {};
#pragma unroll
        for (int k = 0; k < M; ++k) {
          const uint32_t* w =
              W + (((size_t)r * N0 * M + N0 * k + cc) * 2 + li) * D + t;
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[e] += (uint64_t)g[k][e] * w[e * T];
        }
        if ((r == 1 && cc == 0) || (r == 2 && cc == 1))
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[e] += c1[e * T];
        const int col = CONV ? (int)col0 + 1 + cc : cc;
        emit(CONV ? base + (size_t)r * m2 + col : base + r * N0 + cc, r, col,
             acc);
      }
  }
  if constexpr (CONV) {
    __syncthreads();   // every slot read of the last exchange is done
#pragma unroll
    for (int r = 0; r < N1; ++r) {
      uint64_t acc[8] = {};
#pragma unroll
      for (int k = 0; k < M; ++k) {
        const uint32_t* w =
            V + (((size_t)r * 2 * M + h * M + k) * 2 + li) * D + t;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] += (uint64_t)g[k][e] * w[e * T];
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) sm[r * D + e * T + t] = md.reduce(acc[e]);
    }
    cluster.sync();
    // the two blocks of limb li add up the rows' V sums, half each
    const uint32_t* twin = cluster.map_shared_rank(sm, c ^ 2);
    for (int u = h * T + t; u < N1 * D; u += 2 * T) {
      const int r = u >> L, s = u & (D - 1), col = (int)col0;
      const uint32_t val = md.add(sm[u], twin[u]);
      const size_t idx = ((base + (size_t)r * m2 + col) * 2 + li) * D + s;
      out[idx] = val;
      out_neg[idx] =
          md.sub(G2[(((size_t)r * m2 + col) * 2 + li) * D + s], val);
    }
    cluster.sync();  // no block leaves while its shared memory is read
  }
}

template <int L, bool CONV>
int launch(const void* cv, int n_cts, const void* W, const void* V,
           const void* G2, void* out, void* out_neg, const void* tab,
           int nu2, int t_gsw, void* stream) {
  constexpr int C = CONV ? 4 : 2;
  return reg::launch_clusters<L>(
      compose_convert_kernel<L, CONV>, dim3(C * n_cts), C, stream,
      (const uint32_t*)cv, (const uint32_t*)W, (const uint32_t*)V,
      (const uint32_t*)G2, (uint32_t*)out, (uint32_t*)out_neg,
      (const uint32_t*)tab, nu2, t_gsw);
}

}  // namespace

// Composition: cv (n_cts, 2, 1, 2, d) NTT, W (n1, n0*m_conv, 2, d) -> out
// (n_cts, n1, n0, 2, d).
extern "C" int spiral_compose(const void* cv, int n_cts, const void* W,
                              void* out, const void* tab, int d,
                              void* stream) {
  if (n_cts < 1 || (long long)n_cts * 2 > 0x7FFFFFFF)
    return (int)cudaErrorInvalidValue;
  switch (d) {
    case 256: return launch<8, false>(cv, n_cts, W, nullptr, nullptr, out,
                                      nullptr, tab, 1, 1, stream);
    case 2048: return launch<11, false>(cv, n_cts, W, nullptr, nullptr, out,
                                        nullptr, tab, 1, 1, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Conversion: cv (B, nu2*t_gsw, 2, 1, 2, d) NTT, W, V (n1, 2*m_conv, 2, d), G2 (n1, m2, 2, d) NTT -> q_pos,
// q_neg (B, nu2, n1, m2, 2, d), m2 = 3*t_gsw.
extern "C" int spiral_convert(const void* cv, int B, int nu2, int t_gsw, const void* W,
                              const void* V, const void* G2, void* q_pos,
                              void* q_neg, const void* tab, int d,
                              void* stream) {
  const int N = nu2 * t_gsw;
  if (B < 1 || nu2 < 1 || t_gsw < 1 || (long long)B * N * 4 > 0x7FFFFFFF)
    return (int)cudaErrorInvalidValue;
  switch (d) {
    case 256: return launch<8, true>(cv, B * N, W, V, G2, q_pos, q_neg, tab,
                                     nu2, t_gsw, stream);
    case 2048: return launch<11, true>(cv, B * N, W, V, G2, q_pos, q_neg,
                                       tab, nu2, t_gsw, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
