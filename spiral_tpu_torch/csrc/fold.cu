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
// bias correction.  That digit tensor does not fit 227 KB of shared memory
// (54 polys x 8 KB per limb for K3), so one block of d/2 threads handles
// one (o, col, li): it walks the 2*N1*t_gsw digit polys one at a time
// through a single 8 KB shared buffer (digits -> twist -> radix-2 NTT),
// multiplies each slot against q_neg/q_pos read in place at the slot's mxu
// index, and keeps only the N1 output accumulators, as u64 in registers
// (two slots per thread).  N1 inverse NTTs finish the round.  Digits are
// exact residues, so no bias correction is needed.
//
// Bound on the H100: the NTTs' integer multiplies, 2*N1*t_gsw + N1 NTTs of
// d = 2048 per block (57 for K3 at t_gsw 9, 38 for K6), each 11
// __syncthreads() stages; the q reads are gathers from L2.  Latency and
// integer issue bound; the later rounds run few blocks (K6's last round:
// out_n^2 * 2 blocks).  K5 runs B times as many blocks in one launch, so
// its later rounds leave fewer SMs idle.
#include "ntt.cuh"

using namespace spiral;

template <int N1, bool SIGNED>
__global__ void __launch_bounds__(1024)
fold_round_kernel(const uint32_t* __restrict__ cts,
                  const uint32_t* __restrict__ q_neg,
                  const uint32_t* __restrict__ q_pos,
                  uint32_t* __restrict__ out,
                  const uint32_t* __restrict__ tab, int n2, int t_gsw, int d,
                  int logd, int m_per_q) {
  extern __shared__ uint32_t a[];
  const int o = blockIdx.x, col = blockIdx.y, li = blockIdx.z;
  const Mod md = mod_of(li);
  const int half = d >> 1, tid = threadIdx.x;
  const int m2 = t_gsw * N1;
  const size_t q_off = (size_t)(o / m_per_q) * N1 * m2 * 2 * d;
  const int bits = bits_per(t_gsw);
  const uint64_t mask = (1ull << bits) - 1;   // t_gsw >= 2: bits <= 29
  const uint32_t half_z = 1u << (bits - 1);
  const uint32_t z_mod = md.reduce(1ull << bits);
  const int h = t_gsw / 2;   // the two carry chains: [0, h) and [h, t_gsw)
  const uint32_t* twist = tab + (li * 4 + 0) * d;
  const uint32_t* omega = tab + (li * 4 + 2) * d;
  const int slot[2] = {(int)tab[9 * d + tid], (int)tab[9 * d + tid + half]};

  uint64_t acc[N1][2] = {};
  for (int src = 0; src < 2; ++src) {
    const uint32_t* q = (src ? q_pos : q_neg) + q_off;
    for (int j = 0; j < N1; ++j) {
      const uint32_t* c =
          cts + (((size_t)(2 * o + src) * N1 + j) * n2 + col) * 2 * d;
      uint64_t v[2];
      uint32_t carry[2];
      for (int e = 0; e < 2; ++e) {
        const int i = tid + e * half;
        v[e] = lift(c[i], c[d + i]);
      }
      for (int k = 0; k < t_gsw; ++k) {
        const int sh = k * bits;
        for (int e = 0; e < 2; ++e) {
          const int i = tid + e * half;
          uint32_t r;
          if constexpr (SIGNED) {
            if (k == 0 || k == h) carry[e] = 0;
            const uint32_t piece =
                (sh < 64 ? (uint32_t)((v[e] >> sh) & mask) : 0u) + carry[e];
            const bool sgn = piece > half_z && (k >= h || k < h - 1);
            carry[e] = sgn;
            r = md.reduce(piece);
            if (sgn) r = md.sub(r, z_mod);   // digit value piece - 2^bits
          } else {
            r = md.reduce(sh < 64 ? (v[e] >> sh) & mask : 0);
          }
          a[i] = md.mul(r, twist[i]);
        }
        __syncthreads();
        ntt_dif(a, omega, md, d, logd);
        const int kk = k * N1 + j;
        for (int r = 0; r < N1; ++r) {
          const uint32_t* qr = q + ((size_t)(r * m2 + kk) * 2 + li) * d;
          for (int e = 0; e < 2; ++e)
            acc[r][e] += (uint64_t)a[tid + e * half] * qr[slot[e]];
        }
        __syncthreads();
      }
      // at most t_gsw <= 56 products since the last reduction
      for (int r = 0; r < N1; ++r)
        for (int e = 0; e < 2; ++e) acc[r][e] = md.reduce(acc[r][e]);
    }
  }

  const uint32_t* omega_inv = tab + (li * 4 + 3) * d;
  const uint32_t* untwist = tab + (li * 4 + 1) * d;
  for (int r = 0; r < N1; ++r) {
    for (int e = 0; e < 2; ++e) a[tid + e * half] = (uint32_t)acc[r][e];
    __syncthreads();
    ntt_dit_inv(a, omega_inv, md, d, logd);
    uint32_t* y = out + ((((size_t)o * N1 + r) * n2 + col) * 2 + li) * d;
    for (int e = 0; e < 2; ++e) {
      const int i = tid + e * half;
      y[i] = md.mul(a[i], untwist[i]);
    }
    __syncthreads();
  }
}

template <int N1, bool SIGNED>
static int launch_fold(const void* cts, const void* q_neg, const void* q_pos,
                       void* out, const void* tab, int B, int m_out, int n2,
                       int t_gsw, int d, void* stream) {
  if (d < 64 || d > 2048 || t_gsw < 2 || t_gsw > 56 || B < 1 || m_out < 1)
    return (int)cudaErrorInvalidValue;
  dim3 grid(B * m_out, n2, 2);
  fold_round_kernel<N1, SIGNED><<<grid, d / 2, d * sizeof(uint32_t),
                                  (cudaStream_t)stream>>>(
      (const uint32_t*)cts, (const uint32_t*)q_neg, (const uint32_t*)q_pos,
      (uint32_t*)out, (const uint32_t*)tab, n2, t_gsw, d, log2_exact(d),
      m_out);
  return (int)cudaGetLastError();
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
