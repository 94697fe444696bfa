// K3: one signed GSW fold round.
//
// For output ct o, column col and CRT limb li:
//   out[o, r, col] = INTT( sum_kk q_neg[r, kk] * NTT(G^-1(cts[2o]))[kk, col]
//                        + q_pos[r, kk] * NTT(G^-1(cts[2o+1]))[kk, col] )
// where G^-1 is split_and_crt's signed base-2^bits digits with carry
// (spiral_tpu/core/gadget.py gadget_invert_signed_impl), row kk = k*n1 + j
// holding digit k of input row j.  Both digit widths run here: 7-bit at
// t_gsw = 9 and 8-bit at t_gsw = 8.
//
// Replaces the Pallas fold kernel spiral_tpu/server/fold_pallas.py
// _fold_round_call (kernel _make_fold_kernel, signed=True), which keeps all
// m2*n2 digit polys in VMEM and contracts them in int8 limb matmuls with a
// bias correction.  That digit tensor does not fit 227 KB of shared memory
// (54 polys x 8 KB per limb), so one block of d/2 threads handles one
// (o, col, li): it walks the 2*n1*t_gsw digit polys one at a time through a
// single 8 KB shared buffer (digits -> twist -> radix-2 NTT), multiplies
// each slot against q_neg/q_pos read in place at the slot's mxu index, and
// keeps only the n1 output accumulators, as u64 in registers (two slots per
// thread).  Three inverse NTTs finish the round.  Digits are exact
// residues, so no bias correction is needed.
//
// Bound on the H100: 2*m2 + n1 = 57 NTTs of d = 2048 per block, each 11
// __syncthreads() stages; the q reads are gathers from L2.  Latency and
// integer issue bound; the later rounds run few blocks.
#include "ntt.cuh"

using namespace spiral;

constexpr int FOLD_N1 = 3;

__global__ void __launch_bounds__(1024)
fold_round_kernel(const uint32_t* __restrict__ cts,
                  const uint32_t* __restrict__ q_neg,
                  const uint32_t* __restrict__ q_pos,
                  uint32_t* __restrict__ out,
                  const uint32_t* __restrict__ tab, int n2, int t_gsw, int d,
                  int logd) {
  extern __shared__ uint32_t a[];
  const int o = blockIdx.x, col = blockIdx.y, li = blockIdx.z;
  const Mod md = mod_of(li);
  const int half = d >> 1, tid = threadIdx.x;
  const int m2 = t_gsw * FOLD_N1;
  const int bits = bits_per(t_gsw);
  const uint64_t mask = (1ull << bits) - 1;
  const uint32_t half_z = 1u << (bits - 1);
  const uint32_t z_mod = md.reduce(1ull << bits);
  const int h = t_gsw / 2;   // the two carry chains: [0, h) and [h, t_gsw)
  const uint32_t* twist = tab + (li * 4 + 0) * d;
  const uint32_t* omega = tab + (li * 4 + 2) * d;
  const int slot[2] = {(int)tab[9 * d + tid], (int)tab[9 * d + tid + half]};

  uint64_t acc[FOLD_N1][2] = {};
  for (int src = 0; src < 2; ++src) {
    const uint32_t* q = src ? q_pos : q_neg;
    for (int j = 0; j < FOLD_N1; ++j) {
      const uint32_t* c =
          cts + (((size_t)(2 * o + src) * FOLD_N1 + j) * n2 + col) * 2 * d;
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
          if (k == 0 || k == h) carry[e] = 0;
          const uint32_t piece =
              (sh < 64 ? (uint32_t)((v[e] >> sh) & mask) : 0u) + carry[e];
          const bool sgn = piece > half_z && (k >= h || k < h - 1);
          carry[e] = sgn;
          uint32_t r = md.reduce(piece);
          if (sgn) r = md.sub(r, z_mod);   // digit value piece - 2^bits
          a[i] = md.mul(r, twist[i]);
        }
        __syncthreads();
        ntt_dif(a, omega, md, d, logd);
        const int kk = k * FOLD_N1 + j;
        for (int r = 0; r < FOLD_N1; ++r) {
          const uint32_t* qr = q + ((size_t)(r * m2 + kk) * 2 + li) * d;
          for (int e = 0; e < 2; ++e)
            acc[r][e] += (uint64_t)a[tid + e * half] * qr[slot[e]];
        }
        __syncthreads();
      }
      // at most t_gsw <= 56 products since the last reduction
      for (int r = 0; r < FOLD_N1; ++r)
        for (int e = 0; e < 2; ++e) acc[r][e] = md.reduce(acc[r][e]);
    }
  }

  const uint32_t* omega_inv = tab + (li * 4 + 3) * d;
  const uint32_t* untwist = tab + (li * 4 + 1) * d;
  for (int r = 0; r < FOLD_N1; ++r) {
    for (int e = 0; e < 2; ++e) a[tid + e * half] = (uint32_t)acc[r][e];
    __syncthreads();
    ntt_dit_inv(a, omega_inv, md, d, logd);
    uint32_t* y = out + ((((size_t)o * FOLD_N1 + r) * n2 + col) * 2 + li) * d;
    for (int e = 0; e < 2; ++e) {
      const int i = tid + e * half;
      y[i] = md.mul(a[i], untwist[i]);
    }
    __syncthreads();
  }
}

extern "C" int spiral_fold_round(const void* cts, const void* q_neg,
                                 const void* q_pos, void* out,
                                 const void* tab, int m_out, int n1, int n2,
                                 int t_gsw, int d, void* stream) {
  if (n1 != FOLD_N1 || d < 64 || d > 2048 || t_gsw < 2 || t_gsw > 56)
    return (int)cudaErrorInvalidValue;
  dim3 grid(m_out, n2, 2);
  fold_round_kernel<<<grid, d / 2, d * sizeof(uint32_t),
                      (cudaStream_t)stream>>>(
      (const uint32_t*)cts, (const uint32_t*)q_neg, (const uint32_t*)q_pos,
      (uint32_t*)out, (const uint32_t*)tab, n2, t_gsw, d, log2_exact(d));
  return (int)cudaGetLastError();
}
