// K7: packing the out_n^2 scalar result cts into one (out_n+1) x out_n
// matrix ct, for one query or, one block row per query, a batch of B.
//
// For output column c and CRT limb li, with ct_(r,c) the coefficient-domain
// result ct of trial r*out_n + c and v_W (out_n, out_n+1, m_conv) the
// packing keys in the NTT domain:
//   out[b, c] = sum_r sum_k v_W[r, b, k] * NTT(digit_k(ct_(r,c) row 0))
//               + [b >= 1] NTT(ct_(b-1,c) row 1)
// with unsigned base-2^bits digits of the m_conv-digit gadget
// (spiral_tpu/core/gadget.py gadget_invert_impl), reduced mod p, a digit
// wider than 31 bits cut to its low 32 bits as there.
//
// Replaces the Pallas packing kernel spiral_tpu/server/pack_pallas.py
// _pack_call (kernel _make_pack_kernel), which holds all out_n^2 trials'
// digit polys in VMEM and contracts them in one int8 limb matmul; its gate
// m_conv*out_n <= 64 was a VMEM limit.  Here one block of d/2 threads per
// (c, li) walks the out_n*(m_conv + 1) forward NTTs of its column one at a
// time through a single 8 KB shared buffer and keeps the (out_n+1) output
// rows as u64 accumulators in registers (two slots per thread), reading
// v_W in place at each slot's mxu index.  So it takes every pack preset:
// out_n 2, 4 and 8 (a template argument, so the accumulators stay in
// registers), m_conv up to 56.
//
// Bound on the H100: it runs only 2*out_n blocks per query on 132 SMs
// (2*out_n*B for a batch), each a chain of out_n*(m_conv + 1) NTTs of 11
// __syncthreads() stages: latency bound, far from both the integer and the
// memory rate.
#include "ntt.cuh"

using namespace spiral;

template <int OUT_N>
__global__ void __launch_bounds__(1024)
pack_kernel(const uint32_t* __restrict__ cts,
            const uint32_t* __restrict__ v_W, uint32_t* __restrict__ out,
            const uint32_t* __restrict__ tab, int m_conv, int d, int logd) {
  extern __shared__ uint32_t a[];
  const int c = blockIdx.x, li = blockIdx.y;
  cts += (size_t)blockIdx.z * OUT_N * OUT_N * 4 * d;     // query blockIdx.z
  out += (size_t)blockIdx.z * (OUT_N + 1) * OUT_N * 2 * d;
  const Mod md = mod_of(li);
  const int half = d >> 1, tid = threadIdx.x;
  const int bits = bits_per(m_conv);
  const uint64_t mask = bits < 32 ? (1ull << bits) - 1 : 0xFFFFFFFFull;
  const uint32_t* twist = tab + (li * 4 + 0) * d;
  const uint32_t* omega = tab + (li * 4 + 2) * d;
  const int slot[2] = {(int)tab[9 * d + tid], (int)tab[9 * d + tid + half]};

  uint64_t acc[OUT_N + 1][2] = {};
  for (int r = 0; r < OUT_N; ++r) {
    // cts (T, 2, 1, 2, d): row j, limb l of trial t at ((t*2 + j)*2 + l)*d
    const uint32_t* ct = cts + (size_t)(r * OUT_N + c) * 4 * d;
    uint64_t v[2];
    for (int e = 0; e < 2; ++e) {
      const int i = tid + e * half;
      v[e] = lift(ct[i], ct[d + i]);
    }
    for (int k = 0; k < m_conv; ++k) {
      const int sh = k * bits;
      for (int e = 0; e < 2; ++e) {
        const int i = tid + e * half;
        const uint64_t dg = sh < 64 ? (v[e] >> sh) & mask : 0;
        a[i] = md.mul(md.reduce(dg), twist[i]);
      }
      __syncthreads();
      ntt_dif(a, omega, md, d, logd);
#pragma unroll
      for (int b = 0; b <= OUT_N; ++b) {
        const uint32_t* w =
            v_W + ((((size_t)r * (OUT_N + 1) + b) * m_conv + k) * 2 + li) * d;
        for (int e = 0; e < 2; ++e)
          acc[b][e] += (uint64_t)a[tid + e * half] * w[slot[e]];
      }
      __syncthreads();
    }
    // row 1 of ct_(r,c) lands in output row r + 1
    const uint32_t* c1 = ct + (2 + li) * d;
    for (int e = 0; e < 2; ++e) {
      const int i = tid + e * half;
      a[i] = md.mul(c1[i], twist[i]);
    }
    __syncthreads();
    ntt_dif(a, omega, md, d, logd);
#pragma unroll
    for (int b = 1; b <= OUT_N; ++b)
      if (b == r + 1)
        for (int e = 0; e < 2; ++e) acc[b][e] += a[tid + e * half];
    __syncthreads();
    // at most m_conv <= 56 products and one residue since the last
    // reduction: below 2^63
#pragma unroll
    for (int b = 0; b <= OUT_N; ++b)
      for (int e = 0; e < 2; ++e) acc[b][e] = md.reduce(acc[b][e]);
  }
  // out (out_n+1, out_n, 2, d), NTT domain in mxu slot order
#pragma unroll
  for (int b = 0; b <= OUT_N; ++b)
    for (int e = 0; e < 2; ++e)
      out[(((size_t)b * OUT_N + c) * 2 + li) * d + slot[e]] =
          (uint32_t)acc[b][e];
}

template <int OUT_N>
static void launch_pack(const void* cts, const void* v_W, void* out,
                        const void* tab, int B, int m_conv, int d,
                        cudaStream_t stream) {
  dim3 grid(OUT_N, 2, B);
  pack_kernel<OUT_N><<<grid, d / 2, d * sizeof(uint32_t), stream>>>(
      (const uint32_t*)cts, (const uint32_t*)v_W, (uint32_t*)out,
      (const uint32_t*)tab, m_conv, d, log2_exact(d));
}

// cts (B, out_n^2, 2, 1, 2, d) coeff, v_W (out_n, out_n+1, m_conv, 2, d)
// NTT, shared by the batch -> out (B, out_n+1, out_n, 2, d) NTT.
extern "C" int spiral_pack(const void* cts, const void* v_W, void* out,
                           const void* tab, int B, int out_n, int m_conv,
                           int d, void* stream) {
  if (d < 64 || d > 2048 || m_conv < 1 || m_conv > 56 || B < 1 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (out_n) {
    case 2: launch_pack<2>(cts, v_W, out, tab, B, m_conv, d, s); break;
    case 4: launch_pack<4>(cts, v_W, out, tab, B, m_conv, d, s); break;
    case 8: launch_pack<8>(cts, v_W, out, tab, B, m_conv, d, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
