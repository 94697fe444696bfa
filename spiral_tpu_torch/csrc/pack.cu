// K7: packing the out_n^2 scalar result cts into one (out_n+1) x out_n
// matrix ct, for one query or, one grid layer per query, a batch of B.
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
// digit polys in VMEM and contracts them in one int8 limb matmul.
//
// Bound on the H100: a pack query is small (16 cts in, 20 polys out at
// out_n 4): its bytes take under a microsecond, so it is latency, the
// chain of NTTs each (c, li) needs.  The design cuts that chain: the
// out_n (m_conv + 1) NTTs of one (c, li) are spread over a thread-block
// cluster of out_n blocks, block r taking trial row r's m_conv digit polys
// and its row 1, two at a time through the register NTT of ntt_reg.cuh
// (Shoup twiddles, 4 barriers an NTT pair).  Each block keeps per-slot sums
// of the out_n + 1 output rows in registers (slot t + e*d/8 of thread t,
// v_W read coalesced), leaves them in its shared memory, and after a
// cluster barrier each block adds up a 1/out_n share of the (out_n+1) d
// words over the cluster through distributed shared memory and writes
// them out, as K4 does (expand.cu).  A query runs 2 out_n^2 blocks, each
// ceil((m_conv + 1) / 2) steps long (3 at m_conv 4).
#include "ntt_reg.cuh"

using namespace spiral;

template <int L, int OUT_N>
__global__ void __launch_bounds__(1 << (L - 3))
pack_kernel(const uint32_t* __restrict__ cts,
            const uint32_t* __restrict__ v_W, uint32_t* __restrict__ out,
            const uint32_t* __restrict__ tab, int m_conv) {
  using S = reg::Sched<L>;
  constexpr int D = S::D, T = S::T;
  // exchange buffers and twiddles; at the end the block's partial sums
  extern __shared__ uint32_t sm[];
  uint2* tw = reinterpret_cast<uint2*>(sm + 2 * reg::NP_MAX * D);
  reg::cg::cluster_group cluster = reg::cg::this_cluster();
  const int r = cluster.block_rank();      // trial row
  const int c = blockIdx.x / OUT_N, li = blockIdx.y, t = threadIdx.x;
  cts += (size_t)blockIdx.z * OUT_N * OUT_N * 4 * D;   // query blockIdx.z
  out += (size_t)blockIdx.z * (OUT_N + 1) * OUT_N * 2 * D;
  const Mod md = mod_of(li);
  reg::load_twiddles<L>(tw, tab, reg::ROW_REG + 4 * li, t);
  uint32_t pos[4];
  reg::load_slot_positions<L>(pos, tab, t);
  const int bits = bits_per(m_conv);
  const uint64_t mask = bits < 32 ? (1ull << bits) - 1 : 0xFFFFFFFFull;
  const uint32_t one = 0xFFFFFFFFu / md.p;
  // cts (T, 2, 1, 2, d): row j, limb l of trial n at ((n*2 + j)*2 + l)*d
  const uint32_t* ct = cts + (size_t)(r * OUT_N + c) * 4 * D;
  const uint32_t* c1 = ct + (2 + li) * D;
  uint64_t v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = lift(ct[e * T + t], ct[D + e * T + t]);
  uint32_t acc[OUT_N + 1][8] = {};
  uint32_t row1[8];    // NTT of row 1: output row r + 1, added at the end
  int par = 0;
  __syncthreads();

  // items k < m_conv: digit k of row 0; item m_conv: row 1
  auto step = [&](auto np, int k0) {
    constexpr int NP = decltype(np)::value;
    uint32_t x[NP][8];
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      const int k = k0 + q, sh = k * bits;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (k == m_conv) {
          x[q][e] = reg::reduce_word(c1[e * T + t], md.p, one);   // < 2p
        } else {
          const uint64_t dg = sh < 64 ? (v[e] >> sh) & mask : 0;
          x[q][e] = bits <= 29 ? (uint32_t)dg : md.reduce(dg);    // < 4p
        }
      }
    }
    reg::forward<L, NP>(x, sm, par, tw, md.p, t);
    reg::to_slots<L, NP>(x, sm, par, pos, t);
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      const int k = k0 + q;
      if (k == m_conv) {
#pragma unroll
        for (int e = 0; e < 8; ++e) row1[e] = reg::canon(x[q][e], md.p);
        continue;
      }
#pragma unroll
      for (int b = 0; b <= OUT_N; ++b) {
        const uint32_t* w =
            v_W + ((((size_t)r * (OUT_N + 1) + b) * m_conv + k) * 2 + li) * D +
            t;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          acc[b][e] =
              md.add(acc[b][e], md.mul(reg::canon(x[q][e], md.p), w[e * T]));
      }
    }
  };
  for (int k = 0; k <= m_conv; k += 2) {
    if (k + 1 <= m_conv)
      step(std::integral_constant<int, 2>{}, k);
    else
      step(std::integral_constant<int, 1>{}, k);
  }

  __syncthreads();   // every slot read of the last exchange is done
#pragma unroll
  for (int b = 0; b <= OUT_N; ++b)
#pragma unroll
    for (int e = 0; e < 8; ++e) sm[b * D + e * T + t] = acc[b][e];
  // row 1 of ct_(r,c) lands in output row r + 1 (a row indexed at run
  // time: in shared memory, so that acc stays in registers)
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    uint32_t* o = sm + (r + 1) * D + e * T + t;
    *o = md.add(*o, row1[e]);
  }
  cluster.sync();
  for (int u = r * T + t; u < (OUT_N + 1) * D; u += OUT_N * T) {
    const int b = u >> L, j = u & (D - 1);
    // out_n partial sums below p: below 8p < 2^32
    out[(((size_t)b * OUT_N + c) * 2 + li) * D + j] =
        md.reduce(reg::cluster_sum(cluster, sm, OUT_N, u));
  }
  cluster.sync();    // no block leaves while its shared memory is read
}

template <int L, int OUT_N>
static int launch_pack(const void* cts, const void* v_W, void* out,
                       const void* tab, int B, int m_conv,
                       cudaStream_t stream) {
  constexpr int D = 1 << L;
  constexpr int part = (OUT_N + 1) * D * 4;
  constexpr int smem =
      reg::Sched<L>::SMEM > part ? reg::Sched<L>::SMEM : part;
  auto kernel = pack_kernel<L, OUT_N>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(OUT_N * OUT_N, 2, B);
  cfg.blockDim = dim3(reg::Sched<L>::T);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = OUT_N;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, (const uint32_t*)cts, (const uint32_t*)v_W,
      (uint32_t*)out, (const uint32_t*)tab, m_conv);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <int L>
static int launch_out_n(const void* cts, const void* v_W, void* out,
                        const void* tab, int B, int out_n, int m_conv,
                        cudaStream_t s) {
  switch (out_n) {
    case 2: return launch_pack<L, 2>(cts, v_W, out, tab, B, m_conv, s);
    case 4: return launch_pack<L, 4>(cts, v_W, out, tab, B, m_conv, s);
    case 8: return launch_pack<L, 8>(cts, v_W, out, tab, B, m_conv, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// cts (B, out_n^2, 2, 1, 2, d) coeff, v_W (out_n, out_n+1, m_conv, 2, d)
// NTT, shared by the batch -> out (B, out_n+1, out_n, 2, d) NTT;
// d = 256 or 2048.
extern "C" int spiral_pack(const void* cts, const void* v_W, void* out,
                           const void* tab, int B, int out_n, int m_conv,
                           int d, void* stream) {
  if (m_conv < 1 || m_conv > 56 || B < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (d) {
    case 256: return launch_out_n<8>(cts, v_W, out, tab, B, out_n, m_conv, s);
    case 2048:
      return launch_out_n<11>(cts, v_W, out, tab, B, out_n, m_conv, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
