// K8b: a Spiral fold round as digits + NTT written to memory, then the
// per-slot contraction on the int8 tensor cores (the JAX SPIRAL_FOLD=mxu
// path; a K1 inverse NTT closes the round).
//
// K8b-1, fold_ntt_kernel, replaces spiral_tpu/server/fold_pallas.py
// _fold_ntt_call (kernel _make_fold_ntt_kernel).  For ct pairs
// cts (m_out, 2 s, N1, n2, 2, d) in the coefficient domain it writes
//   G[li, s, k, mo, jn1*n2 + c, z] = NTT(digit_k(cts[mo, s, jn1, c]))[z]
// mod p_li, u32 in mxu slot order: JAX's layout (li, s, k, m_out, N1*n2, d).
// The digits are split_and_crt's signed base-2^bits digits with carry
// (spiral_tpu/core/gadget.py gadget_invert_signed_impl), 8-bit at t_gsw 8,
// 7-bit at 9, 6-bit at 11, as exact residues: the TPU offsets 7-bit digits
// by an int8 bias for its matmul NTT and undoes it after the contraction
// (_fold_bias_corr); these digits need neither.  One block of d/2 threads
// per (source poly, limb) lifts the poly once and walks its t_gsw digit
// polys through one 8 KB shared buffer (digits -> twist -> radix-2 NTT ->
// row store along d), as K3's digit stage does.  Bound on the H100: the
// digit NTTs (2*N1*n2*t_gsw per output ct and limb, as in K3) and G's
// bytes (113 MB at spiral_20_256's round 1), written once.
//
// K8b-2, fold_contract_kernel, replaces the contraction that JAX runs in
// XLA, outside any pallas_call (fold_pallas.py _fold_contract_mxu, a
// dot_general, with the query prescaled by _fold_qpre).  Per CRT limb li
// and NTT slot z:
//   out[mo, r, c] = sum_{s,k,jn1} q_s[r, k*N1 + jn1] * G[s, k, mo, jn1, c]
// mod p_li, with q_0 = q_neg and q_1 = q_pos.  Both operands split into
// four 7-bit limbs: B's limb j of G, and A's limb i of (2^{7j} q) mod p,
// so that q*G = sum_i 2^{7i} sum_j A_ij G_j (mod p).  One GEMM per slot:
//   A: M = 4*N1 rows (i*N1 + r; 12 at N1 = 3, padded to 16)
//   B: K = 2*t_gsw*N1*4 (element e = (s*t_gsw + k)*N1 + jn1, then j), K
//      padded to a multiple of 32, by N = m_out*n2 columns (mo*n2 + c)
// on mma.sync.m16n8k32 s8 x s8 -> s32.  The K order puts an element's
// four j-limbs in one byte-packed register: a B fragment register is the
// limb split of one G word, an A fragment register the four prescaled
// limbs of one q word.  Each int32 sum has at most 2*t_gsw*N1*4 terms of
// at most 127^2 (264 at t_gsw 11: < 2^22.1), and sum_i 2^{7i} o_i < 2^44
// takes one Barrett reduction.
// The block: 8 consecutive slots (a warp each) of one limb, over a range
// of 64 columns.  It reads the round's q words of its slots into shared
// memory and builds each warp's A fragments there, prescale included (no
// Qpre tensor in memory).  Then per tile of 8 columns it loads the G rows
// of the tile, 8 slots (32 B) at a time along d, into shared memory and
// each warp reads its slot's column of that tile: the slot-major relayout
// that cost the TPU route a pass over G in memory happens in shared
// memory.  Results go through shared memory to 32 B row stores along d.
// Bound on the H100: G's bytes, read once (113 MB at spiral_20_256's round
// 1); the int8 multiply-adds are ~1.4 G.
#include "ntt.cuh"

using namespace spiral;

namespace {

// Signed digit k of the lifted value v, with the two carry chains [0, h)
// and [h, t_gsw), as a residue mod p (K3's digit in csrc/fold.cu).
struct SignedDigits {
  int bits, h;
  uint64_t mask;
  uint32_t half_z, z_mod;

  __device__ SignedDigits(int t_gsw, const Mod& md)
      : bits(bits_per(t_gsw)), h(t_gsw / 2) {
    mask = (1ull << bits) - 1;   // t_gsw >= 2: bits <= 29
    half_z = 1u << (bits - 1);
    z_mod = md.reduce(1ull << bits);
  }

  __device__ uint32_t next(uint64_t v, int k, uint32_t& carry,
                           const Mod& md) const {
    const int sh = k * bits;
    if (k == 0 || k == h) carry = 0;
    const uint32_t piece =
        (sh < 64 ? (uint32_t)((v >> sh) & mask) : 0u) + carry;
    const bool sgn = piece > half_z && (k >= h || k < h - 1);
    carry = sgn;
    const uint32_t r = md.reduce(piece);
    return sgn ? md.sub(r, z_mod) : r;   // digit value piece - 2^bits
  }
};

}  // namespace

__global__ void __launch_bounds__(1024)
fold_ntt_kernel(const uint32_t* __restrict__ cts, uint32_t* __restrict__ G,
                const uint32_t* __restrict__ tab, int m_out, int P,
                int t_gsw, int d, int logd) {
  extern __shared__ uint32_t a[];
  const int src = blockIdx.x;   // ((mo*2 + s)*P + p), p = jn1*n2 + c
  const int li = blockIdx.y;
  const int p = src % P, s = (src / P) & 1, mo = src / (2 * P);
  const Mod md = mod_of(li);
  const int half = d >> 1, tid = threadIdx.x;
  const SignedDigits dig(t_gsw, md);
  const uint32_t* twist = tab + (li * 4 + 0) * d;
  const uint32_t* omega = tab + (li * 4 + 2) * d;
  const uint32_t* pos_of_slot = tab + 8 * d;
  const uint32_t* c = cts + (size_t)src * 2 * d;

  uint64_t v[2];
  uint32_t carry[2] = {0, 0};
  for (int e = 0; e < 2; ++e) {
    const int i = tid + e * half;
    v[e] = lift(c[i], c[d + i]);
  }
  for (int k = 0; k < t_gsw; ++k) {
    for (int e = 0; e < 2; ++e) {
      const int i = tid + e * half;
      a[i] = md.mul(dig.next(v[e], k, carry[e], md), twist[i]);
    }
    __syncthreads();
    ntt_dif(a, omega, md, d, logd);
    uint32_t* g =
        G + ((((size_t)(li * 2 + s) * t_gsw + k) * m_out + mo) * P + p) * d;
    for (int e = 0; e < 2; ++e) {
      const int j = tid + e * half;
      g[j] = a[pos_of_slot[j]];
    }
    __syncthreads();
  }
}

namespace {

constexpr int ZT = 8;        // slots per block, one warp each
constexpr int NT = 8;        // columns per tile: the mma's n
constexpr int CT = 64;       // columns per block
constexpr int WARPS = ZT;
constexpr int GS_LD = ZT + 1;   // padded row: conflict-free fragment reads

// The four 7-bit limbs of a residue < 2^28, one per byte, limb 0 lowest.
__device__ __forceinline__ uint32_t limbs7(uint32_t x) {
  return (x & 0x7Fu) | ((x >> 7) & 0x7Fu) << 8 | ((x >> 14) & 0x7Fu) << 16 |
         ((x >> 21) & 0x7Fu) << 24;
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint4& a,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// Shared memory of fold_contract_kernel, in 32-bit words.
struct ContractSmem {
  int qs, as, gs, cs, os, total;
  __host__ __device__ ContractSmem(int n1, int t_gsw, int ksteps) {
    qs = 0;                                    // [2 s][n1 r][m2][ZT]
    as = qs + 2 * n1 * t_gsw * n1 * ZT;        // [WARPS][ksteps][32] uint4
    as = (as + 3) & ~3;
    gs = as + WARPS * ksteps * 32 * 4;         // [8*ksteps e][NT][GS_LD]
    cs = gs + 8 * ksteps * NT * GS_LD;         // [WARPS][16][NT]
    os = cs + WARPS * 16 * NT;                 // [n1 r][NT][ZT]
    total = os + n1 * NT * ZT;
  }
};

}  // namespace

__global__ void __launch_bounds__(WARPS * 32)
fold_contract_kernel(const uint32_t* __restrict__ G,
                     const uint32_t* __restrict__ q_neg,
                     const uint32_t* __restrict__ q_pos,
                     uint32_t* __restrict__ out, int m_out, int n1, int n2,
                     int t_gsw, int d, int ksteps) {
  extern __shared__ uint32_t sm[];
  const ContractSmem L(n1, t_gsw, ksteps);
  uint32_t* Qs = sm + L.qs;
  uint4* As = reinterpret_cast<uint4*>(sm + L.as);
  uint32_t* Gs = sm + L.gs;
  int* Cs = reinterpret_cast<int*>(sm + L.cs);
  uint32_t* Os = sm + L.os;

  const int z0 = blockIdx.x * ZT, li = blockIdx.y, col0 = blockIdx.z * CT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int P = n1 * n2, m2 = t_gsw * n1, E = 2 * t_gsw * n1;
  const int N = m_out * n2;
  const Mod md = mod_of(li);

  // the q words of the block's slots: row (s*n1 + r)*m2 + kk
  for (int w = threadIdx.x; w < 2 * n1 * m2 * ZT; w += blockDim.x) {
    const int zl = w % ZT, row = w / ZT;
    const int s = row / (n1 * m2), rk = row % (n1 * m2);
    Qs[w] = (s ? q_pos : q_neg)[((size_t)rk * 2 + li) * d + z0 + zl];
  }
  __syncthreads();

  // this warp's A fragments (slot z0 + warp), prescaled in place:
  // register h holds row g + 8*(h & 1), element 8*kq + tig + 4*(h >> 1),
  // byte j = limb_i((2^{7j} q) mod p) of row i*n1 + r
  {
    uint32_t pw[4];
    for (int j = 0; j < 4; ++j) pw[j] = md.reduce(1ull << (7 * j));
    for (int kq = 0; kq < ksteps; ++kq) {
      uint32_t reg[4];
      for (int h = 0; h < 4; ++h) {
        const int row = g + 8 * (h & 1);
        const int e = 8 * kq + tig + 4 * (h >> 1);
        uint32_t x = 0;
        if (row < 4 * n1 && e < E) {
          const int i = row / n1, r = row % n1;
          const int jn1 = e % n1, sk = e / n1;
          const int k = sk % t_gsw, s = sk / t_gsw;
          const uint32_t qv = Qs[((s * n1 + r) * m2 + k * n1 + jn1) * ZT +
                                 warp];
          for (int j = 0; j < 4; ++j) {
            const uint32_t wj = j ? md.mul(qv, pw[j]) : qv;
            x |= ((wj >> (7 * i)) & 0x7Fu) << (8 * j);
          }
        }
        reg[h] = x;
      }
      As[(warp * ksteps + kq) * 32 + lane] =
          make_uint4(reg[0], reg[1], reg[2], reg[3]);
    }
  }

  const int col_end = min(col0 + CT, N);
  for (int n0 = col0; n0 < col_end; n0 += NT) {
    __syncthreads();   // the previous tile's Gs and Os are read
    // G rows (element e, column n0 + nn), ZT slots each
    for (int w = threadIdx.x; w < 8 * ksteps * NT * ZT; w += blockDim.x) {
      const int zl = w % ZT, row = w / ZT;
      const int nn = row % NT, e = row / NT, n = n0 + nn;
      uint32_t v = 0;
      if (e < E && n < N) {
        const int jn1 = e % n1, sk = e / n1;
        const int mo = n / n2, c = n % n2;
        v = G[((((size_t)li * 2 * t_gsw + sk) * m_out + mo) * P + jn1 * n2 +
               c) * d + z0 + zl];
      }
      Gs[row * GS_LD + zl] = v;
    }
    __syncthreads();

    int acc[4] = {0, 0, 0, 0};
    for (int kq = 0; kq < ksteps; ++kq) {
      const int e0 = 8 * kq + tig;
      const uint32_t b0 = limbs7(Gs[(e0 * NT + g) * GS_LD + warp]);
      const uint32_t b1 = limbs7(Gs[((e0 + 4) * NT + g) * GS_LD + warp]);
      mma_s8(acc, As[(warp * ksteps + kq) * 32 + lane], b0, b1);
    }
    // D fragment: rows g and g + 8, columns 2*tig and 2*tig + 1
    int* C = Cs + warp * 16 * NT;
    C[g * NT + 2 * tig] = acc[0];
    C[g * NT + 2 * tig + 1] = acc[1];
    C[(g + 8) * NT + 2 * tig] = acc[2];
    C[(g + 8) * NT + 2 * tig + 1] = acc[3];
    __syncwarp();
    for (int l = lane; l < n1 * NT; l += 32) {
      const int r = l / NT, nn = l % NT;
      uint64_t v = 0;
      for (int i = 0; i < 4; ++i)
        v += (uint64_t)(uint32_t)C[(i * n1 + r) * NT + nn] << (7 * i);
      Os[l * ZT + warp] = md.reduce(v);
    }
    __syncthreads();
    // out (m_out, n1, n2, 2, d): ZT slots of each (r, column) row
    for (int w = threadIdx.x; w < n1 * NT * ZT; w += blockDim.x) {
      const int zl = w % ZT, row = w / ZT;
      const int r = row / NT, n = n0 + row % NT;
      if (n < N) {
        const int mo = n / n2, c = n % n2;
        out[((((size_t)mo * n1 + r) * n2 + c) * 2 + li) * d + z0 + zl] =
            Os[w];
      }
    }
  }
}

// K8b-1: cts (m_out, 2, n1, n2, 2, d) coeff -> G (2, 2, t_gsw, m_out, n1*n2,
// d) NTT.
extern "C" int spiral_fold_ntt(const void* cts, void* G, const void* tab,
                               int m_out, int n1, int n2, int t_gsw, int d,
                               void* stream) {
  if (d < 64 || d > 2048 || (d & (d - 1)) || t_gsw < 2 || t_gsw > 56 ||
      m_out < 1 || n1 < 1 || n2 < 1)
    return (int)cudaErrorInvalidValue;
  dim3 grid(m_out * 2 * n1 * n2, 2);
  fold_ntt_kernel<<<grid, d / 2, d * sizeof(uint32_t),
                    (cudaStream_t)stream>>>(
      (const uint32_t*)cts, (uint32_t*)G, (const uint32_t*)tab, m_out,
      n1 * n2, t_gsw, d, log2_exact(d));
  return (int)cudaGetLastError();
}

// Dynamic shared memory of K8b-2 in bytes (0 past the card's 227 KB).
extern "C" int spiral_fold_contract_smem(int n1, int t_gsw) {
  const int bytes = ContractSmem(n1, t_gsw, (2 * t_gsw * n1 + 7) / 8).total *
                    (int)sizeof(uint32_t);
  return bytes <= 232448 ? bytes : 0;
}

// K8b-2: G (2, 2, t_gsw, m_out, n1*n2, d), q_neg/q_pos (n1, t_gsw*n1, 2, d)
// NTT -> out (m_out, n1, n2, 2, d) NTT.
extern "C" int spiral_fold_contract(const void* G, const void* q_neg,
                                    const void* q_pos, void* out, int m_out,
                                    int n1, int n2, int t_gsw, int d,
                                    void* stream) {
  const int smem = spiral_fold_contract_smem(n1, t_gsw);
  if (d < ZT || d % ZT || n1 < 1 || 4 * n1 > 16 || n2 < 1 || m_out < 1 ||
      t_gsw < 2 || smem == 0)
    return (int)cudaErrorInvalidValue;
  // raised once to the largest size asked for, so that launches captured
  // in a CUDA graph after a first call make no attribute call
  static int smem_allowed = 0;
  if (smem > smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        fold_contract_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    smem_allowed = smem;
  }
  const int ksteps = (2 * t_gsw * n1 + 7) / 8;
  dim3 grid(d / ZT, 2, (m_out * n2 + CT - 1) / CT);
  fold_contract_kernel<<<grid, WARPS * 32, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)G, (const uint32_t*)q_neg, (const uint32_t*)q_pos,
      (uint32_t*)out, m_out, n1, n2, t_gsw, d, ksteps);
  return (int)cudaGetLastError();
}
