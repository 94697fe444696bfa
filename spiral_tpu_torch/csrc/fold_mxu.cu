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
// (_fold_bias_corr); these digits need neither.  It is K3's digit stage
// (fold.cu) without the contraction, on the register NTT of ntt_reg.cuh.
// The signed digits of a row form two carry chains, digits [0, h) and
// [h, t_gsw) with h = t_gsw / 2, each independent of the other.  A unit
// of work is one source row (ct, row, column, limb) or one of its chains.
// A team of d/8 threads lifts the unit's row, forms its digits two at a
// time (the carry runs in order across them), transforms them
// (reg::forward, reg::to_slots) and stores each digit poly's slots as one
// row of G, thread t slot t + e*d/8: coalesced.  A grid of one wave per limb
// (occupancy x SMs, half a limb, cut to the units) walks the units, each
// block loading its limb's twiddles once (ntt_reg.cuh batched_ntt's grid).
// A unit is a whole row when the rows outnumber the teams of a limb's
// share of the wave; else each chain is a unit of its own, which halves
// the NTTs one team runs in sequence in the small rounds.  Two blocks of
// 256 threads an SM at d = 2048 (128 registers; three spilled, and ran
// slower on the H100).  Built for d = 256 and 2048.
// Bound on the H100: G's bytes, written once (113 MB at spiral_20_256's
// round 1), against the digit NTTs' products (2*N1*n2*t_gsw per output ct
// and limb, as in K3).
//
// K8b-2, fold_contract_kernel, replaces the contraction that JAX runs in
// XLA, outside any pallas_call (fold_pallas.py _fold_contract_mxu, a
// dot_general, with the query prescaled by _fold_qpre).  Per CRT limb li
// and NTT slot z:
//   out[mo, r, c] = sum_{s,k,jn1} q_s[r, k*N1 + jn1] * G[s, k, mo, jn1, c]
// mod p_li, with q_0 = q_neg and q_1 = q_pos.  The prescaled form on 8-bit
// limbs (K2's, firstdim.cu): a G word x = sum_j 2^(8j) x_j is used as
// stored, its four bytes its limbs, and the query word q enters as the
// limbs of its prescaled residues Q_j = (2^(8j) q) mod p, so that
//   q x = sum_i 2^(8i) sum_j limb_i(Q_j) x_j  (mod p).
// One GEMM per slot on mma.sync.m16n8k32 u8 x u8 -> s32:
//   A: M = 4*N1 rows, (i, r) at row r + 4 (i & 1) + 8 (i >> 1) (N1 <= 4;
//      rows r >= N1 zero), K = 4 E bytes, element e = (s*t_gsw + k)*N1
//      + jn1 and its four j-limbs together, E = 2 t_gsw N1 padded to a
//      multiple of 8 with zeros;
//   B: the G words of E elements by N = m_out*n2 columns (mo*n2 + c), a
//      B fragment register one G word as stored: no limb split, no
//      conversion pass.
// Exactness: each int32 sum has at most 4 E terms (264 at t_gsw 11) of at
// most 255^2, below 2^24.1; sum_i 2^(8i) o_i is below 2^49, so one Barrett
// reduction per output word.  tests/test_torch_mxu.py holds these bounds
// with fold.fold_contract_limb_sums(..., bits=8) on worst words.
// Stream: a block owns a group of 32 slots of one limb (one 128-byte TMA
// row along d), a warp per slot, and sweeps its range of column tiles of
// 8 columns.  It builds each warp's A fragments once, the prescale
// included (no Qpre tensor in memory), and holds them in registers across
// the sweep, so each A fragment feeds every column tile of the block.  A
// column tile's G rows, E elements x 8 columns x 32 slots (55 KB at t_gsw
// 9), arrive by TMA (a 5-D box, 128-byte swizzle, zeros past m_out)
// through a ring of 2-4 stages on mbarriers, stages - 1 in flight while
// the tensor cores work on the oldest; one barrier a stage.  The epilogue
// adds a lane's two limb pairs with its neighbour's (lane ^ 16), reduces,
// and goes through shared memory so that each warp stores one 128-byte row
// of 32 slots.  The grid is one wave: the 2 d / 32 slot groups, each
// split into column ranges until the card's SMs are covered.
// Bound on the H100: G's bytes, read once (113 MB at spiral_20_256's round
// 1); the int8 multiply-adds are ~1.4 G.
#include <type_traits>

#include "hopper.cuh"
#include "ntt_reg.cuh"

using namespace spiral;

// ---- K8b-1 ----

template <int L>
__global__ void __launch_bounds__(reg::Batch<L>::THREADS, 2)
fold_ntt_kernel(const uint32_t* __restrict__ cts, uint32_t* __restrict__ G,
                const uint32_t* __restrict__ tab, int m_out, int P,
                int t_gsw, int chains) {
  using B = reg::Batch<L>;
  constexpr int D = B::D, T = B::T;
  extern __shared__ uint32_t smem[];   // per team: exchange buffers; twiddles
  uint2* tw = reinterpret_cast<uint2*>(smem + B::W * 2 * reg::NP_MAX * D);
  const int team = threadIdx.x / T, t = threadIdx.x % T, li = blockIdx.y;
  uint32_t* sm = smem + team * 2 * reg::NP_MAX * D;
  const Mod md = mod_of(li);
  reg::load_twiddles<L, B::THREADS>(tw, tab, reg::ROW_REG + 4 * li,
                                    threadIdx.x);
  uint32_t pos[4];
  reg::load_slot_positions<L>(pos, tab, t);
  const int bits = bits_per(t_gsw);
  const uint64_t mask = (1ull << bits) - 1;   // t_gsw >= 2: bits <= 29
  const uint32_t half_z = 1u << (bits - 1);
  const uint32_t z_mod = md.reduce(1ull << bits);
  const int h = t_gsw / 2;   // the two carry chains: [0, h) and [h, t_gsw)
  const size_t k_stride = (size_t)m_out * P * D;   // G's digit axis
  const int units = m_out * 2 * P * chains;
  int par = 0;
  __syncthreads();

  // unit u: the whole of source row src = u (chains 1), or its chain u & 1
  // (chains 2, src = u >> 1); src = (mo*2 + s)*P + p, p = jn1*n2 + c
  for (int u = blockIdx.x * B::W + team; u < units; u += gridDim.x * B::W) {
    const int src = chains == 2 ? u >> 1 : u;
    const int p = src % P, s = (src / P) & 1, mo = src / (2 * P);
    const int k_begin = chains == 2 && (u & 1) ? h : 0;
    const int k_end = chains == 2 && !(u & 1) ? h : t_gsw;
    const uint32_t* in = cts + (size_t)src * 2 * D;
    uint32_t* g = G + ((((size_t)(li * 2 + s) * t_gsw) * m_out + mo) * P +
                       p) * D + t;
    uint64_t v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = lift(in[e * T + t], in[D + e * T + t]);
    uint32_t carry = 0;      // bit e: the carry of coefficient e*d/8 + t

    auto step = [&](auto np, int k0) {
      constexpr int NP = decltype(np)::value;
      uint32_t x[NP][8];
#pragma unroll
      for (int qq = 0; qq < NP; ++qq) {
        const int k = k0 + qq, sh = k * bits;
        if (k == 0 || k == h) carry = 0;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const uint32_t piece =
              sh < 64 ? (uint32_t)((v[e] >> sh) & mask) : 0u;
          const uint32_t pc = piece + ((carry >> e) & 1);
          const bool sgn = pc > half_z && (k >= h || k < h - 1);
          carry = (carry & ~(1u << e)) | ((uint32_t)sgn << e);
          if (bits <= 27) {          // pc <= 2^bits < p: digit pc - 2^bits
            x[qq][e] = sgn ? pc + (md.p - (1u << bits)) : pc;   // <= p
          } else {
            const uint32_t r = md.reduce(pc);
            x[qq][e] = sgn ? md.sub(r, z_mod) : r;
          }
        }
      }
      reg::forward<L, NP>(x, sm, par, tw, md.p, t);
      reg::to_slots<L, NP>(x, sm, par, pos, t);
#pragma unroll
      for (int qq = 0; qq < NP; ++qq) {
        uint32_t* row = g + (size_t)(k0 + qq) * k_stride;
#pragma unroll
        for (int e = 0; e < 8; ++e) row[e * T] = reg::canon(x[qq][e], md.p);
      }
    };
    for (int k = k_begin; k < k_end; k += 2) {
      if (k + 1 < k_end)
        step(std::integral_constant<int, 2>{}, k);
      else
        step(std::integral_constant<int, 1>{}, k);
    }
  }
}

template <int L>
static int launch_fold_ntt(const void* cts, void* G, const void* tab,
                           int m_out, int P, int t_gsw, void* stream) {
  using B = reg::Batch<L>;
  auto kernel = fold_ntt_kernel<L>;
  static const int wave = [&] {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                  B::THREADS, B::SMEM);
    return sms * per_sm;
  }();
  // a row's two chains go to two teams when the rows are too few for the
  // teams of a limb's share of the wave
  const int rows = m_out * 2 * P, share = wave / 2 > 1 ? wave / 2 : 1;
  const int chains = rows < share * B::W ? 2 : 1;
  const int need = (rows * chains + B::W - 1) / B::W;
  kernel<<<dim3(need < share ? need : share, 2), B::THREADS, B::SMEM,
           (cudaStream_t)stream>>>((const uint32_t*)cts, (uint32_t*)G,
                                   (const uint32_t*)tab, m_out, P, t_gsw,
                                   chains);
  return (int)cudaGetLastError();
}

// K8b-1: cts (m_out, 2, n1, n2, 2, d) coeff -> G (2, 2, t_gsw, m_out, n1*n2,
// d) NTT.
extern "C" int spiral_fold_ntt(const void* cts, void* G, const void* tab,
                               int m_out, int n1, int n2, int t_gsw, int d,
                               void* stream) {
  if (t_gsw < 2 || t_gsw > 56 || m_out < 1 || n1 < 1 || n2 < 1)
    return (int)cudaErrorInvalidValue;
  switch (d) {
    case 256:
      return launch_fold_ntt<8>(cts, G, tab, m_out, n1 * n2, t_gsw, stream);
    case 2048:
      return launch_fold_ntt<11>(cts, G, tab, m_out, n1 * n2, t_gsw, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---- K8b-2 ----

namespace {

constexpr int ZG = 32;           // slots of a block: one 128-byte TMA row
constexpr int WARPS = ZG;        // a warp per slot
constexpr int NT = 8;            // columns of a stage: the mma's n
constexpr int MAX_STAGES = 4;
constexpr int OS_LD = ZG + 1;    // padded epilogue rows: conflict-free
constexpr int QP_LD = ZG + 1;    // padded rows of prescaled query words
// dynamic shared memory a block may take (of 227 KB, less the mbarriers)
constexpr int SMEM_MAX = 226 * 1024;
// the k steps (8 elements of 32 bytes) whose A fragments a warp holds: an
// instance for t_gsw <= 9 and one for t_gsw <= 12 at N1 = 3
constexpr int KS_SMALL = 7, KS_LARGE = 9;

// The block's shared memory, in bytes: a ring of `stages` column tiles (E
// rows of 8 columns x 128 B, a multiple of 1 KB), then two epilogue
// buffers (N1 x 8 rows of OS_LD words), then each k step's two B row
// offsets per lane, with 1 KB of slack for the alignment.  The prescaled
// query words (2 N1 m2 rows of QP_LD uint4) fill stages 1 .. stages - 1
// before their first loads.  server/fold.py contract_geometry is its twin
// (the fold's engine rule reads it); tests/test_torch_kernels.py holds
// the two equal.
struct Geometry {
  int E, ksteps, stage_bytes, os_bytes, qp_bytes, fixed, stages, total;
  __host__ __device__ Geometry(int n1, int t_gsw) {
    E = 2 * t_gsw * n1;
    ksteps = (E + 7) / 8;
    stage_bytes = E * NT * ZG * 4;
    os_bytes = 2 * n1 * NT * OS_LD * 4;
    qp_bytes = E * n1 * QP_LD * 16;
    fixed = os_bytes + ksteps * 2 * 32 * 4 + 1024;
    stages = (SMEM_MAX - fixed) / stage_bytes;
    stages = stages < MAX_STAGES ? stages : MAX_STAGES;
    total = stages * stage_bytes + fixed;
  }
};

}  // namespace

template <int KS>
__global__ void __launch_bounds__(WARPS * 32, 1)
fold_contract_kernel(const __grid_constant__ CUtensorMap g_map,
                     const uint32_t* __restrict__ q_neg,
                     const uint32_t* __restrict__ q_pos,
                     uint32_t* __restrict__ out, int m_out, int n1, int n2,
                     int t_gsw, int d, int chunks) {
  extern __shared__ uint32_t smem_raw[];
  __shared__ uint64_t full[MAX_STAGES];
  // stages start on 1 KB boundaries (the swizzle's period)
  uint32_t* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023) / 4;
  const Geometry geo(n1, t_gsw);
  const int E = geo.E, ksteps = geo.ksteps, stages = geo.stages;
  const int stage_words = geo.stage_bytes / 4;
  uint32_t* Os = sm + stages * stage_words;
  int* Rof = reinterpret_cast<int*>(Os + geo.os_bytes / 4);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int N = m_out * n2, ntiles = (N + NT - 1) / NT;
  const int group = blockIdx.x / chunks, chunk = blockIdx.x % chunks;
  const int li = group / (d / ZG), z0 = (group % (d / ZG)) * ZG;
  const int nt0 = (int)((long)chunk * ntiles / chunks);
  const int mine = (int)((long)(chunk + 1) * ntiles / chunks) - nt0;
  const int mo_tile = NT / n2, m2 = t_gsw * n1;
  const Mod md = mod_of(li);

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&full[s]);
    mbar_fence_init();
  }
  __syncthreads();
  // local column tile i into stage i % stages: all E elements (2 t_gsw
  // rows k' = s t_gsw + k of n1 x n2 G rows) of mo_tile cts, 32 slots
  auto load_tile = [&](int i) {
    if (i < mine) {
      const int st = i % stages;
      mbar_expect_tx(&full[st], geo.stage_bytes);
      tma_load_5d(sm + st * stage_words, &g_map, &full[st], z0, 0, 0,
                  (nt0 + i) * mo_tile, li * 2 * t_gsw);
    }
  };
  if (tid == 0) load_tile(0);

  // the prescale, once per q word of the block's slots: row (s*n1 + r)*m2
  // + kk, slot zl -> its limb planes (W0, W2, W1, W3) (hopper.cuh
  // prescaled_planes), in stages 1 .., whose first loads wait for them to
  // be read
  uint4* QP = reinterpret_cast<uint4*>(sm + stage_words);
  for (int w = tid; w < 2 * n1 * m2 * ZG; w += blockDim.x) {
    const int zl = w % ZG, row = w / ZG;
    const int s = row >= n1 * m2, rk = row - s * n1 * m2;
    const uint4 pl = prescaled_planes(
        (s ? q_pos : q_neg)[((size_t)rk * 2 + li) * d + z0 + zl], li);
    QP[row * QP_LD + zl] = make_uint4(pl.x, pl.z, pl.y, pl.w);
  }
  // B rows: the stage row of element e and column col of a tile is
  // R = ((k' * mo_tile + mo) * n1 + jn1) * n2 + c (e = k' n1 + jn1, col =
  // mo n2 + c), and its slot zl lies at word R*32 + (zl ^ 4 (R & 7)) under
  // the swizzle: Rof holds R*32 + 4 (R & 7), the word is Rof ^ zl.
  // Lane (g, tig) of k step kq reads elements 8 kq + tig (h 0) and
  // 8 kq + tig + 4 (h 1) of column g; an element past E reads a real row
  // (A is zero there).
  for (int w = tid; w < ksteps * 64; w += blockDim.x) {
    const int ln = w & 31, hh = (w >> 5) & 1, kq = w >> 6;
    const int e = min(8 * kq + (ln & 3) + 4 * hh, E - 1);
    const int col = ln >> 2, kp = e / n1, jn1 = e % n1;
    const int R = ((kp * mo_tile + col / n2) * n1 + jn1) * n2 + col % n2;
    Rof[w] = R * ZG + ((R & 7) << 2);
  }
  __syncthreads();

  // this warp's A fragments (slot z0 + warp): register h holds row g +
  // 8 (h & 1), that is (i, r) = (ilo + 2 (h & 1), g & 3) with ilo = g >> 2,
  // and element e = 8 kq + tig + 4 (h >> 1) = s m2 + kk, whose q word is
  // row r m2 + e + s (n1 - 1) m2: planes W_ilo and W_ilo+2, one 8-byte read
  const int zl = warp;
  const int r = g & 3, ilo = g >> 2;
  uint32_t a[KS][4];
#pragma unroll
  for (int kq = 0; kq < KS; ++kq)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int e = 8 * kq + tig + 4 * hh;
      uint2 w = make_uint2(0, 0);
      if (r < n1 && e < E) {
        const int row = r * m2 + e + (e >= m2) * (n1 - 1) * m2;
        w = reinterpret_cast<const uint2*>(QP + row * QP_LD + zl)[ilo];
      }
      a[kq][2 * hh] = w.x;
      a[kq][2 * hh + 1] = w.y;
    }
  fence_proxy_async();   // QP's writes before the stages' loads
  __syncthreads();
  if (tid == 0)
    for (int i = 1; i < stages; ++i) load_tile(i);

#pragma unroll 1
  for (int f = 0; f < mine; ++f) {
    const int st = f % stages;
    mbar_wait(&full[st], (f / stages) & 1);
    const uint32_t* sg = sm + st * stage_words;
    int acc[4] = {0, 0, 0, 0};
#pragma unroll
    for (int kq = 0; kq < KS; ++kq) {
      if (kq < ksteps) {
        const uint32_t b0 = sg[Rof[kq * 64 + lane] ^ zl];
        const uint32_t b1 = sg[Rof[kq * 64 + 32 + lane] ^ zl];
        mma_u8(acc, a[kq][0], a[kq][1], a[kq][2], a[kq][3], b0, b1);
      }
    }
    // D: rows g (limb i = ilo) and g + 8 (limb ilo + 2) of columns 2 tig
    // and 2 tig + 1; lane ^ 16 holds the other two limbs of row r
    uint32_t* os = Os + (f & 1) * n1 * NT * OS_LD;
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      uint64_t v = ((uint64_t)(uint32_t)acc[cc] << (8 * ilo)) +
                   ((uint64_t)(uint32_t)acc[2 + cc] << (8 * (ilo + 2)));
      v += __shfl_xor_sync(0xFFFFFFFFu, v, 16);    // below 2^49
      if (ilo == 0 && r < n1)
        os[(r * NT + 2 * tig + cc) * OS_LD + zl] = md.reduce(v);
    }
    __syncthreads();   // stage st is read by every warp; os is written
    if (tid == 0) load_tile(f + stages);
    // out (m_out, n1, n2, 2, d): a warp stores one (r, column) row of
    // the 32 slots
    for (int w = tid; w < n1 * NT * ZG; w += blockDim.x) {
      const int row = w / ZG, zz = w % ZG;
      const int n = (nt0 + f) * NT + row % NT;
      if (n < N) {
        const int mo = n / n2, c = n % n2;
        out[((((size_t)mo * n1 + row / NT) * n2 + c) * 2 + li) * d + z0 +
            zz] = os[row * OS_LD + zz];
      }
    }
  }
}

// Dynamic shared memory of K8b-2 in bytes; 0 for a shape it does not take
// (more k steps than its instances hold, or no room for a ring of 2 and
// the prescaled query).
extern "C" int spiral_fold_contract_smem(int n1, int t_gsw) {
  if (n1 < 1 || n1 > 4 || t_gsw < 2) return 0;
  const Geometry geo(n1, t_gsw);
  return geo.ksteps <= KS_LARGE && geo.stages >= 2 &&
                 geo.qp_bytes <= (geo.stages - 1) * geo.stage_bytes
             ? geo.total
             : 0;
}

template <int KS>
static int launch_contract(const void* G, const void* q_neg,
                           const void* q_pos, void* out, int m_out, int n1,
                           int n2, int t_gsw, int d, void* stream) {
  auto kernel = fold_contract_kernel<KS>;
  // raised once, so that launches captured in a CUDA graph after a first
  // call make no attribute call
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (attr != cudaSuccess) return (int)attr;
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  // G as (d, n2, n1, m_out, 4 t_gsw): dimension 4 is (li, s, k)
  const size_t row = (size_t)d * 4;
  const cuuint64_t dims[5] = {(cuuint64_t)d, (cuuint64_t)n2, (cuuint64_t)n1,
                              (cuuint64_t)m_out, (cuuint64_t)(4 * t_gsw)};
  const cuuint64_t strides[4] = {row, row * n2, row * n2 * n1,
                                 row * n2 * n1 * m_out};
  const cuuint32_t box[5] = {ZG, (cuuint32_t)n2, (cuuint32_t)n1,
                             (cuuint32_t)(NT / n2), (cuuint32_t)(2 * t_gsw)};
  CUtensorMap map = {};
  if (!make_u32_map(&map, G, 5, dims, strides, box))
    return (int)cudaErrorInvalidValue;
  const int groups = 2 * d / ZG;
  const int ntiles = (m_out * n2 + NT - 1) / NT;
  int chunks = sms / groups;
  chunks = chunks < 1 ? 1 : chunks > ntiles ? ntiles : chunks;
  const Geometry geo(n1, t_gsw);
  kernel<<<groups * chunks, WARPS * 32, geo.total, (cudaStream_t)stream>>>(
      map, (const uint32_t*)q_neg, (const uint32_t*)q_pos, (uint32_t*)out,
      m_out, n1, n2, t_gsw, d, chunks);
  return (int)cudaGetLastError();
}

// K8b-2: G (2, 2, t_gsw, m_out, n1*n2, d), q_neg/q_pos (n1, t_gsw*n1, 2, d)
// NTT -> out (m_out, n1, n2, 2, d) NTT.
extern "C" int spiral_fold_contract(const void* G, const void* q_neg,
                                    const void* q_pos, void* out, int m_out,
                                    int n1, int n2, int t_gsw, int d,
                                    void* stream) {
  if (d < ZG || d % ZG || (n2 != 1 && n2 != 2 && n2 != 4 && n2 != 8) ||
      m_out < 1 || !spiral_fold_contract_smem(n1, t_gsw) ||
      (uintptr_t)G % 16)
    return (int)cudaErrorInvalidValue;
  return Geometry(n1, t_gsw).ksteps <= KS_SMALL
             ? launch_contract<KS_SMALL>(G, q_neg, q_pos, out, m_out, n1, n2,
                                         t_gsw, d, stream)
             : launch_contract<KS_LARGE>(G, q_neg, q_pos, out, m_out, n1, n2,
                                         t_gsw, d, stream);
}
