// K2: the first-dimension multiply, the stage that streams the database,
// for B queries of n1 rows at once and, for the implicit huge-database
// mode, over several chunks of one slab.
//
// For each CRT limb li, NTT slot z and chunk i:
//   out[li, z, b*n1 + r, i*m + col] =
//       sum_k Q[li, (z - i) mod d, k, b*n1 + r] * DB[li, z, k, col] mod p
// with K = dim0*n0 (512 at spiral_20_256), m = num_per*n2 database columns
// (256) and G = B*n1 query rows.  One chunk (i = 0) is the ordinary
// multiply; chunk i of the implicit mode multiplies the same slab by the
// query rolled i slots, as the JAX package's
// multiply_query_by_db_implicit(_batch) does with jnp.roll, without making
// a rolled copy: the block reads its query slot directly.
//
// Replaces the Pallas kernel spiral_tpu/server/firstdim.py
// multiply_query_by_db_fused (_fdim_fused_kernel), which splits residues
// into 7-bit int8 limbs for the TPU's matrix unit and recombines them, and
// the XLA int8-limb matmuls of multiply_query_by_db_mxu_batch and the
// implicit loops.  The same idea, on the H100's int8 tensor cores
// (mma.sync.m16n8k32 u8 x u8 -> s32), in two forms chosen by the pass's
// query rows gn, both exact for any 32-bit words:
//
// The pair form (gn > PRESCALED_ROWS = 8), the JAX kernel's: both words
// split into four 8-bit limbs, x = sum_j x_j 2^(8j), q = sum_i q_i 2^(8i);
// per (limb, slot) the 16 limb-pair products are int8 GEMMs (M = database
// columns, 16 a tile; N = query rows, 8 a tile; depth = k, 32 a step)
// summed into one int32 tile per weight s = i + j:
//   sum_k q_k x_k = sum_{s=0..6} 2^(8s) S_s,  S_s = sum_{i+j=s} sum_k q_ki x_kj,
// recombined once per output as sum_s S_s (2^(8s) mod p), seven Shoup
// products (each below 2p, sum below 14p) and one Barrett reduction.  The
// A register of limb plane j holds byte j of four database words of one
// column: a 4 x 4 byte transpose (eight byte permutes per four words) of
// words loaded from the stage, two columns at a time; the query's B
// registers likewise.
//
// The prescaled form (gn <= 8, one query and small batches): a query word
// q splits into the limbs of its prescaled residues Q_j = 2^(8j) q mod p
// (K8b-2's prescale, csrc/fold_mxu.cu), so that
//   sum_k q_k x_k = sum_i 2^(8i) o_i (mod p),  o_i = sum_k sum_j limb_i(Q_kj) x_kj:
// the depth is (k, j), so a database word is one A register as it is (no
// transpose), and N = (query row, i), four columns a row.  Each stage's
// query slice is prescaled once by the block into the B layout (column
// 4 r + i), one stage ahead of the tensor cores, into one of two buffers;
// the epilogue adds four Shoup products, two per lane and the pair summed
// with the neighbouring lane's.  The form trades the pair form's byte
// transposes, which left one query issue-bound on the H100, for four
// times the B operand's shared-memory reads, which cost more than the
// transposes once the batch has more than a few queries (PERF.md).
//
// Every int32 sum has at most 4 K 255^2 terms: below 2^31 for K <= K_MAX
// = 8,256 (the wrapper raises above it).
//
// Stream.  A tile is one (chunk, limb, slot) and MB database columns, with
// all of a pass's query rows.  The grid is one wave of persistent blocks
// (occupancy x SMs), block x taking tiles x, x + grid, ...  The database
// rows of its tiles (ks k x MB columns a stage, 16 KB) and the query
// slices (ks k x the pass's rows) stream through a ring of S
// shared-memory stages, S - 1 in flight while the tensor cores work on the
// oldest, across tile boundaries, so a tile's epilogue and the next tile's
// first loads overlap; one barrier a stage.  S (3-8) is as large as the
// blocks an SM holds leave room for.  The database comes by TMA
// (cp.async.bulk.tensor, one thread issuing a stage's boxes of 32 columns,
// completion on the stage's mbarrier, zero fill past K and m, 128-byte
// swizzle); the query, when the pass is the whole batch, as one run of
// contiguous rows by the bulk copy engine on the same mbarrier, else by
// 4-byte cp.async (which slowed batches of 2-3 queries on the H100); a
// database whose m is no multiple of 4 (no preset's) streams by 4-byte
// cp.async into the same layout.
//
// Fragments.  Which k row feeds which byte of the MMA's depth is free as
// long as A and B agree; the orders below make every shared-memory load
// of a warp free of bank conflicts under the swizzle.  Pair form: a warp
// owns 16 columns and NW query tiles; byte c of lane group tig reads row
// 2 tig + 8 (c >> 1) + (c & 1) of each 16.  Prescaled form: a warp owns 32
// columns (two M tiles, their rows interleaved columns) and two N tiles;
// for each 8-row depth step lane (g, tig) loads rows 2 tig and 2 tig + 1
// of columns 4g .. 4g + 3, one 16-byte load each.
//
// Chunks.  The chunk is the slowest axis of the tile order and no tile
// serves two chunks, so each chunk streams the whole slab from device
// memory (2 GiB against a 50 MB L2), as a database of num_chunks slabs
// would.
//
// Passes.  A pass takes at most 16 queries and 64 query rows; a larger
// batch runs in several passes, each reading the database again.
//
// Bound on the H100: the database is read once per pass and chunk (2 GiB
// at spiral_20_256, ~0.64 ms at 3.35 TB/s); each modular product costs 16
// int8 multiply-adds, 206 G at B = 8 (0.21 ms at the dense int8 peak,
// about 0.5 ms at the ~440 T/s that mma.sync reaches on this card), so a
// batch of 8 would be bound by the bytes; the kernel is held back by issue
// and latency (PERF.md).
#include "hopper.cuh"

using namespace spiral;

namespace {

constexpr int MAX_STAGES = 8;
// warps a block: 8, so that two or more blocks share an SM and cover
// each other's barriers, or 12 for a pass of more than 3 pair-form N tiles
// (on the H100 8 warps ran batches of 4-8 queries fastest, 12 one of 16)
constexpr int MAX_WARPS = 12;
constexpr int MAX_ROWS = 64;      // query rows per pass
// a pass of at most this many query rows runs the prescaled form, a
// larger one the pair form (see the header)
constexpr int PRESCALED_ROWS = 8;
constexpr int PASS_QUERIES = 16;
constexpr int K_MAX = 8256;       // 4 K 255^2 < 2^31
// shared memory an SM's blocks share (of 227 KB, less the mbarriers)
constexpr int SMEM_SM = 220 * 1024;
constexpr int STAGE_DB_WORDS = 4096;   // a stage's database rows: 16 KB
constexpr int BOX = 32;           // database columns of a TMA box: 128 B

__device__ __forceinline__ void cp_async4(uint32_t* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// all but the n newest groups of this thread's copies have landed
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    default: cp_async_wait<6>(); break;
  }
}

// Word (r, w) of a stage's database rows (row r, tile column w): boxes of
// 32 columns one after another, ks rows of 128 B each, the 16-byte chunk
// index XORed with r mod 8 (TMA's 128-byte swizzle).
__device__ __forceinline__ int db_word(int ks, int r, int w) {
  return (w >> 5) * ks * BOX + r * BOX + ((((w >> 2) & 7) ^ (r & 7)) << 2) +
         (w & 3);
}

// The pair form's depth order: byte c of lane group tig reads row
// 2 tig + 8 (c >> 1) + (c & 1) of each 16 (k half hk), so that under the
// swizzle a half-warp's 8-byte loads fall in 16 distinct bank pairs.
__device__ __forceinline__ int k_row(int hk, int tig, int c) {
  return 16 * hk + 2 * tig + 8 * (c >> 1) + (c & 1);
}

// The block's shape for one pass of gn query rows over m columns.  pairs:
// the pair form (a warp: 16 columns, NW tiles of 8 query rows), else the
// prescaled form (a warp: 32 columns, 2 tiles of 8 columns = 2 query rows
// x 4 limbs).  The query slice comes by cp.async into rows of gq words,
// padded in the pair form against bank conflicts, or (bulk) as one
// contiguous run of rows of gq = G words by the bulk copy engine.  The
// ring's stage count is the launch's.
struct Geometry {
  int nt, nw, ng, lmt, mt, mb, mbl, gq, nl, ks, stage_words, threads;
  bool pairs;
  __host__ __device__ Geometry(int gn, int m, bool bulk) {
    pairs = gn > PRESCALED_ROWS;
    const int wcols = pairs ? 16 : 32;   // database columns a warp
    nt = pairs ? (gn + 7) / 8 : (gn + 1) / 2;   // N tiles of 8 columns
    nw = pairs ? (nt >= 4 ? 2 : 1) : 2;  // N tiles a warp
    ng = (nt + nw - 1) / nw;             // warps along N
    lmt = 3;                             // warps along M: 2^lmt
    const int warps = pairs && nt > 3 ? MAX_WARPS : 8;
    while (lmt > 0 && (ng << lmt) > warps) --lmt;
    while (lmt > 0 && (wcols << (lmt - 1)) >= m) --lmt;
    mt = 1 << lmt;
    mb = wcols * mt;
    mbl = (mb + BOX - 1) / BOX * BOX;    // whole boxes
    gq = pairs && !bulk ? 8 * nt + (nt & 1 ? 12 : 4) : gn;
    nl = pairs ? 0 : 8 * nt + 4;         // prescaled rows 2 apart: banks 8
    ks = 32;                             // k rows a stage: 16 KB of database
    while (ks * 2 * mbl <= STAGE_DB_WORDS) ks *= 2;
    size();
    while (ks > 32 && smem(3) > SMEM_SM) {   // a ring of 3 always fits
      ks /= 2;
      size();
    }
    threads = 32 * mt * ng;
  }
  __host__ __device__ void size() {
    // 1 KB aligned, and 8 words of room: the pair form reads its last
    // query tile's 8 columns past dense (bulk) rows of fewer
    stage_words = (ks * (mbl + gq) + 8 + 255) / 256 * 256;
  }
  // bytes of shared memory for a ring of `stages` and (prescaled form) two
  // prescaled query slices, with 1 KB of slack for the alignment
  __host__ __device__ int smem(int stages) const {
    return (stages * stage_words + 2 * ks * nl + 256) * (int)sizeof(uint32_t);
  }
};

}  // namespace

// PAIRS: the pair form, NW N tiles a warp (1 or 2), else the prescaled
// form (NW = 2); TMA: the database streams by TMA (m % 4 == 0), else by
// 4-byte cp.async
template <int NW, bool TMA, bool PAIRS>
__global__ void __launch_bounds__(MAX_WARPS * 32, 1)
firstdim_kernel(const __grid_constant__ CUtensorMap db_map,
                const uint32_t* __restrict__ db,
                const uint32_t* __restrict__ q, uint32_t* __restrict__ out,
                int d, int K, int m, int G, int g0, int gn, int m_out,
                int num_chunks, int bulk, int stages) {
  extern __shared__ uint32_t smem_raw[];
  __shared__ uint64_t full[MAX_STAGES];
  // stages start on 1 KB boundaries (the swizzle's period)
  uint32_t* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023) / 4;
  const Geometry geo(gn, m, bulk);
  const int ncb = (m + geo.mb - 1) / geo.mb;        // column blocks
  const int ntiles = num_chunks * 2 * d * ncb;
  const int mine = blockIdx.x < ntiles
                       ? (ntiles - blockIdx.x + gridDim.x - 1) / gridDim.x
                       : 0;
  const int nk = (K + geo.ks - 1) / geo.ks;
  const int ks = geo.ks, gq = geo.gq, nl = geo.nl, nbox = geo.mbl / BOX;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int nwarps = nthreads >> 5;
  const int stage_words = geo.stage_words;
  // the prescaled form's query slices of two stages: the next one's is
  // made while the tensor cores work on this one's
  uint32_t* pbs = sm + stages * stage_words;
  const uint32_t tx_bytes = nbox * ks * BOX * (uint32_t)sizeof(uint32_t);

  if (TMA && tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&full[s]);
    mbar_fence_init();
  }
  if constexpr (PAIRS) {
    // query columns gn .. gq stay zero (no copy writes them)
    if (!bulk)
      for (int i = tid; i < stages * ks * (gq - gn); i += nthreads) {
        const int row = i / (gq - gn), c = gn + i % (gq - gn);
        sm[(row / ks) * stage_words + ks * geo.mbl + (row % ks) * gq + c] = 0;
      }
  } else {
    // prescaled columns 4 gn .. nl stay zero (the prescale writes below)
    for (int i = tid; i < 2 * ks * (nl - 4 * gn); i += nthreads) {
      const int r = i / (nl - 4 * gn);
      pbs[r * nl + 4 * gn + i - r * (nl - 4 * gn)] = 0;
    }
  }
  __syncthreads();

  // tile -> (chunk, limb, slot, column block); the chunk slowest
  struct Tile {
    int li, z, zq, chunk, col0;
  };
  auto tile_of = [&](int local) {
    const int tl = blockIdx.x + local * gridDim.x;
    const int cb = tl % ncb, y = (tl / ncb) % (2 * d);
    Tile t;
    t.chunk = tl / (ncb * 2 * d);
    t.li = y / d;
    t.z = y - t.li * d;
    t.zq = (t.z - t.chunk % d + d) % d;   // chunk i reads query slot z - i
    t.col0 = cb * geo.mb;
    return t;
  };

  // the load cursor: (local tile, k step) of the next stage to fill
  int ld_tile = 0, ld_k = 0;
  Tile lt = tile_of(0);
  auto issue = [&](int st) {
    if (ld_tile < mine) {
      uint32_t* sdb = sm + st * stage_words;
      uint32_t* sq = sdb + ks * geo.mbl;
      const int k0 = ld_k * ks;
      if constexpr (TMA) {
        if (tid == 0) {
          // the query rows k0 .. k0 + rows of slot zq, all G columns
          const int rows = min(ks, K - k0);
          const uint32_t qbytes = bulk ? rows * G * 4 : 0;
          mbar_expect_tx(&full[st], tx_bytes + qbytes);
          for (int b = 0; b < nbox; ++b)
            tma_load(sdb + b * ks * BOX, &db_map, &full[st],
                     lt.col0 + b * BOX, k0, lt.li * d + lt.z);
          if (bulk)
            bulk_load(sq, q + (((size_t)lt.li * d + lt.zq) * K + k0) * G,
                      qbytes, &full[st]);
        }
      } else {
        const uint32_t* dbz = db + ((size_t)lt.li * d + lt.z) * K * m;
        for (int i = tid; i < ks * geo.mbl; i += nthreads) {
          const int r = i / geo.mbl, w = i - r * geo.mbl;
          const int k = k0 + r, col = lt.col0 + w;
          const bool ok = k < K && col < m && w < geo.mb;
          cp_async4(sdb + db_word(ks, r, w),
                    ok ? dbz + (size_t)k * m + col : dbz, ok);
        }
      }
      if (!bulk) {
        const uint32_t* qz = q + ((size_t)lt.li * d + lt.zq) * K * G + g0;
        // warp w takes rows w, w + nwarps, ..., a lane a column
        for (int r = tid >> 5; r < ks; r += nwarps) {
          const int k = k0 + r;
          for (int c = tid & 31; c < gn; c += 32)
            cp_async4(sq + r * gq + c, k < K ? qz + (size_t)k * G + c : qz,
                      k < K);
        }
      }
      if (++ld_k == nk) {
        ld_k = 0;
        if (++ld_tile < mine) lt = tile_of(ld_tile);
      }
    }
    cp_async_commit();
  };

  // the prescale of a stage's query slice (slot st, limb li) into pb:
  // query word q of row r, column c -> pb[r][4c + i] = limb plane i of
  // (Q_0, Q_1, Q_2, Q_3), Q_j = 2^(8j) q mod p
  auto prescale = [&](int st, int li, uint32_t* pb) {
    const uint32_t* sq = sm + st * stage_words + ks * geo.mbl;
    for (int i = tid; i < ks * gn; i += nthreads) {
      const int r = i / gn, c = i - r * gn;
      *reinterpret_cast<uint4*>(pb + r * nl + 4 * c) =
          prescaled_planes(sq[r * gq + c], li);
    }
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = warp & (geo.mt - 1), wn = warp >> geo.lmt;
  // pair form: M row g of the warp's tile is column wm*16 + 2g, row g + 8
  // column wm*16 + 2g + 1.  Prescaled form: M row g of tile t is column
  // wm*32 + 4g + 2t, row g + 8 column wm*32 + 4g + 2t + 1; the lane's word
  // offsets: db_word(ks, r0 + 2 tig + h, ccol) for a step r0 (a multiple of
  // 8) is a_off[h] + 32 r0, its B words b_off + r0 nl + 8 nt (+ nl)
  const int ccol = PAIRS ? wm * 16 + 2 * g : wm * 32 + 4 * g;
  int a_off[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    a_off[h] = (ccol >> 5) * ks * BOX + (2 * tig + h) * BOX +
               ((((ccol >> 2) & 7) ^ (2 * tig + h)) << 2);
  const int b_off = 2 * tig * nl + g;
  // pair form: acc[u][s] the weight-s sums of N tile u; prescaled form:
  // acc[t][u] the limb sums of M tile t, N tile u
  constexpr int A0 = PAIRS ? NW : 2, A1 = PAIRS ? 7 : NW;
  int acc[A0][A1][4] = {};

  // stage f + 1's slot and mbarrier phase, and its tile's limb: the
  // prescale runs one stage ahead of the tensor cores
  int pst = 1 % stages, pk = 1 % nk, ptile = nk == 1 ? 1 : 0;
  uint32_t pphase = 0;
  int pli = ptile < mine ? tile_of(ptile).li : 0;

  for (int s = 0; s < stages - 1; ++s) issue(s);
  int st = 0, ck = 0, ct = 0;
  Tile cur = tile_of(0);
  const int total = mine * nk;
  if (total > 0) {
    cp_async_wait_n(stages - 2);
    if constexpr (TMA) mbar_wait(&full[0], 0);
    __syncthreads();
    if constexpr (!PAIRS) prescale(0, cur.li, pbs);
  }
#pragma unroll 1
  for (int f = 0; f < total; ++f) {
    const bool next = f + 1 < total;
    if (next) {
      cp_async_wait_n(stages - 3);
      if constexpr (TMA) mbar_wait(&full[pst], pphase);
    }
    __syncthreads();    // stage f + 1 landed; stage f's prescale is done;
                        // the reads of stage f - 1 are done
    issue(st == 0 ? stages - 1 : st - 1);
    if constexpr (!PAIRS)
      if (next) prescale(pst, pli, pbs + ((f + 1) & 1) * ks * nl);
    if (++pst == stages) {
      pst = 0;
      pphase ^= 1;
    }
    if (++pk == nk) {
      pk = 0;
      if (++ptile < mine) pli = tile_of(ptile).li;
    }

    const uint32_t* sdb = sm + st * stage_words;
    if constexpr (PAIRS) {
      const uint32_t* sq = sdb + ks * geo.mbl;
#pragma unroll 1
      for (int r0 = 0; r0 < ks; r0 += 32) {
        // A: a[j][h] is limb plane j of register h (rows g, g + 8; depth
        // 0-15, 16-31 of the step)
        uint32_t a[4][4];
#pragma unroll
        for (int hk = 0; hk < 2; ++hk) {
          uint2 w[4];
#pragma unroll
          for (int c = 0; c < 4; ++c)
            w[c] = *reinterpret_cast<const uint2*>(
                sdb + db_word(ks, r0 + k_row(hk, tig, c), ccol));
          const uint4 lo = bytes_t(w[0].x, w[1].x, w[2].x, w[3].x);
          const uint4 hi = bytes_t(w[0].y, w[1].y, w[2].y, w[3].y);
          a[0][2 * hk] = lo.x, a[1][2 * hk] = lo.y;
          a[2][2 * hk] = lo.z, a[3][2 * hk] = lo.w;
          a[0][2 * hk + 1] = hi.x, a[1][2 * hk + 1] = hi.y;
          a[2][2 * hk + 1] = hi.z, a[3][2 * hk + 1] = hi.w;
        }
#pragma unroll
        for (int u = 0; u < NW; ++u) {
          const int nt = wn * NW + u;
          if (nt >= geo.nt) break;
          // B: b[hk] plane i is limb i of query row nt*8 + g, depth 0-15
          // / 16-31
          uint4 b[2];
#pragma unroll
          for (int hk = 0; hk < 2; ++hk) {
            uint32_t w[4];
#pragma unroll
            for (int c = 0; c < 4; ++c)
              w[c] = sq[(r0 + k_row(hk, tig, c)) * gq + nt * 8 + g];
            b[hk] = bytes_t(w[0], w[1], w[2], w[3]);
          }
          const uint32_t b0[4] = {b[0].x, b[0].y, b[0].z, b[0].w};
          const uint32_t b1[4] = {b[1].x, b[1].y, b[1].z, b[1].w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              mma_u8(acc[u][i + j], a[j][0], a[j][1], a[j][2], a[j][3],
                     b0[i], b1[i]);
        }
      }
    } else {
      const uint32_t* pb = pbs + (f & 1) * ks * nl;
      // KU depth steps of 8 rows at a time: every load of the group
      // first, then its MMAs (an N tile past the pass's is loaded clamped
      // and not multiplied)
      constexpr int KU = 4;
#pragma unroll 1
      for (int r0 = 0; r0 < ks; r0 += 8 * KU) {
        uint4 x[KU][2];
        uint32_t b[KU][NW][2];
#pragma unroll
        for (int v = 0; v < KU; ++v) {
#pragma unroll
          for (int h = 0; h < 2; ++h)
            x[v][h] = *reinterpret_cast<const uint4*>(
                sdb + a_off[h] + (r0 + 8 * v) * BOX);
#pragma unroll
          for (int u = 0; u < NW; ++u) {
            const int nt = min(wn * NW + u, geo.nt - 1);
            const uint32_t* bp = pb + (r0 + 8 * v) * nl + b_off + nt * 8;
            b[v][u][0] = bp[0];
            b[v][u][1] = bp[nl];
          }
        }
#pragma unroll
        for (int v = 0; v < KU; ++v)
#pragma unroll
          for (int u = 0; u < NW; ++u) {
            if (wn * NW + u >= geo.nt) continue;
            mma_u8(acc[0][u], x[v][0].x, x[v][0].y, x[v][1].x, x[v][1].y,
                   b[v][u][0], b[v][u][1]);
            mma_u8(acc[1][u], x[v][0].z, x[v][0].w, x[v][1].z, x[v][1].w,
                   b[v][u][0], b[v][u][1]);
          }
      }
    }
    if (++st == stages) st = 0;

    if (++ck < nk) continue;
    const Mod md = mod_of(cur.li);
    const size_t orow = ((size_t)cur.li * d + cur.z) * G + g0;
    if constexpr (PAIRS) {
      // the tile's epilogue: sum_s S_s (2^(8s) mod p) mod p, seven terms
      // below 2p: below 14p < 2^32
#pragma unroll
      for (int u = 0; u < NW; ++u) {
        const int nt = wn * NW + u;
        if (nt >= geo.nt) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = cur.col0 + ccol + (e >> 1);
          const int n = nt * 8 + 2 * tig + (e & 1);
          const uint32_t x =
              times_weight<0>(acc[u][0][e], cur.li) +
              times_weight<1>(acc[u][1][e], cur.li) +
              times_weight<2>(acc[u][2][e], cur.li) +
              times_weight<3>(acc[u][3][e], cur.li) +
              times_weight<4>(acc[u][4][e], cur.li) +
              times_weight<5>(acc[u][5][e], cur.li) +
              times_weight<6>(acc[u][6][e], cur.li);
          if (col < m && n < gn)
            out[(orow + n) * m_out + (size_t)cur.chunk * m + col] =
                md.reduce(x);
#pragma unroll
          for (int s = 0; s < 7; ++s) acc[u][s][e] = 0;
        }
      }
    } else {
      // the tile's epilogue: sum_i o_i (2^(8i) mod p) mod p.  Lane
      // (g, tig) holds columns 2 tig, 2 tig + 1 of each N tile: query row
      // 2 nt + tig / 2, limbs i = 2 (tig & 1) and 2 (tig & 1) + 1; the
      // lane tig ^ 1 holds the row's other two.
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int u = 0; u < NW; ++u) {
          const int nt = wn * NW + u;
          if (nt >= geo.nt) break;
          const int n = 2 * nt + (tig >> 1);
#pragma unroll
          for (int h = 0; h < 2; ++h) {     // M row g (h 0) or g + 8 (h 1)
            const uint32_t o0 = (uint32_t)acc[t][u][2 * h];
            const uint32_t o1 = (uint32_t)acc[t][u][2 * h + 1];
            uint32_t x = tig & 1 ? times_weight<2>(o0, cur.li) +
                                       times_weight<3>(o1, cur.li)
                                 : times_weight<0>(o0, cur.li) +
                                       times_weight<1>(o1, cur.li);
            x += __shfl_xor_sync(0xFFFFFFFFu, x, 1);   // four terms: < 8p
            const int col = cur.col0 + ccol + 2 * t + h;
            if (!(tig & 1) && col < m && n < gn)
              out[(orow + n) * m_out + (size_t)cur.chunk * m + col] =
                  md.reduce(x);
            acc[t][u][2 * h] = acc[t][u][2 * h + 1] = 0;
          }
        }
    }
    ck = 0;
    if (++ct < mine) cur = tile_of(ct);
  }
  cp_async_wait<0>();
}

// The database's TMA map: (2d planes, K rows, m columns) uint32, boxes of
// (1, box_rows, 32 columns), 128-byte swizzle, zeros past its edges
static bool make_map(CUtensorMap* map, const void* db, int m, int K,
                     int planes, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)m, (cuuint64_t)K,
                              (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)m * 4, (cuuint64_t)m * K * 4};
  const cuuint32_t box[3] = {BOX, (cuuint32_t)box_rows, 1};
  return make_u32_map(map, db, 3, dims, strides, box);
}

template <int NW, bool TMA, bool PAIRS>
static cudaError_t launch_fd(cudaStream_t s, const void* db, const void* q,
                             void* out, int d, int K, int m, int G, int g0,
                             int gn, int m_out, int num_chunks, bool bulk) {
  const Geometry geo(gn, m, bulk);
  CUtensorMap db_map = {};
  if (TMA && !make_map(&db_map, db, m, K, 2 * d, geo.ks))
    return cudaErrorInvalidValue;
  auto kernel = firstdim_kernel<NW, TMA, PAIRS>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_SM);
  if (attr != cudaSuccess) return attr;
  static const int regs = [&] {
    cudaFuncAttributes a = {};
    cudaFuncGetAttributes(&a, kernel);
    return a.numRegs > 0 ? a.numRegs : 128;
  }();
  // the blocks an SM holds by registers; the ring as deep as their share
  // of the SM's shared memory allows
  const int by_regs = max(1, 65536 / (geo.threads * regs));
  int stages = MAX_STAGES;
  while (stages > 3 && geo.smem(stages) > SMEM_SM / by_regs) --stages;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, geo.threads, geo.smem(stages));
  if (e != cudaSuccess) return e;
  const long ntiles = (long)num_chunks * 2 * d * ((m + geo.mb - 1) / geo.mb);
  const long wave = (long)sms * (per_sm > 0 ? per_sm : 1);
  const int grid = (int)(ntiles < wave ? ntiles : wave);
  firstdim_kernel<NW, TMA, PAIRS><<<grid, geo.threads, geo.smem(stages), s>>>(
      db_map, (const uint32_t*)db, (const uint32_t*)q, (uint32_t*)out, d, K,
      m, G, g0, gn, m_out, num_chunks, (int)bulk, stages);
  return cudaGetLastError();
}

template <int NW, bool PAIRS>
static cudaError_t launch_route(bool tma, cudaStream_t s, const void* db,
                                const void* q, void* out, int d, int K, int m,
                                int G, int g0, int gn, int m_out,
                                int num_chunks, bool bulk) {
  return tma ? launch_fd<NW, true, PAIRS>(s, db, q, out, d, K, m, G, g0, gn,
                                          m_out, num_chunks, bulk)
             : launch_fd<NW, false, PAIRS>(s, db, q, out, d, K, m, G, g0, gn,
                                           m_out, num_chunks, bulk);
}

// Queries one pass takes: at most PASS_QUERIES and MAX_ROWS query rows.
extern "C" int spiral_firstdim_pass_queries(int K, int n1) {
  (void)K;
  return max(1, min(PASS_QUERIES, MAX_ROWS / (n1 > 0 ? n1 : 1)));
}

// db (2, d, K, m), q (2, d, K, B*n1) -> out (2, d, B*n1, num_chunks*m).
// One launch per pass: ceil(B / spiral_firstdim_pass_queries(K, n1)).
extern "C" int spiral_firstdim(const void* db, const void* q, void* out,
                               int d, int K, int m, int B, int n1,
                               int num_chunks, void* stream) {
  if (B < 1 || n1 < 1 || n1 > 4 || K < 1 || K > K_MAX || m < 1 ||
      num_chunks < 1 || (long)num_chunks * 2 * d * m > (1l << 31))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int G = B * n1, m_out = num_chunks * m;
  // TMA wants 16-byte aligned bases and row pitches
  const bool tma = m % 4 == 0 && (uintptr_t)db % 16 == 0;
  const bool q16 = tma && (uintptr_t)q % 16 == 0;   // the bulk copy's too
  const int per_pass = spiral_firstdim_pass_queries(K, n1);
  for (int b0 = 0; b0 < B; b0 += per_pass) {
    const int nb = min(per_pass, B - b0);
    const int g0 = b0 * n1, gn = nb * n1;
    // the query as one run of bytes (16-byte aligned) when the pass is the
    // whole batch, else by cp.async
    const bool bulk = q16 && gn == G && K * G % 4 == 0;
    const Geometry geo(gn, m, bulk);
    const cudaError_t e =
        !geo.pairs ? launch_route<2, false>(tma, s, db, q, out, d, K, m, G,
                                            g0, gn, m_out, num_chunks, bulk)
        : geo.nw == 1
            ? launch_route<1, true>(tma, s, db, q, out, d, K, m, G, g0, gn,
                                    m_out, num_chunks, bulk)
            : launch_route<2, true>(tma, s, db, q, out, d, K, m, G, g0, gn,
                                    m_out, num_chunks, bulk);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}
