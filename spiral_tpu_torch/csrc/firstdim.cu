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
// implicit loops.  The H100 multiplies u32 x u32 -> u64 exactly, so there
// are no limbs.  A thread owns four adjacent columns of one query: it
// walks k with one 16-byte DB load per step, coalesced across the warp
// (layout (2, d, K, m), server/db.py), FD_UNROLL loads in flight, and
// keeps 4 x n1 u64 accumulators, reduced mod p every 128 terms
// (128 * p^2 < 2^63); each query word read from shared memory serves four
// multiply-adds.  The block is (column groups) x (queries), so the B warps
// that share a column range read each DB line from L1 after the first, and
// the database streams from device memory once for the batch; a thread's
// registers do not grow with B.  The block's query slice (K x the pass's
// rows) is copied once into dynamic shared memory, so the k loop runs
// without barriers.  A pass takes at most FD_SMEM bytes of query (24 rows
// at K = 1,024, 6 at K = 4,096) and 16 queries; a larger batch runs in
// several passes, each reading the database again.  The chunk is the
// slowest grid axis, so each chunk streams the whole slab from device
// memory, as a database of num_chunks slabs would.
//
// Bound on the H100: the database is read once per pass and chunk (2 GiB
// at spiral_20_256, ~0.64 ms at 3.35 TB/s), and each element feeds G
// multiply-adds: at G = 3 the bytes bound it, at G = 24 (B = 8) the
// 2^29 * 24 integer products (~0.77 ms at 16.7 T/s).
#include "common.cuh"

using namespace spiral;

constexpr int FD_THREADS = 256;    // thread columns of a one-query block
constexpr int FD_BLOCK = 512;      // threads of a block
constexpr int FD_CHUNK = 128;
constexpr int FD_SMEM = 96 * 1024;
constexpr int FD_UNROLL = 8;

// C consecutive columns of one k row: one 16-byte load for C = 4
template <int C>
__device__ __forceinline__ void load_cols(const uint32_t* p, uint32_t* v) {
  if constexpr (C == 4) {
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = p[c];
  }
}

// R query rows (n1) per thread, C columns per thread (4 when m % 4 == 0)
template <int R, int C>
__global__ void __launch_bounds__(FD_BLOCK)
firstdim_kernel(const uint32_t* __restrict__ db,
                const uint32_t* __restrict__ q, uint32_t* __restrict__ out,
                int d, int K, int m, int G, int g0, int gn, int m_out) {
  extern __shared__ uint32_t qs[];   // K x gn: row k, pass row j
  const int li = blockIdx.y / d, z = blockIdx.y - li * d;
  const int chunk = blockIdx.z;
  const int zq = (z - chunk % d + d) % d;   // chunk i reads query slot z - i
  const Mod md = mod_of(li);
  const uint32_t* qz = q + ((size_t)li * d + zq) * K * G + g0;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  if (gn == G) {
    for (int i = tid; i < K * gn; i += nthreads) qs[i] = qz[i];
  } else {
    for (int i = tid; i < K * gn; i += nthreads) {
      const int k = i / gn;
      qs[i] = qz[(size_t)k * G + (i - k * gn)];
    }
  }
  __syncthreads();
  const int col = (blockIdx.x * blockDim.x + threadIdx.x) * C;
  if (col >= m) return;
  const int j0 = threadIdx.y * R;    // this thread's query rows in the pass
  const uint32_t* dp = db + ((size_t)li * d + z) * K * m + col;
  uint64_t acc[R][C] = {};
  for (int k0 = 0; k0 < K; k0 += FD_CHUNK) {
    const int k1 = min(K, k0 + FD_CHUNK);
#pragma unroll FD_UNROLL
    for (int k = k0; k < k1; ++k) {
      uint32_t v[C];
      load_cols<C>(dp + (size_t)k * m, v);
      const uint32_t* qk = qs + k * gn + j0;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const uint32_t w = qk[r];
#pragma unroll
        for (int c = 0; c < C; ++c) acc[r][c] += (uint64_t)v[c] * w;
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[r][c] = md.reduce(acc[r][c]);
  }
  uint32_t* o = out + (((size_t)li * d + z) * G + g0 + j0) * m_out +
                (size_t)chunk * m + col;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if constexpr (C == 4) {
      *reinterpret_cast<uint4*>(o + (size_t)r * m_out) =
          make_uint4((uint32_t)acc[r][0], (uint32_t)acc[r][1],
                     (uint32_t)acc[r][2], (uint32_t)acc[r][3]);
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) o[(size_t)r * m_out + c] = (uint32_t)acc[r][c];
    }
  }
}

template <int R, int C>
static cudaError_t launch_fd(dim3 grid, dim3 block, cudaStream_t s,
                             const void* db, const void* q, void* out, int d,
                             int K, int m, int G, int g0, int gn, int m_out) {
  const size_t smem = (size_t)K * gn * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        firstdim_kernel<R, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        FD_SMEM);
    if (e != cudaSuccess) return e;
  }
  firstdim_kernel<R, C><<<grid, block, smem, s>>>(
      (const uint32_t*)db, (const uint32_t*)q, (uint32_t*)out, d, K, m, G,
      g0, gn, m_out);
  return cudaGetLastError();
}

template <int R>
static cudaError_t launch_rows(bool vec, dim3 grid, dim3 block,
                               cudaStream_t s, const void* db, const void* q,
                               void* out, int d, int K, int m, int G, int g0,
                               int gn, int m_out) {
  return vec ? launch_fd<R, 4>(grid, block, s, db, q, out, d, K, m, G, g0,
                               gn, m_out)
             : launch_fd<R, 1>(grid, block, s, db, q, out, d, K, m, G, g0,
                               gn, m_out);
}

// Queries one pass takes: at most FD_SMEM bytes of query rows per block
// and FD_BLOCK / 32 queries (one warp of column groups each).
extern "C" int spiral_firstdim_pass_queries(int K, int n1) {
  return max(1, min(FD_BLOCK / 32,
                    FD_SMEM / (K * n1 * (int)sizeof(uint32_t))));
}

// db (2, d, K, m), q (2, d, K, B*n1) -> out (2, d, B*n1, num_chunks*m).
// One launch per pass: ceil(B / spiral_firstdim_pass_queries(K, n1)).
extern "C" int spiral_firstdim(const void* db, const void* q, void* out,
                               int d, int K, int m, int B, int n1,
                               int num_chunks, void* stream) {
  if (B < 1 || n1 < 1 || n1 > 4 || K < 1 || num_chunks < 1 ||
      num_chunks > 65535 || 2 * d > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int G = B * n1, m_out = num_chunks * m;
  const bool vec = m % 4 == 0;       // 16-byte rows: four columns a thread
  const int groups = vec ? m / 4 : m;
  const int per_pass = spiral_firstdim_pass_queries(K, n1);
  for (int b0 = 0; b0 < B; b0 += per_pass) {
    const int nb = min(per_pass, B - b0);
    // column groups per block: a one-query block keeps FD_THREADS; a batch
    // fills FD_BLOCK threads with nb warps over the same columns
    const int cx = min((groups + 31) / 32 * 32,
                       max(32, min(FD_THREADS, FD_BLOCK / nb / 32 * 32)));
    const dim3 block(cx, nb);
    const dim3 grid((groups + cx - 1) / cx, 2 * d, num_chunks);
    const int g0 = b0 * n1, gn = nb * n1;
    cudaError_t e;
    switch (n1) {
      case 1: e = launch_rows<1>(vec, grid, block, s, db, q, out, d, K, m,
                                 G, g0, gn, m_out); break;
      case 2: e = launch_rows<2>(vec, grid, block, s, db, q, out, d, K, m,
                                 G, g0, gn, m_out); break;
      case 3: e = launch_rows<3>(vec, grid, block, s, db, q, out, d, K, m,
                                 G, g0, gn, m_out); break;
      default: e = launch_rows<4>(vec, grid, block, s, db, q, out, d, K, m,
                                  G, g0, gn, m_out); break;
    }
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}
