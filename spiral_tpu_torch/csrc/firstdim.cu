// K2: the first-dimension multiply, the stage that streams the database.
//
// For each CRT limb li and NTT slot z:
//   out[li, z, g, col] = sum_k Q[li, z, k, g] * DB[li, z, k, col] mod p
// with K = dim0*n0 (512 at spiral_20_256), n1 = 3 query rows and
// m = num_per*n2 (256) database columns.
//
// Replaces the Pallas kernel spiral_tpu/server/firstdim.py
// multiply_query_by_db_fused (_fdim_fused_kernel), which splits residues
// into 7-bit int8 limbs for the TPU's matrix unit and recombines them.  The
// H100 multiplies u32 x u32 -> u64 exactly, so there are no limbs: each
// thread owns one column, walks k with the DB load coalesced across the warp
// (layout (2, d, K, m), server/db.py), and keeps n1 u64 accumulators,
// reduced mod p every 128 terms (128 * p^2 < 2^63).  The block's query
// slice (K x n1) sits in shared memory.
//
// Bound on the H100: the database is read once, 2 GiB at spiral_20_256, and
// each element feeds n1 = 3 multiply-adds, so the floor is device memory
// bandwidth (3.35 TB/s, ~0.64 ms); the 64-bit multiply-adds are the
// other limit.
#include "common.cuh"

using namespace spiral;

constexpr int FD_THREADS = 256;
constexpr int FD_CHUNK = 128;
constexpr int FD_MAX_N1 = 4;

__global__ void firstdim_kernel(const uint32_t* __restrict__ db,
                                const uint32_t* __restrict__ q,
                                uint32_t* __restrict__ out, int d, int K,
                                int m, int n1) {
  extern __shared__ uint32_t qs[];   // K * n1
  const int zl = blockIdx.y;         // li * d + z
  const Mod md = mod_of(zl / d);
  const uint32_t* qz = q + (size_t)zl * K * n1;
  for (int i = threadIdx.x; i < K * n1; i += blockDim.x) qs[i] = qz[i];
  __syncthreads();
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= m) return;
  const uint32_t* dp = db + (size_t)zl * K * m + col;
  uint64_t acc[FD_MAX_N1] = {0, 0, 0, 0};
  for (int k0 = 0; k0 < K; k0 += FD_CHUNK) {
    const int k1 = min(K, k0 + FD_CHUNK);
#pragma unroll 4
    for (int k = k0; k < k1; ++k) {
      const uint64_t v = dp[(size_t)k * m];
#pragma unroll
      for (int g = 0; g < FD_MAX_N1; ++g)
        if (g < n1) acc[g] += v * qs[k * n1 + g];
    }
#pragma unroll
    for (int g = 0; g < FD_MAX_N1; ++g) acc[g] = md.reduce(acc[g]);
  }
  uint32_t* o = out + (size_t)zl * n1 * m + col;
#pragma unroll
  for (int g = 0; g < FD_MAX_N1; ++g)
    if (g < n1) o[(size_t)g * m] = (uint32_t)acc[g];
}

extern "C" int spiral_firstdim(const void* db, const void* q, void* out,
                               int d, int K, int m, int n1, void* stream) {
  if (n1 < 1 || n1 > FD_MAX_N1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)K * n1 * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        firstdim_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((m + FD_THREADS - 1) / FD_THREADS, 2 * d);
  firstdim_kernel<<<grid, FD_THREADS, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)db, (const uint32_t*)q, (uint32_t*)out, d, K, m, n1);
  return (int)cudaGetLastError();
}
