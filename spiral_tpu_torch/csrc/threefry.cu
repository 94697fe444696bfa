// K10: the threefry replay that rebuilds a query's uniform `a` halves from
// its seed, one launch for every query of a batch.
//
// core/sampling.py uniform_residues_words_plain computes, for each of B
// keys and counter i < n = prod(shape), jax.random.randint's residue mod
// P_I from two random_bits draws (its high and low words' keys) and the
// residue mod B_I from two more (core/threefry.py): four
// threefry2x32(key, 0, i) hashes, each hash's two words XORed, and the
// range reduction ((hi % span) * mult + lo % span) % span in uint32
// wrap-around.  In torch ops that is about 750 launches of elementwise
// kernels over int64 tensors; here it is one, with no intermediate tensor.
//
// Layout: the key words are (4, 2, B, 1) int64 (sampling.uniform_key_words:
// the P_I high and low keys, then B_I's; word j of set s for query b at
// (s * 2 + j) * B + b), each a uint32 value.  The output is (B, n / d, 2,
// d) int32: counter i of query b gives row (b, i / d), column i % d, the
// P_I residue in limb 0 and the B_I residue in limb 1.  One thread a (query,
// counter) pair, THREADS counters a block and ceil(n / THREADS) blocks a
// query on a one-dimensional grid, so a warp writes 32 consecutive words
// of each limb.
//
// Bound on the H100: a query of n = 2,048 counters writes 16 KB and runs
// 4 x 2,048 hashes, each 20 mixes of add, funnel shift and xor and 5 key
// injections; the 40 funnel shifts and xors of a hash run only on the
// integer ALU (64 a clock an SM).  Both take well under a microsecond,
// so a launch of one query is launch latency; at hundreds of cts a query
// the ALU binds.  It needs no shared memory and no tensor cores.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

// threefry.py _ROT: the rotations of mix j in round r
__device__ __forceinline__ constexpr int rot(int r, int j) {
  return r % 2 ? (j == 0 ? 17 : j == 1 ? 29 : j == 2 ? 16 : 24)
               : (j == 0 ? 13 : j == 1 ? 15 : j == 2 ? 26 : 6);
}

// threefry2x32((k0, k1), 0, i), its two output words XORed (threefry.py
// threefry2x32 and random_bits)
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1,
                                                  uint32_t i) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  uint32_t x0 = ks[0], x1 = i + ks[1];
#pragma unroll
  for (int r = 0; r < 5; ++r) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = __funnelshift_l(x1, x1, rot(r, j)) ^ x0;
    }
    x0 += ks[(r + 1) % 3];
    x1 += ks[(r + 2) % 3] + r + 1;
  }
  return x0 ^ x1;
}

// threefry.randint_u32: the products and sums wrap at 2^32, as JAX's
// uint32 arithmetic does
__device__ __forceinline__ uint32_t randint(uint32_t hi, uint32_t lo,
                                            uint32_t span, uint32_t mult) {
  return ((hi % span) * mult + lo % span) % span;
}

__global__ void __launch_bounds__(THREADS)
threefry_residues_kernel(const int64_t* __restrict__ words, int B,
                         uint32_t n, uint32_t d, uint32_t blocks_per_query,
                         uint32_t span_p, uint32_t mult_p, uint32_t span_b,
                         uint32_t mult_b, int32_t* __restrict__ out) {
  const uint32_t b = blockIdx.x / blocks_per_query;
  const uint32_t i = (blockIdx.x % blocks_per_query) * THREADS + threadIdx.x;
  if (i >= n) return;
  uint32_t k[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) k[s] = (uint32_t)words[(size_t)s * B + b];
  const uint32_t x = randint(threefry_bits(k[0], k[1], i),
                             threefry_bits(k[2], k[3], i), span_p, mult_p);
  const uint32_t y = randint(threefry_bits(k[4], k[5], i),
                             threefry_bits(k[6], k[7], i), span_b, mult_b);
  int32_t* row = out + ((size_t)b * (n / d) + i / d) * 2 * d + i % d;
  row[0] = (int32_t)x;
  row[d] = (int32_t)y;
}

}  // namespace

// words (4, 2, B, 1) int64 -> out (B, n / d, 2, d) int32, spans P_I and
// B_I with their randint multipliers ((2^16 % span)^2 % span).
extern "C" int spiral_uniform_residues(const void* words, int B, long long n,
                                       int d, unsigned span_p,
                                       unsigned mult_p, unsigned span_b,
                                       unsigned mult_b, void* out,
                                       void* stream) {
  if (B < 1 || n < 1 || d < 1 || n % d || n > 0x7FFFFFFFll || !span_p ||
      !span_b)
    return (int)cudaErrorInvalidValue;
  const long long per_query = (n + THREADS - 1) / THREADS;
  if (per_query * B > 0x7FFFFFFFll) return (int)cudaErrorInvalidValue;
  threefry_residues_kernel<<<(unsigned)(per_query * B), THREADS, 0,
                             (cudaStream_t)stream>>>(
      (const int64_t*)words, B, (uint32_t)n, (uint32_t)d,
      (uint32_t)per_query, span_p, mult_p, span_b, mult_b, (int32_t*)out);
  return (int)cudaGetLastError();
}
