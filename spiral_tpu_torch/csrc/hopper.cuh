// Hopper building blocks shared by the kernels on the int8 tensor cores,
// K2 (firstdim.cu) and K8b-2 (fold_mxu.cu): the u8 MMA, the prescaled
// form's query limbs, mbarriers, the bulk copy engine, TMA
// (cp.async.bulk.tensor) and the encoding of a tensor map.  A copy by TMA
// or the bulk copy engine counts its bytes on an mbarrier in shared
// memory: one thread arms the barrier with the bytes it expects
// (mbar_expect_tx) and starts the copies; the consumers wait on the
// barrier's phase (mbar_wait).
#pragma once

#include <cudaTypedefs.h>

#include "common.cuh"

namespace spiral {

// D += A (16 x 32 u8, row-major) * B (32 x 8 u8, col-major), s32 sums.
__device__ __forceinline__ void mma_u8(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 2^(8i) mod p and its Shoup companion floor(2^(8i) mod p * 2^32 / p),
// folded at compile time
__host__ __device__ constexpr uint32_t weight(uint32_t p, int i) {
  return (uint32_t)((1ull << (8 * i)) % p);
}
__host__ __device__ constexpr uint32_t weight_shoup(uint32_t p, int i) {
  return (uint32_t)(((uint64_t)weight(p, i) << 32) / p);
}

__device__ __forceinline__ uint32_t shoup(uint32_t a, uint32_t w,
                                          uint32_t ws, uint32_t p) {
  return a * w - __umulhi(a, ws) * p;   // [0, 2p) for any a < 2^32
}

template <int I>
__device__ __forceinline__ uint32_t times_weight(uint32_t a, int li) {
  return li ? shoup(a, weight(B_I, I), weight_shoup(B_I, I), B_I)
            : shoup(a, weight(P_I, I), weight_shoup(P_I, I), P_I);
}

// Bytes j of four words -> word j holds (w0.j, w1.j, w2.j, w3.j).
__device__ __forceinline__ uint4 bytes_t(uint32_t w0, uint32_t w1,
                                         uint32_t w2, uint32_t w3) {
  const uint32_t t0 = __byte_perm(w0, w1, 0x5140);
  const uint32_t t1 = __byte_perm(w0, w1, 0x7362);
  const uint32_t t2 = __byte_perm(w2, w3, 0x5140);
  const uint32_t t3 = __byte_perm(w2, w3, 0x7362);
  return make_uint4(__byte_perm(t0, t2, 0x5410), __byte_perm(t0, t2, 0x7632),
                    __byte_perm(t1, t3, 0x5410), __byte_perm(t1, t3, 0x7632));
}

// The prescaled form's limb planes of a query word x (any 32-bit word,
// reduced here) in limb li: word i holds (limb_i(Q_0), .., limb_i(Q_3)),
// one byte each, Q_j = 2^(8j) x mod p; an A (or B) register of the u8
// MMA whose K order puts an element's four j-limbs together.
__device__ __forceinline__ uint4 prescaled_planes(uint32_t x, int li) {
  const uint32_t p = li ? B_I : P_I;
  const uint32_t one = li ? 0xFFFFFFFFu / B_I : 0xFFFFFFFFu / P_I;
  uint32_t q0 = x - __umulhi(x, one) * p;   // [0, 2p)
  q0 = q0 >= p ? q0 - p : q0;
  uint32_t q1 = times_weight<1>(q0, li);
  uint32_t q2 = times_weight<2>(q0, li);
  uint32_t q3 = times_weight<3>(q0, li);
  q1 = q1 >= p ? q1 - p : q1;
  q2 = q2 >= p ? q2 - p : q2;
  q3 = q3 >= p ? q3 - p : q3;
  return bytes_t(q0, q1, q2, q3);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// after a block's mbar_init calls, before any copy completes on them
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// this thread's generic-proxy writes to shared memory are ordered before
// later copies of the async proxy (TMA) into it
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// `bytes` contiguous bytes by the bulk copy engine, completion counted on
// the mbarrier bar (both addresses and the size 16-byte multiples).
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// One TMA box of a 3-D tensor map at (c0, c1, c2), completion counted on
// the mbarrier bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar)) : "memory");
}

// One TMA box of a 5-D tensor map at (c0, .., c4).
__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5, %6}], "
      "[%7];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4), "r"(smem_u32(bar))
      : "memory");
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry points
inline PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &res);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &res);
#endif
    return res == cudaDriverEntryPointSuccess
               ? reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p)
               : nullptr;
  }();
  return fn;
}

// A tensor map of `rank` dimensions of uint32 words, dims[0] contiguous,
// strides in bytes of dimensions 1 .. rank-1, boxes of `box` words, the
// 128-byte swizzle and zeros past the edges.  False if it cannot be made.
inline bool make_u32_map(CUtensorMap* map, const void* base, int rank,
                         const cuuint64_t* dims, const cuuint64_t* strides,
                         const cuuint32_t* box) {
  const auto encode = encode_tiled();
  if (!encode) return false;
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT32, rank,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace spiral
