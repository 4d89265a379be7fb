// Pieces of the direct conv kernel of direct_conv.cu (B4), the one kernel
// still on mma.sync: the cp.async / ldmatrix / mma.sync wrappers, the weight
// ring's chunk loader and the product of one ring chunk on bf16 tensor-core
// tiles.  (The kernels on wgmma share hopper_common.cuh.)
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace convk {

constexpr int BN = 128;        // output channels per block
constexpr int CG = 32;         // input channels per group (= weight rows per ring stage)
constexpr int STAGES = 4;      // weight ring depth
constexpr int WLD = BN + 8;    // ring row stride in bf16 (272 B: ldmatrix without bank conflicts)
constexpr int NTHREADS = 256;  // 8 warps: 2 along M x 4 along N
constexpr size_t RING_BYTES = (size_t)STAGES * CG * WLD * 2;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; zero-fills the destination when !pred.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One ring stage: rows [c0, c0 + CG) x columns [n0, n0 + BN) of the (K, F)
// weight matrix at `w` (row stride F); columns past F are zero-filled.
__device__ __forceinline__ void load_wchunk(const __nv_bfloat16* w, int c0, int F, int n0,
                                            __nv_bfloat16* stage, int tid) {
  const __nv_bfloat16* src = w + (size_t)c0 * F;
#pragma unroll
  for (int i = 0; i < CG * BN / 8 / NTHREADS; ++i) {
    const int seg = tid + i * NTHREADS;
    const int row = seg / (BN / 8);
    const int col = (seg % (BN / 8)) * 8;
    const bool ok = n0 + col < F;
    cp_async16(stage + row * WLD + col, ok ? src + (size_t)row * F + n0 + col : w, ok);
  }
}

// acc[mt][nt] += A (MT m16 fragments x CG) * W (CG x this warp's 32 columns).
// `a_lane` is this lane's ldmatrix address for fragment 0 (row lane & 15,
// column (lane >> 4) * 8 of the group); fragment mt lies mt * frag_stride
// elements further.  `wst` is the ring stage.
template <int MT>
__device__ __forceinline__ void mma_chunk(float (&acc)[MT][4][4], const __nv_bfloat16* a_lane,
                                          int frag_stride, const __nv_bfloat16* wst, int lane,
                                          int wn) {
#pragma unroll
  for (int kk = 0; kk < CG; kk += 16) {
    uint32_t af[MT][4], bfr[4][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) ldsm_x4(af[mt], a_lane + mt * frag_stride + kk);
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t t4[4];
      ldsm_x4_t(t4, wst + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * WLD + wn * 32 + np * 16 +
                        (lane >> 4) * 8);
      bfr[2 * np][0] = t4[0];
      bfr[2 * np][1] = t4[1];
      bfr[2 * np + 1][0] = t4[2];
      bfr[2 * np + 1][1] = t4[3];
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], af[mt], bfr[nt]);
  }
}

// Bias, LeakyReLU(0.01) and the store of two neighbouring channels at element i.
__device__ __forceinline__ void finish2(void* base, size_t i, float v0, float v1, float b0,
                                        float b1, bool leaky, bool out_f32) {
  v0 += b0;
  v1 += b1;
  if (leaky) {
    v0 = v0 > 0.f ? v0 : 0.01f * v0;
    v1 = v1 > 0.f ? v1 : 0.01f * v1;
  }
  if (out_f32)
    *reinterpret_cast<float2*>(reinterpret_cast<float*>(base) + i) = make_float2(v0, v1);
  else
    *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<__nv_bfloat16*>(base) + i) =
        __floats2bfloat162_rn(v0, v1);
}

}  // namespace convk
