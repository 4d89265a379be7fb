// F(2,3)^2 Winograd packed 3x3x3 conv (+bias, +LeakyReLU) for Hopper (sm_90a),
// and its fused factored-tangent pair.
//
// Replaces two Pallas TPU kernels of jax_nbody_emulator_with_dj_tpu/ops/winograd_pallas.py:
//   B1 conv3d_wino_pallas_packed      (body _wino_kernel, block planner _pick_block)
//   B2 conv3d_wino_pallas_pair_packed (body _wino_pair_kernel)
// B1 computes a VALID 3x3x3 conv in the W-parity packed layout, x (B, D, H,
// WP, C2) bf16 -> y (B, D-2, H-2, WP-1, F2), Winograd F(2,3) over (D, H) with
// the two packed-W taps summed exactly, weights pre-transformed by
// ops/winograd.py::transform_packed_w3 as (4, 4, 2, C2, F2) bf16, float32
// accumulation, and an epilogue adding a float32 bias and an optional
// LeakyReLU(0.01) before one store in bf16 or float32.  B2 runs the same conv
// on two inputs x and s of one shape (any two sets of strides) against the
// same weights, and from the two float32 accumulators stores
//   y = conv(x, W) + b,   dy = conv(s, W) - c (.) conv(x, W),
// with, when leaky, dy scaled by 0.01 wherever the float32 y <= 0 and then y
// too: the velocity layers' factored tangent (models/blocks.py::_wino_conv_pair).
//
// What bounds it on the H100, at C2 = F2 = 128 (every interior conv of the
// 64-channel model).  Each output row -- one 2x2 (D, H) tile at one packed-W
// cell -- costs 16 point products of K = 2*C2 = 256 by F2 = 128: 1.05 MFLOP,
// 2.25x fewer than the 18-tap direct conv, ~360 GFLOP at the phase-3 tile
// shape (1,142,142,71,128) against ~0.7 GB of device-memory traffic, so the
// ideal kernel is bound by the tensor cores.  Three things stand in the way.
// The 16 points' transformed weights are 1 MB of bf16, far more than one
// SM's 227 KB of shared memory, so every block streams all of them from L2,
// and the four output parities of every row need float32 accumulators, which
// caps a block at 64 rows x 128 channels in registers: ~5.7 GB of L2 reads
// at the phase-3 shape.  The input window adds ~1.5 GB.  And mma.sync takes
// both operands through registers: at a 32x32 warp tile ldmatrix moves as
// many shared-memory bytes per cycle as the tensor cores consume, so the
// products alone run well under the bf16 peak.
//
// Design (simple and correct first; TMA multicast, clusters and wgmma later --
// wgmma needs registers that the parity accumulators hold here):
//   * the output rows are flattened over (B, D-tile, H-tile, cell) with the
//     cell running over all WP input cells (the last one is a dummy row that
//     is never stored), so tap a=1 of row r is the transformed input of row
//     r+1 and no packed-W extent is padded to a block multiple;
//   * one block = 64 such rows x BN = 128 output channels (wider F2 runs
//     more blocks along grid.y), 8 warps of 32x32 on mma.sync m16n8k16 bf16
//     tensor-core tiles fed by ldmatrix, each holding 4 output-parity float32
//     accumulators plus one point product;
//   * the input channels go in groups of 32.  A group's raw input window (4 D
//     x 4 H rows x 65 flat rows: 64 plus the halo row of tap a=1) arrives by
//     cp.async in shared memory while the previous group's products run, so
//     each input element crosses L2 once per block; out-of-range reads are
//     zero-filled there, so ragged D, H and W edges cost the caller nothing.
//     The block then applies BT for all 16 points, shared memory to shared
//     memory on packed bf16 pairs, and runs the group's 16 point products;
//   * the transformed weights stream through a 4-stage cp.async ring of
//     32-row x 128-column chunks shared by all 8 warps, running ahead across
//     point and group boundaries;
//   * AT (entries 0, +-1) is folded into the parity accumulators as each
//     point's partial product completes; the epilogue adds the bias, applies
//     LeakyReLU and stores each thread's column pairs in place, masked;
//   * the pair (B2) is the same kernel with PAIR = true: a block takes 32
//     flat rows of x and the same 32 rows of s, so it still runs 64 rows of
//     products against each weight chunk of the ring, and the registers stay
//     B1's.  Each warp's two m16 fragments are 16 rows of x and the same 16
//     rows of s, so one thread holds the x and the s accumulator of every
//     output element it stores: the c-fold runs on the float32 accumulators
//     and the LeakyReLU mask on the float32 y, in registers.  The two inputs
//     keep their own strides (x is often a view of a padded level buffer, s a
//     fresh tensor).
// Roundings match the Pallas kernels and the plain PyTorch versions
// (ops/winograd.py::conv3_packed_wino, conv3_packed_wino_pair): the BT
// transform rounds to bf16 after the D axis and again after the H axis;
// everything after runs in float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int BN = 128;         // output channels per block
constexpr int CG = 32;          // input channels per group (= weight rows per ring stage)
constexpr int STAGES = 4;       // weight ring depth
constexpr int WLD = BN + 8;     // ring row stride in bf16 (272 B: ldmatrix without bank conflicts)
constexpr int ZLD = CG + 8;     // transformed-input row stride in bf16 (80 B: the same)
constexpr int NTHREADS = 256;   // 8 warps: 2 along M x 4 along N, 32x32 each
constexpr int CHUNKS_PER_GROUP = 16 * 2;  // points x packed-W taps
constexpr size_t RING_BYTES = (size_t)STAGES * CG * WLD * 2;

// Block geometry.  B1: 64 flat output rows of one input.  B2 (PAIR): 32 flat
// rows of x and the same 32 of s.  Either way 64 rows of products.
template <bool PAIR>
struct Geo {
  static constexpr int BR = PAIR ? 32 : 64;         // flat output rows per block
  static constexpr int ZRO = BR + 1;                // transformed rows per input (+ the halo row of tap a=1)
  static constexpr int ZR = (PAIR ? 2 : 1) * ZRO;   // transformed rows of all inputs
  static constexpr int RAW_SEGS = 16 * ZR * (CG / 8);                     // 16-byte pieces of a window
  static constexpr int RAW_STEPS = (RAW_SEGS + NTHREADS - 1) / NTHREADS;  // ring steps that carry them
  static_assert(RAW_STEPS + STAGES <= CHUNKS_PER_GROUP, "window must land before its group");
  static constexpr size_t ZS_BYTES = (size_t)16 * ZR * ZLD * 2;
  static constexpr size_t RAW_BYTES = (size_t)RAW_SEGS * 16;
  static constexpr size_t ROWS_BYTES = (size_t)ZR * 12;
  static constexpr size_t SMEM_BYTES = RING_BYTES + ZS_BYTES + RAW_BYTES + ROWS_BYTES;
  // First transformed row of warp-row wm's m16 fragment mt.  B1: the warp's
  // 32 rows.  PAIR: fragment 0 is 16 rows of x, fragment 1 the same rows of s.
  // For the fragments that are stored, minus the input offset, also the
  // block-relative flat output row.
  __device__ static constexpr int frag_row(int wm, int mt) {
    return PAIR ? mt * ZRO + wm * 16 : wm * 32 + mt * 16;
  }
};

// BT rows of F(2,3): z_k = x[ra(k)] + x[rb(k)] for k == 1, x[ra(k)] - x[rb(k)]
// otherwise.  Functions, not tables, so unrolled loops fold them into constants.
__device__ __forceinline__ int ra(int k) { return k == 0 ? 0 : (k == 2 ? 2 : 1); }
__device__ __forceinline__ int rb(int k) { return k == 3 ? 3 : (k == 2 ? 1 : 2); }
// AT rows of F(2,3): output parity p takes point k with sign at(p, k).
__device__ __forceinline__ float at(int p, int k) {
  if (p == 0) return k == 3 ? 0.f : 1.f;
  return k == 0 ? 0.f : (k == 1 ? 1.f : -1.f);
}

struct Args {
  const __nv_bfloat16* x[2];  // x, and s for the pair
  const __nv_bfloat16* wh;
  const float* bias;
  const float* c;             // the pair's fold vector
  void* y[2];                 // y, and dy for the pair
  long long sB[2], sD[2], sH[2], sW[2];  // element strides of x and s; channels are contiguous
  int B, D, H, WP, C2, F2;
  int OD, OH, OW;
  int ND, NH;  // Winograd tiles along D and H
  int M;       // flat rows: B * ND * NH * WP
};

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

// x + y (plus) or x - y on 8 bf16 lanes, each correctly rounded to bf16: the
// same value as the float32 sum rounded to bf16 (the sum of two bf16 values
// is exact in float32 or too lopsided for the rounding to differ).
__device__ __forceinline__ uint4 pm8(const uint4& x, const uint4& y, bool plus) {
  const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&y);
  uint4 out;
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i] = plus ? __hadd2(a[i], b[i]) : __hsub2(a[i], b[i]);
  return out;
}

// Flat row r -> (b, D-tile, H-tile, cell); false past the last row.
__device__ __forceinline__ bool decode(const Args& a, int r, int& b, int& dt, int& ht,
                                      int& w) {
  w = r % a.WP;
  int t = r / a.WP;
  ht = t % a.NH;
  t /= a.NH;
  dt = t % a.ND;
  b = t / a.ND;
  return r < a.M;
}

// Ring chunk j: channel group j / 32, point (j / 2) % 16, packed-W tap j % 2.
__device__ __forceinline__ void load_chunk(const Args& a, int j, int n0, __nv_bfloat16* ring,
                                           int tid) {
  const int g = j / CHUNKS_PER_GROUP;
  const int pt = j % CHUNKS_PER_GROUP;  // point * 2 + tap
  const __nv_bfloat16* src = a.wh + ((size_t)pt * a.C2 + g * CG) * a.F2;
  __nv_bfloat16* stage = ring + (j % STAGES) * CG * WLD;
#pragma unroll
  for (int i = 0; i < CG * BN / 8 / NTHREADS; ++i) {
    const int seg = tid + i * NTHREADS;
    const int row = seg / (BN / 8);
    const int col = (seg % (BN / 8)) * 8;
    const bool ok = n0 + col < a.F2;
    cp_async16(stage + row * WLD + col, ok ? src + (size_t)row * a.F2 + n0 + col : a.wh, ok);
  }
}

// Piece `step` of channel group g's raw window: raw[(dr*4 + hr)*ZR + row][CG].
// Rows [0, ZRO) read x, rows [ZRO, 2 ZRO) (PAIR) read s.
template <bool PAIR>
__device__ __forceinline__ void load_raw(const Args& a, int g, int step, uint4* raw,
                                         const long long* row_off, const int* row_lim,
                                         int tid) {
  using G = Geo<PAIR>;
  const int seg = step * NTHREADS + tid;
  if (seg >= G::RAW_SEGS) return;
  const int q = seg % (CG / 8);
  const int row = (seg / (CG / 8)) % G::ZR;
  const int dh = seg / (CG / 8 * G::ZR);
  const int dr = dh >> 2, hr = dh & 3;
  const int lim = row_lim[row];
  const bool ok = dr < (lim >> 4) && hr < (lim & 15);
  const bool s_row = PAIR && row >= G::ZRO;
  const __nv_bfloat16* src = (s_row ? a.x[1] : a.x[0]) + row_off[row] +
                             dr * (s_row ? a.sD[1] : a.sD[0]) +
                             hr * (s_row ? a.sH[1] : a.sH[0]) + g * CG + q * 8;
  cp_async16(raw + seg, ok ? src : a.x[0], ok);
}

template <bool OUT_F32>
__device__ __forceinline__ void store2(void* base, size_t i, float v0, float v1) {
  if (OUT_F32)
    *reinterpret_cast<float2*>(reinterpret_cast<float*>(base) + i) = make_float2(v0, v1);
  else
    *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<__nv_bfloat16*>(base) + i) =
        __floats2bfloat162_rn(v0, v1);
}

template <bool LEAKY, bool OUT_F32, bool PAIR>
__global__ void __launch_bounds__(NTHREADS, 1) wino_f23_kernel(Args a) {
  using G = Geo<PAIR>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* zs = reinterpret_cast<__nv_bfloat16*>(smem_raw + RING_BYTES);
  uint4* raw = reinterpret_cast<uint4*>(smem_raw + RING_BYTES + G::ZS_BYTES);
  long long* row_off =
      reinterpret_cast<long long*>(smem_raw + RING_BYTES + G::ZS_BYTES + G::RAW_BYTES);
  int* row_lim = reinterpret_cast<int*>(row_off + G::ZR);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp >> 2;  // warp's slice of the block's rows
  const int wn = warp & 3;   // warp's 32-column slice of BN
  const int r0 = blockIdx.x * G::BR;
  const int n0 = blockIdx.y * BN;
  const int ngroups = a.C2 / CG;
  const int nchunks = ngroups * CHUNKS_PER_GROUP;

  // Each transformed row's input offset and how many of its 4 D and 4 H rows exist.
  for (int row = tid; row < G::ZR; row += NTHREADS) {
    const bool s_row = PAIR && row >= G::ZRO;
    int b, dt, ht, w;
    const bool ok = decode(a, r0 + row - (s_row ? G::ZRO : 0), b, dt, ht, w);
    // (constant indices: a dynamically indexed kernel parameter can land in local memory)
    const long long sB = s_row ? a.sB[1] : a.sB[0], sD = s_row ? a.sD[1] : a.sD[0];
    const long long sH = s_row ? a.sH[1] : a.sH[0], sW = s_row ? a.sW[1] : a.sW[0];
    row_off[row] = ok ? b * sB + 2 * dt * sD + 2 * ht * sH + w * sW : 0;
    row_lim[row] = ok ? (min(a.D - 2 * dt, 4) << 4) | min(a.H - 2 * ht, 4) : 0;
  }
  __syncthreads();

  for (int step = 0; step < G::RAW_STEPS; ++step)
    load_raw<PAIR>(a, 0, step, raw, row_off, row_lim, tid);
  cp_async_commit();
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    load_chunk(a, s, n0, ring, tid);
    cp_async_commit();
  }

  float acc[4][2][4][4];
#pragma unroll
  for (int pq = 0; pq < 4; ++pq)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[pq][mt][nt][i] = 0.f;

  int j = 0;  // ring chunk being consumed
  for (int g = 0; g < ngroups; ++g) {
    // Group g's window landed (its pieces rode ring steps at least STAGES
    // old), and every warp is done reading the previous group's points.
    cp_async_wait<STAGES - 1>();
    __syncthreads();
    // ---- BT over D (row u) then over H (rows v), rounding after each axis
    for (int item = tid; item < 4 * G::ZR * (CG / 8); item += NTHREADS) {
      const int q = item % (CG / 8);
      const int row = (item / (CG / 8)) % G::ZR;
      const int u = item / (CG / 8 * G::ZR);
      uint4 xv[4];
#pragma unroll
      for (int hr = 0; hr < 4; ++hr)
        xv[hr] = pm8(raw[((ra(u) * 4 + hr) * G::ZR + row) * (CG / 8) + q],
                     raw[((rb(u) * 4 + hr) * G::ZR + row) * (CG / 8) + q], u == 1);
#pragma unroll
      for (int v = 0; v < 4; ++v)
        *reinterpret_cast<uint4*>(zs + ((u * 4 + v) * G::ZR + row) * ZLD + q * 8) =
            pm8(xv[ra(v)], xv[rb(v)], v == 1);
    }
    // (the first ring step's barrier makes the points visible and frees the window)

    for (int pt = 0; pt < 16; ++pt) {
      float s[2][4][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) s[mt][nt][i] = 0.f;

      const __nv_bfloat16* zp = zs + pt * G::ZR * ZLD;
#pragma unroll
      for (int tap = 0; tap < 2; ++tap, ++j) {
        cp_async_wait<STAGES - 2>();  // chunk j has landed (this thread's part)
        __syncthreads();              // ... everyone's part; stage j-1 is free
        if (j + STAGES - 1 < nchunks) load_chunk(a, j + STAGES - 1, n0, ring, tid);
        const int step = j % CHUNKS_PER_GROUP;
        if (g + 1 < ngroups && step < G::RAW_STEPS)
          load_raw<PAIR>(a, g + 1, step, raw, row_off, row_lim, tid);
        cp_async_commit();

        const __nv_bfloat16* wst = ring + (j % STAGES) * CG * WLD;
#pragma unroll
        for (int kk = 0; kk < CG; kk += 16) {
          uint32_t af[2][4], bfr[4][2];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            ldsm_x4(af[mt],
                    zp + (G::frag_row(wm, mt) + (lane & 15) + tap) * ZLD + kk + (lane >> 4) * 8);
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            uint32_t t4[4];
            ldsm_x4_t(t4, wst + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * WLD + wn * 32 +
                              np * 16 + (lane >> 4) * 8);
            bfr[2 * np][0] = t4[0];
            bfr[2 * np][1] = t4[1];
            bfr[2 * np + 1][0] = t4[2];
            bfr[2 * np + 1][1] = t4[3];
          }
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) mma_bf16(s[mt][nt], af[mt], bfr[nt]);
        }
      }

      // ---- AT folded into the parity accumulators
      const int u = pt >> 2, v = pt & 3;
#pragma unroll
      for (int pq = 0; pq < 4; ++pq) {
        const float coef = at(pq >> 1, u) * at(pq & 1, v);
        if (coef == 0.f) continue;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[pq][mt][nt][i] += coef * s[mt][nt][i];
      }
    }
  }
  cp_async_wait<0>();

  // ---- epilogue: bias (and the pair's c-fold), LeakyReLU, masked stores
  // straight from the fragments.  PAIR stores fragment 0 (x) and reads the
  // same element's s accumulator from fragment 1.
  const int g8 = lane >> 2;
  const int t4 = lane & 3;
#pragma unroll
  for (int mt = 0; mt < (PAIR ? 1 : 2); ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      int b, dt, ht, w;
      const bool ok = decode(a, r0 + G::frag_row(wm, mt) + half * 8 + g8, b, dt, ht, w);
      if (!ok || w >= a.OW) continue;  // past the end, or the dummy last cell
#pragma unroll
      for (int pq = 0; pq < 4; ++pq) {
        const int od = 2 * dt + (pq >> 1);
        const int oh = 2 * ht + (pq & 1);
        if (od >= a.OD || oh >= a.OH) continue;
        const size_t rowi = (((size_t)b * a.OD + od) * a.OH + oh) * a.OW + w;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int col = n0 + wn * 32 + nt * 8 + 2 * t4;
          if (col >= a.F2) continue;
          const float x0 = acc[pq][mt][nt][2 * half];
          const float x1 = acc[pq][mt][nt][2 * half + 1];
          float v0 = x0 + a.bias[col];
          float v1 = x1 + a.bias[col + 1];
          const size_t yi = rowi * a.F2 + col;
          if (PAIR) {
            // dy = conv(s) - c * conv(x), two roundings as the plain version
            float d0 = __fsub_rn(acc[pq][1][nt][2 * half], __fmul_rn(a.c[col], x0));
            float d1 = __fsub_rn(acc[pq][1][nt][2 * half + 1], __fmul_rn(a.c[col + 1], x1));
            if (LEAKY) {
              d0 = v0 > 0.f ? d0 : 0.01f * d0;
              d1 = v1 > 0.f ? d1 : 0.01f * d1;
            }
            store2<OUT_F32>(a.y[1], yi, d0, d1);
          }
          if (LEAKY) {
            v0 = v0 > 0.f ? v0 : 0.01f * v0;
            v1 = v1 > 0.f ? v1 : 0.01f * v1;
          }
          store2<OUT_F32>(a.y[0], yi, v0, v1);
        }
      }
    }
  }
}

template <bool LEAKY, bool OUT_F32, bool PAIR>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using G = Geo<PAIR>;
  auto kern = wino_f23_kernel<LEAKY, OUT_F32, PAIR>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::SMEM_BYTES);
  if (e != cudaSuccess) return e;
  dim3 grid((a.M + G::BR - 1) / G::BR, (a.F2 + BN - 1) / BN);
  kern<<<grid, NTHREADS, G::SMEM_BYTES, stream>>>(a);
  return cudaGetLastError();
}

template <bool PAIR>
int dispatch(Args& a, int B, int D, int H, int WP, int C2, int F2, int leaky, int out_f32,
             void* stream) {
  a.B = B;
  a.D = D;
  a.H = H;
  a.WP = WP;
  a.C2 = C2;
  a.F2 = F2;
  a.OD = D - 2;
  a.OH = H - 2;
  a.OW = WP - 1;
  a.ND = (a.OD + 1) / 2;
  a.NH = (a.OH + 1) / 2;
  a.M = B * a.ND * a.NH * WP;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (leaky)
    e = out_f32 ? launch<true, true, PAIR>(a, st) : launch<true, false, PAIR>(a, st);
  else
    e = out_f32 ? launch<false, true, PAIR>(a, st) : launch<false, false, PAIR>(a, st);
  return (int)e;
}

}  // namespace

// Plain C entry points (bound with ctypes).  Shapes and strides are checked by
// the Python wrappers (ops/winograd_cuda.py: C2 % 32 == 0, F2 % 8 == 0, strides
// of 8 elements); each returns the CUDA error code of the launch (0 = success).
extern "C" int wino_f23_packed(const void* x, const void* wh, const void* bias,
                               void* y, long long sB, long long sD,
                               long long sH, long long sW, int B, int D, int H,
                               int WP, int C2, int F2, int leaky, int out_f32,
                               void* stream) {
  Args a = {};
  a.x[0] = a.x[1] = static_cast<const __nv_bfloat16*>(x);
  a.wh = static_cast<const __nv_bfloat16*>(wh);
  a.bias = static_cast<const float*>(bias);
  a.y[0] = a.y[1] = y;
  a.sB[0] = a.sB[1] = sB;
  a.sD[0] = a.sD[1] = sD;
  a.sH[0] = a.sH[1] = sH;
  a.sW[0] = a.sW[1] = sW;
  return dispatch<false>(a, B, D, H, WP, C2, F2, leaky, out_f32, stream);
}

// The pair: x and s of one shape, each with its own strides; bias and c are
// (F2,) float32 (zeros for the raw per-part form); y and dy contiguous.
extern "C" int wino_f23_pair_packed(const void* x, const void* s, const void* wh,
                                    const void* bias, const void* c, void* y, void* dy,
                                    long long sxB, long long sxD, long long sxH,
                                    long long sxW, long long ssB, long long ssD,
                                    long long ssH, long long ssW, int B, int D, int H,
                                    int WP, int C2, int F2, int leaky, int out_f32,
                                    void* stream) {
  Args a = {};
  a.x[0] = static_cast<const __nv_bfloat16*>(x);
  a.x[1] = static_cast<const __nv_bfloat16*>(s);
  a.wh = static_cast<const __nv_bfloat16*>(wh);
  a.bias = static_cast<const float*>(bias);
  a.c = static_cast<const float*>(c);
  a.y[0] = y;
  a.y[1] = dy;
  a.sB[0] = sxB;
  a.sD[0] = sxD;
  a.sH[0] = sxH;
  a.sW[0] = sxW;
  a.sB[1] = ssB;
  a.sD[1] = ssD;
  a.sH[1] = ssH;
  a.sW[1] = ssW;
  return dispatch<true>(a, B, D, H, WP, C2, F2, leaky, out_f32, stream);
}
