// Mixed F(2,3) x F(4,3) Winograd packed 3x3x3 conv (+bias, +LeakyReLU) for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel B3 of jax_nbody_emulator_with_dj_tpu/ops/
// winograd43_pallas.py: conv3d_wino43_pallas_packed (body _wino43_kernel).
// It computes the VALID 3x3x3 conv in the W-parity packed layout, x (B, D, H,
// WP, C2) bf16 -> y (B, D-2, H-2, WP-1, F2), with F(2,3) over D and F(4,3)
// over H: a (2, 4) output tile at one packed-W cell costs 24 point products
// (4 along D x 6 along H, the two packed-W taps summed exactly) instead of 72
// tap products, a third of the direct conv's multiplies.  Weights come
// pre-transformed by ops/winograd.py::transform_packed_w3_mixed as (4, 6, 2,
// C2, F2) bf16; accumulation is float32; the epilogue adds a float32 bias and
// an optional LeakyReLU(0.01) before one store in bf16 or float32.
//
// What bounds it on the H100, at C2 = F2 = 128: 270 GFLOP at the phase-3
// shape (1,142,142,71,128) against ~0.7 GB of device-memory traffic, so the
// ideal kernel is bound by the tensor cores (0.27 ms against 0.21 ms).  In
// the way stand the same three things as for the F(2,3)^2 kernel
// (wino_f23.cu), each a little worse: a tile's 8 outputs need 8 float32
// accumulators per output row, so a block of 8 warps holds only 32 rows x 128
// channels (128 registers a thread) and streams the 1.5 MB of transformed
// weights from L2 once per 32 rows (~8 GB at the phase-3 shape); AT's
// entries reach 8, so folding one point product into the accumulators is up
// to 8 multiply-adds where F(2,3)^2 has 4 adds; and the H transform has
// products by 2, 4 and 5 where F(2,3) has only adds.
//
// Design (simple and right first), following wino_f23.cu:
//   * the output rows are flattened over (B, D-tile, H-tile, cell) with the
//     cell running over all WP input cells (the last one a dummy row that is
//     never stored), so tap a=1 of row r is the transformed input of row r+1;
//   * one block = 32 such rows x 128 output channels, 8 warps (2 along M x 4
//     along N) of 16 x 32 on mma.sync m16n8k16 tiles fed by ldmatrix, each
//     holding the 8 output accumulators plus one point product;
//   * the input channels go in groups of 32.  A group's raw window (4 D x 6 H
//     rows x 33 flat rows -- BH + 2 input rows, not the BH + 4 the TPU
//     kernel's reshape wanted) arrives by cp.async while the previous group's
//     products run; out-of-range reads are zero-filled.  The block applies
//     BT2 over D and BT4 over H, shared memory to shared memory on packed
//     bf16 pairs, then runs the group's 24 point products;
//   * the transformed weights stream through the 4-stage cp.async ring of
//     32-row x 128-column chunks, running ahead across points and groups;
//   * AT4 (x) AT2 is folded into the 8 accumulators as each point's partial
//     product completes; the epilogue stores each thread's column pairs,
//     masking output rows past D-2 (odd extents) and H-2 (not multiples of 4).
// Roundings match the Pallas kernel and the plain PyTorch version
// (ops/winograd.py::conv3_packed_wino43): BT2 rounds to bf16, every
// operation of BT4 rounds to bf16 in the Pallas body's order (shared sums
// first, then the x2, x4, x5 products as written), everything after the
// products runs in float32.

#include "mma_common.cuh"

namespace {

using namespace convk;

constexpr int ZLD = CG + 8;          // transformed-input row stride in bf16 (80 B)
constexpr int NU = 4, NV = 6;        // points along D and H
constexpr int CHUNKS_PER_GROUP = NU * NV * 2;  // points x packed-W taps
constexpr int BR = 32;               // flat output rows per block
constexpr int ZR = BR + 1;           // transformed rows (+ the halo row of tap a=1)
constexpr int RAW_SEGS = NU * NV * ZR * (CG / 8);  // 16-byte pieces of a window (4 D x 6 H rows)
constexpr int RAW_STEPS = (RAW_SEGS + NTHREADS - 1) / NTHREADS;
static_assert(RAW_STEPS + STAGES <= CHUNKS_PER_GROUP, "window must land before its group");
constexpr size_t ZS_BYTES = (size_t)NU * NV * ZR * ZLD * 2;
constexpr size_t RAW_BYTES = (size_t)RAW_SEGS * 16;
constexpr size_t ROWS_BYTES = (size_t)ZR * 12;
constexpr size_t SMEM_BYTES = RING_BYTES + ZS_BYTES + RAW_BYTES + ROWS_BYTES;

// BT rows of F(2,3): z_k = x[ra(k)] + x[rb(k)] for k == 1, x[ra(k)] - x[rb(k)] otherwise.
__device__ __forceinline__ int ra(int k) { return k == 0 ? 0 : (k == 2 ? 2 : 1); }
__device__ __forceinline__ int rb(int k) { return k == 3 ? 3 : (k == 2 ? 1 : 2); }
// AT rows of F(2,3): output parity p takes point u with sign at2(p, u).
__device__ __forceinline__ float at2(int p, int u) {
  if (p == 0) return u == 3 ? 0.f : 1.f;
  return u == 0 ? 0.f : (u == 1 ? 1.f : -1.f);
}
// AT rows of F(4,3): [1 1 1 1 1 0; 0 1 -1 2 -2 0; 0 1 1 4 4 0; 0 1 -1 8 -8 1].
__device__ __forceinline__ float at4(int q, int v) {
  if (v == 0) return q == 0 ? 1.f : 0.f;
  if (v == 5) return q == 3 ? 1.f : 0.f;
  const float base = (v <= 2 ? 1.f : 2.f) * ((v & 1) ? 1.f : -1.f);
  float r = 1.f;
  for (int i = 0; i < q; ++i) r *= base;
  return r;
}

struct Args {
  const __nv_bfloat16* x;
  const __nv_bfloat16* wh;
  const float* bias;
  void* y;
  long long sB, sD, sH, sW;  // element strides of x; channels are contiguous
  int B, D, H, WP, C2, F2;
  int OD, OH, OW;
  int ND, NH;  // Winograd tiles along D (2 outputs) and H (4 outputs)
  int M;       // flat rows: B * ND * NH * WP
  int leaky, out_f32;
};

// 8 bf16 lanes: x + y, x - y, c * x, each correctly rounded to bf16.
__device__ __forceinline__ uint4 add8(const uint4& x, const uint4& y) {
  const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&y);
  uint4 out;
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i] = __hadd2(a[i], b[i]);
  return out;
}
__device__ __forceinline__ uint4 sub8(const uint4& x, const uint4& y) {
  const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&y);
  uint4 out;
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i] = __hsub2(a[i], b[i]);
  return out;
}
__device__ __forceinline__ uint4 mul8(float c, const uint4& x) {
  const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162 c2 = __float2bfloat162_rn(c);
  uint4 out;
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i] = __hmul2(c2, a[i]);
  return out;
}

// Flat row r -> (b, D-tile, H-tile, cell); false past the last row.
__device__ __forceinline__ bool decode(const Args& a, int r, int& b, int& dt, int& ht, int& w) {
  w = r % a.WP;
  int t = r / a.WP;
  ht = t % a.NH;
  t /= a.NH;
  dt = t % a.ND;
  b = t / a.ND;
  return r < a.M;
}

// Piece `step` of channel group g's raw window: raw[(dr*6 + hr)*ZR + row][CG].
__device__ __forceinline__ void load_raw(const Args& a, int g, int step, uint4* raw,
                                         const long long* row_off, const int* row_lim, int tid) {
  const int seg = step * NTHREADS + tid;
  if (seg >= RAW_SEGS) return;
  const int q = seg % (CG / 8);
  const int row = (seg / (CG / 8)) % ZR;
  const int dh = seg / (CG / 8 * ZR);
  const int dr = dh / NV, hr = dh % NV;
  const int lim = row_lim[row];
  const bool ok = dr < (lim >> 4) && hr < (lim & 15);
  const __nv_bfloat16* src = a.x + row_off[row] + dr * a.sD + hr * a.sH + g * CG + q * 8;
  cp_async16(raw + seg, ok ? src : a.x, ok);
}

__global__ void __launch_bounds__(NTHREADS, 1) wino_f43_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* zs = reinterpret_cast<__nv_bfloat16*>(smem_raw + RING_BYTES);
  uint4* raw = reinterpret_cast<uint4*>(smem_raw + RING_BYTES + ZS_BYTES);
  long long* row_off = reinterpret_cast<long long*>(smem_raw + RING_BYTES + ZS_BYTES + RAW_BYTES);
  int* row_lim = reinterpret_cast<int*>(row_off + ZR);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp >> 2;  // warp's 16 of the block's 32 rows
  const int wn = warp & 3;   // warp's 32-column slice of BN
  const int r0 = blockIdx.x * BR;
  const int n0 = blockIdx.y * BN;
  const int ngroups = a.C2 / CG;
  const int nchunks = ngroups * CHUNKS_PER_GROUP;

  // Each transformed row's input offset and how many of its 4 D and 6 H rows exist.
  for (int row = tid; row < ZR; row += NTHREADS) {
    int b, dt, ht, w;
    const bool ok = decode(a, r0 + row, b, dt, ht, w);
    row_off[row] = ok ? b * a.sB + 2 * dt * a.sD + 4 * ht * a.sH + w * a.sW : 0;
    row_lim[row] = ok ? (min(a.D - 2 * dt, NU) << 4) | min(a.H - 4 * ht, NV) : 0;
  }
  __syncthreads();

  for (int step = 0; step < RAW_STEPS; ++step) load_raw(a, 0, step, raw, row_off, row_lim, tid);
  cp_async_commit();
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    load_wchunk(a.wh + (size_t)s * a.C2 * a.F2, 0, a.F2, n0, ring + s * CG * WLD, tid);
    cp_async_commit();
  }

  float acc[8][4][4];  // [D parity p * 4 + H slot q][n8 tile][fragment element]
#pragma unroll
  for (int pq = 0; pq < 8; ++pq)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[pq][nt][i] = 0.f;

  int j = 0;  // ring chunk being consumed
  for (int g = 0; g < ngroups; ++g) {
    // Group g's window landed (its pieces rode ring steps at least STAGES
    // old), and every warp is done reading the previous group's points.
    cp_async_wait<STAGES - 1>();
    __syncthreads();
    // ---- BT2 over D (row u), then BT4 over H (rows v)
    for (int item = tid; item < NU * ZR * (CG / 8); item += NTHREADS) {
      const int q = item % (CG / 8);
      const int row = (item / (CG / 8)) % ZR;
      const int u = item / (CG / 8 * ZR);
      uint4 g6[NV];  // the D-transformed window rows g0 g1 g2 g3 g0n g1n
#pragma unroll
      for (int hr = 0; hr < NV; ++hr) {
        const uint4& xa = raw[((ra(u) * NV + hr) * ZR + row) * (CG / 8) + q];
        const uint4& xb = raw[((rb(u) * NV + hr) * ZR + row) * (CG / 8) + q];
        g6[hr] = u == 1 ? add8(xa, xb) : sub8(xa, xb);
      }
      const uint4 s12p = add8(g6[1], g6[2]);
      const uint4 s12m = sub8(g6[1], g6[2]);
      const uint4 s13m2 = mul8(2.f, sub8(g6[1], g6[3]));
      const uint4 t02 = sub8(g6[4], g6[2]);
      uint4 z[NV];
      z[0] = add8(sub8(mul8(4.f, g6[0]), mul8(5.f, g6[2])), g6[4]);
      z[1] = sub8(add8(g6[4], g6[3]), mul8(4.f, s12p));
      z[2] = add8(sub8(g6[4], g6[3]), mul8(4.f, s12m));
      z[3] = sub8(t02, s13m2);
      z[4] = add8(t02, s13m2);
      z[5] = add8(sub8(mul8(4.f, g6[1]), mul8(5.f, g6[3])), g6[5]);
#pragma unroll
      for (int v = 0; v < NV; ++v)
        *reinterpret_cast<uint4*>(zs + ((u * NV + v) * ZR + row) * ZLD + q * 8) = z[v];
    }
    // (the first ring step's barrier makes the points visible and frees the window)

    for (int pt = 0; pt < NU * NV; ++pt) {
      float s[1][4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[0][nt][i] = 0.f;

      const __nv_bfloat16* zp = zs + pt * ZR * ZLD;
#pragma unroll
      for (int tap = 0; tap < 2; ++tap, ++j) {
        cp_async_wait<STAGES - 2>();  // chunk j has landed (this thread's part)
        __syncthreads();              // ... everyone's part; stage j-1 is free
        const int jn = j + STAGES - 1;
        if (jn < nchunks)
          load_wchunk(a.wh + (size_t)(jn % CHUNKS_PER_GROUP) * a.C2 * a.F2,
                      (jn / CHUNKS_PER_GROUP) * CG, a.F2, n0, ring + (jn % STAGES) * CG * WLD,
                      tid);
        const int step = j % CHUNKS_PER_GROUP;
        if (g + 1 < ngroups && step < RAW_STEPS)
          load_raw(a, g + 1, step, raw, row_off, row_lim, tid);
        cp_async_commit();

        mma_chunk<1>(s, zp + (wm * 16 + (lane & 15) + tap) * ZLD + (lane >> 4) * 8, 0,
                     ring + (j % STAGES) * CG * WLD, lane, wn);
      }

      // ---- AT4 (x) AT2 folded into the 8 output accumulators
      const int u = pt / NV, v = pt % NV;
#pragma unroll
      for (int pq = 0; pq < 8; ++pq) {
        const float coef = at2(pq >> 2, u) * at4(pq & 3, v);
        if (coef == 0.f) continue;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[pq][nt][i] += coef * s[0][nt][i];
      }
    }
  }
  cp_async_wait<0>();

  // ---- epilogue: bias, LeakyReLU, masked stores straight from the fragments
  const int g8 = lane >> 2;
  const int t4 = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    int b, dt, ht, w;
    const bool ok = decode(a, r0 + wm * 16 + half * 8 + g8, b, dt, ht, w);
    if (!ok || w >= a.OW) continue;  // past the end, or the dummy last cell
#pragma unroll
    for (int pq = 0; pq < 8; ++pq) {
      const int od = 2 * dt + (pq >> 2);
      const int oh = 4 * ht + (pq & 3);
      if (od >= a.OD || oh >= a.OH) continue;
      const size_t rowi = (((size_t)b * a.OD + od) * a.OH + oh) * a.OW + w;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = n0 + wn * 32 + nt * 8 + 2 * t4;
        if (col >= a.F2) continue;
        finish2(a.y, rowi * a.F2 + col, acc[pq][nt][2 * half], acc[pq][nt][2 * half + 1],
                a.bias[col], a.bias[col + 1], a.leaky, a.out_f32);
      }
    }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  Shapes and strides are checked by
// the Python wrapper (ops/winograd43_cuda.py: C2 % 32 == 0, F2 % 8 == 0,
// strides of 8 elements); returns the CUDA error code of the launch (0 = success).
extern "C" int wino_f43_packed(const void* x, const void* wh, const void* bias, void* y,
                               long long sB, long long sD, long long sH, long long sW, int B,
                               int D, int H, int WP, int C2, int F2, int leaky, int out_f32,
                               void* stream) {
  Args a = {};
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.wh = static_cast<const __nv_bfloat16*>(wh);
  a.bias = static_cast<const float*>(bias);
  a.y = y;
  a.sB = sB;
  a.sD = sD;
  a.sH = sH;
  a.sW = sW;
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
  a.NH = (a.OH + 3) / 4;
  a.M = B * a.ND * a.NH * WP;
  a.leaky = leaky;
  a.out_f32 = out_f32;
  auto kern = wino_f43_kernel;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.M + BR - 1) / BR, (F2 + BN - 1) / BN);
  kern<<<grid, NTHREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
