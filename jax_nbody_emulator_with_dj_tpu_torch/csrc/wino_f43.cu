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
// C2, F2) bf16 and re-tiled by ops/winograd43_cuda.py::tile_what; accumulation
// is float32; the epilogue adds a float32 bias and an optional LeakyReLU(0.01)
// before one store in bf16 or float32.
//
// What bounds it on the H100, at C2 = F2 = 128: 270 GFLOP at the phase-3
// shape (1,142,142,71,128) against ~0.7 GB of device-memory traffic, so the
// ideal kernel is bound by the tensor cores (0.27 ms against 0.21 ms).  What
// stands in the way is on the chip, and is what stands in the F(2,3)^2
// kernel's way (wino_f23.cu), each a little worse.  A row's 8 outputs need 8
// float32 accumulators, so a warpgroup's 64-row tile is only 32 channels wide
// (128 registers a thread, 16 more for the product in flight), and a wgmma
// m64n32k16 with both operands in shared memory reads 3 KB per 16 tensor-core
// cycles, half again what shared memory delivers.  A block of two such
// warpgroups covers 64 channels, so at F2 = 128 every input window is loaded
// and transformed twice: 1.4 GB of 64-byte pieces through the load/store path
// at the phase-3 shape, which delivers them no faster than the consumers
// multiply (measured: the loads alone add 0.4 ms to the products' 1.0), and
// BT4 has products by 2, 4 and 5 where F(2,3) has only adds.  AT4's entries
// reach 8, so folding a point's product is up to 8 multiply-adds an element
// (72 a thread on average, about the tensor-core cycles of the point's four
// wgmma).
//
// Design, on wino_f23.cu's frame:
//   * a block's 64 output rows are a patch of 2 x 4 tiles (D x H) x 8 packed-W
//     cells: 4 x 16 outputs in (D, H).  Its input window is 6 x 18 (D, H)
//     rows of 9 cells (8 plus the halo cell of tap a=1).  Patches past the
//     output's edge are masked; nothing is padded;
//   * blocks stay: as many as the card holds (one per SM, shared among the
//     64-column blocks) walk over the patches, so the next patch's window and
//     weights arrive while this one's outputs are stored;
//   * a block is three warpgroups with their registers rebalanced by
//     setmaxnreg (producer 72, consumers 216).  A consumer owns 64 rows x 32
//     channels: eight float32 accumulators and two point products in flight,
//     run as wgmma m64n32k16 with both operands read from shared memory.  A
//     D-point's six H-points go two at a time, (1, 2), (3, 4), (0, 5): one
//     mbarrier wait, one wgmma fence and one wait for the products serve eight
//     wgmma (with four, the waits cost more than the products), and one
//     warpgroup folds a pair while the other's products run;
//   * operands lie in shared memory in wgmma's unswizzled K-major form.  A
//     core matrix is the 8 cells of one tile of the patch, stored with its
//     halo cell behind it (core matrices 144 bytes apart), so packed-W tap
//     a=1 is the same operand 16 bytes further;
//   * the weights are re-tiled on the host (a permutation) into 8 KB pieces,
//     one per (column block, channel group, point) holding both taps, already
//     in that form and in the order the points are taken.  One lane streams
//     them by bulk asynchronous copies into a ring of four stages with
//     full/empty mbarriers; the consumers release a stage when the wgmma
//     group that read it has retired.  No block-wide barrier in the main
//     loop, no bail-out in a wait;
//   * the input goes in channel groups of 32.  A group's window (3888 16-byte
//     pieces) arrives by cp.async into one of two buffers, zero-filled out of
//     range, while the window before it is transformed (a loader keeps its
//     place in a row of the window and steps a pointer from row to row).  The
//     three transform warps take one (tile, cell, 8 channels) at a time, apply
//     BT2 over D to its six H rows and BT4 over H, on packed bf16 pairs, and
//     write the six points of that D-point.  A D-point's six points are a
//     slice (27 KB) of a ring of two with its own full/empty mbarriers, so one
//     slice is written while the other is multiplied;
//   * the epilogue adds the bias and applies LeakyReLU on the fragments;
//     float32 goes out from them, bf16 is staged one output at a time so that
//     each lane stores 16 bytes.
// Roundings match the Pallas kernel and the plain PyTorch version
// (ops/winograd.py::conv3_packed_wino43): BT2 rounds to bf16, every
// operation of BT4 rounds to bf16 in the Pallas body's order (shared sums
// first, then the x2, x4, x5 products as written), everything after the
// products runs in float32 (the fold as one fused multiply-add per product
// and entry of AT4 (x) AT2, whose entries are powers of two).
//
// WINO43_ABLATE (experiments/conv_ablation.py; 0 is the shipped kernel) is a
// mask that leaves out the weight copies (1), the input loads and the
// transform (2; 8: the transform only, 16: the loads only) or the stores (4)
// to time the rest (wrong results).

#include "hopper_common.cuh"

#ifndef WINO43_ABLATE
#define WINO43_ABLATE 0
#endif

namespace {

using namespace hopper;

constexpr int BM = 64;                // output rows ((2,4) tiles at one cell) per block
constexpr int WN = 32;                // output channels per consumer warpgroup
constexpr int BN = 2 * WN;            // ... and per block
constexpr int CG = 32;                // input channels per group
// A block's rows are a patch of TD x TH tiles x TW packed-W cells:
// row = (a * TH + b) * TW + cell.  Eight rows, one tile of the patch, are one
// wgmma core matrix.
constexpr int TD = 2, TH = 4, TW = 8;
static_assert(TD * TH * TW == BM && TW == 8, "a tile's cells are one 8-row core matrix");
constexpr int NU = 4, NV = 6;         // points along D and H
constexpr int SUBS = TD * TH;         // tiles of a patch
constexpr int CELLS = TW + 1;         // input cells of a patch (+ the halo cell of tap a=1)
constexpr int ZR = SUBS * CELLS;      // transformed rows of a point: 72
constexpr int RD = 2 * TD + 2, RH = 4 * TH + 2;  // input rows of a patch's window: 6 x 18
constexpr int NST = 4;                // weight ring stages, one point (both taps) each
constexpr int NZ = 2;                 // ring of transformed slices (one D-point: 6 points)
constexpr int TAP_BYTES = CG * BN * 2;            // 4096
constexpr int STAGE_BYTES = 2 * TAP_BYTES;        // 8192
constexpr int PLANE = ZR * (CG / 8);              // 16-byte pieces of one point: 288
constexpr int PLANE_BYTES = PLANE * 16;           // 4608
constexpr int SLICE_BYTES = NV * PLANE_BYTES;     // 27648
constexpr int ROWP = (CG / 8) * CELLS;            // 16-byte pieces of one (D, H) row of the window
constexpr int RAW_PIECES = RD * RH * ROWP;        // 3888
constexpr int RAW_BYTES = RAW_PIECES * 16;        // 62208
constexpr int NXF = 96;               // transform threads: warps 1-3 of the producer warpgroup
static_assert(PLANE == 3 * NXF, "three units of a D-point per transform thread");
constexpr int NTHREADS = 384;         // producer warpgroup + 2 consumer warpgroups
constexpr int POINTS = NU * NV;       // 24 ring pieces per channel group
static_assert(POINTS % NST == 0 && (POINTS / NST) % 2 == 0,
              "ring stage and parity of a point are compile-time constants");
static_assert(NU % NZ == 0, "a window's D-points fill whole turns of the slice ring");

constexpr int OFF_RING = 0;
constexpr int OFF_RAW = OFF_RING + NST * STAGE_BYTES;
constexpr int OFF_Z = OFF_RAW + 2 * RAW_BYTES;  // two raw windows: one lands while one is read
// the bf16 epilogue stages one of the 8 outputs at a time: per consumer, rows of 32 channels
// + 16 bytes, so that a warp's 8 rows hit 32 banks
constexpr int STAGE_ROW = WN * 2 + 16;
constexpr int OFF_STAGE = OFF_Z + NZ * SLICE_BYTES;
constexpr int OFF_BAR = OFF_STAGE + 2 * BM * STAGE_ROW;
constexpr int SMEM_BYTES = OFF_BAR + (2 * NST + 2 * NZ) * 8;
static_assert(SMEM_BYTES <= SMEM_MAX, "shared memory of one block");

constexpr int REG_PRODUCER = 72;
constexpr int REG_CONSUMER = 216;  // 128 * 72 + 256 * 216 = 64512 = 384 * 168

// Unswizzled K-major operand: 8 rows x 16 bytes per core matrix, rows 16 bytes apart.
constexpr uint32_t SBO_A = CELLS * 16;        // next tile (8 rows, after its halo row)
constexpr uint32_t LBO_A = ZR * 16;           // next 8 channels of the transformed input
constexpr uint32_t SBO_B = 128;               // next 8 output channels
constexpr uint32_t LBO_B = BN * 16;           // next 8 channels of a weight piece

// BT rows of F(2,3): z_k = x[ra(k)] + x[rb(k)] for k == 1, x[ra(k)] - x[rb(k)]
// otherwise.  Functions, not tables, so unrolled loops fold them into constants.
__device__ __forceinline__ constexpr int ra(int k) { return k == 0 ? 0 : (k == 2 ? 2 : 1); }
__device__ __forceinline__ constexpr int rb(int k) { return k == 3 ? 3 : (k == 2 ? 1 : 2); }
// AT rows of F(2,3): output parity p takes point u with sign at2(p, u).
__device__ __forceinline__ constexpr int at2(int p, int u) {
  return p == 0 ? (u == 3 ? 0 : 1) : (u == 0 ? 0 : (u == 1 ? 1 : -1));
}

struct Args {
  const __nv_bfloat16* x;
  const __nv_bfloat16* wt;  // tiled weights: (column block, group, point) pieces of 8 KB
  const float* bias;
  void* y;
  long long sB, sD, sH, sW;  // element strides of x; channels are contiguous
  int B, D, H, WP, C2, F2;
  int OD, OH, OW;
  int NDP, NHQ, NWC;  // patches along D (TD tiles), H (TH tiles) and the packed W (TW cells)
  int NPATCH;         // B * NDP * NHQ * NWC
  int leaky, out_f32;
};

// What a role's patch loop needs of the launch, read where the role starts
// (volatile, so not before): worked out ahead of the roles' branch these
// uniform values outlive the uniform registers and get parked on the stack.
struct Walk {
  int first, step, end;  // this block's patches: first, first + step, ... < end
  int ngroups;           // channel groups of 32
};
__device__ __forceinline__ Walk walk_of(const Args& a) {
  int bx, gx, npatch = a.NPATCH, c2 = a.C2;
  asm volatile("mov.u32 %0, %%ctaid.x;\n" : "=r"(bx));
  asm volatile("mov.u32 %0, %%nctaid.x;\n" : "=r"(gx));
  asm volatile("" : "+r"(npatch), "+r"(c2));
  return Walk{bx, gx, npatch, c2 / CG};
}

// Patch t -> batch element and the patch's first D-tile, H-tile and cell.
__device__ __forceinline__ void patch_origin(const Args& a, int t, int& b, int& dt0, int& ht0,
                                             int& w0) {
  w0 = (t % a.NWC) * TW;
  t /= a.NWC;
  ht0 = (t % a.NHQ) * TH;
  t /= a.NHQ;
  dt0 = (t % a.NDP) * TD;
  b = t / a.NDP;
}

// ---- the weight lane: piece j of this block's stream (a point's two taps)
// goes to ring stage j % NST once both consumers have released it.
__device__ __forceinline__ void stream_weights(const Args& a, uint32_t smem, int npieces) {
  const char* src = reinterpret_cast<const char*>(a.wt) + (size_t)blockIdx.y * npieces * STAGE_BYTES;
  const uint32_t full_w = smem + OFF_BAR, empty_w = full_w + NST * 8;
  for (int j = 0; j < npieces; ++j) {
    const int s = j % NST;
    mbar_wait(empty_w + s * 8, ((j / NST) & 1) ^ 1);
    if (WINO43_ABLATE & 1) {
      mbar_arrive(full_w + s * 8);
      continue;
    }
    mbar_expect_tx(full_w + s * 8, STAGE_BYTES);
    bulk_copy(smem + OFF_RING + s * STAGE_BYTES, src + (size_t)j * STAGE_BYTES, STAGE_BYTES,
              full_w + s * 8);
  }
}

// ---- the producer warpgroup's three transform warps.  As loaders they
// share a window's 3888 16-byte pieces, 8 channels of one input cell each, 64
// bytes of a cell from neighbouring lanes; the window lies in shared memory as
// [D row][H row][8-channel step][cell].  As transformers thread tp owns units
// tp + 96 j of a D-point's 288, in the order [8-channel step][tile][cell] that
// wgmma reads.
__device__ __forceinline__ void produce_points(const Args& a, uint32_t smem, int tp,
                                               const Walk& wk) {
  const uint32_t full_z = smem + OFF_BAR + 2 * NST * 8, empty_z = full_z + NZ * 8;
  const __nv_bfloat16* xin = a.x;
  const long long sD = a.sD, sH = a.sH, sW = a.sW;
  // the patch whose window is being loaded: its origin, and the rows and cells
  // of its window that exist
  const __nv_bfloat16* src = xin;
  int lim_d = 0, lim_h = 0, lim_w = 0;
  auto aim = [&](int w) {
    int b, dt0, ht0, w0;
    patch_origin(a, w, b, dt0, ht0, w0);
    src = xin + b * a.sB + 2 * dt0 * sD + 4 * ht0 * sH + w0 * sW;
    lim_d = min(a.D - 2 * dt0, RD);
    lim_h = min(a.H - 4 * ht0, RH);
    lim_w = min(a.WP - w0, CELLS);
  };

  // As a loader a thread keeps its place in a (D, H) row of the window (cell, 8-channel step)
  // and takes every ROWS-th row, so a piece costs a pointer step and two compares.
  constexpr int ROWS = NXF / ROWP;  // rows in flight over the loaders: 2 (72 of the 96 threads)
  const int rem = tp % ROWP, row0 = tp / ROWP;
  const int cell = rem >> 2, q = rem & 3;
  auto load_raw = [&](int g, int buf) {  // group g's window of the aimed patch
    if (WINO43_ABLATE & (2 | 16)) return;
    if (row0 < ROWS) {
      const bool ok_w = cell < lim_w;
      int dr = row0 / RH, hr = row0 % RH;
      uint32_t dst = smem + OFF_RAW + buf * RAW_BYTES + ((row0 * (CG / 8) + q) * CELLS + cell) * 16;
      const __nv_bfloat16* p = src + g * CG + dr * sD + hr * sH + cell * sW + q * 8;
#pragma unroll 1
      for (int row = row0; row < RD * RH; row += ROWS) {
        const bool ok = ok_w && dr < lim_d && hr < lim_h;
        cp_async16(dst, ok ? p : xin, ok);
        dst += ROWS * ROWP * 16;
        p += ROWS * sH;
        hr += ROWS;
        if (hr >= RH) {
          hr -= RH;
          ++dr;
          p += sD - RH * sH;
        }
      }
    }
    cp_async_commit();
  };

  // unit t of a D-point's 288: where the window's first (D, H) rows have its tile and cell
  auto raw_of = [](int t) {
    const int uq = t / ZR, sc = t - uq * ZR;
    const int sub = sc / CELLS, ucell = sc - sub * CELLS;
    return ((2 * (sub / TH) * RH + 4 * (sub % TH)) * (CG / 8) + uq) * CELLS + ucell;
  };

  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint4* zp = reinterpret_cast<uint4*>(smem_raw + OFF_Z);

  unsigned n = 0;  // windows so far: window n lies in raw buffer n % 2, its D-point u is slice 4 n + u
  for (int w = wk.first; w < wk.end; w += wk.step) {
    if (w == wk.first) {  // (else the patch before this one has started it)
      aim(w);
      load_raw(0, n & 1);
    }
    for (int g = 0; g < wk.ngroups; ++g, ++n) {
      cp_async_wait_all();
      // window n is in, and nobody still reads the one before it
      bar_sync(1, NXF);
      if (g + 1 < wk.ngroups) {
        load_raw(g + 1, (n + 1) & 1);
      } else if (w + wk.step < wk.end) {  // the next patch's first window
        aim(w + wk.step);
        load_raw(0, (n + 1) & 1);
      }
      const uint4* rawp = reinterpret_cast<const uint4*>(smem_raw + OFF_RAW + (n & 1) * RAW_BYTES);
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        const unsigned zn = NU * n + u;
        const unsigned zs = zn % NZ;
        mbar_wait(empty_z + zs * 8, ((zn / NZ) & 1) ^ 1);
        if (!(WINO43_ABLATE & (2 | 8))) {
          uint4* zslot = zp + zs * (SLICE_BYTES / 16);
#pragma unroll 1
          for (int j = 0; j < 3; ++j) {
            // BT2 over D: the D-transformed window rows g0 g1 g2 g3 g0n g1n of this tile
            const uint4* rawj = rawp + raw_of(tp + NXF * j);
            uint4 g6[NV];
#pragma unroll
            for (int hr = 0; hr < NV; ++hr) {
              const uint4 xa = rawj[(ra(u) * RH + hr) * ROWP];
              const uint4 xb = rawj[(rb(u) * RH + hr) * ROWP];
              g6[hr] = u == 1 ? add8(xa, xb) : sub8(xa, xb);
            }
            // BT4 over H, in the Pallas body's order
            const uint4 s12p = add8(g6[1], g6[2]);
            const uint4 s12m = sub8(g6[1], g6[2]);
            const uint4 s13m2 = mul8(2.f, sub8(g6[1], g6[3]));
            const uint4 t02 = sub8(g6[4], g6[2]);
            uint4* zo = zslot + tp + NXF * j;
            zo[0 * PLANE] = add8(sub8(mul8(4.f, g6[0]), mul8(5.f, g6[2])), g6[4]);
            zo[1 * PLANE] = sub8(add8(g6[4], g6[3]), mul8(4.f, s12p));
            zo[2 * PLANE] = add8(sub8(g6[4], g6[3]), mul8(4.f, s12m));
            zo[3 * PLANE] = sub8(t02, s13m2);
            zo[4 * PLANE] = add8(t02, s13m2);
            zo[5 * PLANE] = add8(sub8(mul8(4.f, g6[1]), mul8(5.f, g6[3])), g6[5]);
          }
          fence_async_smem();  // the consumers read the slice through the async proxy
        }
        mbar_arrive(full_z + zs * 8);
      }
    }
  }
}

// A D-point's six H-points are multiplied two at a time, in the order (1, 2),
// (3, 4), (0, 5), the pairs whose columns of AT4 differ in signs only: one wait
// serves eight wgmma.  The weight pieces are stored in that order
// (ops/winograd43_cuda.py::TiledWhat.V_ORDER).
__device__ __forceinline__ constexpr int pair_v(int k, int second) {
  return k == 2 ? (second ? 5 : 0) : 2 * k + 1 + second;
}

// AT4 (x) AT2 fold of the products sa, sb of pair K of D-point U into the
// eight output accumulators [D parity p * 4 + H slot q].  AT4's columns are
// v=1: [1 1 1 1], v=2: [1 -1 1 -1]; v=3: [1 2 4 8], v=4: [1 -2 4 -8]; v=0:
// [1 0 0 0], v=5: [0 0 0 1].
template <int U, int K>
__device__ __forceinline__ void fold_pair(float (&acc)[8][16], const float (&sa)[16],
                                          const float (&sb)[16]) {
  // (one chain of two multiply-adds per entry, no sums kept aside: with the pair's sum and
  // difference in registers of their own ptxas spills)
  constexpr float w1 = K == 1 ? 2.f : 1.f, w2 = K == 1 ? 4.f : 1.f, w3 = K == 1 ? 8.f : 1.f;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const float c = (float)at2(p, U);
    if (c == 0.f) continue;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      if (K == 2) {
        acc[4 * p + 0][i] = fmaf(c, sa[i], acc[4 * p + 0][i]);
        acc[4 * p + 3][i] = fmaf(c, sb[i], acc[4 * p + 3][i]);
      } else {
        acc[4 * p + 0][i] = fmaf(c, sb[i], fmaf(c, sa[i], acc[4 * p + 0][i]));
        acc[4 * p + 1][i] = fmaf(-w1 * c, sb[i], fmaf(w1 * c, sa[i], acc[4 * p + 1][i]));
        acc[4 * p + 2][i] = fmaf(w2 * c, sb[i], fmaf(w2 * c, sa[i], acc[4 * p + 2][i]));
        acc[4 * p + 3][i] = fmaf(-w3 * c, sb[i], fmaf(w3 * c, sa[i], acc[4 * p + 3][i]));
      }
    }
  }
}

// The product of H-point V of the slice at da_slice with piece PT of the weight
// stream: 2 taps x 2 k-steps of 16 channels into s.
template <int V, int PT>
__device__ __forceinline__ void multiply_point(float (&s)[16], uint64_t da_slice, uint64_t db_wg) {
#pragma unroll
  for (int tap = 0; tap < 2; ++tap)
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const uint64_t da = da_slice + ((V * PLANE_BYTES + tap * 16 + k * 2 * (int)LBO_A) >> 4);
      const uint64_t db =
          db_wg + (((PT % NST) * STAGE_BYTES + tap * TAP_BYTES + k * 2 * (int)LBO_B) >> 4);
      wgmma_m64n32k16(s, da, db, (tap | k) != 0);
    }
}

// Pair J = 3 U + K of a channel group: the products of its two points (each 2
// taps x 2 k-steps of 16 channels) into sa and sb, then, once their ring
// stages and (after a D-point's last pair) the slice they read are released,
// the fold.
template <int J>
__device__ __forceinline__ void consume_pair(float (&acc)[8][16], float (&sa)[16],
                                             float (&sb)[16], uint32_t smem, uint64_t da_slice,
                                             uint64_t db_wg, bool elected, unsigned& zrel) {
  const uint32_t full_w = smem + OFF_BAR, empty_w = full_w + NST * 8;
  const uint32_t empty_z = smem + OFF_BAR + 2 * NST * 8 + NZ * 8;
  constexpr int U = J / 3, K = J % 3;
#pragma unroll
  for (int second = 0; second < 2; ++second) {
    constexpr int pt = 2 * J;  // the pair's place in the weight stream
    mbar_wait(full_w + ((pt + second) % NST) * 8, ((pt + second) / NST) & 1);
  }
  wgmma_fence();
  multiply_point<pair_v(K, 0), 2 * J>(sa, da_slice, db_wg);
  multiply_point<pair_v(K, 1), 2 * J + 1>(sb, da_slice, db_wg);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sa);
  fence_regs(sb);
  if (elected) {
    mbar_arrive(empty_w + ((2 * J) % NST) * 8);
    mbar_arrive(empty_w + ((2 * J + 1) % NST) * 8);
    if (K == 2) mbar_arrive(empty_z + (zrel % NZ) * 8);
  }
  if (K == 2) ++zrel;
  fold_pair<U, K>(acc, sa, sb);
}

__global__ void __launch_bounds__(NTHREADS, 1) wino_f43_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t smem = smem_u32(smem_raw);
  const int tid = threadIdx.x;
  // (through a shuffle, so that the compiler knows it uniform over the warp and keeps what
  // derives from it, the weight descriptors, in uniform registers)
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);

  if (tid == 0) {
    const uint32_t bar = smem + OFF_BAR;
    for (int s = 0; s < NST; ++s) {
      mbar_init(bar + s * 8, 1);                   // full_w: the weight lane's expect_tx
      mbar_init(bar + (NST + s) * 8, 2);           // empty_w: both consumer warpgroups
    }
    for (int s = 0; s < NZ; ++s) {
      mbar_init(bar + (2 * NST + s) * 8, NXF);     // full_z: the transform threads
      mbar_init(bar + (2 * NST + NZ + s) * 8, 2);  // empty_z: both consumer warpgroups
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // ================= producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REG_PRODUCER));
    const Walk wk = walk_of(a);
    const int wt = tid & 127;
    if (wt >= 32) {
      produce_points(a, smem, wt - 32, wk);
    } else if (tid == 0) {
      for (int w = wk.first; w < wk.end; w += wk.step)  // the same pieces for every patch
        stream_weights(a, smem, wk.ngroups * POINTS);
    }
  } else {
    // ================= consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REG_CONSUMER));
    const Walk wk = walk_of(a);
    const int cw = wg - 1;           // this warpgroup's 32-column half
    const bool elected = (tid & 127) == 0;
    const uint32_t full_z = smem + OFF_BAR + 2 * NST * 8;
    const uint64_t db_wg = make_desc(smem + OFF_RING + cw * WN * 16, LBO_B, SBO_B);
    const uint64_t da_z = make_desc(smem + OFF_Z, LBO_A, SBO_A);

    unsigned zn = 0, zrel = 0;  // slices waited for, and released: slice n is in slot n % NZ
    for (int w = wk.first; w < wk.end; w += wk.step) {
      float acc[8][16];
#pragma unroll
      for (int pq = 0; pq < 8; ++pq)
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[pq][i] = 0.f;
      float sa[16], sb[16];
      uint64_t da = 0;  // the slice in use
      for (int g = 0; g < wk.ngroups; ++g) {
        // D-point u's slice is waited for just before its first pair
#define WINO43_DPOINT(U)                                          \
  mbar_wait(full_z + (zn % NZ) * 8, (zn / NZ) & 1);               \
  da = da_z + (((zn % NZ) * SLICE_BYTES) >> 4);                   \
  ++zn;                                                           \
  consume_pair<3 * U + 0>(acc, sa, sb, smem, da, db_wg, elected, zrel); \
  consume_pair<3 * U + 1>(acc, sa, sb, smem, da, db_wg, elected, zrel); \
  consume_pair<3 * U + 2>(acc, sa, sb, smem, da, db_wg, elected, zrel);
        WINO43_DPOINT(0)
        WINO43_DPOINT(1)
        WINO43_DPOINT(2)
        WINO43_DPOINT(3)
#undef WINO43_DPOINT
      }

      // ---- epilogue: bias and LeakyReLU on the fragments.  float32 goes out
      // straight from them (a quad's float2s fill a 32-byte sector); bf16 is
      // staged, one of the 8 outputs at a time, so that each lane stores 16
      // bytes of a row.  (This thread's place is worked out here, not before
      // the main loop, where it would hold registers.)
      const int n0 = blockIdx.y * BN;
      const int g8 = (tid & 31) >> 2;
      const int t4 = tid & 3;
      const int wrow = ((tid >> 5) & 3) * 16;
      const int wt = tid & 127;
      const bool leaky = a.leaky != 0;
      const bool f32 = a.out_f32 != 0;
      unsigned char* stage = smem_raw + OFF_STAGE + cw * BM * STAGE_ROW;
      float bv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = n0 + cw * WN + (i >> 1) * 8 + 2 * t4 + (i & 1);
        bv[i] = col < a.F2 ? a.bias[col] : 0.f;
      }
      const bool no_store = (WINO43_ABLATE & 4) && a.B >= 0;
      int pb, dt0, ht0, w0;
      patch_origin(a, w, pb, dt0, ht0, w0);
      // row r of the block: tile r / 8 = (D-tile r / 32, H-tile r / 8 % 4), cell r % 8
      auto out_row = [&](int r, int pq, size_t& rowi) {
        const int od = 2 * (dt0 + r / (TH * TW)) + (pq >> 2);
        const int oh = 4 * (ht0 + r / TW % TH) + (pq & 3);
        const int ow = w0 + r % TW;
        rowi = (((size_t)pb * a.OD + od) * a.OH + oh) * a.OW + ow;
        return !no_store && od < a.OD && oh < a.OH && ow < a.OW;
      };
#pragma unroll
      for (int pq = 0; pq < 8; ++pq) {
        if (f32) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            size_t rowi;
            const bool rok = out_row(wrow + half * 8 + g8, pq, rowi);
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              const int col = n0 + cw * WN + nt * 8 + 2 * t4;
              const float o0 = bias_act(acc[pq][nt * 4 + 2 * half], bv[2 * nt], leaky);
              const float o1 = bias_act(acc[pq][nt * 4 + 2 * half + 1], bv[2 * nt + 1], leaky);
              if (rok && col < a.F2)
                *reinterpret_cast<float2*>(static_cast<float*>(a.y) + rowi * a.F2 + col) =
                    make_float2(o0, o1);
            }
          }
        } else {
#pragma unroll
          for (int half = 0; half < 2; ++half)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              const float o0 = bias_act(acc[pq][nt * 4 + 2 * half], bv[2 * nt], leaky);
              const float o1 = bias_act(acc[pq][nt * 4 + 2 * half + 1], bv[2 * nt + 1], leaky);
              *reinterpret_cast<__nv_bfloat162*>(stage + (wrow + half * 8 + g8) * STAGE_ROW +
                                                 (nt * 8 + 2 * t4) * 2) =
                  __floats2bfloat162_rn(o0, o1);
            }
          bar_sync(3 + cw, 128);  // each warpgroup stages and reads back its own 32 columns
#pragma unroll
          for (int pass = 0; pass < 2; ++pass) {
            const int piece = wt + 128 * pass;
            const int row = piece >> 2, c8 = piece & 3;
            const int col = n0 + cw * WN + c8 * 8;
            size_t rowi;
            const bool ok = out_row(row, pq, rowi) && col < a.F2;
            const uint4 v = *reinterpret_cast<const uint4*>(stage + row * STAGE_ROW + c8 * 16);
            if (ok)
              *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(a.y) + rowi * a.F2 + col) = v;
          }
          bar_sync(3 + cw, 128);  // the output is out of the staging rows
        }
      }
    }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  Shapes and strides are checked by
// the Python wrapper (ops/winograd43_cuda.py: C2 % 32 == 0, F2 % 8 == 0,
// strides of 8 elements; wt from tile_what); returns the CUDA error code of the
// launch (0 = success).
extern "C" int wino_f43_packed(const void* x, const void* wt, const void* bias, void* y,
                               long long sB, long long sD, long long sH, long long sW, int B,
                               int D, int H, int WP, int C2, int F2, int leaky, int out_f32,
                               void* stream) {
  Args a = {};
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.wt = static_cast<const __nv_bfloat16*>(wt);
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
  a.NDP = (a.OD + 2 * TD - 1) / (2 * TD);
  a.NHQ = (a.OH + 4 * TH - 1) / (4 * TH);
  a.NWC = (a.OW + TW - 1) / TW;
  a.NPATCH = B * a.NDP * a.NHQ * a.NWC;
  a.leaky = leaky;
  a.out_f32 = out_f32;
  auto kern = wino_f43_kernel;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  // Blocks stay and walk over the patches: as many as the card holds at once
  // (one block per SM), shared among the 64-column blocks.
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int nb = (F2 + BN - 1) / BN;
  int blocks = sms / nb;
  blocks = blocks < 1 ? 1 : (blocks > a.NPATCH ? a.NPATCH : blocks);
  wino_f43_kernel<<<dim3(blocks, nb), NTHREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
