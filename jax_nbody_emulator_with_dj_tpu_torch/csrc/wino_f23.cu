// F(2,3)^2 Winograd packed 3x3x3 conv (+bias, +LeakyReLU) for Hopper (sm_90a),
// and its fused factored-tangent pair.
//
// Replaces two Pallas TPU kernels of jax_nbody_emulator_with_dj_tpu/ops/winograd_pallas.py:
//   B1 conv3d_wino_pallas_packed      (body _wino_kernel, block planner _pick_block)
//   B2 conv3d_wino_pallas_pair_packed (body _wino_pair_kernel)
// B1 computes a VALID 3x3x3 conv in the W-parity packed layout, x (B, D, H,
// WP, C2) bf16 -> y (B, D-2, H-2, WP-1, F2), Winograd F(2,3) over (D, H) with
// the two packed-W taps summed exactly, weights pre-transformed by
// ops/winograd.py::transform_packed_w3 as (4, 4, 2, C2, F2) bf16 and re-tiled
// by ops/winograd_cuda.py::tile_wh, float32 accumulation, and an epilogue
// adding a float32 bias and an optional LeakyReLU(0.01) before one store in
// bf16 or float32.  B2 runs the same conv on two inputs x and s of one shape
// (any two sets of strides) against the same weights, and from the two
// float32 accumulators stores
//   y = conv(x, W) + b,   dy = conv(s, W) - c (.) conv(x, W),
// with, when leaky, dy scaled by 0.01 wherever the float32 y <= 0 and then y
// too: the velocity layers' factored tangent (models/blocks.py::_wino_conv_pair).
//
// What bounds it on the H100, at C2 = F2 = 128 (every interior conv of the
// 64-channel model).  Each output row -- one 2x2 (D, H) tile at one packed-W
// cell -- costs 16 point products of K = 2*C2 = 256 by F2 = 128: 1.05 MFLOP,
// 2.25x fewer than the 18-tap direct conv, ~360 GFLOP at the phase-3 tile
// shape (1,142,142,71,128) against ~0.7 GB of device-memory traffic, so the
// ideal kernel is bound by the tensor cores.  What stands in the way is on
// the chip.  The four output parities of a row need float32 accumulators, so
// a block's tile cannot exceed 64 rows x 128 channels (half the register
// file); a warpgroup's share of it is a 64 x 64 wgmma, which reads 4 KB of
// shared memory per 32 tensor-core cycles, all that shared memory delivers,
// and AT costs ~72 adds a thread for every point.  Every tile needs all 1 MB
// of transformed weights from L2 (~5.7 GB at the phase-3 shape) and its
// input window in 64-byte pieces, which the load/store path brings in far
// more slowly than bulk copies bring the weights.  mma.sync, which moves
// both operands through registers, a block-wide barrier per ring step, an
// input transform between two barriers and a fresh block per tile (the first
// version of this kernel) left the tensor cores idle most of the time.
//
// Design:
//   * a block's 64 output rows are a patch of 2 x 4 Winograd tiles (D x H)
//     x 8 packed-W cells.  The patch's input window is 6 x 10 (D, H) rows of
//     9 cells (8 plus the halo cell of tap a=1): 540 cell pieces per channel
//     group where 64 cells of one tile would need 1040.  Patches past the
//     output's edge are masked; nothing is padded;
//   * blocks stay: as many as the card holds (one per SM) walk over the
//     patches, so the next patch's window and weights arrive while this
//     one's outputs are stored, and no tile pays a launch and a cold start;
//   * a block is three warpgroups with their registers rebalanced by
//     setmaxnreg (producer 72, consumers 216).  Two consumer warpgroups own
//     64 rows x 64 channels each: four float32 parity accumulators and the
//     point product in flight (160 registers a thread), issued as wgmma
//     m64n64k16 with both operands read from shared memory; one warpgroup
//     folds a point while the other's products run.  (A second product in
//     flight per warpgroup, WINO_INFLIGHT=2, gains nothing.)  The producer
//     warpgroup never touches a product: one of its warps streams the
//     weights, three bring the input in and transform it;
//   * operands lie in shared memory in wgmma's unswizzled K-major form: 8-row
//     x 16-byte core matrices.  A core matrix is the 8 cells of one tile of
//     the patch, stored with its halo cell behind it (core matrices 144 bytes
//     apart), so packed-W tap a=1 is the same operand with its start address
//     16 bytes further: no second copy of the transformed input;
//   * the weights are re-tiled on the host (a permutation, done once where
//     the model packs them) into 8 KB pieces, one per (column block, channel
//     group, point, tap), already in that form.  A piece arrives by one bulk
//     asynchronous copy that completes on its ring stage's `full` mbarrier;
//     the consumers release a stage on its `empty` mbarrier when the wgmma
//     group that read it has retired.  There is no block-wide barrier in the
//     main loop, and no bail-out in a wait: a trap there makes ptxas hold the
//     consumers to the launch's 168 registers and spill the accumulators;
//   * the blocks of a cluster share the weight stream: each block fetches its
//     share of a piece and multicasts it into every block's ring, and a
//     stage's `empty` barrier collects the consumers of all blocks.  B2 runs
//     so (below).  B1 runs with one block per cluster: the bulk copies hide
//     the L2 stream almost fully, and a cluster's lock step costs what the
//     halved stream saves (WINO_CLUSTER_B1 = 2, 4 to re-measure);
//   * the input goes in channel groups of 32.  A group's window arrives by
//     cp.async, 16 bytes a lane (no TMA box follows a patch with ragged
//     edges without a tensor map, and 64-byte bulk copies are far slower);
//     out-of-range reads are zero-filled, so ragged D, H and W edges cost the
//     caller nothing.  There are two window buffers, so the next window
//     lands while this one is read.  The producer applies BT on packed bf16
//     pairs one D-point at a time (a slice of 4 points, 18 KB) into a ring of
//     four slices with its own full/empty mbarriers, so the transform of one
//     slice runs under the products of the slices before it;
//   * the epilogue adds the bias and applies LeakyReLU on the fragments;
//     float32 goes out from them (a quad's float2s fill a sector), bf16 is
//     staged one parity at a time so that each lane stores 16 bytes;
//   * the pair (B2) is the same kernel over a cluster of two blocks that take
//     the same patch of x and of s.  Both run B1's main loop off one
//     multicast weight stream (1 MB per patch of the pair); then, between two
//     cluster barriers, the x block writes its float32 accumulators of output
//     parities 2, 3 into the s block's idle slice ring and the s block its
//     parities 0, 1 into the x block's (fragment order, so thread t of one
//     reads what thread t of the other wrote), and each block stores y and dy
//     of its two parities from float32 values: the c-fold and the LeakyReLU
//     mask see no rounding.  The two inputs keep their own strides (x is
//     often a view of a padded level buffer, s a fresh tensor).
// Roundings match the Pallas kernels and the plain PyTorch versions
// (ops/winograd.py::conv3_packed_wino, conv3_packed_wino_pair): the BT
// transform rounds to bf16 after the D axis and again after the H axis;
// everything after runs in float32.
//
// Compile-time knobs for experiments/wino_ablation.py (defaults are the
// shipped kernel): WINO_CLUSTER_B1 / WINO_CLUSTER_B2, blocks per cluster;
// WINO_INFLIGHT, point products in flight per warpgroup, with
// WINO_REG_PRODUCER / WINO_REG_CONSUMER; and WINO_ABLATE, a mask that leaves
// out the weight copies (1), the input loads and the transform (2; 8: the
// transform only, 16: the loads only) or the stores (4) to time the rest
// (wrong results).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#ifndef WINO_CLUSTER_B1
#define WINO_CLUSTER_B1 1
#endif
#ifndef WINO_CLUSTER_B2
#define WINO_CLUSTER_B2 2
#endif
#ifndef WINO_ABLATE
#define WINO_ABLATE 0
#endif

namespace {

constexpr int BM = 64;                // output rows (2x2 tiles at one cell) per block
constexpr int BN = 128;               // output channels per block: 2 consumer warpgroups x 64
constexpr int CG = 32;                // input channels per group
// A block's rows are a patch of TD x TH Winograd tiles x TW packed-W cells:
// row = (a * TH + b) * TW + cell.  Eight rows, one (D-tile, H-tile) of the
// patch, are one wgmma core matrix.
constexpr int TD = 2, TH = 4, TW = 8;
static_assert(TD * TH * TW == BM && TW == 8, "a sub-tile's cells are one 8-row core matrix");
constexpr int SUBS = TD * TH;         // sub-tiles of a patch
constexpr int CELLS = TW + 1;         // input cells of a patch (+ the halo cell of tap a=1)
constexpr int ZR = SUBS * CELLS;      // transformed rows of a point: 72
constexpr int RD = 2 * TD + 2, RH = 2 * TH + 2;  // input rows of a patch's window: 6 x 10
constexpr int NST = 8;                // weight ring stages, one (point, tap) piece each
constexpr int NZ = 4;                 // ring of transformed slices (4 points each)
static_assert((NZ & (NZ - 1)) == 0, "a slice's slot and phase are bit fields of its count");
constexpr int STAGE_BYTES = CG * BN * 2;          // 8192
constexpr int PLANE = ZR * (CG / 8);              // 16-byte pieces of one point: 288
constexpr int PLANE_BYTES = PLANE * 16;           // 4608
constexpr int SLICE_BYTES = 4 * PLANE_BYTES;      // 18432
constexpr int ROWP = (CG / 8) * CELLS;            // 16-byte pieces of one (D, H) row of the window
constexpr int RAW_PIECES = RD * RH * ROWP;        // 2160
constexpr int RAW_BYTES = RAW_PIECES * 16;        // 34560
constexpr int NTHREADS = 384;         // producer warpgroup + 2 consumer warpgroups
constexpr int NXF = 96;               // transform threads: warps 1-3 of the producer warpgroup
static_assert(PLANE == 3 * NXF, "three pieces of a point per transform thread");
constexpr int CHUNKS_PER_GROUP = 32;  // points x packed-W taps
static_assert(CHUNKS_PER_GROUP % NST == 0 && (CHUNKS_PER_GROUP / NST) % 2 == 0,
              "ring stage and parity of a piece are compile-time constants");

constexpr int OFF_RING = 0;
constexpr int OFF_RAW = OFF_RING + NST * STAGE_BYTES;
constexpr int OFF_Z = OFF_RAW + 2 * RAW_BYTES;  // two raw windows: one lands while one is read
// the bf16 epilogue stages one output parity at a time: rows of 128 channels + 16 bytes, so a
// warp's 8 rows hit 32 banks
constexpr int STAGE_ROW = BN * 2 + 16;
constexpr int OFF_STAGE = OFF_Z + NZ * SLICE_BYTES;
constexpr int OFF_BAR = OFF_STAGE + BM * STAGE_ROW;
constexpr int SMEM_BYTES = OFF_BAR + (2 * NST + 2 * NZ) * 8;
// the pair's hand-over: 2 parities x 64 rows x 128 channels of float32 over the idle slice
// ring, which only the block's own transform warps fill (peers multicast into the weight
// ring whenever its stages are free, and the next patch's window lands meanwhile)
constexpr int OFF_HAND = OFF_Z;
static_assert(2 * BM * BN * 4 <= NZ * SLICE_BYTES, "hand-over buffer must fit the slice ring");
static_assert(SMEM_BYTES <= 232448, "shared memory of one block");

#ifndef WINO_REG_PRODUCER
#define WINO_REG_PRODUCER 72
#define WINO_REG_CONSUMER 216
#endif
#ifndef WINO_INFLIGHT
#define WINO_INFLIGHT 1
#endif
constexpr int REG_PRODUCER = WINO_REG_PRODUCER;
constexpr int REG_CONSUMER = WINO_REG_CONSUMER;  // 128 * 72 + 256 * 216 = 64512 = 384 * 168
constexpr int INFLIGHT = WINO_INFLIGHT;

// Unswizzled K-major operand: 8 rows x 16 bytes per core matrix, rows 16 bytes apart.
constexpr uint32_t SBO_A = CELLS * 16;        // next sub-tile (8 rows, after its halo row)
constexpr uint32_t LBO_A = ZR * 16;           // next 8 channels of the transformed input
constexpr uint32_t SBO_B = 128;               // next 8 output channels
constexpr uint32_t LBO_B = BN * 16;           // next 8 channels of a weight piece

// BT rows of F(2,3): z_k = x[ra(k)] + x[rb(k)] for k == 1, x[ra(k)] - x[rb(k)]
// otherwise.  Functions, not tables, so unrolled loops fold them into constants.
__device__ __forceinline__ constexpr int ra(int k) { return k == 0 ? 0 : (k == 2 ? 2 : 1); }
__device__ __forceinline__ constexpr int rb(int k) { return k == 3 ? 3 : (k == 2 ? 1 : 2); }
// AT rows of F(2,3): output parity p takes point k with sign at(p, k).
__device__ __forceinline__ constexpr int at(int p, int k) {
  return p == 0 ? (k == 3 ? 0 : 1) : (k == 0 ? 0 : (k == 1 ? 1 : -1));
}

template <int V>
struct Int {  // a compile-time int as an argument
  static constexpr int value = V;
};

struct Args {
  const __nv_bfloat16* x[2];  // x, and s for the pair
  const __nv_bfloat16* wt;    // tiled weights: (column block, group, point, tap) pieces of 8 KB
  const float* bias;
  const float* c;             // the pair's fold vector
  void* y[2];                 // y, and dy for the pair
  long long sB[2], sD[2], sH[2], sW[2];  // element strides of x and s; channels are contiguous
  int B, D, H, WP, C2, F2;
  int OD, OH, OW;
  int NDP, NHQ, NWC;  // patches along D (TD tiles), H (TH tiles) and the packed W (TW cells)
  int NPATCH;         // B * NDP * NHQ * NWC
  int leaky, out_f32;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Arrive on the barrier at the same offset in block `rank` of the cluster.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, uint32_t rank) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(bar), "r"(rank)
      : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// Wait for the phase of parity `parity` to complete.  (No bail-out: a trap in
// this loop makes ptxas hold the consumers to the registers of the launch,
// whatever setmaxnreg grants them, and spill the accumulators.)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- copies
// 16-byte async copy; zero-fills the destination when !pred.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// Bulk copy global -> shared, completing `bytes` on `bar`; with CL > 1 into
// the same offsets of every block of the cluster.
template <int CL>
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  if constexpr (CL == 1) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
            "r"(dst),
        "l"(src), "r"(bytes), "r"(bar)
        : "memory");
  } else {
    const uint16_t mask = (uint16_t)((1u << CL) - 1);
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
        "[%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
        "l"(src), "r"(bytes), "r"(bar), "h"(mask)
        : "memory");
  }
}

// ---- cluster
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void st_cluster_f4(uint32_t local_addr, uint32_t rank, float v0,
                                              float v1, float v2, float v3) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "st.shared::cluster.v4.f32 [remote], {%2, %3, %4, %5};\n"
      "}\n" ::"r"(local_addr),
      "r"(rank), "f"(v0), "f"(v1), "f"(v2), "f"(v3)
      : "memory");
}

// What a role's patch loop needs of the launch, read where the role starts
// (volatile, so not before): worked out ahead of the roles' branch these
// uniform values outlive the uniform registers and get parked on the stack.
struct Walk {
  int first, step, end;  // this cluster's work items: first, first + step, ... < end
  int ngroups;           // channel groups of 32
  uint32_t rank;         // this block in its cluster
};
template <int CL, int TILES>
__device__ __forceinline__ Walk walk_of(const Args& a) {
  int bx, gx, npatch = a.NPATCH, c2 = a.C2;
  asm volatile("mov.u32 %0, %%ctaid.x;\n" : "=r"(bx));
  asm volatile("mov.u32 %0, %%nctaid.x;\n" : "=r"(gx));
  asm volatile("" : "+r"(npatch), "+r"(c2));
  return Walk{bx / CL, gx / CL, (npatch + TILES - 1) / TILES, c2 / CG,
              CL > 1 ? cluster_rank() : 0};
}

// ---- wgmma
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads of an accumulator across a wgmma wait.
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// d (64 x 64, float32) = or += A (64 x 16 bf16, shared) * B (16 x 64 bf16, shared).
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da, uint64_t db,
                                                int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
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

// Patch t -> batch element and the patch's first D-tile, H-tile and cell;
// false past the last patch (a cluster's surplus block).
__device__ __forceinline__ bool patch_origin(const Args& a, int t, int& b, int& dt0, int& ht0,
                                            int& w0) {
  w0 = (t % a.NWC) * TW;
  t /= a.NWC;
  ht0 = (t % a.NHQ) * TH;
  t /= a.NHQ;
  dt0 = (t % a.NDP) * TD;
  b = t / a.NDP;
  return b < a.B;
}

// ---- the producer warpgroup's weight warp (one lane): piece j of this
// block's stream goes to ring stage j % NST once every consumer of the
// cluster has released it; with CL > 1 this block fetches its 1/CL of the
// piece and multicasts it.
template <int CL>
__device__ __forceinline__ void stream_weights(const Args& a, uint32_t smem, uint32_t rank,
                                               int nchunks) {
  const char* src = reinterpret_cast<const char*>(a.wt) +
                    (size_t)blockIdx.y * nchunks * STAGE_BYTES + rank * (STAGE_BYTES / CL);
  const uint32_t full_w = smem + OFF_BAR, empty_w = full_w + NST * 8;
  for (int j = 0; j < nchunks; ++j) {
    const int s = j % NST;
    mbar_wait(empty_w + s * 8, ((j / NST) & 1) ^ 1);
    if (WINO_ABLATE & 1) {
      mbar_arrive(full_w + s * 8);
      continue;
    }
    mbar_expect_tx(full_w + s * 8, STAGE_BYTES);
    bulk_copy<CL>(smem + OFF_RING + s * STAGE_BYTES + rank * (STAGE_BYTES / CL),
                  src + (size_t)j * STAGE_BYTES, STAGE_BYTES / CL, full_w + s * 8);
  }
}

// The pair's hand-over lies over a block's slice ring.  Between two patches
// every thread of the cluster passes the two cluster barriers around it; the
// transform warps then wait (barrier 5) until the block's consumers have read
// the hand-over before they write the next patch's first slice.
__device__ __forceinline__ void pair_patch_end_producer() {
  cluster_arrive();
  cluster_wait();
  cluster_arrive();
  cluster_wait();
}

// ---- the producer warpgroup's three transform warps.  As loaders they
// share a window's 2160 16-byte pieces, piece i = tp + 96 k being 8 channels
// of one input cell, 64 bytes of a cell from neighbouring lanes; the window
// lies in shared memory as [D row][H row][8-channel step][cell].  As
// transformers thread tp owns pieces tp + 96 j of a point's 288, in the order
// [8-channel step][sub-tile][cell] that wgmma reads.
template <bool PAIR>
__device__ __forceinline__ void produce_points(const Args& a, uint32_t smem,
                                               const __nv_bfloat16* xin, long long sB,
                                               long long sD, long long sH, long long sW,
                                               int wfirst, int wstep, int nwork, int tiles,
                                               int sub, int tp, int ngroups) {
  const uint32_t full_z = smem + OFF_BAR + 2 * NST * 8, empty_z = full_z + NZ * 8;
  // the patch whose window is being loaded: its origin, and the rows and cells
  // of its window that exist (0 for a surplus block: all zero-filled)
  const __nv_bfloat16* src = xin;
  int lim_d = 0, lim_h = 0, lim_w = 0;
  auto aim = [&](int w) {
    int b, dt0, ht0, w0;
    const bool live = patch_origin(a, w * tiles + sub, b, dt0, ht0, w0);
    src = xin + (live ? b * sB + 2 * dt0 * sD + 2 * ht0 * sH + w0 * sW : 0);
    lim_d = live ? min(a.D - 2 * dt0, RD) : 0;
    lim_h = live ? min(a.H - 2 * ht0, RH) : 0;
    lim_w = live ? min(a.WP - w0, CELLS) : 0;
  };

  // piece tp of the window: its (D, H) row and its place in that row
  const int dh_first = tp / ROWP, rem_first = tp - dh_first * ROWP;
  auto load_raw = [&](int g, int buf) {  // group g's window of the aimed patch
    if (WINO_ABLATE & (2 | 16)) return;
    const uint32_t dst = smem + OFF_RAW + buf * RAW_BYTES;
    const __nv_bfloat16* srcg = src + g * CG;
    int dr = 0, hr = dh_first, rem = rem_first;  // (dh_first < RH: NXF < RH * ROWP)
#pragma unroll 1
    for (int i = tp; i < RAW_PIECES; i += NXF) {
      const int cell = rem >> 2, q = rem & 3;
      const bool ok = dr < lim_d && hr < lim_h && cell < lim_w;
      cp_async16(dst + (((dr * RH + hr) * (CG / 8) + q) * CELLS + cell) * 16,
                 ok ? srcg + dr * sD + hr * sH + cell * sW + q * 8 : xin, ok);
      rem += NXF % ROWP;  // the next piece: NXF further
      hr += NXF / ROWP;
      if (rem >= ROWP) {
        rem -= ROWP;
        ++hr;
      }
      if (hr >= RH) {
        hr -= RH;
        ++dr;
      }
    }
    cp_async_commit();
  };

  // this thread's three pieces of a point: where the window's first (D, H) row has them
  int raw0[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int t = tp + NXF * j;
    const int q = t / ZR, sc = t - q * ZR;
    const int sub = sc / CELLS, cell = sc - sub * CELLS;
    raw0[j] = ((2 * (sub / TH) * RH + 2 * (sub % TH)) * (CG / 8) + q) * CELLS + cell;
  }

  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint4* zp = reinterpret_cast<uint4*>(smem_raw + OFF_Z);

  unsigned zn = 0;      // slices so far: slice n goes to slot n % NZ, free at the start
  int n = 0;            // windows so far: window n lies in raw buffer n % 2
  for (int w = wfirst; w < nwork; w += wstep) {
    if (w == wfirst) {  // (else the patch before this one has started it)
      aim(w);
      load_raw(0, n & 1);
    }
    for (int g = 0; g < ngroups; ++g, ++n) {
      cp_async_wait_all();
      // window n is in, and nobody still reads the one before it
      asm volatile("bar.sync 1, %0;\n" ::"n"(NXF) : "memory");
      if (g + 1 < ngroups) {
        load_raw(g + 1, (n + 1) & 1);
      } else if (w + wstep < nwork) {  // the next patch's first window
        aim(w + wstep);
        load_raw(0, (n + 1) & 1);
      }
      if (PAIR && g == 0 && w != wfirst)  // the last patch's hand-over is read
        asm volatile("bar.sync 5, %0;\n" ::"n"(NXF + 256) : "memory");
      const uint4* rawp = reinterpret_cast<const uint4*>(smem_raw + OFF_RAW + (n & 1) * RAW_BYTES);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const unsigned zs = zn % NZ;
        mbar_wait(empty_z + zs * 8, ((zn / NZ) & 1) ^ 1);
        ++zn;
        if (!(WINO_ABLATE & (2 | 8))) {
          uint4* zslot = zp + zs * (SLICE_BYTES / 16);
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            uint4 xv[4];
#pragma unroll
            for (int hr = 0; hr < 4; ++hr)
              xv[hr] = pm8(rawp[raw0[j] + (ra(u) * RH + hr) * ROWP],
                           rawp[raw0[j] + (rb(u) * RH + hr) * ROWP], u == 1);
#pragma unroll
            for (int v = 0; v < 4; ++v)
              zslot[v * PLANE + tp + NXF * j] = pm8(xv[ra(v)], xv[rb(v)], v == 1);
          }
          // the consumers read the slice through the async proxy
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        }
        mbar_arrive(full_z + zs * 8);
      }
    }
    if (PAIR) pair_patch_end_producer();
  }
}

// AT fold of point PT's product into the four parity accumulators.
template <int PT>
__device__ __forceinline__ void fold(float (&acc)[4][32], const float (&s)[32]) {
#pragma unroll
  for (int pq = 0; pq < 4; ++pq) {
    constexpr int u = PT >> 2, v = PT & 3;
    const int coef = at(pq >> 1, u) * at(pq & 1, v);
    if (coef == 0) continue;
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[pq][i] = coef > 0 ? acc[pq][i] + s[i] : acc[pq][i] - s[i];
  }
}

// Release what point PT's product read: its two ring stages, in every block
// of the cluster, and after a slice's last point the slice's slot.
template <int PT, int CL>
__device__ __forceinline__ void release(uint32_t smem, bool elected, unsigned& zrel) {
  if (!elected) return;
  const uint32_t empty_w = smem + OFF_BAR + NST * 8;
  const uint32_t empty_z = smem + OFF_BAR + 2 * NST * 8 + NZ * 8;
#pragma unroll
  for (int tap = 0; tap < 2; ++tap) {
    const uint32_t bar = empty_w + ((2 * PT + tap) % NST) * 8;
    if (CL == 1) {
      mbar_arrive(bar);
    } else {
#pragma unroll
      for (int r = 0; r < CL; ++r) mbar_arrive_cluster(bar, r);
    }
  }
  if ((PT & 3) == 3) {
    mbar_arrive(empty_z + (zrel % NZ) * 8);
    ++zrel;
  }
}

// Issue point PT's product (2 taps x 2 k-steps of 16 channels) into s.
template <int PT>
__device__ __forceinline__ void issue(float (&s)[32], uint32_t smem, uint64_t da_slice,
                                      uint64_t db_wg) {
  const uint32_t full_w = smem + OFF_BAR;
  constexpr int v = PT & 3;
  wgmma_fence();
#pragma unroll
  for (int tap = 0; tap < 2; ++tap) {
    const int piece = 2 * PT + tap;
    mbar_wait(full_w + (piece % NST) * 8, (piece / NST) & 1);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const uint64_t da = da_slice + ((v * PLANE_BYTES + tap * 16 + k * 2 * LBO_A) >> 4);
      const uint64_t db = db_wg + (((piece % NST) * STAGE_BYTES + k * 2 * LBO_B) >> 4);
      wgmma_m64n64k16(s, da, db, (tap | k) != 0);
    }
  }
  wgmma_commit();
}

template <int PT, int CL>
__device__ __forceinline__ void consume_point(float (&acc)[4][32], float (&s_new)[32],
                                              float (&s_old)[32], uint32_t smem,
                                              uint64_t da_slice, uint64_t db_wg, bool elected,
                                              unsigned& zrel) {
  issue<PT>(s_new, smem, da_slice, db_wg);
  if constexpr (INFLIGHT == 1) {
    wgmma_wait<0>();
    fence_regs(s_new);
    release<PT, CL>(smem, elected, zrel);
    fold<PT>(acc, s_new);
  } else {
    if constexpr (PT > 0) {  // the point before, under this one's products
      wgmma_wait<1>();
      fence_regs(s_old);
      release<PT - 1, CL>(smem, elected, zrel);
      fold<PT - 1>(acc, s_old);
    }
    if constexpr (PT == 15) {  // a group ends drained
      wgmma_wait<0>();
      fence_regs(s_new);
      release<PT, CL>(smem, elected, zrel);
      fold<PT>(acc, s_new);
    }
  }
}

template <bool PAIR, int CL>
__global__ void __launch_bounds__(NTHREADS, 1) wino_f23_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t smem = smem_u32(smem_raw);
  const int tid = threadIdx.x;
  // (through a shuffle, so that the compiler knows it uniform over the warp and keeps what
  // derives from it, the weight descriptors, in uniform registers)
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  constexpr int TILES = PAIR ? CL / 2 : CL;  // patches per cluster and work item
  // Blocks stay: cluster c takes work items c, c + clusters, ... (walk_of).  An item's
  // last patches may lie past the end: such a block runs on zeros and stores nothing.
  const int n0 = blockIdx.y * BN;

  if (tid == 0) {
    const uint32_t bar = smem + OFF_BAR;
    for (int s = 0; s < NST; ++s) {
      mbar_init(bar + s * 8, 1);                        // full_w: the weight warp's expect_tx
      mbar_init(bar + (NST + s) * 8, 2 * CL);           // empty_w: every consumer warpgroup
    }
    for (int s = 0; s < NZ; ++s) {
      mbar_init(bar + (2 * NST + s) * 8, NXF);          // full_z: the transform threads
      mbar_init(bar + (2 * NST + NZ + s) * 8, 2);       // empty_z: this block's consumers
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (CL > 1) {  // no block copies into, or arrives on, a peer that has not initialised
    cluster_arrive();
    cluster_wait();
  }

  if (wg == 0) {
    // ================= producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REG_PRODUCER));
    const Walk wk = walk_of<CL, TILES>(a);
    const int wfirst = wk.first, wstep = wk.step, nwork = wk.end, ngroups = wk.ngroups;
    // The pair: neighbouring blocks take x (role 0) and s (role 1) of one patch.
    const uint32_t rank = wk.rank;
    const int role = PAIR ? (rank & 1) : 0;
    const int sub = PAIR ? rank >> 1 : rank;  // this block's patch of a work item
    if (tid < 32) {
      for (int w = wfirst; w < nwork; w += wstep) {  // the same pieces for every patch
        if (tid == 0) stream_weights<CL>(a, smem, rank, ngroups * CHUNKS_PER_GROUP);
        __syncwarp();
        if (PAIR) pair_patch_end_producer();
      }
    } else {
      // (constant indices: a dynamically indexed kernel parameter can land in local memory)
      const bool s_in = role != 0;
      produce_points<PAIR>(a, smem, s_in ? a.x[1] : a.x[0], s_in ? a.sB[1] : a.sB[0],
                           s_in ? a.sD[1] : a.sD[0], s_in ? a.sH[1] : a.sH[0],
                           s_in ? a.sW[1] : a.sW[0], wfirst, wstep, nwork, TILES, sub, tid - 32,
                           ngroups);
    }
    if (CL > 1 && !PAIR) {  // stay until every peer is done with this block's barriers
      cluster_arrive();
      cluster_wait();
    }
  } else {
    // ================= consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REG_CONSUMER));
    const Walk wk = walk_of<CL, TILES>(a);
    const int wfirst = wk.first, wstep = wk.step, nwork = wk.end, ngroups = wk.ngroups;
    // The pair: neighbouring blocks take x (role 0) and s (role 1) of one patch.
    const uint32_t rank = wk.rank;
    const int role = PAIR ? (rank & 1) : 0;
    const int sub = PAIR ? rank >> 1 : rank;  // this block's patch of a work item
    const int cw = wg - 1;           // this warpgroup's 64-column half
    const int ctid = tid - 128;      // 0..255 over both consumer warpgroups
    const bool elected = (tid & 127) == 0;
    const uint32_t full_z = smem + OFF_BAR + 2 * NST * 8;
    const uint64_t db_wg = make_desc(smem + OFF_RING + cw * 64 * 16, LBO_B, SBO_B);
    const uint64_t da_z = make_desc(smem + OFF_Z, LBO_A, SBO_A);

    unsigned zn = 0, zrel = 0;  // slices waited for, and released: slice n is in slot n % NZ
    for (int w = wfirst; w < nwork; w += wstep) {
      float acc[4][32];
#pragma unroll
      for (int pq = 0; pq < 4; ++pq)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[pq][i] = 0.f;
      float s0[32];
#if WINO_INFLIGHT == 2
      float s1[32];
#else
      float(&s1)[32] = s0;
#endif
      uint64_t da = 0;  // the slice in use
      for (int g = 0; g < ngroups; ++g) {
        // slice u = PT / 4 is waited for just before its first point
#define WINO_SLICE(u)                                           \
  mbar_wait(full_z + (zn % NZ) * 8, (zn / NZ) & 1);             \
  da = da_z + (((zn % NZ) * SLICE_BYTES) >> 4);                 \
  ++zn;
#define WINO_POINT(PT, SN, SO) \
  consume_point<PT, CL>(acc, SN, SO, smem, da, db_wg, elected, zrel);
        WINO_SLICE(0)
        WINO_POINT(0, s0, s1)
        WINO_POINT(1, s1, s0)
        WINO_POINT(2, s0, s1)
        WINO_POINT(3, s1, s0)
        WINO_SLICE(1)
        WINO_POINT(4, s0, s1)
        WINO_POINT(5, s1, s0)
        WINO_POINT(6, s0, s1)
        WINO_POINT(7, s1, s0)
        WINO_SLICE(2)
        WINO_POINT(8, s0, s1)
        WINO_POINT(9, s1, s0)
        WINO_POINT(10, s0, s1)
        WINO_POINT(11, s1, s0)
        WINO_SLICE(3)
        WINO_POINT(12, s0, s1)
        WINO_POINT(13, s1, s0)
        WINO_POINT(14, s0, s1)
        WINO_POINT(15, s1, s0)
#undef WINO_SLICE
#undef WINO_POINT
      }

      // ---- the pair's hand-over, once every block of the cluster is past its
      // main loop (no copy in flight, no operand still read): the x block
      // sends conv(x) of output parities 2, 3 to the s block and gets conv(s)
      // of parities 0, 1, so each block holds both float32 accumulators of
      // two parities and stores y and dy of those.
      if (PAIR) {
        cluster_arrive();
        cluster_wait();
        auto send = [&](auto first) {  // (a constant: the accumulators stay in registers)
#pragma unroll
          for (int k = 0; k < 16; ++k) {
            constexpr int base = decltype(first)::value;
            st_cluster_f4(smem + OFF_HAND + (k * 256 + ctid) * 16, rank ^ 1,
                          acc[base + (k >> 3)][(k & 7) * 4], acc[base + (k >> 3)][(k & 7) * 4 + 1],
                          acc[base + (k >> 3)][(k & 7) * 4 + 2],
                          acc[base + (k >> 3)][(k & 7) * 4 + 3]);
          }
        };
        if (role)
          send(Int<0>{});
        else
          send(Int<2>{});
        cluster_arrive();
        cluster_wait();
      }

      // ---- epilogue: bias, the pair's c-fold and mask from the float32 y,
      // LeakyReLU, on the fragments.  float32 goes out straight from them (a
      // quad's float2s fill a 32-byte sector); bf16 is staged, one output
      // parity at a time, so that each lane stores 16 bytes of a row.
      // (This thread's place is worked out here, not before the main loop,
      // where it would hold registers.)
      const int g8 = (tid & 31) >> 2;
      const int t4 = tid & 3;
      const int wrow = ((tid >> 5) & 3) * 16;
      const int wt = tid & 127;
      const bool leaky = a.leaky != 0;
      const bool f32 = a.out_f32 != 0;
      const float4* hand = reinterpret_cast<const float4*>(smem_raw + OFF_HAND);
      unsigned char* stage = smem_raw + OFF_STAGE;
      float bv[16], cv[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int col = n0 + cw * 64 + (i >> 1) * 8 + 2 * t4 + (i & 1);
        bv[i] = col < a.F2 ? a.bias[col] : 0.f;
        cv[i] = PAIR && col < a.F2 ? a.c[col] : 0.f;
      }
      // the element at (parity pq, column pair nt, row half): y, or the pair's dy
      auto finish = [&](int pq, bool want_dy, int nt, int half, float& o0, float& o1) {
        float x0 = acc[pq][nt * 4 + 2 * half];
        float x1 = acc[pq][nt * 4 + 2 * half + 1];
        float s0v = 0.f, s1v = 0.f;
        if (PAIR) {  // the other accumulator of the same element, from the peer
          const float4 pv = hand[((pq & 1) * 8 + nt) * 256 + ctid];
          const float p0 = half ? pv.z : pv.x;
          const float p1 = half ? pv.w : pv.y;
          if (role == 0) {
            s0v = p0;
            s1v = p1;
          } else {
            s0v = x0;
            s1v = x1;
            x0 = p0;
            x1 = p1;
          }
        }
        const float y0 = x0 + bv[2 * nt];
        const float y1 = x1 + bv[2 * nt + 1];
        if (PAIR && want_dy) {
          // dy = conv(s) - c * conv(x), two roundings as the plain version
          o0 = __fsub_rn(s0v, __fmul_rn(cv[2 * nt], x0));
          o1 = __fsub_rn(s1v, __fmul_rn(cv[2 * nt + 1], x1));
          if (leaky) {
            o0 = y0 > 0.f ? o0 : 0.01f * o0;
            o1 = y1 > 0.f ? o1 : 0.01f * o1;
          }
        } else {
          o0 = leaky && !(y0 > 0.f) ? 0.01f * y0 : y0;
          o1 = leaky && !(y1 > 0.f) ? 0.01f * y1 : y1;
        }
      };
      const bool no_store = (WINO_ABLATE & 4) && a.B >= 0;
      int pb, dt0, ht0, w0;
      const bool live = patch_origin(a, w * TILES + sub, pb, dt0, ht0, w0) && !no_store;
      // row r of the block: sub-tile r / 8 = (D-tile r / 32, H-tile r / 8 % 4), cell r % 8
      auto out_row = [&](int r, int pq, size_t& rowi) {
        const int od = 2 * (dt0 + r / (TH * TW)) + (pq >> 1);
        const int oh = 2 * (ht0 + r / TW % TH) + (pq & 1);
        const int ow = w0 + r % TW;
        rowi = (((size_t)pb * a.OD + od) * a.OH + oh) * a.OW + ow;
        return live && od < a.OD && oh < a.OH && ow < a.OW;
      };
      // four rounds: B1 its four parities; a block of the pair y and dy of its two
      auto rounds = [&](auto first) {
#pragma unroll
      for (int round = 0; round < 4; ++round) {
        const int pq = PAIR ? decltype(first)::value + (round >> 1) : round;
        const bool want_dy = PAIR && (round & 1);
        void* out = want_dy ? a.y[1] : a.y[0];
        if (f32) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            size_t rowi;
            const bool rok = out_row(wrow + half * 8 + g8, pq, rowi);
#pragma unroll
            for (int nt = 0; nt < 8; ++nt) {
              const int col = n0 + cw * 64 + nt * 8 + 2 * t4;
              float o0, o1;
              finish(pq, want_dy, nt, half, o0, o1);
              if (rok && col < a.F2)
                *reinterpret_cast<float2*>(static_cast<float*>(out) + rowi * a.F2 + col) =
                    make_float2(o0, o1);
            }
          }
        } else {
          const int col = n0 + cw * 64 + (wt & 7) * 8;
#pragma unroll
          for (int half = 0; half < 2; ++half)
#pragma unroll
            for (int nt = 0; nt < 8; ++nt) {
              float o0, o1;
              finish(pq, want_dy, nt, half, o0, o1);
              *reinterpret_cast<__nv_bfloat162*>(stage + (wrow + half * 8 + g8) * STAGE_ROW +
                                                 (cw * 64 + nt * 8 + 2 * t4) * 2) =
                  __floats2bfloat162_rn(o0, o1);
            }
          // each warpgroup stages and reads back its own 64 columns
          if (cw == 0)
            asm volatile("bar.sync 3, 128;\n" ::: "memory");
          else
            asm volatile("bar.sync 4, 128;\n" ::: "memory");
#pragma unroll
          for (int pass = 0; pass < 4; ++pass) {
            const int row = pass * 16 + (wt >> 3);
            size_t rowi;
            const bool ok = out_row(row, pq, rowi) && col < a.F2;
            const uint4 v = *reinterpret_cast<const uint4*>(stage + row * STAGE_ROW +
                                                            (cw * 64 + (wt & 7) * 8) * 2);
            if (ok)
              *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(out) + rowi * a.F2 + col) = v;
          }
          if (cw == 0)  // the round is out of the staging rows
            asm volatile("bar.sync 3, 128;\n" ::: "memory");
          else
            asm volatile("bar.sync 4, 128;\n" ::: "memory");
        }
      }
      };
      if (PAIR && role)
        rounds(Int<2>{});
      else
        rounds(Int<0>{});
      // the hand-over is read: the transform warps may write the next patch's slices
      if (PAIR && w + wstep < nwork)
        asm volatile("bar.arrive 5, %0;\n" ::"n"(NXF + 256) : "memory");
    }
    if (CL > 1 && !PAIR) {  // stay until every peer is done with this block's barriers
      cluster_arrive();
      cluster_wait();
    }
  }
}

template <bool PAIR, int CL>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  static_assert(CL == 1 || CL == 2 || CL == 4, "cluster of 1, 2 or 4 blocks");
  static_assert(!PAIR || CL >= 2, "the pair needs an x block and an s block");
  auto kern = wino_f23_kernel<PAIR, CL>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return e;
  constexpr int TILES = PAIR ? CL / 2 : CL;
  const int nwork = (a.NPATCH + TILES - 1) / TILES;
  const int nb = (a.F2 + BN - 1) / BN;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = SMEM_BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // Blocks stay and walk over the work items: as many clusters as the card
  // holds at once (one block per SM), shared among the column blocks.
  int slots = 0;
  cfg.gridDim = dim3(CL, 1);
  if (CL > 1) {
    e = cudaOccupancyMaxActiveClusters(&slots, kern, &cfg);
  } else {
    int dev = 0;
    e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&slots, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e != cudaSuccess) return e;
  int clusters = slots / nb;
  clusters = clusters < 1 ? 1 : (clusters > nwork ? nwork : clusters);
  cfg.gridDim = dim3(clusters * CL, nb);
  e = cudaLaunchKernelEx(&cfg, kern, a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

void set_shape(Args& a, int B, int D, int H, int WP, int C2, int F2, int leaky, int out_f32) {
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
  a.NHQ = (a.OH + 2 * TH - 1) / (2 * TH);
  a.NWC = (a.OW + TW - 1) / TW;
  a.NPATCH = B * a.NDP * a.NHQ * a.NWC;
  a.leaky = leaky;
  a.out_f32 = out_f32;
}

}  // namespace

// Plain C entry points (bound with ctypes).  Shapes and strides are checked by
// the Python wrappers (ops/winograd_cuda.py: C2 % 32 == 0, F2 % 8 == 0, strides
// of 8 elements; wt from tile_wh); each returns the CUDA error code of the
// launch (0 = success).
extern "C" int wino_f23_packed(const void* x, const void* wt, const void* bias,
                               void* y, long long sB, long long sD,
                               long long sH, long long sW, int B, int D, int H,
                               int WP, int C2, int F2, int leaky, int out_f32,
                               void* stream) {
  Args a = {};
  a.x[0] = a.x[1] = static_cast<const __nv_bfloat16*>(x);
  a.wt = static_cast<const __nv_bfloat16*>(wt);
  a.bias = static_cast<const float*>(bias);
  a.y[0] = a.y[1] = y;
  a.sB[0] = a.sB[1] = sB;
  a.sD[0] = a.sD[1] = sD;
  a.sH[0] = a.sH[1] = sH;
  a.sW[0] = a.sW[1] = sW;
  set_shape(a, B, D, H, WP, C2, F2, leaky, out_f32);
  return (int)launch<false, WINO_CLUSTER_B1>(a, static_cast<cudaStream_t>(stream));
}

// The pair: x and s of one shape, each with its own strides; bias and c are
// (F2,) float32 (zeros for the raw per-part form); y and dy contiguous.
extern "C" int wino_f23_pair_packed(const void* x, const void* s, const void* wt,
                                    const void* bias, const void* c, void* y, void* dy,
                                    long long sxB, long long sxD, long long sxH,
                                    long long sxW, long long ssB, long long ssD,
                                    long long ssH, long long ssW, int B, int D, int H,
                                    int WP, int C2, int F2, int leaky, int out_f32,
                                    void* stream) {
  Args a = {};
  a.x[0] = static_cast<const __nv_bfloat16*>(x);
  a.x[1] = static_cast<const __nv_bfloat16*>(s);
  a.wt = static_cast<const __nv_bfloat16*>(wt);
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
  set_shape(a, B, D, H, WP, C2, F2, leaky, out_f32);
  return (int)launch<true, WINO_CLUSTER_B2>(a, static_cast<cudaStream_t>(stream));
}
