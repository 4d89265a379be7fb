// Direct packed 3x3x3 conv (+bias, +LeakyReLU) from a resident input window,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel B4 of jax_nbody_emulator_with_dj_tpu/ops/
// pallas_conv.py: conv3d_pallas_packed (body _conv_kernel).  It computes a
// VALID 3x3x3 conv in the W-parity packed layout, x (B, D, H, WP, C) bf16 -> y
// (B, D-2, H-2, WP-1, Co), as 18 tap products x[kd:, kh:, ka:] @ wp[kd, kh, ka]
// with wp (3, 3, 2, C, Co) bf16 from ops/s2d.py::pack_w3, float32
// accumulation, a packed (Co,) float32 bias and an optional LeakyReLU(0.01)
// before one store in bf16 or float32.  (The plane-streamed form of the same
// conv over N parts, B5, is stripe_conv.cu.)
//
// What bounds it on the H100, at C = Co = 128 (the 64-channel model).  One
// output position costs 18 x 128 x 128 multiply-adds: 809 GFLOP at the phase-3
// shape (1,142,142,71,128) against ~0.7 GB of device-memory traffic, so the
// ideal kernel is bound by the tensor cores (0.82 ms at the bf16 peak against
// 0.21 ms of traffic).  In the way: the 18 tap slices are 590 KB of bf16 per
// 128 channels, more than an SM's shared memory, so a block streams all of
// them from L2 once per patch of output positions; and a wgmma m64n128k16 with
// both operands in shared memory reads 6 KB per 64 tensor-core cycles, three
// quarters of what shared memory delivers, beside which the weight ring and
// the incoming windows are written.
//
// Design (the TPU kernel's VMEM windows, row chunks and per-batch loop have no
// counterpart; batch is part of the patch index):
//   * a block owns a patch of 2 D planes x 16 H rows x 8 packed-W cells x 128
//     output channels, and stays resident: it walks over patches (blockIdx.x,
//     + gridDim.x, ...) of its column block (blockIdx.y).  It is a producer
//     warpgroup and two consumer warpgroups; each consumer owns 8 H rows of
//     both D planes, two 64 x 128 float32 accumulator tiles in registers, and
//     runs wgmma m64n128k16 with both operands read from shared memory.  One
//     8 KB weight piece in the ring so feeds four wgmma per consumer: half the
//     ring writes and half the L2 weight stream of a one-plane patch;
//   * the patch's 4 x 18 x 9 halo window lives in shared memory one 32-channel
//     group at a time, in wgmma's unswizzled K-major form: per 8 channels, per
//     D plane, per H row, the row's 9 cells (8 plus the halo cell) as 16-byte
//     pieces.  A core matrix is the 8 cells of one H row; the next H row is
//     144 bytes on, the next 8 channels 4 x 18 rows further.  Tap (kd, kh, ka)
//     for the tile of output plane p is the same descriptor ((p + kd) * 18 +
//     kh) * 144 + ka * 16 bytes further: all 18 taps of both tiles need no
//     copy;
//   * the taps run group-outermost (group, kd, kh, ka), so a group's slot is
//     dead after its 18 pieces.  Three slots go round over (patch, group):
//     the next patch's groups land while this patch's later groups multiply,
//     a full group ahead, and shared memory does not grow with C;
//   * the producer's warps 1-3 bring a group's window in by cp.async (16 bytes
//     a lane, four lanes to a cell's 64 bytes, 27 pieces a lane; zero-fill
//     outside the input; any strides with contiguous channels) on the slots'
//     full/empty mbarriers;
//   * the weights are ops/direct_conv_cuda.py::tile_wp's 8 KB pieces of 32
//     input channels x 128 output channels, already in the B operand's form,
//     indexed (column block, kd, group, kh * 2 + ka).  One lane of the producer
//     streams them in the order the taps run by bulk asynchronous copies into
//     a ring of 8 stages with full/empty mbarriers; a consumer keeps one wgmma
//     group in flight and releases a stage, and after a group's last piece its
//     window slot, when the wgmma group that read it has retired.  There is no
//     block-wide barrier after the set-up;
//   * a patch's bias, LeakyReLU and store run in one consumer warpgroup while
//     the other multiplies (they drift apart by up to the ring's depth).
//     float32 goes out from the fragments (a quad's float2s fill a sector);
//     bf16 is staged through shared memory, 64 columns at a time, so that each
//     lane stores 16 bytes.  Ragged D, H, W and Co are masked in the store.
// Products and sums match ops/direct_conv.py::conv3_packed_taps up to the
// float32 summation order.
//
// DIRECT_ABLATE (experiments/conv_ablation.py; 0 is the shipped kernel) is a
// mask that leaves out the weight copies (1), the window loads (2) or the
// stores (4) to time the rest (wrong results).

#include "hopper_common.cuh"

#ifndef DIRECT_ABLATE
#define DIRECT_ABLATE 0
#endif

namespace {

using namespace hopper;

constexpr int BN = 128;        // output channels per block
constexpr int CG = 32;         // input channels of a weight piece and of a window slot
constexpr int BD = 2;          // D planes of a patch: a consumer's two accumulator tiles
constexpr int BH = 16;         // H rows of a patch, 8 per consumer warpgroup
constexpr int WW = 9;          // cells of a window row: 8 + the halo cell of tap ka = 1
constexpr int HR = BH + 2;     // H rows of the window
constexpr int DR = BD + 2;     // D planes of the window
constexpr int ROW = WW * 16;   // bytes of one H row of one 8-channel step: 144
constexpr int CELLS = DR * HR * WW;              // 648 window cells
constexpr int STEP_BYTES = DR * HR * ROW;        // one 8-channel step of a slot: 10,368
constexpr int SLOT_BYTES = (CG / 8) * STEP_BYTES;  // 41,472
constexpr int NSLOT = 3;
constexpr int NST = 8;         // weight ring stages
constexpr int STAGE_BYTES = CG * BN * 2;         // 8192
constexpr int NLOAD = 96;      // window loaders: warps 1-3 of the producer warpgroup
constexpr int PIECES = CELLS * (CG / 8) / NLOAD;  // 16-byte pieces a loader brings: 27
static_assert(PIECES * NLOAD == CELLS * (CG / 8), "the loaders share a slot evenly");
// bf16 staging of one consumer warpgroup: 64 rows x 64 columns + 16 bytes a
// row, so that a warp's 8 rows hit 32 banks
constexpr int OUT_ROW = 64 * 2 + 16;
constexpr int OUT_BYTES = 64 * OUT_ROW;          // 9216
// Registers after setmaxnreg: 128 x 72 + 256 x 216 = 64,512 of the SM's 65,536 (the launch
// takes 168 a thread).  A consumer holds 128 accumulators; at 168 it spilled a few addresses.
constexpr int REG_PRODUCER = 72, REG_CONSUMER = 216;
constexpr uint32_t SBO_B = 128;                  // next 8 output channels of a weight piece
constexpr uint32_t LBO_B = BN * 16;              // next 8 input channels

// Shared memory of one block: the weight ring, three window slots, the
// consumers' bf16 staging, the block's 128 bias values, the mbarriers.
constexpr int OFF_RING = 0;
constexpr int OFF_WIN = OFF_RING + NST * STAGE_BYTES;
constexpr int OFF_OUT = OFF_WIN + NSLOT * SLOT_BYTES;
constexpr int OFF_BIAS = OFF_OUT + 2 * OUT_BYTES;
constexpr int OFF_BAR = OFF_BIAS + BN * 4;
constexpr int SMEM_BYTES = OFF_BAR + (2 * NST + 2 * NSLOT) * 8;  // 209,072
static_assert(SMEM_BYTES <= SMEM_MAX, "one block's shared memory");

struct Args {
  const __nv_bfloat16* x;
  const __nv_bfloat16* wt;  // tiled weights: (column block, kd, group, kh * 2 + ka) pieces
  const float* bias;
  void* y;
  long long sB, sD, sH, sW;  // element strides of x; channels are contiguous
  int B, D, H, WP, C, Co;
  int OD, OH, OW;
  int ND, NH, NW;  // patches along D, H and W
  int leaky, out_f32;
};

// A block's walk over its column block's patches.
struct Walk {
  int first, end, step, ngroups;
};
__device__ __forceinline__ Walk walk_of(const Args& a) {
  return {(int)blockIdx.x, a.B * a.ND * a.NH * a.NW, (int)gridDim.x, a.C / CG};
}
// Patch index -> batch and the patch's first output plane, row and cell (W fastest, so that
// the blocks running together share their halos in L2).
__device__ __forceinline__ void patch_of(const Args& a, int t, int& b, int& d0, int& h0, int& w0) {
  w0 = (t % a.NW) * 8;
  t /= a.NW;
  h0 = (t % a.NH) * BH;
  t /= a.NH;
  d0 = (t % a.ND) * BD;
  b = t / a.ND;
}

__global__ void __launch_bounds__(384, 1) direct_conv_window_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t smem = smem_u32(smem_raw);
  const int tid = threadIdx.x;
  // (through a shuffle, so that the compiler knows it uniform over the warp)
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);

  const uint32_t ring = smem + OFF_RING, wins = smem + OFF_WIN;
  const uint32_t full_w = smem + OFF_BAR, empty_w = full_w + NST * 8;
  const uint32_t full_x = empty_w + NST * 8, empty_x = full_x + NSLOT * 8;
  const int n0 = blockIdx.y * BN;

  if (tid == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(full_w + s * 8, 1);   // the weight lane's expect_tx
      mbar_init(empty_w + s * 8, 2);  // both consumer warpgroups
    }
    for (int s = 0; s < NSLOT; ++s) {
      mbar_init(full_x + s * 8, NLOAD);  // the window loaders
      mbar_init(empty_x + s * 8, 2);
    }
    mbar_init_fence();
  }
  if (tid < BN)
    reinterpret_cast<float*>(smem_raw + OFF_BIAS)[tid] = n0 + tid < a.Co ? a.bias[n0 + tid] : 0.f;
  __syncthreads();

  if (wg == 0) {
    // ================= producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REG_PRODUCER));
    const Walk wk = walk_of(a);
    if (tid == 0) {
      // ---- the weights: every patch streams its column block's 18 x groups pieces, group
      // outermost; a piece goes to the next ring stage once both consumers have released it
      const char* src = reinterpret_cast<const char*>(a.wt) +
                        (size_t)blockIdx.y * 18 * wk.ngroups * STAGE_BYTES;
      int s = 0;
      uint32_t wrap = 0;  // parity of the times the ring has gone round
      for (int t = wk.first; t < wk.end; t += wk.step) {
        for (int g = 0; g < wk.ngroups; ++g) {
          for (int kd = 0; kd < 3; ++kd) {
            const char* six = src + (size_t)((kd * wk.ngroups + g) * 6) * STAGE_BYTES;
            for (int k6 = 0; k6 < 6; ++k6) {
              mbar_wait(empty_w + s * 8, wrap ^ 1);
              if (DIRECT_ABLATE & 1) {
                mbar_arrive(full_w + s * 8);
              } else {
                mbar_expect_tx(full_w + s * 8, STAGE_BYTES);
                bulk_copy(ring + s * STAGE_BYTES, six + k6 * STAGE_BYTES, STAGE_BYTES,
                          full_w + s * 8);
              }
              if (++s == NST) {
                s = 0;
                wrap ^= 1;
              }
            }
          }
        }
      }
    } else if (tid >= 32) {
      // ---- the windows: group g of a patch goes to the next of the three slots once the
      // consumers have retired the products of the group that lay there.
      // Four neighbouring lanes take the 64 bytes of one cell's 32 channels; a lane's 27
      // cells are 24 apart in the slot's (plane, row, cell) order, which is also the order of
      // the slot's bytes, so it steps its place and never divides.
      const int tp = tid - 32;
      const int qq = tp & 3;
      const int pos0 = tp >> 2;
      const int hr0 = pos0 / WW, cell0 = pos0 - hr0 * WW;  // pos0 < 24: plane 0
      const uint32_t dst0 = wins + qq * STEP_BYTES + pos0 * 16;
      int sl = 0;
      uint32_t wrap = 0;
      for (int t = wk.first; t < wk.end; t += wk.step) {
        int b, d0, h0, w0;
        patch_of(a, t, b, d0, h0, w0);
        const __nv_bfloat16* origin = a.x + b * a.sB + d0 * a.sD + h0 * a.sH + w0 * a.sW + qq * 8;
        const int nd = a.D - d0, nh = a.H - h0, nw = a.WP - w0;  // what of the window is input
        for (int g = 0; g < wk.ngroups; ++g) {
          mbar_wait(empty_x + sl * 8, wrap ^ 1);
          if (!(DIRECT_ABLATE & 2)) {
            const __nv_bfloat16* src = origin + g * CG;
            uint32_t dst = dst0 + sl * SLOT_BYTES;
            int pz = 0, hr = hr0, cell = cell0;
#pragma unroll 9
            for (int i = 0; i < PIECES; ++i) {
              const bool ok = pz < nd && hr < nh && cell < nw;
              cp_async16(dst, ok ? src + pz * a.sD + hr * a.sH + cell * a.sW : a.x, ok);
              dst += (NLOAD / 4) * 16;
              cell += 6;  // 24 cells on: 2 rows and 6 cells
              hr += 2;
              if (cell >= WW) {
                cell -= WW;
                ++hr;
              }
              if (hr >= HR) {
                hr -= HR;
                ++pz;
              }
            }
            cp_async_commit();
            cp_async_wait_all();
            fence_async_smem();  // the consumers read the window through the async proxy
          }
          mbar_arrive(full_x + sl * 8);
          if (++sl == NSLOT) {
            sl = 0;
            wrap ^= 1;
          }
        }
      }
    }
  } else {
    // ================= consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REG_CONSUMER));
    const Walk wk = walk_of(a);
    const int cw = wg - 1;  // this warpgroup's 8 H rows of the patch
    const int wt = tid & 127;
    const bool elected = wt == 0;
    const int lane = tid & 31;
    const int g8 = lane >> 2, t4 = lane & 3;
    const int w4 = wt >> 5;
    const float* bias_s = reinterpret_cast<const float*>(smem_raw + OFF_BIAS);
    unsigned char* stage = smem_raw + OFF_OUT + cw * OUT_BYTES;
    const uint64_t da_base = make_desc(wins + cw * 8 * ROW, STEP_BYTES, ROW);
    const uint64_t db_base = make_desc(ring, LBO_B, SBO_B);
    const bool leaky = a.leaky != 0;
    const bool no_store = (DIRECT_ABLATE & 4) && a.B >= 0;

    int s = 0, prev = -1;  // the ring stage in use, and the one whose products are in flight
    uint32_t wrap = 0;
    int sl = 0, dead = -1;  // the window slot in use, and one whose last products are in flight
    uint32_t xwrap = 0;
    for (int t = wk.first; t < wk.end; t += wk.step) {
      float acc[BD][64];  // (each tile's first wgmma overwrites it)
      for (int g = 0; g < wk.ngroups; ++g) {
        mbar_wait(full_x + sl * 8, xwrap);
        const uint64_t da_g = da_base + ((sl * SLOT_BYTES) >> 4);
#pragma unroll
        for (int tap = 0; tap < 18; ++tap) {
          const int kd = tap / 6, kh = (tap >> 1) % 3, ka = tap & 1;
          mbar_wait(full_w + s * 8, wrap);
          wgmma_fence();
          const uint64_t db_s = db_base + ((s * STAGE_BYTES) >> 4);
#pragma unroll
          for (int k = 0; k < 2; ++k) {
#pragma unroll
            for (int p = 0; p < BD; ++p) {
              const uint64_t da =
                  da_g + ((k * 2 * STEP_BYTES + ((p + kd) * HR + kh) * ROW + ka * 16) >> 4);
              wgmma_m64n128k16(acc[p], da, db_s + ((k * 2 * (int)LBO_B) >> 4), (g | tap | k) != 0);
            }
          }
          wgmma_commit();
          wgmma_wait<1>();  // the piece before this one has retired
          if (elected) {
            if (prev >= 0) mbar_arrive(empty_w + prev * 8);
            if (dead >= 0) mbar_arrive(empty_x + dead * 8);
          }
          dead = -1;
          prev = s;
          if (++s == NST) {
            s = 0;
            wrap ^= 1;
          }
        }
        dead = sl;
        if (++sl == NSLOT) {
          sl = 0;
          xwrap ^= 1;
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int p = 0; p < BD; ++p) fence_regs(acc[p]);
      if (elected) {
        mbar_arrive(empty_w + prev * 8);
        mbar_arrive(empty_x + dead * 8);
      }
      prev = -1;
      dead = -1;

      // ---- this patch's epilogue: bias, LeakyReLU, store.  Thread's fragment rows are
      // 16 w4 + g8 (+ 8): H rows 2 w4 (+ 1) of the warpgroup's 8, cell g8.
      int b, d0, h0, w0;
      patch_of(a, t, b, d0, h0, w0);
#pragma unroll
      for (int p = 0; p < BD; ++p) {
        const int od = d0 + p;
        if (od >= a.OD) break;  // (the same for the whole block)
        const size_t plane_row = ((size_t)b * a.OD + od) * a.OH;
        if (a.out_f32) {
          const int ow = w0 + g8;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int oh = h0 + cw * 8 + 2 * w4 + half;
            const bool rok = oh < a.OH && ow < a.OW && !no_store;
            float* out = static_cast<float*>(a.y) + ((plane_row + oh) * a.OW + ow) * a.Co;
#pragma unroll
            for (int nt = 0; nt < 16; ++nt) {
              const int cl = nt * 8 + 2 * t4;
              const float v0 = bias_act(acc[p][nt * 4 + 2 * half], bias_s[cl], leaky);
              const float v1 = bias_act(acc[p][nt * 4 + 2 * half + 1], bias_s[cl + 1], leaky);
              if (rok && n0 + cl < a.Co)
                *reinterpret_cast<float2*>(out + n0 + cl) = make_float2(v0, v1);
            }
          }
        } else {
#pragma unroll
          for (int pass = 0; pass < 2; ++pass) {  // 64 columns at a time
            bar_sync(1 + cw, 128);                // the staging rows are read out
#pragma unroll
            for (int half = 0; half < 2; ++half)
#pragma unroll
              for (int n8 = 0; n8 < 8; ++n8) {
                const int nt = pass * 8 + n8;
                const int cl = nt * 8 + 2 * t4;
                const float v0 = bias_act(acc[p][nt * 4 + 2 * half], bias_s[cl], leaky);
                const float v1 = bias_act(acc[p][nt * 4 + 2 * half + 1], bias_s[cl + 1], leaky);
                *reinterpret_cast<__nv_bfloat162*>(stage + (16 * w4 + 8 * half + g8) * OUT_ROW +
                                                   (n8 * 8 + 2 * t4) * 2) =
                    __floats2bfloat162_rn(v0, v1);
              }
            bar_sync(1 + cw, 128);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int piece = wt + 128 * i;
              const int row = piece >> 3, c8 = piece & 7;
              const int oh = h0 + cw * 8 + (row >> 3), ow = w0 + (row & 7);
              const int col = n0 + pass * 64 + c8 * 8;
              const uint4 v = *reinterpret_cast<const uint4*>(stage + row * OUT_ROW + c8 * 16);
              if (oh < a.OH && ow < a.OW && col < a.Co && !no_store)
                *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(a.y) +
                                          ((plane_row + oh) * a.OW + ow) * a.Co + col) = v;
            }
          }
        }
      }
    }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  Shapes and strides are checked by
// the Python wrapper (ops/direct_conv_cuda.py: C % 32 == 0, Co % 8 == 0,
// strides of 8 elements; wt from tile_wp); returns the CUDA error code of the
// launch (0 = success).  blocks: how many blocks the card runs at a time (its
// SM count: one block per SM); they share out the patches.
extern "C" int direct_conv_window(const void* x, const void* wt, const void* bias, void* y,
                                  long long sB, long long sD, long long sH, long long sW, int B,
                                  int D, int H, int WP, int C, int Co, int leaky, int out_f32,
                                  int blocks, void* stream) {
  if (C < CG || C % CG || blocks < 1) return (int)cudaErrorInvalidValue;
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
  a.C = C;
  a.Co = Co;
  a.OD = D - 2;
  a.OH = H - 2;
  a.OW = WP - 1;
  a.ND = (a.OD + BD - 1) / BD;
  a.NH = (a.OH + BH - 1) / BH;
  a.NW = (a.OW + 7) / 8;
  a.leaky = leaky;
  a.out_f32 = out_f32;
  auto kern = direct_conv_window_kernel;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  // resident blocks: the card's SMs shared among the column blocks, each walking its patches
  const int ncol = (Co + BN - 1) / BN;
  const long long patches = (long long)B * a.ND * a.NH * a.NW;
  long long gx = blocks / ncol > 0 ? blocks / ncol : 1;
  if (gx > patches) gx = patches;
  dim3 grid((unsigned)gx, ncol);
  kern<<<grid, 384, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
