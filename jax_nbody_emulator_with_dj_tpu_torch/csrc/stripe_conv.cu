// Direct packed 3x3x3 conv (+bias, +LeakyReLU) over an implicit channel concat
// of N parts, the input streamed one D plane at a time, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel B5 of jax_nbody_emulator_with_dj_tpu/ops/
// stripe_conv.py: conv3_packed_stripe (body _kernel).  It computes a VALID
// 3x3x3 conv in the W-parity packed layout, x (B, D, H, WP, C) bf16 -> y (B,
// D-2, H-2, WP-1, Co), as 18 tap products x[kd:, kh:, ka:] @ wp[kd, kh, ka]
// with wp (3, 3, 2, C, Co) bf16 from ops/s2d.py::pack_w3, float32
// accumulation, a packed (Co,) float32 bias and an optional LeakyReLU(0.01)
// before one store in bf16 or float32.  The input comes as up to 4 parts that
// share (B, D, H, WP), each with its own channel count and strides: the conv
// runs over their channel concat (wp's rows are the parts' rows in order),
// which is never written out.
//
// What bounds it on the H100, at C = Co = 128 (the 64-channel model).  One
// output position costs 18 x 128 x 128 multiply-adds: 809 GFLOP at the phase-3
// shape (1,142,142,71,128) against ~0.7 GB of device-memory traffic, so the
// ideal kernel is bound by the tensor cores (0.82 ms at the bf16 peak against
// 0.21 ms of traffic).  In the way: the 18 tap slices are 590 KB of bf16 per
// 128 channels, more than an SM's shared memory, so a block streams all of
// them from L2 once per output plane of its patch; and a wgmma m64n128k16 with
// both operands in shared memory reads 6 KB per 64 tensor-core cycles, three
// quarters of what shared memory delivers, beside which the weight ring and the
// incoming planes are written.
//
// Design:
//   * blocks share nothing on this card, so the TPU kernel's sequential d axis
//     is a loop inside the block.  A block owns a patch of BH H rows x 8
//     packed-W cells x 128 output channels and walks a segment of D (the
//     wrapper picks the segment count that fills the SMs,
//     ops/direct_conv_cuda.py::stripe_segments), holding two input planes
//     ((BH+2) x 9 cells x all channels of all parts) in shared memory.  The
//     taps run kd-outermost, so input plane d is dead a third of the way
//     through output plane d, and plane d+2, needed for the last third,
//     arrives over it meanwhile: two slots hold what three planes need, and
//     each input plane is read once per block (plus 2 halo planes a segment);
//   * a block is a producer warpgroup and one consumer warpgroup per 8 H rows
//     of the patch: two (BH = 16) up to 256 input channels, one (BH = 8) up to
//     512, where two planes of 10 x 9 cells fill 180 KB.  No role needs more
//     than the launch's registers (one 64 x 128 float32 accumulator set is 64
//     a thread; the lone consumer above 256 channels holds three, one per kd,
//     to keep its sums as short as they are below), so there is no setmaxnreg;
//   * a consumer warpgroup owns 64 output positions (8 H rows x 8 cells) x 128
//     channels and runs wgmma m64n128k16 with both operands read from shared
//     memory.  A plane slot lies in wgmma's unswizzled K-major form: per 8
//     channels, per H row, the row's 9 cells (8 plus the halo cell) as 16-byte
//     pieces.  A core matrix is the 8 cells of one H row; the next H row is
//     144 bytes on, the next 8 channels one row set further.  Tap (kh, ka) is
//     the same descriptor kh * 144 + ka * 16 bytes further and tap kd is the
//     other plane slot: all 18 taps need no copy;
//   * the weights are re-tiled on the host (a permutation, ops/
//     direct_conv_cuda.py::tile_wp) into 8 KB pieces of 32 input channels x
//     128 output channels, already in the B operand's form, in the order the
//     taps run (kd outermost, then the channel group, then kh and ka).  One
//     lane of the producer warpgroup streams them by bulk asynchronous copies
//     into a ring (4 to 8 stages, what the planes leave) with full/empty
//     mbarriers; a consumer keeps one wgmma group in flight and releases a
//     stage when the group that read it has retired;
//   * the producer's other three warps bring plane d+2 in by cp.async (16
//     bytes a lane, each part from its own pointer and strides, zero-fill for
//     ragged H and W) into the slot that plane d frees after the kd = 0 taps,
//     on the planes' own full/empty mbarriers.  There is no block-wide barrier
//     after the set-up;
//   * a plane's bias, LeakyReLU and store run in one consumer warpgroup while
//     the other multiplies (they drift apart by up to the ring's depth).
//     float32 goes out from the fragments (a quad's float2s fill a sector);
//     bf16 is staged through shared memory, 64 columns at a time, so that each
//     lane stores 16 bytes.
// Products and sums match ops/direct_conv.py::conv3_packed_taps up to the
// float32 summation order.
//
// STRIPE_ABLATE (experiments/conv_ablation.py; 0 is the shipped kernel) is a
// mask that leaves out the weight copies (1), the plane loads (2) or the
// stores (4) to time the rest (wrong results).

#include "hopper_common.cuh"

#ifndef STRIPE_ABLATE
#define STRIPE_ABLATE 0
#endif

namespace {

using namespace hopper;

constexpr int BN = 128;     // output channels per block
constexpr int CG = 32;      // input channels of a weight piece
constexpr int WW = 9;       // cells of an input row: 8 + the halo cell of tap ka = 1
constexpr int ROW = WW * 16;  // bytes of one H row of one 8-channel step: 144
constexpr int TAPS = 18;
constexpr int MAX_PARTS = 4;
constexpr int MAX_STAGES = 8;
constexpr int STAGE_BYTES = CG * BN * 2;  // 8192
constexpr int NLOAD = 96;   // plane loaders: warps 1-3 of the producer warpgroup
// bf16 staging of one consumer warpgroup: 64 rows x 64 columns + 16 bytes a
// row, so that a warp's 8 rows hit 32 banks
constexpr int OUT_ROW = 64 * 2 + 16;
constexpr int OUT_BYTES = 64 * OUT_ROW;   // 9216
constexpr int BAR_BYTES = (2 * MAX_STAGES + 4) * 8;
constexpr uint32_t SBO_B = 128;           // next 8 output channels of a weight piece
constexpr uint32_t LBO_B = BN * 16;       // next 8 input channels

struct Args {
  const __nv_bfloat16* x[MAX_PARTS];
  long long sB[MAX_PARTS], sD[MAX_PARTS], sH[MAX_PARTS], sW[MAX_PARTS];  // element strides
  int cin[MAX_PARTS];
  int nparts;
  const __nv_bfloat16* wt;  // tiled weights: (column block, kd, group, kh * 2 + ka) pieces
  const float* bias;
  void* y;
  int B, D, H, WP, C, Co;  // C: channels of all parts together
  int OD, OH, OW;
  int NSEG, DSEG, NH, NW;  // D segments, output planes per segment, patches along H and W
  int nst;                 // weight ring stages
  int leaky, out_f32;
};

// Shared memory of one block: the weight ring, two plane slots, the consumers'
// bf16 staging, the block's 128 bias values, the mbarriers.
__host__ __device__ constexpr int slot_bytes(int c, int bh) { return (c / 8) * (bh + 2) * ROW; }
__host__ __device__ constexpr int smem_bytes(int c, int ncons, int nst) {
  return nst * STAGE_BYTES + 2 * slot_bytes(c, 8 * ncons) + ncons * OUT_BYTES + BN * 4 + BAR_BYTES;
}

template <int NCONS>
__global__ void __launch_bounds__(128 + 128 * NCONS, 1) stripe_conv_kernel(const Args a) {
  constexpr int BH = 8 * NCONS;   // H rows of the block's patch
  constexpr int HR = BH + 2;      // ... and of an input plane's tile
  // Accumulator sets of a consumer.  A tensor-core sum drops low bits at every step, and the
  // loss grows with the length of the chain: above 256 channels (one consumer, registers to
  // spare) each kd sums into its own set, and the three meet in float32 in the epilogue, so a
  // chain is never longer than at 256 channels.
  constexpr int NACC = NCONS == 1 ? 3 : 1;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t smem = smem_u32(smem_raw);
  const int tid = threadIdx.x;
  // (through a shuffle, so that the compiler knows it uniform over the warp)
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);

  const int nst = a.nst;
  const int slot = slot_bytes(a.C, BH);
  const uint32_t ring = smem;
  const uint32_t planes = ring + nst * STAGE_BYTES;
  const int off_out = nst * STAGE_BYTES + 2 * slot;
  const int off_bias = off_out + NCONS * OUT_BYTES;
  const uint32_t full_w = smem + off_bias + BN * 4, empty_w = full_w + MAX_STAGES * 8;
  const uint32_t full_p = empty_w + MAX_STAGES * 8, empty_p = full_p + 2 * 8;

  const int n0 = blockIdx.y * BN;
  int t = blockIdx.x;
  const int w0 = (t % a.NW) * 8;
  t /= a.NW;
  const int h0 = (t % a.NH) * BH;
  t /= a.NH;
  const int od0 = (t % a.NSEG) * a.DSEG;
  const int b = t / a.NSEG;
  const int nplanes = min(a.DSEG, a.OD - od0);
  const int ngroups = a.C / CG;

  if (tid == 0) {
    for (int s = 0; s < MAX_STAGES; ++s) {
      mbar_init(full_w + s * 8, 1);       // the weight lane's expect_tx
      mbar_init(empty_w + s * 8, NCONS);  // every consumer warpgroup
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(full_p + s * 8, NLOAD);   // the plane loaders
      mbar_init(empty_p + s * 8, NCONS);
    }
    mbar_init_fence();
  }
  if (tid < BN)
    reinterpret_cast<float*>(smem_raw + off_bias)[tid] = n0 + tid < a.Co ? a.bias[n0 + tid] : 0.f;
  __syncthreads();

  if (wg == 0) {
    // ================= producer warpgroup
    if (tid == 0) {
      // ---- the weights: piece j of a plane's 18 x groups goes to the next ring stage once
      // every consumer has released it; every plane streams the same pieces
      const char* src =
          reinterpret_cast<const char*>(a.wt) + (size_t)blockIdx.y * TAPS * ngroups * STAGE_BYTES;
      int s = 0;
      uint32_t wrap = 0;  // parity of the times the ring has gone round
      for (int pl = 0; pl < nplanes; ++pl) {
        for (int j = 0; j < TAPS * ngroups; ++j) {
          mbar_wait(empty_w + s * 8, wrap ^ 1);
          if (STRIPE_ABLATE & 1) {
            mbar_arrive(full_w + s * 8);
          } else {
            mbar_expect_tx(full_w + s * 8, STAGE_BYTES);
            bulk_copy(ring + s * STAGE_BYTES, src + (size_t)j * STAGE_BYTES, STAGE_BYTES,
                      full_w + s * 8);
          }
          if (++s == nst) {
            s = 0;
            wrap ^= 1;
          }
        }
      }
    } else if (tid >= 32) {
      // ---- the planes: input plane p of the segment goes to slot p & 1, for p >= 2 once the
      // consumers are past the kd = 0 taps of output plane p - 2.
      // Four neighbouring lanes take the 64 bytes of one cell's 32-channel group; the items
      // (group, cell) go round the 24 lane quads, cells fastest, so a thread re-aims at a
      // part's pointer and strides only when its group changes.
      const int tp = tid - 32;
      const int qq = tp & 3;
      constexpr int CELLS = HR * WW;
      for (int p = 0; p < nplanes + 2; ++p) {
        const int sl = p & 1;
        mbar_wait(empty_p + sl * 8, ((p >> 1) & 1) ^ 1);
        if (!(STRIPE_ABLATE & 2)) {
          const uint32_t dst = planes + sl * slot + qq * (HR * ROW);
          const int plane = od0 + p;
          int g = 0, pos = tp >> 2, aimed = -1;
          const __nv_bfloat16* src = a.x[0];
          long long sH = 0, sW = 0;
#pragma unroll 1
          while (g < ngroups) {
            if (g != aimed) {
              // (constant indices: a dynamically indexed kernel parameter can land in local memory)
              int c0 = 0;
#pragma unroll
              for (int k = 0; k < MAX_PARTS; ++k) {
                if (k < a.nparts && g * CG >= c0 && g * CG < c0 + a.cin[k]) {
                  src = a.x[k] + b * a.sB[k] + plane * a.sD[k] + (g * CG - c0) + qq * 8;
                  sH = a.sH[k];
                  sW = a.sW[k];
                }
                c0 += a.cin[k];
              }
              aimed = g;
            }
            const int hr = pos / WW, cell = pos - hr * WW;
            const int ih = h0 + hr, iw = w0 + cell;
            const bool ok = ih < a.H && iw < a.WP;
            cp_async16(dst + ((g * (CG / 8) * HR + hr) * WW + cell) * 16,
                       ok ? src + ih * sH + iw * sW : a.x[0], ok);
            pos += NLOAD / 4;
            if (pos >= CELLS) {
              pos -= CELLS;
              ++g;
            }
          }
          cp_async_commit();
          cp_async_wait_all();
          fence_async_smem();  // the consumers read the plane through the async proxy
        }
        mbar_arrive(full_p + sl * 8);
      }
    }
  } else {
    // ================= consumer warpgroups
    const int cw = wg - 1;  // this warpgroup's 8 H rows of the patch
    const int wt = tid & 127;
    const bool elected = wt == 0;
    const int lane = tid & 31;
    const int g8 = lane >> 2, t4 = lane & 3;
    const int w4 = wt >> 5;
    const float* bias_s = reinterpret_cast<const float*>(smem_raw + off_bias);
    unsigned char* stage = smem_raw + off_out + cw * OUT_BYTES;
    const uint64_t da_base = make_desc(planes + cw * 8 * ROW, HR * ROW, ROW);
    const uint64_t db_base = make_desc(ring, LBO_B, SBO_B);
    const bool leaky = a.leaky != 0;
    const bool no_store = (STRIPE_ABLATE & 4) && a.B >= 0;

    int s = 0, prev = -1;  // the ring stage in use, and the one whose products are in flight
    uint32_t wrap = 0;
    for (int pl = 0; pl < nplanes; ++pl) {
      float acc[NACC][64];  // (each set's first wgmma overwrites it)
      bool plane_dead = false;  // the kd = 0 taps are under way: their slot goes when they retire
#pragma unroll
      for (int kd = 0; kd < 3; ++kd) {
        const int p = pl + kd;
        mbar_wait(full_p + (p & 1) * 8, (p >> 1) & 1);
        const uint64_t da_slot = da_base + (((p & 1) * slot) >> 4);
        for (int g = 0; g < ngroups; ++g) {
          const uint64_t da_g = da_slot + ((g * (CG / 8) * HR * ROW) >> 4);
#pragma unroll
          for (int k6 = 0; k6 < 6; ++k6) {
            mbar_wait(full_w + s * 8, wrap);
            wgmma_fence();
#pragma unroll
            for (int k = 0; k < 2; ++k) {
              const uint64_t da = da_g + ((k * 2 * HR * ROW + (k6 >> 1) * ROW + (k6 & 1) * 16) >> 4);
              const uint64_t db = db_base + ((s * STAGE_BYTES + k * 2 * (int)LBO_B) >> 4);
              wgmma_m64n128k16(acc[kd % NACC], da, db, ((NACC == 1 ? kd : 0) | g | k6 | k) != 0);
            }
            wgmma_commit();
            wgmma_wait<1>();  // the stage before this one has retired
            if (elected) {
              if (prev >= 0) mbar_arrive(empty_w + prev * 8);
              if (plane_dead) mbar_arrive(empty_p + (pl & 1) * 8);
            }
            plane_dead = false;
            prev = s;
            if (++s == nst) {
              s = 0;
              wrap ^= 1;
            }
          }
        }
        plane_dead = kd == 0;
      }
      wgmma_wait<0>();
#pragma unroll
      for (int k = 0; k < NACC; ++k) fence_regs(acc[k]);
      if (elected) mbar_arrive(empty_w + prev * 8);
      prev = -1;
#pragma unroll
      for (int k = 1; k < NACC; ++k)
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[0][i] += acc[k][i];

      // ---- this plane's epilogue: bias, LeakyReLU, store.  Thread's fragment rows are
      // 16 w4 + g8 (+ 8): H rows 2 w4 (+ 1) of the warpgroup's 8, cell g8.
      const int od = od0 + pl;
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
            const float v0 = bias_act(acc[0][nt * 4 + 2 * half], bias_s[cl], leaky);
            const float v1 = bias_act(acc[0][nt * 4 + 2 * half + 1], bias_s[cl + 1], leaky);
            if (rok && n0 + cl < a.Co) *reinterpret_cast<float2*>(out + n0 + cl) = make_float2(v0, v1);
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
              const float v0 = bias_act(acc[0][nt * 4 + 2 * half], bias_s[cl], leaky);
              const float v1 = bias_act(acc[0][nt * 4 + 2 * half + 1], bias_s[cl + 1], leaky);
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

template <int NCONS>
cudaError_t launch(Args& a, cudaStream_t stream) {
  constexpr int BH = 8 * NCONS;
  a.NH = (a.OH + BH - 1) / BH;
  const int smem = smem_bytes(a.C, NCONS, a.nst);
  if (a.nst < 2 || a.nst > MAX_STAGES || smem > SMEM_MAX) return cudaErrorInvalidValue;
  auto kern = stripe_conv_kernel<NCONS>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(a.B * a.NSEG * a.NH * a.NW, (a.Co + BN - 1) / BN);
  kern<<<grid, 128 + 128 * NCONS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  Shapes and strides are checked by
// the Python wrapper (ops/direct_conv_cuda.py: channel counts % 32 == 0,
// Co % 8 == 0, strides of 8 elements; wt from tile_wp); returns the CUDA error
// code of the launch (0 = success).
//
// xs: nparts input pointers; strides: nparts x (sB, sD, sH, sW) in elements;
// cins: nparts channel counts (each % 32 == 0, C their sum <= 512); dseg:
// output planes per block; nst: weight ring stages (stripe_ring_stages).
extern "C" int stripe_conv(const void* const* xs, const long long* strides, const int* cins,
                           int nparts, const void* wt, const void* bias, void* y, int B, int D,
                           int H, int WP, int C, int Co, int dseg, int nst, int leaky,
                           int out_f32, void* stream) {
  if (nparts < 1 || nparts > MAX_PARTS || dseg < 1 || C < CG || C > 512 || C % CG)
    return (int)cudaErrorInvalidValue;
  Args a = {};
  for (int i = 0; i < nparts; ++i) {
    a.x[i] = static_cast<const __nv_bfloat16*>(xs[i]);
    a.sB[i] = strides[4 * i];
    a.sD[i] = strides[4 * i + 1];
    a.sH[i] = strides[4 * i + 2];
    a.sW[i] = strides[4 * i + 3];
    a.cin[i] = cins[i];
  }
  a.nparts = nparts;
  a.wt = static_cast<const __nv_bfloat16*>(wt);
  a.bias = static_cast<const float*>(bias);
  a.y = y;
  a.B = B;
  a.D = D;
  a.H = H;
  a.WP = WP;
  a.C = C;
  a.Co = Co;
  a.OD = D - 2;
  a.OH = H - 2;
  a.OW = WP - 1;
  a.DSEG = dseg;
  a.NSEG = (a.OD + dseg - 1) / dseg;
  a.NW = (a.OW + 7) / 8;
  a.nst = nst;
  a.leaky = leaky;
  a.out_f32 = out_f32;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // two consumer warpgroups (a 16 x 8 patch) while two planes of 18 x 9 cells fit, else one
  return (int)(C <= 256 ? launch<2>(a, st) : launch<1>(a, st));
}
