// Direct packed 3x3x3 conv (+bias, +LeakyReLU) for Hopper (sm_90a), in two
// forms: a resident input window (B4) and a plane-streamed input of N parts (B5).
//
// Replaces two Pallas TPU kernels of jax_nbody_emulator_with_dj_tpu:
//   B4 ops/pallas_conv.py::conv3d_pallas_packed   (body _conv_kernel)
//   B5 ops/stripe_conv.py::conv3_packed_stripe    (body _kernel)
// Both compute a VALID 3x3x3 conv in the W-parity packed layout, x (B, D, H,
// WP, C) bf16 -> y (B, D-2, H-2, WP-1, Co), as 18 tap products
// x[kd:, kh:, ka:] @ wp[kd, kh, ka] with wp (3, 3, 2, C, Co) bf16 from
// ops/s2d.py::pack_w3, float32 accumulation, a packed (Co,) float32 bias and
// an optional LeakyReLU(0.01) before one store in bf16 or float32.  B5 takes
// the input as up to 4 parts that share (B, D, H, WP), each with its own
// channel count and strides: the conv runs over their implicit channel concat
// (wp's rows are the parts' rows in order), which is never written out.
//
// What bounds them on the H100, at C = Co = 128 (the 64-channel model).  One
// output position costs 18 x 128 x 128 MACs: 809 GFLOP at the phase-3 shape
// (1,142,142,71,128) against ~0.7 GB of device-memory traffic, so the ideal
// kernel is bound by the tensor cores (0.82 ms at the bf16 peak against
// 0.21 ms of traffic).  In the way: the 18 tap slices are 590 KB of bf16,
// more than one SM's 227 KB of shared memory, so every block streams all of
// them from L2 once per 128 output positions (one float32 accumulator set of
// 128 x 128 is what 8 warps hold in 64 registers a thread): ~6 GB of L2 reads
// at the phase-3 shape; and mma.sync takes both operands through registers
// by ldmatrix.
//
// Design (simple and right first; wgmma, TMA and clusters are later work):
//   * a block's 8 warps (2 along M x 4 along N) run mma.sync m16n8k16 bf16
//     tiles fed by ldmatrix, with one float32 accumulator set.  The weights
//     stream through a 3- or 4-stage cp.async ring of 32-row x 128-column chunks
//     shared by the warps, one chunk per (tap, 32-channel group), running
//     ahead across group and plane boundaries;
//   * a tap shift is an address offset into the input tile in shared memory:
//     each lane's ldmatrix row address is its output position's window cell,
//     plus a constant per tap.  No shifted copy is made;
//   * out-of-range input cells are zero-filled by cp.async and ragged output
//     edges are masked in the store, so any (D, H, WP) and any strides with
//     contiguous channels go in as they are;
//   * B4 (direct_conv_window_kernel): a block owns a 2 x 8 x 8 patch of
//     output positions (D, H, packed-W cells) x 128 output channels.  Its
//     4 x 10 x 9 halo window comes in 32 input channels at a time, double
//     buffered: group g+1 lands while group g's 18 taps run.  Each input
//     element is read 2.8 times over all blocks (from L2, mostly);
//   * B5 (direct_conv_stripe_kernel): blocks share nothing on this card, so
//     the TPU kernel's sequential d axis is a loop inside the block.  A block
//     owns a (BH x 8 cells) patch x 128 output channels and walks a segment
//     of D, holding a ring of input planes ((BH+2) x 9 cells x all channels
//     of all parts) in shared memory, and every output plane is accumulated
//     and stored on its own.  The taps run kd-outermost, so input plane d is
//     dead a third of the way through output plane d and plane d+2, needed
//     for the last third, arrives over it meanwhile: two slots hold what
//     three planes need.  So each input plane is read once per block (plus 2
//     halo planes per D segment and the patch's H/W halo), where B4 reads
//     each plane twice.  BH is 16 up to 256 channels over all parts and 8 up
//     to 512 (the ring must fit in 227 KB).  Up to 128 channels the weight
//     ring has 3 stages, so that two blocks fit on an SM and one fills the
//     other's barrier waits, as with B4 (measured: 2.9 against 3.8 ms at the
//     phase-3 shape); above, one block has the SM to itself.  The loop keeps
//     its place in the tap order in counters: divisions by the runtime group
//     count cost it a third of its time when it had them.  The wrapper picks
//     the number of D segments that fills the SMs
//     (ops/direct_conv_cuda.py::stripe_segments).  This is the plane-streamed
//     counterpart, not B4 with a loop over parts.

#include "mma_common.cuh"

namespace {

using namespace convk;

constexpr int BW = 8;       // packed-W cells of a block's patch
constexpr int WW = BW + 1;  // ... and of its input tile (1 halo cell)
constexpr int TAPS = 18;

// ---------------------------------------------------------------------------
// B4: resident window
// ---------------------------------------------------------------------------

constexpr int WIN_BD = 2, WIN_BH = 8;                          // patch: 2 x 8 x 8 = 128 rows
constexpr int WIN_H = WIN_BH + 2;                              // window rows along H
constexpr int WIN_POS = (WIN_BD + 2) * WIN_H * WW;             // 360 window cells
constexpr int XLD = CG + 8;                                    // cell stride in bf16 (80 B)
constexpr int WIN_SEGS = WIN_POS * (CG / 8);                   // 16-byte pieces of a group's window
constexpr int WIN_STEPS = (WIN_SEGS + NTHREADS - 1) / NTHREADS;  // ring steps that carry them
static_assert(WIN_STEPS + STAGES <= TAPS, "window must land before its group");
constexpr size_t WIN_BYTES = (size_t)WIN_POS * XLD * 2;
constexpr size_t WIN_SMEM = RING_BYTES + 2 * WIN_BYTES + (size_t)WIN_POS * 8;

struct WinArgs {
  const __nv_bfloat16* x;
  const __nv_bfloat16* wp;
  const float* bias;
  void* y;
  long long sB, sD, sH, sW;  // element strides of x; channels are contiguous
  int B, D, H, WP, C, Co;
  int OD, OH, OW;
  int ND, NH, NW;  // patches along D, H and W
  int leaky, out_f32;
};

__device__ __forceinline__ void load_window(const WinArgs& a, int g, int step,
                                            __nv_bfloat16* win, const long long* win_off,
                                            int tid) {
  const int seg = step * NTHREADS + tid;
  if (seg >= WIN_SEGS) return;
  const int q = seg % (CG / 8);
  const int pos = seg / (CG / 8);
  const long long off = win_off[pos];
  const bool ok = off >= 0;
  cp_async16(win + pos * XLD + q * 8, ok ? a.x + off + g * CG + q * 8 : a.x, ok);
}

__global__ void __launch_bounds__(NTHREADS, 2) direct_conv_window_kernel(WinArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* wins = reinterpret_cast<__nv_bfloat16*>(smem_raw + RING_BYTES);
  long long* win_off = reinterpret_cast<long long*>(smem_raw + RING_BYTES + 2 * WIN_BYTES);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp >> 2;  // the patch's D plane
  const int wn = warp & 3;   // warp's 32-column slice of BN
  const int n0 = blockIdx.y * BN;
  int t = blockIdx.x;
  const int w0 = (t % a.NW) * BW;
  t /= a.NW;
  const int h0 = (t % a.NH) * WIN_BH;
  t /= a.NH;
  const int d0 = (t % a.ND) * WIN_BD;
  const int b = t / a.ND;
  const int ngroups = a.C / CG;
  const int nchunks = ngroups * TAPS;

  // Each window cell's input offset; -1 outside the input (zero-filled).
  for (int pos = tid; pos < WIN_POS; pos += NTHREADS) {
    const int id = d0 + pos / (WIN_H * WW);
    const int ih = h0 + (pos / WW) % WIN_H;
    const int iw = w0 + pos % WW;
    const bool ok = id < a.D && ih < a.H && iw < a.WP;
    win_off[pos] = ok ? b * a.sB + id * a.sD + ih * a.sH + iw * a.sW : -1;
  }
  __syncthreads();

  for (int step = 0; step < WIN_STEPS; ++step) load_window(a, 0, step, wins, win_off, tid);
  cp_async_commit();
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {  // taps 0.. of group 0
    load_wchunk(a.wp + (size_t)s * a.C * a.Co, 0, a.Co, n0, ring + s * CG * WLD, tid);
    cp_async_commit();
  }

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  // Lane's ldmatrix row: output row (lane & 15) of fragment 0 = cell
  // (d = wm, h = (lane & 15) >> 3, w = lane & 7) of the window; fragment mt
  // lies 2 H rows further.
  const int a_lane = ((wm * WIN_H + ((lane & 15) >> 3)) * WW + (lane & 7)) * XLD + (lane >> 4) * 8;

  int j = 0;  // ring chunk being consumed
  for (int g = 0; g < ngroups; ++g) {
    const __nv_bfloat16* win = wins + (g & 1) * (WIN_POS * XLD);
    for (int tap = 0; tap < TAPS; ++tap, ++j) {
      cp_async_wait<STAGES - 2>();  // chunk j has landed (and, at tap 0, group g's window)
      __syncthreads();              // ... everyone's part; stage j-1 and window g-1 are free
      const int jn = j + STAGES - 1;
      if (jn < nchunks)
        load_wchunk(a.wp + (size_t)(jn % TAPS) * a.C * a.Co, (jn / TAPS) * CG, a.Co, n0,
                    ring + (jn % STAGES) * CG * WLD, tid);
      if (g + 1 < ngroups && tap < WIN_STEPS)
        load_window(a, g + 1, tap, wins + ((g + 1) & 1) * (WIN_POS * XLD), win_off, tid);
      cp_async_commit();

      const int kd = tap / 6, kh = (tap >> 1) % 3, ka = tap & 1;
      const int shift = ((kd * WIN_H + kh) * WW + ka) * XLD;
      mma_chunk<4>(acc, win + a_lane + shift, 2 * WW * XLD, ring + (j % STAGES) * CG * WLD, lane,
                   wn);
    }
  }
  cp_async_wait<0>();

  // ---- epilogue: bias, LeakyReLU, masked stores straight from the fragments
  const int g8 = lane >> 2;
  const int t4 = lane & 3;
  const int od = d0 + wm;
  const int ow = w0 + g8;
  if (od >= a.OD || ow >= a.OW) return;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int oh = h0 + 2 * mt + half;
      if (oh >= a.OH) continue;
      const size_t rowi = (((size_t)b * a.OD + od) * a.OH + oh) * a.OW + ow;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = n0 + wn * 32 + nt * 8 + 2 * t4;
        if (col >= a.Co) continue;
        finish2(a.y, rowi * a.Co + col, acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1],
                a.bias[col], a.bias[col + 1], a.leaky, a.out_f32);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// B5: plane-streamed, N parts
// ---------------------------------------------------------------------------

constexpr int MAX_PARTS = 4;
constexpr int NSLOT = 2;  // plane ring slots (see the kernel's note on their schedule)

struct StripeArgs {
  const __nv_bfloat16* x[MAX_PARTS];
  long long sB[MAX_PARTS], sD[MAX_PARTS], sH[MAX_PARTS], sW[MAX_PARTS];
  int cin[MAX_PARTS];
  int nparts;
  const __nv_bfloat16* wp;
  const float* bias;
  void* y;
  int B, D, H, WP, C, Co;  // C: channels of all parts together
  int OD, OH, OW;
  int NSEG, DSEG, NH, NW;  // D segments, output planes per segment, patches along H and W
  int leaky, out_f32;
};

// Piece `step` of input plane `plane` into a ring slot laid out as
// [cell][C + 8]: the parts' channels side by side, as the concat would be.
template <int POS>
__device__ __forceinline__ void load_plane(const StripeArgs& a, int b, int plane, int h0, int w0,
                                           int step, __nv_bfloat16* slot, int tid) {
  const int cq = a.C / 8;
  const int seg = step * NTHREADS + tid;
  if (seg >= POS * cq) return;
  const int pos = seg / cq;
  const int c = (seg % cq) * 8;
  const int ih = h0 + pos / WW;
  const int iw = w0 + pos % WW;
  const bool ok = ih < a.H && iw < a.WP;
  // (constant indices: a dynamically indexed kernel parameter can land in local memory)
  const __nv_bfloat16* src = a.x[0];
  int c0 = 0;
#pragma unroll
  for (int i = 0; i < MAX_PARTS; ++i) {
    if (i < a.nparts && c >= c0 && c < c0 + a.cin[i])
      src = a.x[i] + b * a.sB[i] + plane * a.sD[i] + ih * a.sH[i] + iw * a.sW[i] + (c - c0);
    c0 += a.cin[i];
  }
  cp_async16(slot + pos * (a.C + 8) + c, ok ? src : a.x[0], ok);
}

// The ring chunk a block prefetches next: tap (kd, k6 = kh * 2 + ka) of channel
// group g, in the order the taps run (kd outermost, then the group, then k6).
// Kept as counters: the loop does no division by a runtime value.
struct ChunkCursor {
  int kd = 0, g = 0, k6 = 0;
  __device__ __forceinline__ void advance(int ngroups) {
    if (++k6 == 6) {
      k6 = 0;
      if (++g == ngroups) {
        g = 0;
        if (++kd == 3) kd = 0;
      }
    }
  }
};

// MT m16 fragments per warp: a patch of BH = 4 MT rows x 8 cells, 32 MT output
// rows per plane.  STG ring stages; with 3, two blocks are to share an SM.
//
// The plane ring has two slots.  Output plane d runs its taps kd-outermost:
// kd = 0 reads input plane d, kd = 1 plane d+1, kd = 2 plane d+2.  Plane d is
// dead once the kd = 0 taps are done, so plane d+2 arrives over it while the
// kd = 1 taps run, and is read from the kd = 2 taps on: plane p lives in slot
// p & 1, and two slots hold what three planes need.
template <int MT, int STG>
__global__ void __launch_bounds__(NTHREADS, STG == 3 ? 2 : 1)
    direct_conv_stripe_kernel(StripeArgs a) {
  constexpr int BH = 4 * MT;          // patch rows along H
  constexpr int POS = (BH + 2) * WW;  // cells of one input plane's tile
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* planes = reinterpret_cast<__nv_bfloat16*>(smem_raw + (size_t)STG * CG * WLD * 2);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp >> 2;  // warp's slice of the patch's H rows
  const int wn = warp & 3;   // warp's 32-column slice of BN
  const int n0 = blockIdx.y * BN;
  int t = blockIdx.x;
  const int w0 = (t % a.NW) * BW;
  t /= a.NW;
  const int h0 = (t % a.NH) * BH;
  t /= a.NH;
  const int od0 = (t % a.NSEG) * a.DSEG;
  const int b = t / a.NSEG;
  const int nplanes = min(a.DSEG, a.OD - od0);
  const int LD = a.C + 8;  // cell stride in bf16
  const int ngroups = a.C / CG;
  const int nchunks = nplanes * TAPS * ngroups;
  const int plane_steps = (POS * (a.C / 8) + NTHREADS - 1) / NTHREADS;
  const size_t tap_elems = (size_t)a.C * a.Co;

  for (int p = 0; p < 2; ++p)
    for (int step = 0; step < plane_steps; ++step)
      load_plane<POS>(a, b, od0 + p, h0, w0, step, planes + p * POS * LD, tid);
  cp_async_commit();
  ChunkCursor next;  // chunk j + STG - 1
#pragma unroll
  for (int s = 0; s < STG - 1; ++s) {  // (a plane has at least 18 chunks)
    load_wchunk(a.wp + (size_t)(next.kd * 6 + next.k6) * tap_elems, next.g * CG, a.Co, n0,
                ring + s * CG * WLD, tid);
    next.advance(ngroups);
    cp_async_commit();
  }

  // Lane's ldmatrix row: output row (lane & 15) of fragment 0 = cell
  // (h = wm * 2 MT + ((lane & 15) >> 3), w = lane & 7); fragment mt lies 2 H rows further.
  const int a_lane = ((wm * 2 * MT + ((lane & 15) >> 3)) * WW + (lane & 7)) * LD + (lane >> 4) * 8;
  const int g8 = lane >> 2;
  const int t4 = lane & 3;

  int j = 0;  // ring chunk being consumed
  for (int pl = 0; pl < nplanes; ++pl) {
    float acc[MT][4][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

    int pstep = 0;  // pieces of the incoming plane started so far
    for (int kd = 0; kd < 3; ++kd) {
      const __nv_bfloat16* slot = planes + ((pl + kd) & 1) * POS * LD + a_lane;
      for (int g = 0; g < ngroups; ++g) {
#pragma unroll
        for (int k6 = 0; k6 < 6; ++k6, ++j) {
          cp_async_wait<STG - 2>();  // chunk j has landed, and every plane piece older than it
          __syncthreads();           // ... everyone's part; stage j-1 is free
          if (j + STG - 1 < nchunks) {
            load_wchunk(a.wp + (size_t)(next.kd * 6 + next.k6) * tap_elems, next.g * CG, a.Co,
                        n0, ring + ((j + STG - 1) % STG) * CG * WLD, tid);
            next.advance(ngroups);
          }
          // Input plane pl+2 rides the first steps of the kd = 1 taps (every warp is past
          // the kd = 0 taps, the last readers of plane pl, whose slot it takes).
          if (kd == 1 && pstep < plane_steps) {
            load_plane<POS>(a, b, od0 + pl + 2, h0, w0, pstep, planes + (pl & 1) * POS * LD, tid);
            ++pstep;
          }
          cp_async_commit();
          mma_chunk<MT>(acc, slot + ((k6 >> 1) * WW + (k6 & 1)) * LD + g * CG, 2 * WW * LD,
                        ring + (j % STG) * CG * WLD, lane, wn);
        }
      }
    }

    // ---- this plane's epilogue: bias, LeakyReLU, masked stores from the fragments
    const int od = od0 + pl;
    const int ow = w0 + g8;
    if (ow < a.OW) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int oh = h0 + wm * 2 * MT + 2 * mt + half;
          if (oh >= a.OH) continue;
          const size_t rowi = (((size_t)b * a.OD + od) * a.OH + oh) * a.OW + ow;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int col = n0 + wn * 32 + nt * 8 + 2 * t4;
            if (col >= a.Co) continue;
            finish2(a.y, rowi * a.Co + col, acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1],
                    a.bias[col], a.bias[col + 1], a.leaky, a.out_f32);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
}

template <int MT, int STG>
cudaError_t launch_stripe(StripeArgs& a, cudaStream_t stream) {
  constexpr int BH = 4 * MT;
  constexpr int POS = (BH + 2) * WW;
  a.NH = (a.OH + BH - 1) / BH;
  const size_t smem = (size_t)STG * CG * WLD * 2 + (size_t)NSLOT * POS * (a.C + 8) * 2;
  // The incoming plane must land while the kd = 1 taps run: its last piece rides
  // step 6 ngroups + plane_steps - 1 and is waited for STG - 1 steps later.
  const int plane_steps = (POS * (a.C / 8) + NTHREADS - 1) / NTHREADS;
  if (plane_steps + STG - 2 > 6 * (a.C / CG)) return cudaErrorInvalidValue;
  auto kern = direct_conv_stripe_kernel<MT, STG>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid(a.B * a.NSEG * a.NH * a.NW, (a.Co + BN - 1) / BN);
  kern<<<grid, NTHREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes).  Shapes and strides are checked by
// the Python wrappers (ops/direct_conv_cuda.py: channel counts % 32 == 0,
// Co % 8 == 0, strides of 8 elements); each returns the CUDA error code of the
// launch (0 = success).
extern "C" int direct_conv_window(const void* x, const void* wp, const void* bias, void* y,
                                  long long sB, long long sD, long long sH, long long sW, int B,
                                  int D, int H, int WP, int C, int Co, int leaky, int out_f32,
                                  void* stream) {
  WinArgs a = {};
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.wp = static_cast<const __nv_bfloat16*>(wp);
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
  a.ND = (a.OD + WIN_BD - 1) / WIN_BD;
  a.NH = (a.OH + WIN_BH - 1) / WIN_BH;
  a.NW = (a.OW + BW - 1) / BW;
  a.leaky = leaky;
  a.out_f32 = out_f32;
  auto kern = direct_conv_window_kernel;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)WIN_SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B * a.ND * a.NH * a.NW, (Co + BN - 1) / BN);
  kern<<<grid, NTHREADS, WIN_SMEM, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// xs: nparts input pointers; strides: nparts x (sB, sD, sH, sW) in elements;
// cins: nparts channel counts (each % 32 == 0, C their sum <= 512); dseg:
// output planes per block.
extern "C" int direct_conv_stripe(const void* const* xs, const long long* strides,
                                  const int* cins, int nparts, const void* wp, const void* bias,
                                  void* y, int B, int D, int H, int WP, int C, int Co, int dseg,
                                  int leaky, int out_f32, void* stream) {
  if (nparts < 1 || nparts > MAX_PARTS || dseg < 1) return (int)cudaErrorInvalidValue;
  StripeArgs a = {};
  for (int i = 0; i < nparts; ++i) {
    a.x[i] = static_cast<const __nv_bfloat16*>(xs[i]);
    a.sB[i] = strides[4 * i];
    a.sD[i] = strides[4 * i + 1];
    a.sH[i] = strides[4 * i + 2];
    a.sW[i] = strides[4 * i + 3];
    a.cin[i] = cins[i];
  }
  a.nparts = nparts;
  a.wp = static_cast<const __nv_bfloat16*>(wp);
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
  a.NW = (a.OW + BW - 1) / BW;
  a.leaky = leaky;
  a.out_f32 = out_f32;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (C <= 128)
    e = launch_stripe<4, 3>(a, st);  // 16 x 8 patch, 3-stage ring, two blocks per SM
  else if (C <= 256)
    e = launch_stripe<4, 4>(a, st);  // 16 x 8 patch
  else if (C <= 512)
    e = launch_stripe<2, 4>(a, st);  // 8 x 8 patch
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}
