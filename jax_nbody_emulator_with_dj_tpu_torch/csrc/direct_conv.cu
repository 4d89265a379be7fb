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
// Design (simple and right first; wgmma, bulk copies and specialised
// warpgroups, as stripe_conv.cu has them, are later work):
//   * a block's 8 warps (2 along M x 4 along N) run mma.sync m16n8k16 bf16
//     tiles fed by ldmatrix, with one float32 accumulator set.  The weights
//     stream through a 4-stage cp.async ring of 32-row x 128-column chunks
//     shared by the warps, one chunk per (tap, 32-channel group), running
//     ahead across group boundaries;
//   * a tap shift is an address offset into the input tile in shared memory:
//     each lane's ldmatrix row address is its output position's window cell,
//     plus a constant per tap.  No shifted copy is made;
//   * out-of-range input cells are zero-filled by cp.async and ragged output
//     edges are masked in the store, so any (D, H, WP) and any strides with
//     contiguous channels go in as they are;
//   * a block owns a 2 x 8 x 8 patch of output positions (D, H, packed-W
//     cells) x 128 output channels.  Its 4 x 10 x 9 halo window comes in 32
//     input channels at a time, double buffered: group g+1 lands while group
//     g's 18 taps run.  Each input element is read 2.8 times over all blocks
//     (from L2, mostly).  With 94 registers two blocks share an SM, and one's
//     products run while the other waits at its ring barrier.

#include "mma_common.cuh"

namespace {

using namespace convk;

constexpr int BW = 8;       // packed-W cells of a block's patch
constexpr int WW = BW + 1;  // ... and of its input tile (1 halo cell)
constexpr int TAPS = 18;

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

}  // namespace

// Plain C entry point (bound with ctypes).  Shapes and strides are checked by
// the Python wrapper (ops/direct_conv_cuda.py: channel counts % 32 == 0,
// Co % 8 == 0, strides of 8 elements); returns the CUDA error code of the
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
