// Periodic chunk staging: gather a padded, periodically-wrapped subvolume
// out of a C-order (C, D, H, W) host array into a contiguous buffer.
//
// This is the host half of the chunked big-box runtime
// (``chunked.py::ChunkedHierarchicalProcessor.process_box`` host-input
// mode): the reference does the same crop with a broadcast numpy
// fancy-index (the reference package's ``subbox.py:197-201``), which
// executes element-by-element (~30 MiB/s for fp16, as the JAX package
// measured it).  Here every output row along the W axis is at most a handful of
// ``memcpy`` segments (one per torus wrap), so the gather runs at memory
// bandwidth.  Dtype-agnostic: operates on raw bytes with an ``itemsize``.
//
// The row loop parallelizes over std::thread when more than one core is
// available; segment copies dominate either way.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Geom {
  const unsigned char* src;
  unsigned char* dst;
  int64_t C, D, H, W;      // global extents
  int64_t sd, sh, sw;      // start (already >= 0; wrapped again here)
  int64_t od, oh, ow;      // output extents (may exceed the global extent)
  int64_t itemsize;
};

// Copy one output row: dst row of `ow` elements from the periodic source
// row starting at column `sw`.  Handles multi-wrap (ow > W) by restarting
// at column 0 after each torus crossing.
inline void copy_row(const Geom& g, const unsigned char* src_row,
                     unsigned char* dst_row) {
  int64_t copied = 0;
  int64_t pos = g.sw % g.W;
  while (copied < g.ow) {
    int64_t n = std::min(g.W - pos, g.ow - copied);
    std::memcpy(dst_row + copied * g.itemsize, src_row + pos * g.itemsize,
                static_cast<size_t>(n * g.itemsize));
    copied += n;
    pos = 0;
  }
}

void gather_rows(const Geom& g, int64_t row_begin, int64_t row_end) {
  const int64_t rows_per_c = g.od * g.oh;
  for (int64_t r = row_begin; r < row_end; ++r) {
    const int64_t c = r / rows_per_c;
    const int64_t rem = r % rows_per_c;
    const int64_t id = rem / g.oh;
    const int64_t ih = rem % g.oh;
    const int64_t gd = (g.sd + id) % g.D;
    const int64_t gh = (g.sh + ih) % g.H;
    const unsigned char* src_row =
        g.src + (((c * g.D + gd) * g.H + gh) * g.W) * g.itemsize;
    unsigned char* dst_row = g.dst + r * g.ow * g.itemsize;
    copy_row(g, src_row, dst_row);
  }
}

}  // namespace

extern "C" int periodic_gather(const unsigned char* src, unsigned char* dst,
                               int64_t C, int64_t D, int64_t H, int64_t W,
                               int64_t sd, int64_t sh, int64_t sw,
                               int64_t od, int64_t oh, int64_t ow,
                               int64_t itemsize, int n_threads) {
  if (C <= 0 || D <= 0 || H <= 0 || W <= 0 || od <= 0 || oh <= 0 || ow <= 0 ||
      itemsize <= 0 || sd < 0 || sh < 0 || sw < 0) {
    return 1;
  }
  Geom g{src, dst, C, D, H, W, sd, sh, sw, od, oh, ow, itemsize};
  const int64_t rows = C * od * oh;
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  if (n_threads <= 0) n_threads = hw > 0 ? hw : 1;
  n_threads = static_cast<int>(
      std::min<int64_t>(n_threads, std::max<int64_t>(rows, 1)));
  if (n_threads <= 1) {
    gather_rows(g, 0, rows);
    return 0;
  }
  std::vector<std::thread> pool;
  pool.reserve(n_threads);
  const int64_t per = (rows + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    const int64_t b = t * per;
    const int64_t e = std::min(rows, b + per);
    if (b >= e) break;
    pool.emplace_back(gather_rows, std::cref(g), b, e);
  }
  for (auto& th : pool) th.join();
  return 0;
}
