// Periodic friends-of-friends linking: sparse cell grid + union-find, C++.
//
// Native engine of the cell-hash finder in science/halos.py (a copy of the
// JAX package's native/fof.cpp, so that this package needs nothing of it):
// the Python implementation stays the canonical, always-available path;
// this kernel accelerates the pair-linking inner loop for production
// catalogs.  Host code: compiled on demand by native/__init__.py (g++ -O3
// -shared) and called through ctypes; exact agreement with the numpy
// engine is asserted in tests/test_torch_port_halos.py.
//
// The cell grid is SPARSE (occupied cells only, sorted ids + binary
// search for neighbors): the grid can have ~10^9 cells at production
// linking lengths while only <= Np are occupied, so a dense CSR array
// would dominate both memory and time.
//
// Threading: the pair-linking loop partitions the occupied cells across
// `n_threads` workers over a LOCK-FREE union-find: CAS root hooks + CAS
// path halving (Jayanti-Tarjan concurrent DSU).  Hooks always attach the
// larger root under the smaller (parent values are monotone decreasing,
// so no cycles under any interleaving), which also makes the FINAL labels
// deterministic: each component's representative is its minimum particle
// index regardless of thread schedule, the same representative the numpy
// engine produces, so multi-threaded results stay array-identical to
// single-threaded and to Python.
//
// Contract: positions in [0, L), absolute linking length b.  Output
// labels[i] = union-find root of particle i; roots are the minimum
// particle index of each component.  n_threads <= 1 runs the exact
// single-threaded path.  Returns 0 on success.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cmath>
#include <memory>
#include <thread>
#include <vector>

namespace {

struct UnionFind {
  std::unique_ptr<std::atomic<int64_t>[]> parent;
  explicit UnionFind(int64_t n) : parent(new std::atomic<int64_t>[n]) {
    for (int64_t i = 0; i < n; ++i)
      parent[i].store(i, std::memory_order_relaxed);
  }
  int64_t find(int64_t x) {
    while (true) {
      int64_t p = parent[x].load(std::memory_order_relaxed);
      if (p == x) return x;
      int64_t gp = parent[p].load(std::memory_order_relaxed);
      if (gp == p) return p;
      // CAS path halving: safe under concurrency because parent values
      // only ever decrease (hooks go larger -> smaller root).
      parent[x].compare_exchange_weak(p, gp, std::memory_order_relaxed);
      x = gp;
    }
  }
  void unite(int64_t a, int64_t b) {
    while (true) {
      a = find(a);
      b = find(b);
      if (a == b) return;
      if (a > b) std::swap(a, b);  // hook the larger root under the smaller
      int64_t expected = b;
      if (parent[b].compare_exchange_weak(expected, a,
                                          std::memory_order_relaxed))
        return;
      // b's root changed underneath us — retry from the new roots.
    }
  }
};

// The 13 positive-halfspace neighbor offsets + the self cell — every
// unordered cell pair in the 27-neighborhood visited once (same table as
// science/halos.py::_HALF_OFFSETS).
const int OFFSETS[14][3] = {
    {0, 0, 0}, {0, 0, 1}, {0, 1, -1}, {0, 1, 0}, {0, 1, 1},
    {1, -1, -1}, {1, -1, 0}, {1, -1, 1}, {1, 0, -1}, {1, 0, 0},
    {1, 0, 1}, {1, 1, -1}, {1, 1, 0}, {1, 1, 1},
};

inline double min_image(double d, double L) {
  d = std::fabs(d);
  return d > 0.5 * L ? L - d : d;
}

}  // namespace

extern "C" int fof_labels(const float* pos, int64_t np_, double L, double b,
                          int64_t* labels_out, int n_threads) {
  if (np_ <= 0 || L <= 0 || b <= 0 || b != b) return 1;
  // Cell width >= b so linked pairs span at most one cell per axis.
  int64_t ncell = static_cast<int64_t>(std::floor(L / b));
  if (ncell < 1) ncell = 1;
  if (ncell > 2048) ncell = 2048;
  const double cell_w = L / static_cast<double>(ncell);
  const double b2 = b * b;

  // Cell id per particle, then sort particle indices by cell id.
  std::vector<int64_t> cid(np_);
  for (int64_t i = 0; i < np_; ++i) {
    int64_t cx = static_cast<int64_t>(pos[3 * i + 0] / cell_w);
    int64_t cy = static_cast<int64_t>(pos[3 * i + 1] / cell_w);
    int64_t cz = static_cast<int64_t>(pos[3 * i + 2] / cell_w);
    if (cx >= ncell) cx = ncell - 1;
    if (cy >= ncell) cy = ncell - 1;
    if (cz >= ncell) cz = ncell - 1;
    if (cx < 0 || cy < 0 || cz < 0) return 2;  // position out of [0, L)
    cid[i] = (cx * ncell + cy) * ncell + cz;
  }
  // Sort (cell, particle) pairs — contiguous keys sort ~2x faster than an
  // indirect comparator chasing cid[] per comparison.
  std::vector<std::pair<int64_t, int64_t>> keyed(np_);
  for (int64_t i = 0; i < np_; ++i) keyed[i] = {cid[i], i};
  std::sort(keyed.begin(), keyed.end());
  std::vector<int64_t> order(np_);
  for (int64_t i = 0; i < np_; ++i) order[i] = keyed[i].second;
  keyed.clear();
  keyed.shrink_to_fit();

  // Sorted position copy: pair loops stream contiguous memory.
  std::vector<float> ps(3 * np_);
  for (int64_t s = 0; s < np_; ++s) {
    const int64_t i = order[s];
    ps[3 * s] = pos[3 * i];
    ps[3 * s + 1] = pos[3 * i + 1];
    ps[3 * s + 2] = pos[3 * i + 2];
  }

  // Occupied cells: unique sorted ids + slot ranges.
  std::vector<int64_t> uniq, start;
  uniq.reserve(np_ / 4 + 1);
  start.reserve(np_ / 4 + 2);
  for (int64_t s = 0; s < np_; ++s) {
    const int64_t c = cid[order[s]];
    if (uniq.empty() || uniq.back() != c) {
      uniq.push_back(c);
      start.push_back(s);
    }
  }
  start.push_back(np_);
  const int64_t nocc = static_cast<int64_t>(uniq.size());

  UnionFind uf(np_);

  // wrap=false: the cell pair is face-adjacent without crossing the box
  // edge, so plain |dx| is already the minimum image (holds for
  // ncell >= 3; tiny grids always take the wrapped path).
  auto link_ranges = [&](int64_t a0, int64_t a1, int64_t b0, int64_t b1,
                         bool self_pair, bool wrap) {
    for (int64_t ia = a0; ia < a1; ++ia) {
      const double xi = ps[3 * ia], yi = ps[3 * ia + 1], zi = ps[3 * ia + 2];
      const int64_t jb0 = self_pair ? ia + 1 : b0;
      for (int64_t jb = jb0; jb < b1; ++jb) {
        double dx, dy, dz;
        if (wrap) {
          dx = min_image(xi - ps[3 * jb], L);
          if (dx > b) continue;
          dy = min_image(yi - ps[3 * jb + 1], L);
          if (dy > b) continue;
          dz = min_image(zi - ps[3 * jb + 2], L);
          if (dz > b) continue;
        } else {
          dx = std::fabs(xi - ps[3 * jb]);
          if (dx > b) continue;
          dy = std::fabs(yi - ps[3 * jb + 1]);
          if (dy > b) continue;
          dz = std::fabs(zi - ps[3 * jb + 2]);
          if (dz > b) continue;
        }
        if (dx * dx + dy * dy + dz * dz <= b2) {
          if (order[ia] != order[jb]) uf.unite(order[ia], order[jb]);
        }
      }
    }
  };

  const int64_t ncell2 = ncell * ncell;
  auto link_cells = [&](int64_t u_begin, int64_t u_end) {
    for (int64_t u = u_begin; u < u_end; ++u) {
      const int64_t c = uniq[u];
      const int64_t cx = c / ncell2, cy = (c / ncell) % ncell, cz = c % ncell;
      for (const auto& off : OFFSETS) {
        const bool self = off[0] == 0 && off[1] == 0 && off[2] == 0;
        if (self) {
          link_ranges(start[u], start[u + 1], start[u], start[u + 1], true,
                      ncell <= 2);
          continue;
        }
        const int64_t ux = cx + off[0], uy = cy + off[1], uz = cz + off[2];
        const bool wrapped = ux < 0 || ux >= ncell || uy < 0 || uy >= ncell ||
                             uz < 0 || uz >= ncell;
        const int64_t px = (ux + ncell) % ncell;
        const int64_t py = (uy + ncell) % ncell;
        const int64_t pz = (uz + ncell) % ncell;
        const int64_t p = (px * ncell + py) * ncell + pz;
        if (p == c) continue;  // tiny grid: offset wraps onto this cell
        const auto it = std::lower_bound(uniq.begin(), uniq.end(), p);
        if (it == uniq.end() || *it != p) continue;  // neighbor unoccupied
        const int64_t v = it - uniq.begin();
        link_ranges(start[u], start[u + 1], start[v], start[v + 1], false,
                    wrapped || ncell <= 2);
      }
    }
  };

  int nt = n_threads;
  if (nt <= 0) nt = static_cast<int>(std::thread::hardware_concurrency());
  if (nt < 1) nt = 1;
  if (static_cast<int64_t>(nt) > nocc) nt = static_cast<int>(std::max<int64_t>(nocc, 1));
  if (nt <= 1) {
    link_cells(0, nocc);
  } else {
    // Interleaved round-robin strides would thrash the neighbor binary
    // searches; contiguous cell ranges keep each worker's pair loops on
    // one streaming region.  Dense cores cluster in cell order, so use
    // MORE chunks than threads with dynamic claiming to balance them.
    std::atomic<int64_t> next_chunk{0};
    const int64_t n_chunks = std::min<int64_t>(nocc, int64_t(nt) * 16);
    const int64_t chunk = (nocc + n_chunks - 1) / n_chunks;
    std::vector<std::thread> pool;
    pool.reserve(nt);
    for (int t = 0; t < nt; ++t) {
      pool.emplace_back([&]() {
        while (true) {
          const int64_t k = next_chunk.fetch_add(1, std::memory_order_relaxed);
          const int64_t u0 = k * chunk;
          if (u0 >= nocc) return;
          link_cells(u0, std::min(u0 + chunk, nocc));
        }
      });
    }
    for (auto& th : pool) th.join();
  }

  // Final full compression (single-threaded): labels are component minima.
  for (int64_t i = 0; i < np_; ++i) labels_out[i] = uf.find(i);
  return 0;
}
