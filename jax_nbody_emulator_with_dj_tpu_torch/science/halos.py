"""Friends-of-friends halo finding and halo mass functions (host code).

Counterpart of ``jax_nbody_emulator_with_dj_tpu/science/halos.py``: a
host-side periodic FoF, plus

  * the empirical HMF dn/dlog10M with the Warren-style FoF mass-bias
    correction n -> n(1 - n^-0.6);
  * the Tinker et al. 2008 theory HMF from the linear P(k).

The group finder is a **cell-hash union-find**: particles are bucketed into
periodic cells of the linking length (any pair within b spans at most one
cell per axis), candidate pairs are generated per neighbor offset with
vectorized ragged expansion (chunked over cells, so peak memory is O(N)),
and linked pairs are merged with a batched path-halving union-find; the
native engine (``native/fof.cpp``) runs the same linking in C++ threads.
Displacements may come from the card as torch tensors; everything here runs
on numpy arrays on the host.
"""

from __future__ import annotations

import numpy as np

from ..cosmology import growth_factor
from ..native import fof_labels as native_fof
from ._common import to_numpy
from .linear_pk import sigma_r

RHO_CRIT = 2.77536627e11  # M_sun/h / (Mpc/h)^3


def positions_from_displacement(psi, boxsize: float):
    """Eulerian positions x = (q + psi) mod L of grid particles.

    Args:
        psi: (3, N, N, N) displacement [Mpc/h], numpy or a torch tensor on
            any device.
        boxsize: box side [Mpc/h].

    Returns:
        (N^3, 3) float32 numpy positions in [0, L).
    """
    psi = to_numpy(psi, np.float32)
    n = psi.shape[1]
    q = (np.arange(n, dtype=np.float32)) * (boxsize / n)
    qx, qy, qz = np.meshgrid(q, q, q, indexing="ij")
    pos = np.stack(
        [qx + psi[0], qy + psi[1], qz + psi[2]], axis=-1
    ).reshape(-1, 3)
    return np.mod(pos, boxsize).astype(np.float32)


def _find_roots(parent: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Vectorized union-find root lookup with path halving."""
    cur = parent[idx]
    while True:
        up = parent[cur]
        if np.array_equal(up, cur):
            return cur
        parent[idx] = up  # halve the paths we walked through
        cur = up


def _union_batch(parent: np.ndarray, a: np.ndarray, b: np.ndarray) -> None:
    """Merge pair batch (a_i ~ b_i) into the union-find forest.

    Batched unions can conflict (several pairs rooting the same node), so
    the merge iterates: link each root pair hi->lo via ``np.minimum.at``
    (deterministic under collisions), then re-find until no pair straddles
    two components.  Converges in O(log) rounds.
    """
    while len(a):
        ra = _find_roots(parent, a)
        rb = _find_roots(parent, b)
        diff = ra != rb
        if not diff.any():
            return
        a, b = a[diff], b[diff]
        ra, rb = ra[diff], rb[diff]
        hi = np.maximum(ra, rb)
        lo = np.minimum(ra, rb)
        np.minimum.at(parent, hi, lo)


# The 13 positive-halfspace neighbor offsets + the self cell: every
# unordered cell pair within the 27-neighborhood is visited exactly once.
_HALF_OFFSETS = [(0, 0, 0), (0, 0, 1), (0, 1, -1), (0, 1, 0), (0, 1, 1)] + [
    (1, dy, dz) for dy in (-1, 0, 1) for dz in (-1, 0, 1)
]


def _finalize_groups(pos: np.ndarray, root_labels: np.ndarray, L: float,
                     nmin: int):
    """Group statistics from per-particle union-find roots (shared tail of
    the numpy and native engines — both emit min-component-index roots)."""
    n_p = len(pos)
    roots, labels = np.unique(root_labels, return_inverse=True)
    n_comp = len(roots)

    lengths = np.bincount(labels, minlength=n_comp)
    keep = lengths >= nmin
    group_ids = np.nonzero(keep)[0]
    remap = -np.ones(n_comp, np.int64)
    remap[group_ids] = np.arange(len(group_ids))
    out_labels = remap[labels].astype(np.int32)

    # Periodic center of mass via circular mean per axis.
    centers = np.zeros((len(group_ids), 3), np.float64)
    two_pi = 2 * np.pi / L
    for d in range(3):
        ang = pos[:, d].astype(np.float64) * two_pi
        cs = np.zeros(n_comp)
        sn = np.zeros(n_comp)
        np.add.at(cs, labels, np.cos(ang))
        np.add.at(sn, labels, np.sin(ang))
        mean_ang = np.arctan2(sn[group_ids], cs[group_ids])
        centers[:, d] = np.mod(mean_ang / (2 * np.pi), 1.0) * L

    del n_p
    return {
        "labels": out_labels,
        "lengths": lengths[group_ids].astype(np.int64),
        "centers": centers.astype(np.float32),
        "n_groups": int(len(group_ids)),
    }


def friends_of_friends(
    positions: np.ndarray,
    boxsize: float,
    linking_length: float,
    nmin: int = 20,
    chunk: int = 4_000_000,
    engine: str = "auto",
):
    """Periodic FoF group finder (cell-hash + batched union-find).

    O(N) memory; candidate pairs are generated per neighbor-cell offset in
    cell chunks, distance-filtered with the periodic minimum image, and
    merged into a union-find forest — no global pair graph.  512^3
    particles run on one host (reference scale: ``halos.py:407-450``).

    Args:
        positions: (Np, 3) in [0, boxsize).
        boxsize: periodic box side.
        linking_length: absolute linking length b (same units).
        nmin: minimum group multiplicity to report.
        chunk: candidate-pair batch size (memory control).
        engine: 'auto' uses the native C++ linking kernel when it builds
            (``native/fof.cpp``, ~1.5-2x the numpy engine with far
            smaller peak memory; exact agreement — both emit
            min-component-index roots), falling back to numpy;
            'numpy' / 'native' force one.

    Returns:
        dict with 'labels' (Np,) int32 (-1 for unreported), 'lengths',
        'centers' (group CM positions, periodic-aware), 'n_groups'.
    """
    pos = np.asarray(positions, np.float32)
    n_p = len(pos)
    b = float(linking_length)
    L = float(boxsize)

    # Normalize slightly out-of-contract inputs (file-format rounding can
    # leave coordinates a few ulp below 0 / at L) so both engines see the
    # same in-[0, L) catalog and behave identically.
    if n_p and (float(pos.min()) < 0.0 or float(pos.max()) >= L):
        pos = np.mod(pos, np.float32(L))
        pos[pos >= L] = 0.0  # f32 mod of a tiny negative can round to L

    if engine not in ("auto", "numpy", "native"):
        raise ValueError(f"engine must be auto/numpy/native, got {engine!r}")
    if engine in ("auto", "native"):
        try:
            roots = native_fof(pos, L, b) if n_p else np.zeros(0, np.int64)
        except Exception:
            if engine == "native":
                raise
            roots = None  # auto: any native failure falls back to numpy
        if roots is not None:
            return _finalize_groups(pos, roots, L, nmin)
        if engine == "native":
            raise RuntimeError("native FoF kernel unavailable (g++ build failed)")

    # Cell grid: cell >= b so any linked pair spans <= 1 cell per axis.
    ncell = max(1, int(np.floor(L / b)))
    ncell = min(ncell, 2048)  # cap the id space; cells only get bigger
    cell_w = L / ncell
    # Quotient in float64, matching the native kernel (fof.cpp:77): an f32
    # quotient can misassign a boundary particle by one cell when cell_w
    # is within an f32 ulp of b, silently dropping genuine links.
    ci = np.empty((n_p, 3), np.int64)
    for d in range(3):
        ci[:, d] = pos[:, d].astype(np.float64) / cell_w
    np.clip(ci, 0, ncell - 1, out=ci)
    cid = (ci[:, 0] * ncell + ci[:, 1]) * ncell + ci[:, 2]
    del ci

    order = np.argsort(cid, kind="stable")
    cid_sorted = cid[order]
    del cid
    # Occupied cells: ids (sorted unique), start offsets, counts.
    uniq, starts, counts = np.unique(
        cid_sorted, return_index=True, return_counts=True
    )
    del cid_sorted
    ux = uniq // (ncell * ncell)
    uy = (uniq // ncell) % ncell
    uz = uniq % ncell

    parent = np.arange(n_p, dtype=np.int64)

    def link_pairs(ia, ib):
        """Distance-filter candidate particle pairs and union them.

        Distances evaluate in float64, matching the native kernel
        (fof.cpp:146), so the two engines give identical link verdicts for
        pairs within f32 rounding of the |d| == b threshold."""
        d = np.abs(pos[ia].astype(np.float64) - pos[ib].astype(np.float64))
        d = np.minimum(d, L - d)  # periodic minimum image
        hit = (d[:, 0] <= b) & (d[:, 1] <= b) & (d[:, 2] <= b)
        hit &= (d * d).sum(axis=1) <= b * b
        if hit.any():
            _union_batch(parent, ia[hit], ib[hit])

    def expand(c_idx, p_idx):
        """All (particle of cell c, particle of cell p) candidate pairs.

        Ragged vectorized expansion: for each cell pair, n1*n2 candidates.
        """
        n1 = counts[c_idx]
        n2 = counts[p_idx]
        tot = n1 * n2
        nz = tot > 0
        c_idx, p_idx, n1, n2, tot = (
            c_idx[nz], p_idx[nz], n1[nz], n2[nz], tot[nz],
        )
        if not len(tot):
            return (np.zeros(0, np.int64),) * 2
        off = np.concatenate([[0], np.cumsum(tot)])
        total = int(off[-1])
        pair_cell = np.repeat(np.arange(len(tot)), tot)  # which cell pair
        within = np.arange(total, dtype=np.int64) - off[pair_cell]
        ia = starts[c_idx][pair_cell] + within // n2[pair_cell]
        ib = starts[p_idx][pair_cell] + within % n2[pair_cell]
        return order[ia], order[ib]

    n_occ = len(uniq)

    def stream_dense_pair(c, p, dedupe):
        """One cell pair whose product alone exceeds `chunk`: stream row
        blocks of cell c against all of cell p (dense halo cores make
        single-cell products of 10^8+ pairs; a one-shot expand there would
        break the O(N) peak-memory contract).  ``dedupe`` is '<' for the
        self cell (each unordered pair once), '!=' on tiny wrapped grids,
        None otherwise."""
        n1, n2 = int(counts[c]), int(counts[p])
        ib_all = order[starts[p]: starts[p] + n2]
        rows = max(1, chunk // n2)
        for r0 in range(0, n1, rows):
            ia_rows = order[starts[c] + r0: starts[c] + min(r0 + rows, n1)]
            ia = np.repeat(ia_rows, n2)
            ib = np.tile(ib_all, len(ia_rows))
            if dedupe == "<":
                keep = ia < ib
                ia, ib = ia[keep], ib[keep]
            elif dedupe == "!=":
                keep = ia != ib
                ia, ib = ia[keep], ib[keep]
            link_pairs(ia, ib)

    # Per neighbor offset: resolve every occupied partner cell up front,
    # then split into batches by the CUMULATIVE candidate-pair count (not
    # mean occupancy — clustered inputs put 100-1000x the mean in halo-core
    # cells, which would blow a mean-sized batch up by orders of magnitude).
    for dx, dy, dz in _HALF_OFFSETS:
        self_pair = (dx, dy, dz) == (0, 0, 0)
        if self_pair:
            c_all = np.nonzero(counts > 1)[0]
            p_all = c_all
        else:
            px = (ux + dx) % ncell
            py = (uy + dy) % ncell
            pz = (uz + dz) % ncell
            pid = (px * ncell + py) * ncell + pz
            p_idx = np.searchsorted(uniq, pid)
            p_idx = np.clip(p_idx, 0, n_occ - 1)
            occupied = uniq[p_idx] == pid
            if ncell <= 2:
                # degenerate tiny grids: offset wraps onto the same cell
                occupied &= pid != uniq
            c_all = np.nonzero(occupied)[0]
            p_all = p_idx[occupied]
        if not len(c_all):
            continue
        tot = counts[c_all] * counts[p_all]
        csum = np.cumsum(tot)
        s0 = 0
        base = 0
        while s0 < len(c_all):
            s1 = int(np.searchsorted(csum, base + chunk, side="right"))
            s1 = max(s1, s0 + 1)
            if s1 == s0 + 1 and tot[s0] > chunk:
                dedupe = "<" if self_pair else ("!=" if ncell <= 2 else None)
                stream_dense_pair(int(c_all[s0]), int(p_all[s0]), dedupe)
            else:
                ia, ib = expand(c_all[s0:s1], p_all[s0:s1])
                if self_pair:
                    keep = ia < ib  # dedupe within-cell pairs
                    ia, ib = ia[keep], ib[keep]
                elif ncell <= 2:
                    keep = ia != ib
                    ia, ib = ia[keep], ib[keep]
                link_pairs(ia, ib)
            base = int(csum[s1 - 1])
            s0 = s1

    roots = _find_roots(parent, np.arange(n_p, dtype=np.int64))
    return _finalize_groups(pos, roots, L, nmin)


def friends_of_friends_slabbed(
    psi,
    boxsize: float,
    linking_length: float,
    nmin: int = 20,
    n_slabs: int = 8,
    chunk: int = 4_000_000,
    return_labels: bool = False,
    engine: str = "auto",
):
    """Memory-bounded FoF: Eulerian x-slab streaming with ghost-zone merges.

    The same decomposition strategy as the reference's MPI pipeline
    (``halos.py:352-465`` there: rank-per-x-slab nbodykit FoF), run
    sequentially on one host so peak memory is one slab (+2 ghost layers)
    instead of all Np positions: each Eulerian slab ``[x0, x1)`` is
    extended by one linking length per side, FoF'd locally with the
    cell-hash finder (all groups kept), and groups of adjacent slabs are
    merged through the particles their ghost zones share — every
    cross-boundary link has both endpoints within ``b`` of the boundary,
    so the run on either side sees it.  Group statistics (multiplicity,
    periodic CM) accumulate per *owned* particle only and ``nmin`` is
    applied after the merge, so a halo straddling a boundary is counted
    once, with its full mass.

    Args:
        psi: (3, N, N, N) displacement [Mpc/h]: ``np.ndarray`` or
            ``np.memmap`` (only x-row blocks are materialized), or a torch
            tensor on any device (copied to the host whole).
        n_slabs: number of Eulerian slabs; ``boxsize/n_slabs`` must be
            >= 2 linking lengths so ghost zones only touch neighbors.
        return_labels: also build the full (N^3,) label array (needs
            4 B/particle — leave False at production sizes).

    Returns:
        dict with 'lengths', 'centers', 'n_groups' (and 'labels' when
        requested), identical (up to group ordering) to
        ``friends_of_friends`` on the full particle set.
    """
    psi = to_numpy(psi)
    n = psi[0].shape[0]
    slab_subset = _grid_slab_source(psi, n, float(boxsize), chunk)
    return _fof_eulerian_slabs(
        slab_subset, n, float(boxsize), float(linking_length), nmin,
        n_slabs, chunk, return_labels, engine,
    )


def _grid_slab_source(psi, n: int, L: float, chunk: int):
    """Eulerian x-slab membership scans over the Lagrangian grid.

    Returns ``slab_subset(x0, width) -> (positions, gids)`` streaming ``psi``
    in x-row blocks: displacements are bounded by a few slab widths, so the
    whole grid is scanned per slab, but only ``chunk``-sized row blocks are
    ever materialized (``psi`` may be an ``np.memmap``).
    """
    cell = np.float32(L / n)
    q = np.arange(n, dtype=np.float32) * cell

    def slab_subset(x0: float, width: float):
        pos_parts, gid_parts = [], []
        rows = max(1, int(chunk // (n * n)))
        for r0 in range(0, n, rows):
            r1 = min(r0 + rows, n)
            px = np.mod(q[r0:r1, None, None] + np.asarray(psi[0][r0:r1], np.float32), L)
            sel = np.mod(px - x0, L) < width
            if not sel.any():
                continue
            py = np.mod(q[None, :, None] + np.asarray(psi[1][r0:r1], np.float32), L)
            pz = np.mod(q[None, None, :] + np.asarray(psi[2][r0:r1], np.float32), L)
            gid = (
                (np.arange(r0, r1, dtype=np.int64)[:, None, None] * n
                 + np.arange(n, dtype=np.int64)[None, :, None]) * n
                + np.arange(n, dtype=np.int64)[None, None, :]
            )
            pos_parts.append(np.stack([px[sel], py[sel], pz[sel]], axis=-1))
            gid_parts.append(gid[sel])
        if not pos_parts:
            return np.zeros((0, 3), np.float32), np.zeros(0, np.int64)
        return np.concatenate(pos_parts), np.concatenate(gid_parts)

    return slab_subset


def _fof_eulerian_slabs(
    slab_subset, n: int, L: float, b: float, nmin: int, n_slabs: int,
    chunk: int, return_labels: bool, engine: str,
):
    """Shared Eulerian-slab FoF engine (see ``friends_of_friends_slabbed``)."""
    if n_slabs < 1:
        raise ValueError("n_slabs must be >= 1")
    slab_w = L / n_slabs
    if n_slabs > 1 and slab_w < 2 * b:
        raise ValueError(
            f"slab width {slab_w:.3f} < 2 linking lengths {2 * b:.3f}: "
            f"reduce n_slabs"
        )

    if n_slabs == 1:
        pos, gid = slab_subset(0.0, L)
        res = friends_of_friends(pos, L, b, nmin=nmin, chunk=chunk, engine=engine)
        if return_labels:
            labels = np.empty(n**3, np.int32)
            labels[gid] = res["labels"]
            res["labels"] = labels
        else:
            res.pop("labels")
        return res

    # Per-slab runs: group nodes are numbered globally across slabs.
    node_off = [0]
    len_parts, cs_parts, sn_parts = [], [], []
    shared = {}  # boundary index -> list of (gids, node_ids) from both sides
    owned_records = []  # (gids_owned, node_ids_owned) when return_labels
    two_pi = 2 * np.pi / L
    for s in range(n_slabs):
        x0 = s * slab_w
        pos, gid = slab_subset(np.float32((x0 - b) % L), slab_w + 2 * b)
        sub = friends_of_friends(pos, L, b, nmin=1, chunk=chunk, engine=engine)
        nodes = node_off[-1] + sub["labels"].astype(np.int64)
        node_off.append(node_off[-1] + sub["n_groups"])
        own = np.mod(pos[:, 0] - x0, L) < slab_w
        cnt = np.bincount(
            nodes[own] - node_off[-2], minlength=sub["n_groups"]
        ).astype(np.int64)
        len_parts.append(cnt)
        cs = np.zeros((sub["n_groups"], 3))
        sn = np.zeros((sub["n_groups"], 3))
        ang = pos[own].astype(np.float64) * two_pi
        np.add.at(cs, nodes[own] - node_off[-2], np.cos(ang))
        np.add.at(sn, nodes[own] - node_off[-2], np.sin(ang))
        cs_parts.append(cs)
        sn_parts.append(sn)
        if return_labels:
            owned_records.append((gid[own], nodes[own]))
        # ghost zones: low boundary s, high boundary (s+1) % n_slabs
        for bidx, zone_start in ((s, (x0 - b) % L), ((s + 1) % n_slabs, (x0 + slab_w - b) % L)):
            z = np.mod(pos[:, 0] - zone_start, L) < 2 * b
            shared.setdefault(bidx, []).append((gid[z], nodes[z]))
        del pos, gid, sub, nodes

    total_nodes = node_off[-1]
    parent = np.arange(total_nodes, dtype=np.int64)
    for bidx, sides in shared.items():
        if len(sides) != 2:
            continue
        (g1, n1), (g2, n2) = sides
        o1 = np.argsort(g1, kind="stable")
        o2 = np.argsort(g2, kind="stable")
        if len(g1) != len(g2) or not np.array_equal(g1[o1], g2[o2]):
            # particles within fp rounding of a zone edge may appear on
            # one side only; intersect instead of assuming identical sets
            common, i1, i2 = np.intersect1d(g1, g2, return_indices=True)
            _union_batch(parent, n1[i1], n2[i2])
            continue
        _union_batch(parent, n1[o1], n2[o2])

    roots = _find_roots(parent, np.arange(total_nodes, dtype=np.int64))
    uniq_roots, comp = np.unique(roots, return_inverse=True)
    n_comp = len(uniq_roots)
    lengths = np.zeros(n_comp, np.int64)
    np.add.at(lengths, comp, np.concatenate(len_parts))
    cs_all = np.zeros((n_comp, 3))
    sn_all = np.zeros((n_comp, 3))
    np.add.at(cs_all, comp, np.concatenate(cs_parts))
    np.add.at(sn_all, comp, np.concatenate(sn_parts))

    keep = lengths >= nmin
    group_ids = np.nonzero(keep)[0]
    mean_ang = np.arctan2(sn_all[group_ids], cs_all[group_ids])
    centers = np.mod(mean_ang / (2 * np.pi), 1.0) * L

    out = {
        "lengths": lengths[group_ids],
        "centers": centers.astype(np.float32),
        "n_groups": int(len(group_ids)),
    }
    if return_labels:
        remap = -np.ones(n_comp, np.int64)
        remap[group_ids] = np.arange(len(group_ids))
        labels = np.empty(n**3, np.int32)
        for g, nd in owned_records:
            labels[g] = remap[comp[nd]].astype(np.int32)
        out["labels"] = labels
    return out


def particle_mass_msun_h(boxsize: float, n_part: int, Om: float) -> float:
    """Mass of one grid particle [M_sun/h] (reference halos.py:345-349)."""
    return RHO_CRIT * Om * boxsize**3 / n_part**3


def empirical_hmf(
    lengths: np.ndarray,
    particle_mass: float,
    boxsize: float,
    bins_per_dex: int = 5,
    fof_correction: bool = True,
):
    """dn/dlog10M from FoF multiplicities.

    ``fof_correction`` applies the Warren et al. 2006 FoF discreteness bias
    n_corr = n (1 - n^-0.6) before converting to mass (reference
    ``halos.py:317-342``).
    """
    n = np.asarray(lengths, np.float64)
    if fof_correction:
        # the correction maps n=1 to mass 0 (log10 -> -inf); singletons
        # carry no HMF weight, so drop them instead of crashing
        n = n[n > 1]
        n = n * (1.0 - n**-0.6)
    if not len(n):
        raise ValueError(
            "no groups with corrected mass > 0 (all multiplicities were 1)"
        )
    masses = n * particle_mass
    logm = np.log10(masses)
    lo = np.floor(logm.min() * bins_per_dex) / bins_per_dex
    hi = np.ceil(logm.max() * bins_per_dex) / bins_per_dex
    edges = np.arange(lo, hi + 1e-9, 1.0 / bins_per_dex)
    counts, _ = np.histogram(logm, bins=edges)
    vol = boxsize**3
    dlog = np.diff(edges)
    centers = 10 ** (0.5 * (edges[1:] + edges[:-1]))
    dn = counts / vol / dlog
    err = np.sqrt(counts) / vol / dlog
    return centers, dn, err


def tinker08_hmf(m_grid, k_table, p_table, Om: float, z: float = 0.0, growth=None):
    """Tinker et al. 2008 (Delta=200m) dn/dlog10M [h^3/Mpc^3 per dex].

    Args:
        m_grid: halo masses [M_sun/h].
        k_table, p_table: z=0 linear spectrum [h/Mpc, (Mpc/h)^3].
        Om: matter density.
        z: redshift (growth applied to sigma); ``growth`` overrides D(z).
    """
    m = np.asarray(m_grid, np.float64)
    rho_m = RHO_CRIT * Om
    r = (3 * m / (4 * np.pi * rho_m)) ** (1.0 / 3.0)

    if growth is None:
        if z == 0.0:
            growth = 1.0
        else:
            growth = float(growth_factor(z, Om))

    sig = np.array([sigma_r(k_table, p_table, float(ri)) for ri in r]) * growth

    # Tinker08 Delta=200 (mean) parameters with redshift evolution.
    A = 0.186 * (1 + z) ** -0.14
    a = 1.47 * (1 + z) ** -0.06
    alpha = 10 ** (-((0.75 / np.log10(200.0 / 75.0)) ** 1.2))
    b = 2.57 * (1 + z) ** -alpha
    c = 1.19
    f_sigma = A * ((sig / b) ** -a + 1.0) * np.exp(-c / sig**2)

    ln_sig_inv = -np.log(sig)
    dlnsinv_dlogm = np.gradient(ln_sig_inv, np.log10(m))
    dn_dlog10m = f_sigma * (rho_m / m) * dlnsinv_dlogm
    return dn_dlog10m
