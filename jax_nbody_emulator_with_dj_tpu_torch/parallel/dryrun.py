"""Dry run of the whole multi-device layer on an n-shard mesh.

Counterpart of ``__graft_entry__.dryrun_multichip`` of the JAX package.
``dryrun_multichip(n, device)`` places ``n`` virtual shards on one device
(``mesh_for_devices(n, devices=[device] * n)``; the card unless
``device="cpu"``) and runs:

  1. one levels-1 ``ShardedBoxProcessor`` step (the subbox scheme, halo
     exchange on all three axes, a style disp+vel model);
  2. one mid-4 ``ShardedHierarchicalProcessor`` disp+vel box (per-phase
     margin exchange, packed interior);
  3. one mid-64 sharded box, the production channel width, with per-phase
     and per-exchange wall times and the margin bytes of each phase boundary;
  4. the on-mesh science chain (GRF -> 1LPT -> deposit -> P(k)), and the
     audit of every sharded estimator against its single-device counterpart
     on two skewed meshes.

    python3 -c "from jax_nbody_emulator_with_dj_tpu_torch.parallel.dryrun import dryrun_multichip; dryrun_multichip(8)"
"""

from __future__ import annotations

import numpy as np
import torch

from ..emulator import modulate_emulator_parameters_vel
from ..hierarchical import HierarchicalConfig, resolve_device
from ..models.cores import NBodyEmulatorVelCore, StyleNBodyEmulatorVelCore
from .mesh import _factor3, make_mesh, mesh_for_devices
from .sharded_box import ShardedBoxConfig, ShardedBoxProcessor
from .sharded_hierarchical import ShardedHierarchicalProcessor

K_TABLE = np.logspace(-3, 1.5, 64)


def _eh_table():
    from ..science import eisenstein_hu_pk

    return eisenstein_hu_pk(K_TABLE, Om=0.3175, Ob=0.049, h=0.6711, ns=0.9624, sigma8=0.834)


def _check_sharded(outs, shape, n_devices):
    for o in outs:
        if o.shape != shape or len(o.parts) != n_devices:
            raise RuntimeError(f"sharded output {o}: expected {shape} over {n_devices} shards")
        if not all(bool(torch.isfinite(p).all()) for p in o.parts):
            raise RuntimeError(f"sharded output {o} is not finite")


def dryrun_multichip(n_devices: int, device=None) -> list:
    """Run one step of each sharded path over ``n_devices`` shards of
    ``device`` (default: the CUDA card); print the report lines and return them."""
    from ..science import (
        displacement_to_density_sharded,
        gaussian_random_field_sharded,
        power_spectrum_sharded,
        zeldovich_displacement_sharded,
    )

    dev = resolve_device(device)
    mesh = mesh_for_devices(n_devices, devices=[dev] * n_devices)
    mesh_shape = mesh.spatial_shape()

    model = StyleNBodyEmulatorVelCore(levels=1, mid_chan=4)
    size = tuple(16 * m for m in mesh_shape)  # shard extent 16 >= halo 12
    proc = ShardedBoxProcessor(model, model.init(0), mesh, ShardedBoxConfig(
        size=size, dtype=torch.float32, output_dtype=torch.float32, halo=model.margin))
    box = np.random.default_rng(0).normal(size=(3,) + size).astype(np.float32)
    _check_sharded(proc.process_box(box, z=0.5, Om=0.3175), (3,) + size, n_devices)

    # the production sharded-hierarchical path at the levels=3 topology
    pm3 = modulate_emulator_parameters_vel(StyleNBodyEmulatorVelCore(mid_chan=4).init(1),
                                           z=0.0, Om=0.3175)
    hsize = tuple(16 * m for m in mesh_shape)
    hcfg = HierarchicalConfig(size=hsize, slab=8, tile=(16, 16, 16), dtype=torch.float32,
                              output_dtype=torch.float32)
    hproc = ShardedHierarchicalProcessor(NBodyEmulatorVelCore(mid_chan=4), pm3, mesh, hcfg)
    hbox = np.random.default_rng(1).normal(size=(3,) + hsize).astype(np.float32)
    _check_sharded(hproc.process_box(hbox, z=0.0, Om=0.3175), (3,) + hsize, n_devices)

    # production channel width: per-phase times and margin bytes per boundary
    pm64 = modulate_emulator_parameters_vel(StyleNBodyEmulatorVelCore(mid_chan=64).init(2),
                                            z=0.0, Om=0.3175)
    pproc = ShardedHierarchicalProcessor(NBodyEmulatorVelCore(mid_chan=64), pm64, mesh, hcfg)
    pbox = np.random.default_rng(2).normal(size=(3,) + hsize).astype(np.float32)
    pproc.process_box(pbox, z=0.0, Om=0.3175)  # warm-up (cuDNN plans, allocator)
    _check_sharded(pproc.process_box(pbox, z=0.0, Om=0.3175, profile=True), (3,) + hsize,
                   n_devices)
    timings, moved = pproc.last_timings, pproc.last_halo_bytes

    # the on-mesh science chain, no gather
    n_sci = 16
    while not (all(n_sci % m == 0 for m in mesh_shape)
               and (n_sci // mesh_shape[0]) % mesh_shape[2] == 0
               and (n_sci // mesh_shape[0]) % mesh_shape[1] == 0
               and (n_sci // mesh_shape[1]) % mesh_shape[0] == 0
               and min(n_sci // m for m in mesh_shape) >= 8):  # deposit margin
        n_sci += 8
    gen = torch.Generator(device=dev).manual_seed(3)
    d_lin = gaussian_random_field_sharded(gen, n_sci, mesh, 100.0, K_TABLE, _eh_table())
    psi = zeldovich_displacement_sharded(d_lin, mesh, 100.0)
    rho = displacement_to_density_sharded(psi, mesh, 100.0, margin=8)
    _, pks, _ = power_spectrum_sharded(rho, mesh, 100.0)
    if not bool(torch.isfinite(pks).all()) or len(rho.parts) != n_devices:
        raise RuntimeError("the sharded science chain gave a non-finite P(k)")

    lines = [
        f"dryrun_multichip OK: mesh {mesh_shape} on {n_devices} x {dev}, box {size}, dis/vel "
        f"sharded over {n_devices} shards; hierarchical box {hsize} via per-phase halo "
        f"exchange; on-mesh science chain (GRF->LPT->deposit->P(k)) at {n_sci}^3",
        *_asymmetric_estimator_audit(n_devices, dev),
        "production-width shard step (mid_chan=64, packed, vel): "
        + ", ".join(f"{k} {v * 1e3:.0f} ms" for k, v in timings.items()),
        "exchanged halo bytes/shard-boundary: "
        + ", ".join(f"{k} {v / n_devices / 1024:.0f} KiB" for k, v in moved.items()),
    ]
    for line in lines:
        print(line)
    return lines


def _asymmetric_estimator_audit(n_devices: int, dev) -> list:
    """Every ``*_sharded`` estimator on skewed meshes, each held against its
    single-device counterpart on the same device; returns the report lines."""
    from .. import science as sci
    from ..science import grf

    box_side, n = 250.0, 48
    rng = np.random.default_rng(5)
    a = rng.normal(size=(n, n, n)).astype(np.float32)
    b = (0.7 * a + 0.3 * rng.normal(size=a.shape)).astype(np.float32)
    coarse = rng.normal(size=(24, 24, 24)).astype(np.float32)
    ta, tb, tc = (torch.from_numpy(x).to(dev) for x in (a, b, coarse))
    thr = [-0.5, 0.0, 0.5]
    kf = 2 * np.pi / box_side
    thetas = np.linspace(0.1, np.pi - 0.1, 4)
    p_table = _eh_table()

    # skewed factorizations: merge two axes of the balanced one, e.g. (4, 2, 1)
    # and its mirror (1, 2, 4) for 8 shards
    base = _factor3(n_devices)
    skew = (base[0] * base[1], base[2], 1)
    shapes = []
    for cand in (skew, tuple(reversed(skew))):
        if int(np.prod(cand)) == n_devices and cand not in shapes and cand != (1, 1, 1) \
                and all(n % m == 0 for m in cand):
            shapes.append(cand)
    shapes = shapes or [base]  # prime counts etc.: the balanced shape

    def close(got, ref, rtol=2e-3, atol=1e-5):
        got, ref = (np.asarray(x.numpy() if hasattr(x, "parts") else
                               x.detach().cpu().numpy() if torch.is_tensor(x) else x, np.float64)
                    for x in (got, ref))
        m = np.isfinite(ref)
        if not np.isfinite(got[m]).all():
            raise RuntimeError("a sharded estimator is not finite")
        np.testing.assert_allclose(got[m], ref[m], rtol=rtol, atol=atol)

    lines = []
    for shape in shapes:
        mesh = make_mesh(shape, devices=[dev] * n_devices)
        checks = []
        k_r, p_r, n_r = sci.power_spectrum(ta, box_side)
        _, p_s, n_s = sci.power_spectrum_sharded(a, mesh, box_side)
        close(p_s, p_r)
        close(n_s, n_r, rtol=1e-6)
        checks.append("power_spectrum")
        close(sci.cross_power_sharded(a, b, mesh, box_side)[1], sci.cross_power(ta, tb, box_side)[1])
        checks.append("cross_power")
        _, t_s, c_s = sci.transfer_and_correlation_sharded(a, b, mesh, box_side)
        _, t_r, c_r = sci.transfer_and_correlation(ta, tb, box_side)
        close(t_s, t_r)
        close(c_s, c_r)
        checks.append("transfer_and_correlation")
        m_r = sci.summary_metrics(ta, tb, box_side, kmax=0.5)
        m_s = sci.summary_metrics_sharded(a, b, mesh, box_side, kmax=0.5)
        for key in m_r:
            close(m_s[key], m_r[key], rtol=5e-3)
        checks.append("summary_metrics")
        close(sci.minkowski_functionals_sharded(a, thr, mesh), sci.minkowski_functionals(ta, thr),
              rtol=1e-4)
        checks.append("minkowski_functionals")
        bi_r = sci.reduced_bispectrum(ta, box_side, 4 * kf, 6 * kf, thetas)
        bi_s = sci.reduced_bispectrum_sharded(a, mesh, box_side, 4 * kf, 6 * kf, thetas)
        close(bi_s["B"], bi_r["B"], rtol=5e-3)
        close(bi_s["Q"], bi_r["Q"], rtol=5e-3)
        checks.append("reduced_bispectrum")
        close(sci.upsample_fourier_sharded(coarse, n, mesh), sci.upsample_fourier(tc, n))
        checks.append("upsample_fourier")
        close(sci.downsample_average_sharded(a, 24, mesh), sci.downsample_average(ta, 24))
        checks.append("downsample_average")
        close(sci.gaussian_smooth_sharded(a, mesh, box_side, 5.0),
              sci.gaussian_smooth(ta, box_side, 5.0))
        checks.append("gaussian_smooth")
        up = sci.upsample_modes_sharded(coarse, n, mesh, box_side, K_TABLE, p_table,
                                        generator=torch.Generator(device=dev).manual_seed(4))
        _check_sharded([up], (n, n, n), n_devices)
        checks.append("upsample_modes")
        # the sharded field chain on this mesh; the GRF through given noise too
        noise = torch.from_numpy(rng.standard_normal((n, n, n)).astype(np.float32)).to(dev)
        close(sci.gaussian_random_field_sharded(None, n, mesh, box_side, K_TABLE, p_table,
                                                white=noise),
              grf._colour_noise(noise, box_side, K_TABLE, p_table))
        d_lin = sci.gaussian_random_field_sharded(torch.Generator(device=dev).manual_seed(9), n,
                                                  mesh, box_side, K_TABLE, p_table)
        psi = sci.zeldovich_displacement_sharded(d_lin, mesh, box_side)
        rho = sci.displacement_to_density_sharded(psi, mesh, box_side, margin=8)
        close(sci.deconvolve_mas_sharded(rho, mesh, 2), sci.deconvolve_mas(rho.gather().to(dev), 2),
              rtol=5e-3)
        _, pks, _ = sci.power_spectrum_sharded(rho, mesh, box_side)
        if not bool(torch.isfinite(pks).all()):
            raise RuntimeError("the sharded field chain gave a non-finite P(k)")
        checks.append("grf/zeldovich/deposit/deconvolve_mas")
        lines.append(f"asymmetric mesh {shape} @ {n}^3: {len(checks)} sharded estimators equal "
                     f"to single-device ({', '.join(checks)})")
    return lines
