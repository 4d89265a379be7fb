"""End-to-end science pipeline: IC -> 1LPT -> emulator -> density -> stats.

Counterpart of ``jax_nbody_emulator_with_dj_tpu/pipeline.py``, built on the
port's science toolkit (EH98 P(k), :mod:`.science.grf`, :mod:`.science.lpt`,
:mod:`.science.mas`) and its emulator runtimes.  The fields stay on the
device from the Gaussian random field to the emulated density; only the
results the caller keeps are copied to the host.

Input convention: the emulator consumes the z=0-normalized Zel'dovich
displacement; growth is applied inside the model via D(z).
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from .chunked import ChunkedHierarchicalConfig
from .cosmology import growth_factor
from .emulator import create_emulator
from .geometry import auto_hierarchical_config
from .hierarchical import resolve_device
from .science._common import to_numpy
from .science.grf import gaussian_random_field
from .science.linear_pk import eisenstein_hu_pk, load_pk_table
from .science.lpt import displacement_to_density, zeldovich_displacement
from .science.resize import resize_density_grid
from .subbox import SubboxConfig
from .utils.timing import force_sync

# Quijote fiducial cosmology.
QUIJOTE_FIDUCIAL = {
    "Om": 0.3175,
    "Ob": 0.049,
    "h": 0.6711,
    "ns": 0.9624,
    "sigma8": 0.834,
}

_PRECISION = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32}
# The JAX planner's default budget: what a CPU run plans for (the card's own
# memory is read when the pipeline runs on one).
_CPU_PLAN_BYTES = 16 << 30


@dataclass
class PipelineResult:
    psi_lpt: np.ndarray | None = None
    psi_emu: np.ndarray | None = None
    vel_emu: np.ndarray | None = None
    delta_lin: np.ndarray | None = None
    delta_lpt: np.ndarray | None = None
    delta_emu: np.ndarray | None = None
    timings: dict = field(default_factory=dict)
    metadata: dict = field(default_factory=dict)


def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype, or the counterpart of a numpy one (``np.float32`` ...)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


def run_lpt_emulator_pipeline(
    *,
    seed: int | None = None,
    input_delta=None,
    n_part: int = 512,
    boxsize: float = 1000.0,
    z: float = 0.0,
    cosmo: dict | None = None,
    pk_table=None,
    params: dict | None = None,
    load_params: bool = True,
    premodulate: bool = True,
    compute_vel: bool = True,
    ndiv: tuple = (4, 4, 8),
    runtime: str = "subbox",
    precision: str = "bf16",
    output_dtype=np.float32,
    mas_worder: int = 2,
    deconvolve: bool = True,
    density_res: int | None = None,
    num_sims: int = 1,
    out_dir: str | Path | None = None,
    save_fields: bool = False,
    keep_fields: bool = True,
    mid_chan: int = 64,
    device=None,
) -> PipelineResult:
    """Run the full IC -> 1LPT -> emulator -> density pipeline.

    Args:
        seed: draw the linear field as a GRF from a ``torch.Generator`` on
            the device seeded with this (mode A); or
        input_delta: use this (N,N,N) linear density contrast, z=0
            normalization (mode B; resized to ``n_part`` if needed, the new
            modes drawn from a generator seeded with ``seed or 0``).
        n_part: particle grid per axis (the emulation resolution).
        boxsize: box side [Mpc/h].
        z: output redshift.
        cosmo: dict(Om, Ob, h, ns, sigma8); default Quijote fiducial.
        pk_table: external linear z=0 P(k) replacing the in-package EH98: a
            path to a CLASS-style table (see
            :func:`.science.linear_pk.load_pk_table`) or a (k, P) array pair.
        params / load_params: emulator weights (see ``create_emulator``; a
            JAX tree converts with ``utils.params.params_from_jax``).
        premodulate: fold style at (z, Om) (production default).
        compute_vel: also emulate velocities.
        ndiv: subbox decomposition of the emulation run (``runtime="subbox"``).
        runtime: 'subbox' (the reference's semantics, uses ``ndiv``; the
            unpacked forward, no custom kernel) or 'auto' (the hierarchical
            runtime under ``geometry.auto_hierarchical_config``: planned
            geometry, chunked fallback; ``ndiv`` is ignored; on the card its
            packed convs run kernels B1/B2).
        precision: 'bf16' | 'f16' | 'f32' compute dtype.
        output_dtype: dtype of the emulator's outputs (numpy or torch).
        mas_worder / deconvolve: density deposition settings.
        density_res: density diagnostic mesh (default n_part).
        num_sims: repeat the emulation (timing statistics).
        out_dir / save_fields: persist .npy fields + metadata.json.
        keep_fields: include field arrays in the returned result.
        mid_chan: the model's interior width (the planner sizes buffers by it).
        device: where the pipeline runs (default: the CUDA card; raises if
            there is none.  Pass ``"cpu"`` to run on the CPU).

    ``timings["emulator_seconds_includes_compile"]`` is True with one run:
    the first emulator call in a process pays the first-use ``nvcc`` build
    of the CUDA kernels (minutes with an empty ``_build/``) and cuDNN's
    autotuning, so take ``emulator_seconds`` from ``num_sims >= 2``.
    """
    device = resolve_device(device)
    cosmo = dict(cosmo or QUIJOTE_FIDUCIAL)
    density_res = density_res or n_part
    dtype = _PRECISION[precision]
    timings: dict = {}
    result = PipelineResult()

    # --- 1. Linear field -------------------------------------------------
    t0 = time.perf_counter()
    if pk_table is not None:
        k_tab, p_tab = (load_pk_table(pk_table) if isinstance(pk_table, (str, Path))
                        else pk_table)
    else:
        k_tab = np.logspace(-4, 2, 512)
        p_tab = eisenstein_hu_pk(k_tab, Om=cosmo["Om"], Ob=cosmo["Ob"], h=cosmo["h"],
                                 ns=cosmo["ns"], sigma8=cosmo["sigma8"])
    if input_delta is not None:
        delta_lin = torch.as_tensor(input_delta, dtype=torch.float32).to(device)
        if delta_lin.shape[0] != n_part:
            gen = torch.Generator(device=device).manual_seed(seed or 0)
            delta_lin = resize_density_grid(delta_lin, n_part, boxsize, k_tab, p_tab,
                                            generator=gen)
    else:
        if seed is None:
            raise ValueError("provide either seed or input_delta")
        gen = torch.Generator(device=device).manual_seed(seed)
        delta_lin = gaussian_random_field(gen, n_part, boxsize, k_tab, p_tab, device=device)
    force_sync(delta_lin)
    timings["ic_seconds"] = time.perf_counter() - t0

    # --- 2. 1LPT displacement (z=0 normalization) ------------------------
    t0 = time.perf_counter()
    psi0 = zeldovich_displacement(delta_lin, boxsize)
    force_sync(psi0)
    timings["lpt_seconds"] = time.perf_counter() - t0

    # LPT density diagnostic at the target redshift.
    t0 = time.perf_counter()
    dz = float(growth_factor(z, cosmo["Om"]))
    delta_lpt = displacement_to_density(psi0 * dz, boxsize, nmesh=density_res,
                                        worder=mas_worder, deconvolve=deconvolve)
    force_sync(delta_lpt)
    timings["lpt_density_seconds"] = time.perf_counter() - t0

    # --- 3. Emulator ------------------------------------------------------
    t0 = time.perf_counter()
    if runtime == "auto":
        # mid_chan scales every buffer and transient in the planner's
        # estimate: it must match the model built below.
        sb = auto_hierarchical_config(
            (n_part,) * 3, dtype=dtype, compute_vel=compute_vel,
            output_dtype=_torch_dtype(output_dtype), mid_chan=mid_chan,
            hbm_bytes=_CPU_PLAN_BYTES if device.type == "cpu" else None, device=device,
        )
    elif runtime == "subbox":
        sb = SubboxConfig(size=(n_part,) * 3, ndiv=tuple(ndiv), dtype=dtype,
                          output_dtype=_torch_dtype(output_dtype))
    else:
        raise ValueError(f"runtime must be 'subbox' or 'auto', got {runtime!r}")
    emulator = create_emulator(
        premodulate=premodulate,
        compute_vel=compute_vel,
        load_params=load_params,
        params=params,
        processor_config=sb,
        premodulate_z=z if premodulate else None,
        premodulate_Om=cosmo["Om"] if premodulate else None,
        mid_chan=mid_chan,
        device=device,
    )
    timings["emulator_build_seconds"] = time.perf_counter() - t0

    # The chunked fallback exists because full-size device buffers do not
    # fit beside the phase buffers: its input is staged from the host chunk
    # by chunk and its outputs assembled in host arrays.  The monolithic
    # runtimes keep the device path (no host bounce).
    host_io = isinstance(sb, ChunkedHierarchicalConfig)
    emu_in = psi0.cpu().numpy() if host_io else psi0

    emu_runtimes = []
    psi_emu = vel_emu = None
    for _ in range(num_sims):
        t0 = time.perf_counter()
        out = emulator.process_box(emu_in, z=z, Om=cosmo["Om"], as_numpy=host_io)
        force_sync(out)
        emu_runtimes.append(time.perf_counter() - t0)
        if compute_vel:
            psi_emu, vel_emu = out
        else:
            psi_emu = out
        del out
    timings["emulator_runs_seconds"] = emu_runtimes
    timings["emulator_seconds"] = min(emu_runtimes)
    timings["emulator_seconds_includes_compile"] = num_sims == 1

    # --- 4. Emulated density ---------------------------------------------
    t0 = time.perf_counter()
    delta_emu = displacement_to_density(
        torch.as_tensor(psi_emu).to(device, torch.float32), boxsize,
        nmesh=density_res, worder=mas_worder, deconvolve=deconvolve,
    )
    force_sync(delta_emu)
    timings["emu_density_seconds"] = time.perf_counter() - t0

    metadata = {
        "seed": seed,
        "n_part": n_part,
        "boxsize": boxsize,
        "z": z,
        "cosmology": cosmo,
        "pk_table": str(pk_table) if isinstance(pk_table, (str, Path)) else (
            "external-array" if pk_table is not None else "eh98"
        ),
        "growth_factor": dz,
        "premodulate": premodulate,
        "compute_vel": compute_vel,
        "ndiv": list(ndiv),
        "runtime": runtime,
        "precision": precision,
        "mas_worder": mas_worder,
        "deconvolve": deconvolve,
        "density_res": density_res,
        "num_sims": num_sims,
        "timings": timings,
        "voxels_per_second": n_part**3 / min(emu_runtimes),
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else str(device),
    }

    fields = dict(delta_lin=delta_lin, psi_lpt=psi0, delta_lpt=delta_lpt, psi_emu=psi_emu,
                  vel_emu=vel_emu, delta_emu=delta_emu)
    if keep_fields or save_fields:
        fields = {k: None if v is None else to_numpy(v, np.float32) for k, v in fields.items()}
    if keep_fields:
        for k, v in fields.items():
            setattr(result, k, v)
    result.timings = timings
    result.metadata = metadata

    if out_dir is not None:
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        with open(out / "metadata.json", "w") as f:
            json.dump(metadata, f, indent=2, default=str)
        if save_fields:
            for name in ("delta_lin", "delta_lpt", "delta_emu", "psi_emu", "vel_emu"):
                if fields[name] is not None:
                    np.save(out / f"{name}.npy", fields[name])
    return result
