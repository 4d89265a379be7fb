"""The port's multi-device layer against the JAX package's, on the CPU.

The JAX side runs on the 8 virtual CPU devices that ``tests/conftest.py``
sets; the port runs the same decompositions on ``[torch.device("cpu")] * 8``
(a mesh may repeat a device).  Exchanges move data and compute nothing, so
``halo_exchange`` and ``fill_margins_exchange`` must equal JAX's inside
``shard_map`` exactly.  The sharded runtimes are float32 and held at the JAX
tests' gates (``tests/test_sharded.py``): rtol 2e-4 / atol 2e-5 on the
displacement, velocity to 2e-4 of max |v|.  The sharded hierarchical runtime
is held against the port's single-device runtime (which the tier holds
against JAX), for all four cores, packed and unpacked, on (2, 2, 2) and
(2, 4, 1) (level-2 local extents of 4 under margins of 8: multi-hop); one
end-to-end case runs JAX's sharded runtime beside it.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch.utils._python_dispatch import TorchDispatchMode

from jax_nbody_emulator_with_dj_tpu.emulator import modulate_emulator_parameters as jmodulate
from jax_nbody_emulator_with_dj_tpu.hierarchical import HierarchicalConfig as JConfig
from jax_nbody_emulator_with_dj_tpu.models import NBodyEmulatorCore as JCore
from jax_nbody_emulator_with_dj_tpu.models import StyleNBodyEmulatorCore as JStyleCore
from jax_nbody_emulator_with_dj_tpu.parallel import ShardedBoxConfig as JBoxConfig
from jax_nbody_emulator_with_dj_tpu.parallel import ShardedBoxProcessor as JBoxProcessor
from jax_nbody_emulator_with_dj_tpu.parallel import ShardedHierarchicalProcessor as JShProcessor
from jax_nbody_emulator_with_dj_tpu.parallel import halo as jhalo
from jax_nbody_emulator_with_dj_tpu.parallel import mesh as jmesh
from jax_nbody_emulator_with_dj_tpu.parallel import sharded_hierarchical as jsh
from jax_nbody_emulator_with_dj_tpu_torch import HierarchicalConfig, HierarchicalProcessor
from jax_nbody_emulator_with_dj_tpu_torch import SubboxConfig, SubboxProcessor
from jax_nbody_emulator_with_dj_tpu_torch.emulator import (
    modulate_emulator_parameters,
    modulate_emulator_parameters_vel,
)
from jax_nbody_emulator_with_dj_tpu_torch.models.cores import (
    NBodyEmulatorCore,
    NBodyEmulatorVelCore,
    StyleNBodyEmulatorCore,
    StyleNBodyEmulatorVelCore,
)
from jax_nbody_emulator_with_dj_tpu_torch.models.unet import init_unet
from jax_nbody_emulator_with_dj_tpu_torch.parallel import (
    ShardedBoxConfig,
    ShardedBoxProcessor,
    ShardedField,
    ShardedHierarchicalProcessor,
    box_spec,
    halo_exchange,
    initialize,
    make_mesh,
    make_sharded_box,
    mesh_for_devices,
)
from jax_nbody_emulator_with_dj_tpu_torch.parallel import collectives, distributed
from jax_nbody_emulator_with_dj_tpu_torch.parallel import sharded_hierarchical as tsh
from jax_nbody_emulator_with_dj_tpu_torch.parallel.mesh import _factor3, shard_linear_index
from jax_nbody_emulator_with_dj_tpu_torch.utils.params import params_from_jax

torch.set_num_threads(2)  # tier-1 runs several xdist workers

CPU = torch.device("cpu")
KEY = jax.random.key(5)
HALO = 12  # levels=1 margin
Z, OM = 0.5, 0.3175

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 (virtual) devices")


def cpu_mesh(shape):
    return make_mesh(shape, devices=[CPU] * int(np.prod(shape)))


def jax_blocks(arr, mesh_shape, dims):
    """Split a JAX shard_map result (local blocks side by side) into the
    blocks of each shard, in row-major shard order."""
    arr = np.asarray(arr)
    out = []
    for coords in np.ndindex(*mesh_shape):
        sl = [slice(None)] * arr.ndim
        for d, c, m in zip(dims, coords, mesh_shape):
            step = arr.shape[d] // m
            sl[d] = slice(c * step, (c + 1) * step)
        out.append(arr[tuple(sl)])
    return out


def side_by_side(blocks, mesh_shape, dims):
    """The inverse of ``jax_blocks``: blocks laid side by side along ``dims``."""
    local = blocks[0].shape
    shape = list(local)
    for d, m in zip(dims, mesh_shape):
        shape[d] *= m
    out = np.empty(shape, blocks[0].dtype)
    for block, coords in zip(blocks, np.ndindex(*mesh_shape)):
        sl = [slice(None)] * len(shape)
        for d, c in zip(dims, coords):
            sl[d] = slice(c * local[d], (c + 1) * local[d])
        out[tuple(sl)] = block
    return out


# ---------------------------------------------------------------------------
# mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", range(1, 17))
def test_factor3_matches_jax(n):
    assert _factor3(n) == jmesh._factor3(n)


@pytest.mark.parametrize("n", [1, 2, 4, 6, 8])
def test_mesh_for_devices_matches_jax(n):
    mesh = mesh_for_devices(n, devices=[CPU] * n)
    assert mesh.spatial_shape() == tuple(jmesh.mesh_for_devices(n).shape.values())
    assert mesh.shape == dict(zip(("x", "y", "z"), mesh.spatial_shape()))
    assert list(mesh.devices.flat) == [CPU] * n and mesh.distinct_devices() == [CPU]


def test_make_mesh_defaults_to_the_cards(monkeypatch):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh((1, 1, 1))  # no card here: no fallback to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mesh = make_mesh((2, 1, 1))
    assert list(mesh.devices.flat) == [torch.device("cuda", 0), torch.device("cuda", 1)]
    with pytest.raises(ValueError, match="needs 8 devices, have 2"):
        mesh_for_devices(8)


def test_mesh_needing_more_devices_raises():
    with pytest.raises(ValueError, match="needs 8 devices, have 4"):
        make_mesh((2, 2, 2), devices=[CPU] * 4)
    with pytest.raises(ValueError):
        mesh_for_devices(6, devices=[CPU] * 5)


def test_shard_linear_index_is_row_major():
    shape = (2, 4, 3)
    assert [shard_linear_index(shape, c) for c in np.ndindex(*shape)] == list(range(24))


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh_shape", [(2, 2, 2), (4, 2, 1), (1, 2, 4)])
@pytest.mark.parametrize("axis,split,concat", [(0, 1, 0), (1, 0, 1), (2, 0, 2), (2, 2, 0)])
def test_all_to_all_matches_jax(mesh_shape, axis, split, concat):
    name = "xyz"[axis]
    vol = np.random.default_rng(3).normal(size=(16, 16, 16)).astype(np.float32)
    f = jax.jit(jax.shard_map(
        lambda v: jax.lax.all_to_all(v, name, split, concat, tiled=True),
        mesh=jmesh.make_mesh(mesh_shape), in_specs=P("x", "y", "z"), out_specs=P("x", "y", "z"),
        check_vma=False))
    want = jax_blocks(f(vol), mesh_shape, (0, 1, 2))
    parts = ShardedField.shard(vol, cpu_mesh(mesh_shape), (0, 1, 2)).parts
    got = collectives.all_to_all_tiled(parts, mesh_shape, axis, split, concat)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("shift", [1, -1, 2, 3])
def test_ppermute_shift_matches_jax(shift):
    mesh_shape = (4, 2, 1)
    vol = np.random.default_rng(4).normal(size=(8, 4, 2)).astype(np.float32)
    perm = [(i, (i + shift) % 4) for i in range(4)]
    f = jax.jit(jax.shard_map(lambda v: jax.lax.ppermute(v, "x", perm),
                              mesh=jmesh.make_mesh(mesh_shape), in_specs=P("x", "y", "z"),
                              out_specs=P("x", "y", "z"), check_vma=False))
    want = jax_blocks(f(vol), mesh_shape, (0, 1, 2))
    parts = ShardedField.shard(vol, cpu_mesh(mesh_shape), (0, 1, 2)).parts
    for g, w in zip(collectives.ppermute_shift(parts, mesh_shape, 0, shift), want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_psum_and_sharded_field_round_trip():
    mesh = cpu_mesh((2, 2, 2))
    vol = np.random.default_rng(5).normal(size=(3, 8, 6, 4)).astype(np.float32)
    field = ShardedField.shard(vol, mesh, (1, 2, 3))
    assert field.local_shape == (3, 4, 3, 2) and len(field.parts) == 8
    np.testing.assert_array_equal(field.numpy(), vol)
    for piece, origin in field.pieces():
        np.testing.assert_array_equal(
            piece.numpy(), vol[:, origin[0]:origin[0] + 4, origin[1]:origin[1] + 3,
                               origin[2]:origin[2] + 2])
    total = collectives.psum([p.double().sum() for p in field.parts])
    np.testing.assert_allclose(float(total), vol.astype(np.float64).sum(), rtol=1e-12)
    kept = vol.copy()
    vol[:] = 0.0  # the blocks are copies, never views of the caller's array
    np.testing.assert_array_equal(field.numpy(), kept)
    assert collectives.as_sharded(field, mesh, (1, 2, 3)) is field
    assert collectives.as_sharded(field, mesh, (1, 2, 3), torch.float64).dtype == torch.float64
    with pytest.raises(ValueError):
        collectives.as_sharded(field, cpu_mesh((4, 2, 1)), (1, 2, 3))
    with pytest.raises(ValueError):
        ShardedField.shard(np.zeros((3, 9, 8, 8)), mesh, (1, 2, 3))


# ---------------------------------------------------------------------------
# halo exchange and the margin fill, exact against JAX inside shard_map
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh_shape,halo", [
    ((2, 2, 2), 4), ((2, 2, 2), 11), ((2, 4, 1), 5), ((2, 4, 1), 9), ((4, 1, 1), 6),
    ((4, 1, 1), 16),
])
def test_halo_exchange_matches_jax(mesh_shape, halo):
    vol = np.random.default_rng(9).normal(size=(3, 16, 16, 16)).astype(np.float32)
    spec = P(None, "x", "y", "z")
    f = jax.jit(jax.shard_map(lambda v: jhalo.halo_exchange(v, halo), mesh=jmesh.make_mesh(
        mesh_shape), in_specs=spec, out_specs=spec, check_vma=False))
    want = jax_blocks(f(vol), mesh_shape, (1, 2, 3))
    parts = ShardedField.shard(vol, cpu_mesh(mesh_shape), (1, 2, 3)).parts
    got = halo_exchange(parts, mesh_shape, halo)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_halo_wider_than_the_global_extent_raises():
    parts = ShardedField.shard(np.zeros((1, 8, 8, 8), np.float32), cpu_mesh((2, 2, 2)),
                               (1, 2, 3)).parts
    with pytest.raises(ValueError, match="exceeds the global extent"):
        halo_exchange(parts, (2, 2, 2), 9)


@pytest.mark.parametrize("mesh_shape,local,margins", [
    ((2, 2, 2), (8, 8, 4), (2, 2, 1)),
    ((2, 2, 2), (4, 4, 2), (8, 8, 4)),  # multi-hop; margins as wide as the global extent
    ((2, 2, 2), (4, 4, 2), (10, 9, 5)),  # margins wider than the global extent
    ((2, 4, 1), (16, 8, 8), (4, 4, 2)),
    ((2, 4, 1), (4, 2, 4), (8, 8, 3)),  # level-2 extents under the 8 margin of phase 2c
    ((4, 1, 1), (4, 16, 8), (8, 3, 0)),
    ((4, 1, 1), (2, 8, 8), (9, 2, 1)),
])
def test_fill_margins_exchange_matches_jax(mesh_shape, local, margins):
    shape = (1,) + tuple(n + 2 * m for n, m in zip(local, margins)) + (3,)
    rng = np.random.default_rng(11)
    blocks = [rng.normal(size=shape).astype(np.float32) for _ in range(int(np.prod(mesh_shape)))]
    spec = P(None, "x", "y", "z", None)
    f = jax.jit(jax.shard_map(lambda b: jsh.fill_margins_exchange(b, margins),
                              mesh=jmesh.make_mesh(mesh_shape), in_specs=spec, out_specs=spec,
                              check_vma=False))
    glob = side_by_side(blocks, mesh_shape, (1, 2, 3))
    want = jax_blocks(f(glob), mesh_shape, (1, 2, 3))
    bufs = [torch.from_numpy(b.copy()) for b in blocks]
    moved = tsh.fill_margins_exchange(cpu_mesh(mesh_shape), bufs, margins)
    for g, w in zip(bufs, want):
        np.testing.assert_array_equal(g.numpy(), w)
    per_shard = sum(2 * m * int(np.prod([s for i, s in enumerate(shape) if i != ax])) * 4
                    for ax, m in zip((1, 2, 3), margins))
    assert moved == per_shard * len(bufs)


def test_fill_margins_on_one_shard_is_the_ghost_fill():
    buf = torch.randn(1, 14, 12, 9, 2)
    ref = buf.clone()
    HierarchicalProcessor._ghost_fill(ref, (4, 3, 2))
    tsh.fill_margins_exchange(cpu_mesh((1, 1, 1)), [buf], (4, 3, 2))
    torch.testing.assert_close(buf, ref, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# distributed
# ---------------------------------------------------------------------------


def test_initialize_is_a_noop_in_one_process(monkeypatch):
    for name in distributed.COORDINATOR_ENV:
        monkeypatch.delenv(name, raising=False)
    assert initialize() is None


@pytest.mark.parametrize("kw", [dict(coordinator_address="localhost:1234"),
                                dict(num_processes=2), dict(process_id=0)])
def test_initialize_with_a_coordinator_raises(kw):
    with pytest.raises(NotImplementedError, match="A10b"):
        initialize(**kw)


def test_initialize_with_a_coordinator_in_the_environment_raises(monkeypatch):
    monkeypatch.setenv("COORDINATOR_ADDRESS", "localhost:1234")
    with pytest.raises(NotImplementedError, match="A10b"):
        initialize()


def test_make_sharded_box_assembles_the_global_box():
    mesh = cpu_mesh((2, 2, 2))
    size = (8, 8, 8)
    global_box = np.random.default_rng(7).normal(size=(3,) + size).astype(np.float32)
    calls = []

    def block(idx):
        calls.append(idx)
        return global_box[idx]

    arr = make_sharded_box(mesh, size, block, dtype=np.float64)
    assert len(calls) == 8 and all(global_box[i].shape == (3, 4, 4, 4) for i in calls)
    assert arr.dtype == torch.float64 and len(arr.parts) == 8
    np.testing.assert_array_equal(arr.numpy(), global_box)
    assert box_spec() == (None, "x", "y", "z")
    assert distributed.process_local_devices(mesh) == [CPU] * 8
    torch_box = make_sharded_box(mesh, size, lambda i: torch.from_numpy(global_box[i]),
                                 dtype=torch.bfloat16)
    assert torch_box.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# ShardedBoxProcessor (the JAX test geometry: levels=1, mid 4, (3, 64, 32, 32))
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def style1_params():
    return JStyleCore(levels=1, mid_chan=4).init(KEY)


@pytest.fixture(scope="module")
def box1():
    return np.asarray(jax.random.normal(KEY, (3, 64, 32, 32), jnp.float32))


@pytest.fixture(scope="module")
def subbox_reference(style1_params, box1):
    """The port's single-device subbox result, against which every mesh is held."""
    cfg = SubboxConfig(size=(64, 32, 32), ndiv=(2, 1, 1), padding=((HALO, HALO),) * 3)
    return SubboxProcessor(StyleNBodyEmulatorCore(levels=1, mid_chan=4),
                           params_from_jax(style1_params), cfg, device="cpu").process_box(
        box1, Z, 0.3)


def _box_proc(params, mesh_shape, size=(64, 32, 32), vel=False, **kw):
    model = (StyleNBodyEmulatorVelCore if vel else StyleNBodyEmulatorCore)(levels=1, mid_chan=4)
    cfg = ShardedBoxConfig(size=size, dtype=torch.float32, halo=HALO, **kw)
    return ShardedBoxProcessor(model, params_from_jax(params), cpu_mesh(mesh_shape), cfg)


@pytest.mark.parametrize("mesh_shape", [(2, 2, 2), (4, 2, 1), (4, 1, 1), (1, 1, 1)])
def test_sharded_box_matches_subbox(style1_params, box1, subbox_reference, mesh_shape):
    out = _box_proc(style1_params, mesh_shape).process_box(box1, Z, 0.3, as_numpy=True)
    np.testing.assert_allclose(out, subbox_reference, rtol=2e-4, atol=2e-5)


def test_sharded_box_matches_jax(style1_params, box1):
    jcfg = JBoxConfig(size=(64, 32, 32), dtype=jnp.float32, halo=HALO)
    want = JBoxProcessor(JStyleCore(levels=1, mid_chan=4), style1_params,
                         jmesh.make_mesh((2, 2, 2)), jcfg).process_box(box1, Z, 0.3,
                                                                       as_numpy=True)
    got = _box_proc(style1_params, (2, 2, 2)).process_box(box1, Z, 0.3, as_numpy=True)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_sharded_box_tiled_shards(style1_params, box1, subbox_reference):
    out = _box_proc(style1_params, (2, 1, 1), tiles_per_shard=(2, 2, 1)).process_box(
        box1, Z, 0.3, as_numpy=True)
    np.testing.assert_allclose(out, subbox_reference, rtol=2e-4, atol=2e-5)


def test_sharded_box_velocity(style1_params, box1):
    model = StyleNBodyEmulatorVelCore(levels=1, mid_chan=4)
    scfg = SubboxConfig(size=(64, 32, 32), ndiv=(2, 1, 1), padding=((HALO, HALO),) * 3)
    d1, v1 = SubboxProcessor(model, params_from_jax(style1_params), scfg,
                             device="cpu").process_box(box1, Z, 0.3)
    d, v = _box_proc(style1_params, (2, 2, 2), vel=True).process_box(box1, Z, 0.3,
                                                                     as_numpy=True)
    np.testing.assert_allclose(d, d1, rtol=2e-4, atol=2e-5)
    scale = np.abs(v1).max()
    np.testing.assert_allclose(v / scale, v1 / scale, rtol=2e-4, atol=2e-4)


def test_sharded_box_shard_extent_below_halo(style1_params):
    """Multi-hop exchange: 8-voxel shards under a 12-voxel halo."""
    size = (32, 16, 16)
    small = np.random.default_rng(3).normal(size=(3,) + size).astype(np.float32)
    scfg = SubboxConfig(size=size, ndiv=(1, 1, 1), padding=((HALO, HALO),) * 3)
    want = SubboxProcessor(StyleNBodyEmulatorCore(levels=1, mid_chan=4),
                           params_from_jax(style1_params), scfg, device="cpu").process_box(
        small, Z, 0.3)
    got = _box_proc(style1_params, (4, 1, 1), size=size).process_box(small, Z, 0.3,
                                                                     as_numpy=True)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_sharded_box_output_stays_sharded_and_takes_a_sharded_box(style1_params, box1):
    proc = _box_proc(style1_params, (2, 2, 2))
    out = proc.process_box(box1, Z, 0.3)
    assert isinstance(out, ShardedField) and len(out.parts) == 8 and out.shape == box1.shape
    field = make_sharded_box(proc.mesh, (64, 32, 32), lambda i: box1[i], dtype=torch.float32)
    np.testing.assert_array_equal(proc.process_box(field, Z, 0.3, as_numpy=True), out.numpy())


def test_sharded_box_invalid_geometry_raises(style1_params):
    with pytest.raises(ValueError):  # 8/2 = 4 per shard: a tile input of 28, invalid
        _box_proc(style1_params, (2, 2, 2), size=(8, 8, 8))
    with pytest.raises(ValueError, match="halo"):
        _box_proc(style1_params, (2, 2, 2), size=(16, 16, 8))
    with pytest.raises(ValueError, match="not divisible"):
        _box_proc(style1_params, (4, 1, 1), size=(34, 32, 32))


# ---------------------------------------------------------------------------
# ShardedHierarchicalProcessor against the port's single-device runtime
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def style3_params():
    return init_unet(3, style=True, mid_chan=4)


def _core(kind, style3):
    if kind == "disp":
        return NBodyEmulatorCore(mid_chan=4), modulate_emulator_parameters(style3, Z, OM)
    if kind == "vel":
        return NBodyEmulatorVelCore(mid_chan=4), modulate_emulator_parameters_vel(style3, Z, OM)
    if kind == "style_disp":
        return StyleNBodyEmulatorCore(mid_chan=4), style3
    return StyleNBodyEmulatorVelCore(mid_chan=4), style3


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("mesh_shape,size", [((2, 2, 2), (32, 32, 32)), ((2, 4, 1), (32, 64, 16))])
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("kind", ["disp", "vel", "style_disp", "style_vel"])
def test_sharded_hierarchical_matches_single_device(style3_params, kind, packed, mesh_shape,
                                                    size):
    model, params = _core(kind, style3_params)
    box = np.random.default_rng(11).normal(size=(3,) + size).astype(np.float32)
    cfg = HierarchicalConfig(size=size, slab=8, tile=(16, 16, 16), dtype=torch.float32,
                             output_dtype=torch.float32, packed=packed)
    ref = _as_tuple(HierarchicalProcessor(model, params, cfg, device="cpu").process_box(
        box, Z, OM))
    proc = ShardedHierarchicalProcessor(model, params, cpu_mesh(mesh_shape), cfg)
    assert proc.config.size == (16, 16, 16) and proc.config.tile1 == 8
    out = _as_tuple(proc.process_box(box, Z, OM, as_numpy=True))
    np.testing.assert_allclose(out[0], ref[0], rtol=2e-4, atol=2e-5)
    if len(ref) == 2:
        scale = np.abs(ref[1]).max()
        np.testing.assert_allclose(out[1] / scale, ref[1] / scale, rtol=2e-4, atol=2e-4)


def test_sharded_hierarchical_matches_jax(style3_params):
    """End to end against JAX's sharded runtime at its own test geometry
    (``tests/test_sharded.py``: 32^3, mesh (2, 1, 1), the multi-wrap regime:
    local level-1 extent 8, global 16 < margin 22)."""
    jstyle = JStyleCore(mid_chan=4).init(jax.random.key(5))
    jparams = jmodulate(jstyle, 0.0, OM)
    box = np.random.default_rng(0).normal(size=(3, 32, 32, 32)).astype(np.float32)
    jcfg = JConfig(size=(32, 32, 32), slab=8, tile=(16, 16, 16), dtype=jnp.float32,
                   output_dtype=np.float32)
    want = JShProcessor(JCore(mid_chan=4), jparams, jmesh.make_mesh((2, 1, 1)), jcfg).process_box(
        box, 0.0, OM, as_numpy=True)
    cfg = HierarchicalConfig(size=(32, 32, 32), slab=8, tile=(16, 16, 16), dtype=torch.float32,
                             output_dtype=torch.float32)
    proc = ShardedHierarchicalProcessor(NBodyEmulatorCore(mid_chan=4), params_from_jax(jparams),
                                        cpu_mesh((2, 1, 1)), cfg)
    out = proc.process_box(box, 0.0, OM)
    assert isinstance(out, ShardedField) and len(out.parts) == 2
    np.testing.assert_allclose(out.numpy(), want, rtol=2e-4, atol=2e-5)


def test_sharded_hierarchical_interleaved_exchange_breaks_corners(style3_params, monkeypatch):
    """The order the runtime keeps matters: filling each shard's margins axis by
    axis on its own (D, H, W of shard 0, then of shard 1, ...) reads corner
    strips that a neighbour has not filled yet, so the box goes wrong on a
    (2, 2, 2) mesh."""
    model, params = _core("disp", style3_params)
    box = np.random.default_rng(12).normal(size=(3, 32, 32, 32)).astype(np.float32)
    cfg = HierarchicalConfig(size=(32, 32, 32), slab=8, tile=(16, 16, 16), dtype=torch.float32,
                             output_dtype=torch.float32)
    ref = HierarchicalProcessor(model, params, cfg, device="cpu").process_box(box, Z, OM)
    proc = ShardedHierarchicalProcessor(model, params, cpu_mesh((2, 2, 2)), cfg)
    np.testing.assert_allclose(proc.process_box(box, Z, OM, as_numpy=True), ref, rtol=2e-4,
                               atol=2e-5)
    exchange = tsh.fill_margins_exchange

    def per_shard_axes(mesh, bufs, margins):
        for i in range(len(bufs)):  # every axis of shard i before the next shard's
            for axis in range(3):
                one = [0, 0, 0]
                one[axis] = margins[axis]
                exchange(mesh, [b if j == i else b.clone() for j, b in enumerate(bufs)], one)
        return 0

    monkeypatch.setattr(tsh, "fill_margins_exchange", per_shard_axes)
    bad = proc.process_box(box, Z, OM, as_numpy=True)
    assert np.abs(bad - ref).max() > 1e-2 * np.abs(ref).max()


def test_style_model_folds_once_per_call(style3_params, monkeypatch):
    model = StyleNBodyEmulatorVelCore(mid_chan=4)
    cfg = HierarchicalConfig(size=(32, 32, 32), slab=8, tile=(16, 16, 16), dtype=torch.float32,
                             output_dtype=torch.float32)
    proc = ShardedHierarchicalProcessor(model, style3_params, cpu_mesh((2, 2, 2)), cfg)
    assert len(proc.locals) == 1 and all(loc is proc.local for loc in proc.shard_local)
    folds = []
    fold = tsh._LocalHierarchical._fold_exec
    monkeypatch.setattr(tsh._LocalHierarchical, "_fold_exec",
                        lambda self, z, Om: folds.append(1) or fold(self, z, Om))
    box = np.random.default_rng(2).normal(size=(3, 32, 32, 32)).astype(np.float32)
    proc.process_box(box, Z, OM, profile=True)
    assert folds == [1] and proc.local._exec is None
    assert set(proc.last_timings) == {"fold", "scale", "exchange_input", "phase1", "exchange_h1",
                                      "phase2a", "exchange_y1", "phase2b", "exchange_y2",
                                      "phase2c", "exchange_r1", "phase3"}
    assert set(proc.last_halo_bytes) == {"input", "h1", "y1", "y2", "r1"}


def test_exec_tree_copy_keeps_tiled_weights():
    from jax_nbody_emulator_with_dj_tpu_torch.hierarchical import pack_exec_params
    from jax_nbody_emulator_with_dj_tpu_torch.ops.winograd_cuda import TiledWh

    p = modulate_emulator_parameters_vel(init_unet(0, style=True, mid_chan=64), Z, OM)
    ex = pack_exec_params(p["params"], vel=True, wino=True, dtype=torch.bfloat16, device=CPU)
    moved = tsh._exec_to(ex, torch.device("meta"))
    w0, w1 = ex["conv_l1"]["conv_0"]["wh"], moved["conv_l1"]["conv_0"]["wh"]
    assert isinstance(w1, TiledWh) and w1.device.type == "meta" and w0.device == CPU
    assert w1.shape == w0.shape and w1.f2 == w0.f2


def test_sharded_hierarchical_config_checks():
    model, params = NBodyEmulatorCore(mid_chan=4), modulate_emulator_parameters(
        init_unet(0, style=True, mid_chan=4), Z, OM)
    cfg = HierarchicalConfig(size=(48, 48, 48), slab=8, tile=(16, 16, 16))
    with pytest.raises(ValueError, match="not divisible by mesh"):
        ShardedHierarchicalProcessor(model, params, cpu_mesh((1, 1, 5)), cfg)
    with pytest.raises(ValueError):  # local W 12: not a multiple of 8 (3 levels)
        ShardedHierarchicalProcessor(model, params, cpu_mesh((1, 1, 4)), cfg)


# ---------------------------------------------------------------------------
# the 1024^3 geometry: local config, abstract shapes and the memory audit
# ---------------------------------------------------------------------------


class _RealAllocations(TorchDispatchMode):
    """Counts the bytes of every op result that lies on a device other than
    ``meta`` (a style tree is packed on ``meta`` to count its weights)."""

    def __init__(self):
        super().__init__()
        self.nbytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (list, tuple)) else [out]:
            if torch.is_tensor(t) and t.device.type != "meta":
                self.nbytes += t.nbytes
        return out


@pytest.mark.parametrize("style", [False, True])
def test_1024_geometry_and_memory_audit(style):
    """Counterpart of the JAX package's 1024^3 / 8-shard tests: the local
    geometry is the 512^3 single-card one, and the per-device audit (8
    virtual shards on one device) allocates nothing."""
    sp = init_unet(0, style=True, mid_chan=64)
    model = StyleNBodyEmulatorVelCore() if style else NBodyEmulatorVelCore()
    params = sp if style else modulate_emulator_parameters_vel(sp, 0.0, OM)
    cfg = HierarchicalConfig(size=(1024,) * 3, slab=16, tile=(128, 128, 128),
                             dtype=torch.bfloat16, output_dtype=torch.float16)
    proc = ShardedHierarchicalProcessor(model, params, cpu_mesh((2, 2, 2)), cfg)
    assert proc.config.size == (512, 512, 512) and proc.config.tile1 in (64, 128)
    shapes = proc.abstract_inputs()
    assert shapes["box"].shape == (1, 3, 1024, 1024, 1024)
    assert shapes["boxp"].shape == (1, 3, 1056, 1056, 1056)
    # h1 of a shard: (1, 256 + 4, 256 + 4, 128 + 2, 128), side by side over (2, 2, 2)
    assert len(shapes["h1"]) == 2 and shapes["h1"][0].shape == (1, 520, 520, 260, 128)
    with _RealAllocations() as seen:
        audit = proc.memory_audit()
    assert seen.nbytes < 2**20  # a few host scalars and index tensors, no buffer
    local = proc.local.memory_audit()["phases"]
    w = proc.local.exec_weight_bytes()
    dev = audit["devices"]["cpu"]
    assert dev["shards"] == 8 and audit["max_device"] == "cpu"
    for name, row in dev["phases"].items():
        want = w + 8 * (local[name]["args"] - w) + 8 * local[name]["out"] + local[name]["temps"]
        assert row["peak"] == want
        assert row["total"] == want + 8 * local[name]["extra_live"]
    assert audit["max_total"] == max(r["total"] for r in dev["phases"].values())
    with pytest.raises(NotImplementedError, match="memory_audit"):
        proc.lower_phases()


def test_parallel_modules_load_no_jax():
    code = (
        "import sys\n"
        "import jax_nbody_emulator_with_dj_tpu_torch.parallel\n"
        "import jax_nbody_emulator_with_dj_tpu_torch.parallel.dryrun\n"
        "import jax_nbody_emulator_with_dj_tpu_torch.science.powerspec_sharded\n"
        "import jax_nbody_emulator_with_dj_tpu_torch.science.field_sharded\n"
        "import jax_nbody_emulator_with_dj_tpu_torch.science.resize_sharded\n"
        "import jax_nbody_emulator_with_dj_tpu_torch.science.stats_sharded\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m.split('.')[0] == 'jax_nbody_emulator_with_dj_tpu']\n"
        "assert not bad, bad\n"
    )
    root = Path(__file__).resolve().parent.parent
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root, timeout=120)


def test_parallel_exports_cover_the_jax_package():
    import jax_nbody_emulator_with_dj_tpu.parallel as jpar
    import jax_nbody_emulator_with_dj_tpu_torch.parallel as tpar

    assert set(jpar.__all__) <= set(tpar.__all__)
    assert all(hasattr(tpar, name) for name in tpar.__all__)
