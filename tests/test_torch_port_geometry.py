"""The port's geometry planner, fallback ladder, OOM test and memory audit vs the JAX package.

The port keeps the JAX package's geometry rules and buffer algebra and
refits only the transient coefficients on the H100 (``geometry.py``), so with
the JAX package's coefficients monkeypatched in, the estimate must equal the
JAX estimate as an integer and the planner must return the same geometry,
field by field, over a grid of sizes, dtypes, models, budgets and widths.
The fallback ladder skips the rungs that JAX repeats, and the memory audit
is the same algebra as the estimate, computed without allocating or folding.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_nbody_emulator_with_dj_tpu import ChunkedHierarchicalConfig as JChunkedConfig
from jax_nbody_emulator_with_dj_tpu import geometry as jgeo
from jax_nbody_emulator_with_dj_tpu.hierarchical import HierarchicalConfig as JConfig
from jax_nbody_emulator_with_dj_tpu_torch import (
    ChunkedHierarchicalConfig,
    ChunkedHierarchicalProcessor,
    HierarchicalConfig,
    HierarchicalProcessor,
    auto_hierarchical_config,
    create_emulator,
    emulator,
    geometry,
)
from jax_nbody_emulator_with_dj_tpu_torch.models.unet import init_unet

torch.set_num_threads(2)  # tier-1 runs several xdist workers

GIB = 1 << 30
TO_JAX = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32, torch.float16: np.float16}


@pytest.fixture
def jax_coefficients(monkeypatch):
    """The JAX package's coefficients, which know one path and one tangent form."""
    for name, table in (("_LIVE_P1", jgeo._LIVE_P1), ("_LIVE_P3", jgeo._LIVE_P3),
                        ("_LIVE_P1_UNPACKED", jgeo._LIVE_P1), ("_LIVE_P3_UNPACKED", jgeo._LIVE_P3)):
        monkeypatch.setattr(geometry, name, dict(table))
    monkeypatch.setattr(geometry, "_LIVE_P3_LEARNED", jgeo._LIVE_P3[True])
    monkeypatch.setattr(geometry, "_HEADROOM", jgeo._HEADROOM)


def _to_jax(cfg):
    """The JAX config of the same geometry (dtypes mapped)."""
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg) if f.init}
    for k in ("dtype", "output_dtype", "buf_dtype"):
        if kw.get(k) is not None:
            kw[k] = TO_JAX[kw[k]]
    return (JChunkedConfig if isinstance(cfg, ChunkedHierarchicalConfig) else JConfig)(**kw)


def _same_config(port, ref):
    assert type(port).__name__ == type(ref).__name__
    for f in dataclasses.fields(port):
        got, want = getattr(port, f.name), getattr(ref, f.name)
        if f.name in ("dtype", "output_dtype", "buf_dtype"):
            assert jnp.dtype(TO_JAX[got]) == jnp.dtype(want), f.name
        else:
            assert got == want, f.name


# ---------------------------------------------------------------------------
# (a) The algebra and the planner against JAX's, with JAX's coefficients
# ---------------------------------------------------------------------------

SIZES = [128, 256, 512, 1024, 2048, (512, 256, 256), (256, 512, 1024), (1024, 768, 512)]


@pytest.mark.parametrize("mid", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("vel", [False, True])
def test_planner_matches_jax_with_jax_coefficients(jax_coefficients, vel, dtype, mid):
    for size in SIZES:
        for budget in (8 * GIB, 16 * GIB, 80 * GIB):
            try:
                ref = jgeo.auto_hierarchical_config(size, dtype=TO_JAX[dtype], compute_vel=vel,
                                                    hbm_bytes=budget, mid_chan=mid)
            except ValueError:
                with pytest.raises(ValueError, match="no chunk decomposition"):
                    auto_hierarchical_config(size, dtype=dtype, compute_vel=vel,
                                             hbm_bytes=budget, mid_chan=mid)
                continue
            got = auto_hierarchical_config(size, dtype=dtype, compute_vel=vel, hbm_bytes=budget,
                                           mid_chan=mid)
            _same_config(got, ref)
            inner = got.inner_config() if isinstance(got, ChunkedHierarchicalConfig) else got
            assert geometry.estimate_peak_bytes(inner, vel, mid) == jgeo.estimate_peak_bytes(
                _to_jax(inner), vel, mid)


@pytest.mark.parametrize("kw", [
    dict(size=(512,) * 3, slab=64, slab_h=256, tile=(128, 128, 128), tile1=64),
    dict(size=(256, 512, 128), slab=16, tile=(64, 128, 32), tile1=32, dtype=torch.float32,
         buf_dtype=torch.bfloat16),
    dict(size=(128,) * 3, slab=32, tile=(128, 128, 128), output_dtype=torch.float32),
    dict(size=(96, 64, 48), slab=8, tile=(32, 16, 8), packed=False, tile1=8),
])
@pytest.mark.parametrize("vel", [False, True])
def test_estimate_equals_jax_as_an_integer(jax_coefficients, kw, vel):
    cfg = HierarchicalConfig(**kw)
    want = jgeo.estimate_peak_bytes(_to_jax(cfg), vel)
    if cfg.packed:
        assert geometry.estimate_peak_bytes(cfg, vel) == want
    else:
        # the unpacked r1 buffer carries the runtime's margin 3 (JAX's estimate
        # assumes 4): the port's estimate is the runtime's own algebra, so smaller
        assert geometry.estimate_peak_bytes(cfg, vel) <= want


def test_fitted_coefficients_cover_the_jax_ones():
    """The card's eager phases keep more alive than XLA's programs: no fitted
    transient is below the JAX package's."""
    for vel in (False, True):
        for p1, p3 in ((geometry._LIVE_P1, geometry._LIVE_P3),
                       (geometry._LIVE_P1_UNPACKED, geometry._LIVE_P3_UNPACKED)):
            assert p1[vel] >= jgeo._LIVE_P1[vel]
            assert p3[vel] >= jgeo._LIVE_P3[vel]
    assert geometry._LIVE_P3_LEARNED >= jgeo._LIVE_P3[True]
    assert 0 < geometry._HEADROOM <= 1


@pytest.mark.parametrize("kw", [dict(), dict(y0_cache=True, tile=(128, 128, 64))])
def test_learned_tangent_keys_phase_3_only(kw):
    """A learned dweight changes phase 3's transient of a packed vel run, and
    nothing of a disp run or an unpacked one."""
    cfg = HierarchicalConfig(size=(128,) * 3, slab=32, **kw)
    fac, lrn = (geometry.phase_bytes(cfg, True, learned_tangent=t) for t in (False, True))
    assert lrn["phase3"]["temps"] < fac["phase3"]["temps"]
    assert all(lrn[k] == fac[k] for k in ("scale", "phase1"))
    unpacked = HierarchicalConfig(size=(128,) * 3, slab=32, packed=False)
    for c, vel in ((cfg, False), (unpacked, True)):
        assert geometry.phase_bytes(c, vel, learned_tangent=True) == geometry.phase_bytes(c, vel)


def test_planner_fits_its_budget():
    for vel in (False, True):
        for size in (256, 512, 1024, 2048):
            cfg = auto_hierarchical_config(size, compute_vel=vel, hbm_bytes=80 * GIB)
            if isinstance(cfg, ChunkedHierarchicalConfig):
                est = (geometry.estimate_peak_bytes(cfg.inner_config(), vel)
                       + 3 * int(np.prod(cfg.inner_size)) * 4)
            else:
                est = geometry.estimate_peak_bytes(cfg, vel)
            assert est <= 80 * GIB * geometry._HEADROOM


def test_planner_rejects_unpackable_extents():
    with pytest.raises(ValueError, match="divisible by 16"):
        auto_hierarchical_config(200, hbm_bytes=16 * GIB)


def test_auto_needs_a_budget_or_a_card():
    with pytest.raises(ValueError, match="hbm_bytes"):
        auto_hierarchical_config(128, device="cpu")
    cfg = auto_hierarchical_config(128, device="cpu", hbm_bytes=16 * GIB)
    assert isinstance(cfg, HierarchicalConfig)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            auto_hierarchical_config(128)


# ---------------------------------------------------------------------------
# (b) The fallback ladder
# ---------------------------------------------------------------------------

LADDER_CONFIGS = [
    dict(size=(512,) * 3, slab=64, slab_h=256, tile=(128, 128, 128), tile1=64),
    dict(size=(32,) * 3, slab=16, tile=(16, 16, 16), tile1=8),
    dict(size=(64,) * 3, slab=32, tile=(64, 64, 64), tile1=32),
    dict(size=(256, 256, 128), slab=32, tile=(128, 64, 128), tile1=64, dtype=torch.float32,
         buf_dtype=torch.bfloat16),
]


@pytest.mark.parametrize("kw", LADDER_CONFIGS)
@pytest.mark.parametrize("vel", [False, True])
def test_ladder_strictly_shrinks(kw, vel):
    cfg = HierarchicalConfig(**kw)
    prev = geometry.estimate_peak_bytes(cfg, vel)
    vols = []
    for name, c in geometry.fallback_ladder(cfg, compute_vel=vel):
        if isinstance(c, HierarchicalConfig):
            peak = geometry.estimate_peak_bytes(c, vel)
            assert peak < prev, (name, peak, prev)
            prev = peak
        else:
            vols.append(int(np.prod(c.inner_size)))
    assert vols == sorted(vols, reverse=True)


@pytest.mark.parametrize("kw", LADDER_CONFIGS)
@pytest.mark.parametrize("vel", [False, True])
def test_ladder_rungs_equal_jax_where_jax_moves(kw, vel):
    """Where JAX's rung shrinks the estimate of the last rung taken, the port
    yields the same config; JAX's repeated rungs (at 32^3 both slim rungs sit
    on the floors), rungs that move only knobs no phase peak feels, and a
    chunked rung that grows the inner run are skipped."""
    cfg = HierarchicalConfig(**kw)
    got = list(geometry.fallback_ladder(cfg, compute_vel=vel))
    want, last, volume = [], geometry.estimate_peak_bytes(cfg, vel), None
    for name, c in jgeo.fallback_ladder(_to_jax(cfg), compute_vel=vel):
        if isinstance(c, JConfig):
            est = geometry.estimate_peak_bytes(HierarchicalConfig(**{
                f.name: getattr(c, f.name) for f in dataclasses.fields(c)
                if f.name not in ("dtype", "output_dtype", "buf_dtype")},
                dtype=cfg.dtype, output_dtype=cfg.output_dtype, buf_dtype=cfg.buf_dtype), vel)
            if est >= last:  # repeats its predecessor, or moves a knob no phase peak feels
                continue
            last = est
        else:  # a chunked rung that does not shrink the inner run
            if volume is not None and np.prod(c.inner_size) >= volume:
                continue
            volume = np.prod(c.inner_size)
        want.append((name, c))
    assert [n for n, _ in got] == [n for n, _ in want]
    for (_, g), (_, w) in zip(got, want):
        _same_config(g, w)
    if kw["size"] == (32,) * 3:
        jax_slim = [c for _, c in jgeo.fallback_ladder(_to_jax(cfg), vel)
                    if isinstance(c, JConfig)]
        assert jax_slim[0] == jax_slim[1]  # the fault the port does not copy
        assert len([c for _, c in got if isinstance(c, HierarchicalConfig)]) < 2


# ---------------------------------------------------------------------------
# (c) is_oom_error
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("err", [
    torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
    torch.cuda.OutOfMemoryError("allocation failed"),
    RuntimeError("RESOURCE_EXHAUSTED: TPU backend error (ResourceExhausted)."),
    MemoryError("Out of memory allocating 8 bytes"),
    RuntimeError("OOM when allocating tensor with shape"),
    RuntimeError("wrapped: CUDA error: out of memory"),
])
def test_is_oom_error_matches(err):
    assert geometry.is_oom_error(err)
    if not isinstance(err, torch.OutOfMemoryError):
        assert jgeo.is_oom_error(err)


@pytest.mark.parametrize("err", [
    ValueError("tile 7 must divide size"),
    RuntimeError("INVALID_ARGUMENT: bad shape"),
    TypeError("kernel takes bf16 xp and wh"),
])
def test_is_oom_error_rejects_others(err):
    assert not geometry.is_oom_error(err)
    assert not jgeo.is_oom_error(err)


# ---------------------------------------------------------------------------
# (d) memory_audit
# ---------------------------------------------------------------------------

PHASES = ["scale", "phase1", "phase2a", "phase2b", "phase2c", "phase3"]
KEYS = {"peak", "args", "out", "temps", "extra_live", "total"}


def _processor(style, vel, mid=4, **kw):
    cfg = HierarchicalConfig(**{**dict(size=(32,) * 3, slab=8, tile=(16, 16, 16)), **kw})
    return create_emulator(premodulate=not style, compute_vel=vel,
                           params=init_unet(2, mid_chan=mid, style=True), premodulate_z=0.5,
                           premodulate_Om=0.3, processor_config=cfg, mid_chan=mid,
                           device="cpu").processor


@pytest.mark.parametrize("kw", [dict(), dict(packed=False), dict(y0_cache=True, tile=(16, 16, 8)),
                                dict(wino=True, dtype=torch.float32, buf_dtype=torch.bfloat16)])
@pytest.mark.parametrize("style,vel", [(False, False), (False, True), (True, True)])
def test_memory_audit_is_the_estimate(style, vel, kw):
    proc = _processor(style, vel, **kw)
    audit = proc.memory_audit()
    assert set(audit) == {"phases", "max_total", "max_phase"}
    assert list(audit["phases"]) == PHASES
    for row in audit["phases"].values():
        assert set(row) == KEYS
        assert row["peak"] == row["args"] + row["out"] + row["temps"]
        assert row["total"] == row["peak"] + row["extra_live"]
    assert audit["phases"]["phase2b"]["extra_live"] > 0 == audit["phases"]["phase3"]["extra_live"]
    w = proc.exec_weight_bytes()
    assert w > 0
    assert audit["max_total"] == geometry.estimate_peak_bytes(proc.config, vel, 4, weight_bytes=w)
    assert audit["max_total"] == max(r["total"] for r in audit["phases"].values())


def test_memory_audit_buffers_follow_buf_shape():
    proc = _processor(False, True, packed=False)
    audit = proc.memory_audit()
    nbytes = int(np.prod(proc._buf_shape(proc._r1_margin()))) * 2 * 2  # two bf16 buffers
    assert audit["phases"]["phase2c"]["out"] == nbytes
    assert proc._buf_shape(proc._r1_margin()) == (1, 22, 22, 22, 4)  # unpacked margin 3


@pytest.mark.parametrize("mid,vel", [(4, True), (64, False), (64, True)])
def test_style_audit_never_folds_and_counts_the_folded_tree(monkeypatch, mid, vel):
    """A style model's audit counts its exec weights from the style tree's
    shapes, on the meta device: the fold never runs; the count equals the
    bytes of the tree the fold and pack make."""
    proc = _processor(True, vel, mid=mid, wino=True)
    folded = geometry.tree_nbytes(proc._fold_exec(0.5, 0.3))

    def no_fold(*a, **k):
        raise AssertionError("memory_audit must not fold")

    monkeypatch.setattr(emulator, "_modulate_tree", no_fold)
    audit = proc.memory_audit(z=1.0, Om=0.25)
    assert proc._exec is None
    assert proc.exec_weight_bytes() == folded
    assert audit["phases"]["phase1"]["args"] >= folded


def test_premodulated_audit_counts_its_own_tree():
    proc = _processor(False, True, wino=True, mid=64)
    assert proc.exec_weight_bytes() == geometry.tree_nbytes(proc._exec)
    learned = create_emulator(premodulate=True, compute_vel=True,
                              params=init_unet(2, mid_chan=64, style=False, vel=True),
                              processor_config=proc.config, mid_chan=64, device="cpu").processor
    # a learned dweight adds the concat weights: more bytes than the factored tree
    assert learned.exec_weight_bytes() > proc.exec_weight_bytes()
    assert learned.learned_tangent and not proc.learned_tangent
    assert learned.memory_audit()["max_total"] == geometry.estimate_peak_bytes(
        proc.config, True, 64, weight_bytes=learned.exec_weight_bytes(), learned_tangent=True)


# ---------------------------------------------------------------------------
# (e) create_emulator dispatch
# ---------------------------------------------------------------------------


def test_create_emulator_builds_the_chunked_processor():
    emu = create_emulator(premodulate=True, compute_vel=False, params=init_unet(2, mid_chan=4,
                                                                                 style=True),
                          premodulate_z=0.5, premodulate_Om=0.3, mid_chan=4, device="cpu",
                          processor_config=ChunkedHierarchicalConfig(size=(32,) * 3,
                                                                     chunks=(2, 1, 1)))
    assert isinstance(emu.processor, ChunkedHierarchicalProcessor)
    assert isinstance(emu.processor.inner, HierarchicalProcessor)
    assert emu.processor.inner.config.size == (112, 32, 32)
    assert emu.dtype == torch.bfloat16


@pytest.mark.parametrize("budget,kind", [(80 * GIB, HierarchicalProcessor),
                                         (1 * GIB, ChunkedHierarchicalProcessor)])
def test_create_emulator_takes_the_planners_config(budget, kind):
    cfg = auto_hierarchical_config(512, compute_vel=True, hbm_bytes=budget, device="cpu",
                                   mid_chan=4)
    emu = create_emulator(premodulate=True, compute_vel=True,
                          params=init_unet(2, mid_chan=4, style=True), premodulate_z=0.5,
                          premodulate_Om=0.3, mid_chan=4, device="cpu", processor_config=cfg)
    assert isinstance(emu.processor, kind)


def test_create_emulator_rejects_unknown_configs():
    with pytest.raises(TypeError, match="ChunkedHierarchicalConfig"):
        create_emulator(premodulate=True, compute_vel=False,
                        params=init_unet(2, mid_chan=4, style=True), premodulate_z=0.5,
                        premodulate_Om=0.3, mid_chan=4, device="cpu", processor_config=object())
