"""The port's subbox runtime, checkpoint import and checkpoints vs the JAX package, on the CPU.

The same seeded trees (made by the JAX package, converted with
``params_from_jax``) and the same numpy boxes go through the JAX package and
the port.  Tolerances, each stated where it is used: geometry and the
imported tree bit for bit; whole boxes rtol 2e-4 / atol 2e-5, as
``tests/test_hierarchical.py`` holds the JAX runtimes against each other,
velocity in displacement units (divided by ``vel_norm``); the stored goldens
at the JAX tests' own tolerances (``tests/test_golden.py``: rtol/atol 5e-5;
``tests/test_torch_fixture.py``: rtol 1e-5 / atol 1e-6).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax_nbody_emulator_with_dj_tpu as jpkg
from jax_nbody_emulator_with_dj_tpu import StyleNBodyEmulatorCore as JStyleCore
from jax_nbody_emulator_with_dj_tpu import StyleNBodyEmulatorVelCore as JStyleVelCore
from jax_nbody_emulator_with_dj_tpu.emulator import _make_processor as j_make_processor
from jax_nbody_emulator_with_dj_tpu.emulator import modulate_emulator_parameters as jmod
from jax_nbody_emulator_with_dj_tpu.emulator import modulate_emulator_parameters_vel as jmod_vel
from jax_nbody_emulator_with_dj_tpu.utils import torch_convert as jconvert
import jax_nbody_emulator_with_dj_tpu_torch as tpkg
from jax_nbody_emulator_with_dj_tpu_torch import (
    HierarchicalConfig,
    SubboxConfig,
    SubboxProcessor,
    create_emulator,
    modulate_emulator_parameters,
    modulate_emulator_parameters_vel,
    vel_norm,
)
from jax_nbody_emulator_with_dj_tpu_torch.emulator import _make_processor
from jax_nbody_emulator_with_dj_tpu_torch.utils import checkpoint, torch_convert
from jax_nbody_emulator_with_dj_tpu_torch.utils.params import params_from_jax

torch.set_num_threads(2)  # tier-1 runs several xdist workers

N = 16
Z, OM = 0.5, 0.3175
VF = float(vel_norm(Z, OM))
FIXTURES = Path(__file__).resolve().parent / "fixtures"
GOLDEN = Path(__file__).resolve().parent / "golden" / "emulator_golden.npz"
CORES = ["StyleNBodyEmulatorCore", "StyleNBodyEmulatorVelCore", "NBodyEmulatorCore",
         "NBodyEmulatorVelCore"]


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


@pytest.fixture(scope="module")
def box():
    return np.random.default_rng(1).standard_normal((3, N, N, N)).astype(np.float32)


@pytest.fixture(scope="module")
def style4():
    return JStyleCore(mid_chan=4).init(jax.random.key(17))


def _close(out, ref):
    """Whole boxes: rtol 2e-4 / atol 2e-5; velocity over vel_norm."""
    out, ref = (out, ref) if isinstance(out, tuple) else ((out,), (ref,))
    assert len(out) == len(ref)
    for i, (got, want) in enumerate(zip(out, ref)):
        unit = VF if i else 1.0
        assert got.shape == (3, N, N, N) and got.dtype == np.float32
        np.testing.assert_allclose(got / unit, np.asarray(want) / unit, rtol=2e-4, atol=2e-5)


# ---------------------------------------------------------------------------
# SubboxConfig: geometry and validation, against the JAX config
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(size=(16, 16, 16), ndiv=(2, 2, 2)),
    dict(size=(32, 16, 24), ndiv=(4, 1, 3), padding=((12, 12),) * 3),
    dict(size=(8, 8, 8), ndiv=(1, 1, 1), padding=((3, 5), (0, 0), (9, 2))),
    dict(size=(128, 128, 128), ndiv=(2, 2, 2)),
])
def test_subbox_config_geometry_matches_jax(kw):
    cfg, jcfg = SubboxConfig(**kw), jpkg.SubboxConfig(**kw)
    for name in ("size", "ndiv", "n_subboxes", "crop_size", "crop_extent", "NDIM"):
        assert getattr(cfg, name) == getattr(jcfg, name), name
    np.testing.assert_array_equal(cfg.anchors, jcfg.anchors)
    assert cfg.anchors.dtype == jcfg.anchors.dtype
    for idx in range(cfg.n_subboxes):
        assert cfg._get_anchor(idx) == jcfg._get_anchor(idx)
        for got, want in zip(cfg.crop_indices(idx), jcfg.crop_indices(idx)):
            np.testing.assert_array_equal(got, want)
    assert cfg.dtype == torch.float32 and cfg.output_dtype == torch.float32


@pytest.mark.parametrize("kw", [
    dict(size=(16, 16, 16), ndiv=(3, 2, 2)),
    dict(size=(16, 15, 16), ndiv=(2, 2, 2)),
    dict(size=(10, 10, 10), ndiv=(1, 1, 4)),
])
def test_subbox_config_validation_matches_jax(kw):
    with pytest.raises(ValueError):
        jpkg.SubboxConfig(**kw)
    with pytest.raises(ValueError):
        SubboxConfig(**kw)


# ---------------------------------------------------------------------------
# SubboxProcessor vs the JAX SubboxProcessor, all four cores
# ---------------------------------------------------------------------------


def _trees(style, name):
    """(JAX tree, port tree) for a core: the style tree, or its fold at (Z, OM)."""
    if name.startswith("Style"):
        return style, params_from_jax(style)
    if name == "NBodyEmulatorCore":
        return jmod(style, Z, OM), modulate_emulator_parameters(params_from_jax(style), Z, OM)
    return jmod_vel(style, Z, OM), modulate_emulator_parameters_vel(params_from_jax(style), Z, OM)


@pytest.mark.parametrize("name", CORES)
def test_subbox_matches_jax(style4, box, name):
    jtree, tree = _trees(style4, name)
    geo = dict(size=(N,) * 3, ndiv=(2, 1, 1))
    ref = jpkg.SubboxProcessor(getattr(jpkg, name)(mid_chan=4), jtree,
                               jpkg.SubboxConfig(**geo, dtype=jnp.float32)).process_box(box, Z, OM)
    proc = SubboxProcessor(getattr(tpkg, name)(mid_chan=4), tree, SubboxConfig(**geo),
                           device="cpu")
    _close(proc.process_box(box, Z, OM), ref)


@pytest.mark.parametrize("vel", [False, True])
def test_hierarchical_matches_subbox_style(style4, box, vel):
    """The port's two runtimes on one style model, as ``tests/test_hierarchical.py``
    holds the JAX ones (rtol 2e-4 / atol 2e-5, velocity over vel_norm)."""
    tree = params_from_jax(style4)
    sub = create_emulator(compute_vel=vel, params=tree, mid_chan=4, device="cpu",
                          processor_config=SubboxConfig(size=(N,) * 3, ndiv=(1, 2, 1)))
    hier = create_emulator(compute_vel=vel, params=tree, mid_chan=4, device="cpu",
                           processor_config=HierarchicalConfig(
                               size=(N,) * 3, slab=8, tile=(8, 8, 8), dtype=torch.float32,
                               output_dtype=torch.float32))
    assert isinstance(sub.processor, SubboxProcessor)
    # desc / show_progress reach either runtime through the bundle (fault C7)
    _close(hier.process_box(box, Z, OM, desc="box", show_progress=False),
           sub.process_box(box, Z, OM, desc="box", show_progress=False))


def test_subbox_matches_golden():
    """``tests/test_golden.py::test_subbox_runtime`` through the port: rtol/atol 5e-5."""
    seed = 20260816
    tree = params_from_jax(JStyleVelCore(levels=1, mid_chan=4).init(jax.random.key(seed)))
    box = np.asarray(jax.random.normal(jax.random.key(seed + 2), (3, 16, 16, 16), jnp.float32))
    cfg = SubboxConfig(size=(16, 16, 16), ndiv=(2, 1, 1), padding=((12, 12),) * 3)
    out = SubboxProcessor(tpkg.StyleNBodyEmulatorCore(levels=1, mid_chan=4), tree, cfg,
                          device="cpu").process_box(box, Z, OM)
    with np.load(GOLDEN) as f:
        np.testing.assert_allclose(out, f["subbox_disp"], rtol=5e-5, atol=5e-5)


def test_subbox_loops_and_outputs(style4, box):
    """``loop`` takes the JAX package's two values (the same loop here) and
    refuses others; ``output_dtype`` and ``as_numpy=False`` as asked; the
    input box is not written to."""
    tree, model = params_from_jax(style4), tpkg.StyleNBodyEmulatorVelCore(mid_chan=4)
    kept = box.copy()
    cfg = SubboxConfig(size=(N,) * 3, ndiv=(1, 1, 2), output_dtype=torch.float16)
    a = SubboxProcessor(model, tree, cfg, device="cpu").process_box(box, Z, OM)
    b = SubboxProcessor(model, tree, cfg, loop="fused", device="cpu").process_box(
        torch.from_numpy(box), Z, OM, as_numpy=False)
    np.testing.assert_array_equal(box, kept)
    assert a[0].dtype == np.float16 and b[0].dtype == torch.float16
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y.numpy())
    with pytest.raises(ValueError, match="loop"):
        SubboxProcessor(model, tree, cfg, loop="scan", device="cpu")
    with pytest.raises(ValueError, match="loop"):
        jpkg.SubboxProcessor(JStyleVelCore(mid_chan=4), style4,
                             jpkg.SubboxConfig(size=(N,) * 3, ndiv=(1, 1, 2)), loop="scan")


def test_subbox_rejects_what_jax_rejects(style4, box):
    tree, model = params_from_jax(style4), tpkg.StyleNBodyEmulatorCore(mid_chan=4)
    pad = dict(size=(N,) * 3, ndiv=(2, 2, 2), padding=((12, 12),) * 3)
    with pytest.raises(ValueError, match="receptive margin 48"):
        jpkg.SubboxProcessor(JStyleCore(mid_chan=4), style4, jpkg.SubboxConfig(**pad))
    with pytest.raises(ValueError, match="receptive margin 48"):
        SubboxProcessor(model, tree, SubboxConfig(**pad), device="cpu")
    proc = SubboxProcessor(model, tree, SubboxConfig(size=(N,) * 3, ndiv=(2, 2, 2)),
                           device="cpu")
    with pytest.raises(ValueError, match="shape"):
        proc.process_box(box[:, :8], Z, OM)
    if not torch.cuda.is_available():  # no device named: the card, and none here
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            SubboxProcessor(model, tree, SubboxConfig(size=(N,) * 3, ndiv=(2, 2, 2)))


def test_processor_dispatch_matches_jax(style4):
    """A config of another type: the JAX package's ``TypeError``, word for word."""
    with pytest.raises(TypeError) as jerr:
        j_make_processor(JStyleCore(mid_chan=4), style4, object())
    with pytest.raises(TypeError) as err:
        _make_processor(tpkg.StyleNBodyEmulatorCore(mid_chan=4), params_from_jax(style4),
                        object(), "cpu")
    assert str(err.value) == str(jerr.value)
    with pytest.raises(TypeError):
        create_emulator(params=params_from_jax(style4), processor_config=dict(size=(N,) * 3),
                        mid_chan=4, device="cpu")
    with pytest.raises(ValueError, match="params="):
        create_emulator(load_params=False, mid_chan=4, device="cpu",
                        processor_config=SubboxConfig(size=(N,) * 3, ndiv=(2, 2, 2)))


# ---------------------------------------------------------------------------
# The map2map torch checkpoint: import, and the fixture's goldens
# ---------------------------------------------------------------------------

CKPT = FIXTURES / "map2map_style_ckpt.pt"


@pytest.fixture(scope="module")
def loaded():
    return torch_convert.load_torch_checkpoint(CKPT)


def test_torch_checkpoint_import_matches_jax(loaded):
    """The same paths as the JAX package's import, every leaf bit for bit,
    float32 CPU tensors, DHWIO kernels."""
    ref = dict(_leaves(jconvert.load_torch_checkpoint(CKPT)))
    got = dict(_leaves(loaded))
    assert got.keys() == ref.keys() and len(got) > 50
    for k, v in got.items():
        assert isinstance(v, torch.Tensor) and v.dtype == torch.float32 and v.device.type == "cpu"
        assert v.is_contiguous()
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref[k]), err_msg=str(k))
    assert loaded["params"]["conv_l00"]["conv_0"]["weight"].shape[:3] == (3, 3, 3)


@pytest.mark.parametrize("wrap", [None, "state_dict", "model", "model_state_dict"])
def test_state_dict_wrappers_and_key_map(tmp_path, wrap):
    """Training wrappers around the state dict and ``module.`` prefixes are
    dropped, keys that are no parameter are skipped, as in the JAX package."""
    sd = {"module.conv_c.conv_0.weight": torch.arange(2 * 3 * 27.0).reshape(2, 3, 3, 3, 3),
          "module.conv_c.conv_0.bias": torch.ones(2),
          "optimizer.state.step": torch.tensor(3)}
    path = tmp_path / "ck.pt"
    torch.save(sd if wrap is None else {wrap: sd, "epoch": 7}, path)
    got = dict(_leaves(torch_convert.load_torch_checkpoint(path)))
    ref = dict(_leaves(jconvert.load_torch_checkpoint(path)))
    assert got.keys() == ref.keys() == {("params", "conv_c", "conv_0", "weight"),
                                        ("params", "conv_c", "conv_0", "bias")}
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref[k]))
    for key in ("module.conv_l00.conv_0.weight", "model.conv_c.skip.style_bias",
                "net.module.up_r0.conv_0.dweight", "optimizer.state.step", "conv_c.weight",
                "conv_c.conv_0.running_mean"):
        assert torch_convert.default_key_map(key) == jconvert.default_key_map(key), key
    with pytest.raises(ValueError, match="key_map"):
        torch_convert.convert_torch_state_dict({"optimizer.state.step": torch.tensor(3)})


@pytest.mark.parametrize("premodulate", [False, True])
def test_fixture_goldens_through_the_port(loaded, premodulate):
    """``tests/test_torch_fixture.py``'s two goldens, read through the port's own
    import and run by the port's factory and subbox runtime: rtol 1e-5 / atol 1e-6."""
    box = np.load(FIXTURES / "torch_golden_input.npy")
    golden = np.load(FIXTURES / ("torch_golden_premod.npy" if premodulate
                                 else "torch_golden_style.npy"))
    cfg = SubboxConfig(size=box.shape[1:], ndiv=(2, 2, 2), padding=((48, 48),) * 3,
                       dtype=torch.float32)
    emu = create_emulator(premodulate=premodulate, compute_vel=False, params=loaded,
                          processor_config=cfg, premodulate_z=0.5, premodulate_Om=0.3175,
                          mid_chan=4, device="cpu")
    out = emu.process_box(box, z=0.5, Om=0.3175, show_progress=False)
    np.testing.assert_allclose(out, golden, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# save_checkpoint / load_checkpoint
# ---------------------------------------------------------------------------


def test_checkpoint_round_trip(tmp_path, style4):
    tree = params_from_jax(style4)
    path = tmp_path / "params.pt"
    checkpoint.save_checkpoint(path, tree)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["params.pt"]
    back = dict(_leaves(checkpoint.load_checkpoint(path)))
    want = dict(_leaves(tree))
    assert back.keys() == want.keys()
    for k, v in back.items():
        assert torch.equal(v, want[k]), k
    like = tpkg.StyleNBodyEmulatorCore(mid_chan=4).init(0)
    like["params"]["conv_c"]["conv_0"]["weight"] = \
        like["params"]["conv_c"]["conv_0"]["weight"].to(torch.bfloat16)
    got = dict(_leaves(checkpoint.load_checkpoint(path, like=like)))
    assert got.keys() == want.keys()
    for k, v in got.items():
        assert v.dtype == dict(_leaves(like))[k].dtype
        assert torch.equal(v, want[k].to(v.dtype)), k


@pytest.mark.parametrize("like_kw", [dict(mid_chan=8), dict(levels=2)])
def test_checkpoint_like_must_match(tmp_path, style4, like_kw):
    """``like`` of another width (leaf shapes) or depth (tree structure) is refused."""
    path = tmp_path / "params.pt"
    checkpoint.save_checkpoint(path, params_from_jax(style4))
    like = tpkg.StyleNBodyEmulatorCore(**{"mid_chan": 4, **like_kw}).init(0)
    with pytest.raises(ValueError, match="checkpoint"):
        checkpoint.load_checkpoint(path, like=like)
