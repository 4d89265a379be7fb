"""The PyTorch port's model, packed blocks and hierarchical runtime vs JAX, on the CPU.

The same seeded style tree (made by the JAX package, converted with
``params_from_jax``) and the same numpy box go through the JAX package and
the port.  Tolerances are float32: rtol 2e-4 / atol 2e-5 for whole boxes, as
``tests/test_hierarchical.py`` holds the JAX runtimes against each other;
rtol 1e-4 / atol 1e-5 for single blocks.  Where the port runs the Winograd
conv (plain version on the CPU) its operands are bf16 by contract, so that
comparison uses the JAX package's gate for the kernel path: relative max
error < 0.02.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_nbody_emulator_with_dj_tpu import NBodyEmulatorCore as JCore
from jax_nbody_emulator_with_dj_tpu import StyleNBodyEmulatorCore as JStyleCore
from jax_nbody_emulator_with_dj_tpu.emulator import modulate_emulator_parameters as jmodulate
from jax_nbody_emulator_with_dj_tpu.hierarchical import HierarchicalConfig as JConfig
from jax_nbody_emulator_with_dj_tpu.hierarchical import HierarchicalProcessor as JProcessor
from jax_nbody_emulator_with_dj_tpu.models import blocks as jblocks
from jax_nbody_emulator_with_dj_tpu.utils import params as jparams
from jax_nbody_emulator_with_dj_tpu_torch import HierarchicalConfig, create_emulator
from jax_nbody_emulator_with_dj_tpu_torch.emulator import modulate_emulator_parameters
from jax_nbody_emulator_with_dj_tpu_torch.hierarchical import HierarchicalProcessor, _wrap_pad
from jax_nbody_emulator_with_dj_tpu_torch.models import blocks as tblocks
from jax_nbody_emulator_with_dj_tpu_torch.models.cores import NBodyEmulatorCore
from jax_nbody_emulator_with_dj_tpu_torch.models.unet import init_unet
from jax_nbody_emulator_with_dj_tpu_torch.utils.params import (
    load_params_npz,
    params_from_jax,
    save_params_npz,
)

torch.set_num_threads(2)  # tier-1 runs several xdist workers

N = 16  # tiny box: slab 8, tiles 8^3, tile1 8
Z, OM = 0.5, 0.3175
PORT_DIR = Path(__file__).resolve().parent.parent / "jax_nbody_emulator_with_dj_tpu_torch"


def rel_max(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


@pytest.fixture(scope="module")
def box():
    return np.random.default_rng(1).standard_normal((3, N, N, N)).astype(np.float32)


def _style_tree(mid):
    return JStyleCore(mid_chan=mid).init(jax.random.key(17))


@pytest.fixture(scope="module")
def style4():
    return _style_tree(4)


@pytest.fixture(scope="module")
def style64():
    return _style_tree(64)


def _jax_box(style, mid, box):
    cfg = JConfig(size=(N,) * 3, slab=8, tile=(8, 8, 8), dtype=jnp.float32,
                  output_dtype=np.float32)
    return JProcessor(JCore(mid_chan=mid), jmodulate(style, Z, OM), cfg).process_box(box, Z, OM)


def _port_box(style, mid, box, wino=None, **cfg_kw):
    cfg = HierarchicalConfig(**{**dict(size=(N,) * 3, slab=8, tile=(8, 8, 8)), **cfg_kw},
                             dtype=torch.float32, output_dtype=torch.float32, wino=wino)
    emu = create_emulator(premodulate=True, compute_vel=False, params=params_from_jax(style),
                          premodulate_z=Z, premodulate_Om=OM, processor_config=cfg,
                          mid_chan=mid, device="cpu")
    return emu.process_box(box, Z, OM)


# ---------------------------------------------------------------------------
# Parameter trees
# ---------------------------------------------------------------------------


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def test_params_from_jax(style4):
    port = params_from_jax(style4)
    ref = dict(_leaves(style4))
    got = dict(_leaves(port))
    assert got.keys() == ref.keys()
    for k, v in got.items():
        assert isinstance(v, torch.Tensor) and v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref[k]))


def test_npz_round_trip(style4, tmp_path):
    jparams.save_params_npz(tmp_path / "jax.npz", style4)
    port = load_params_npz(tmp_path / "jax.npz")
    save_params_npz(tmp_path / "port.npz", port)
    back = jparams.load_params_npz(tmp_path / "port.npz")
    again = load_params_npz(tmp_path / "port.npz")
    ref = dict(_leaves(style4))
    for tree in (port, again):
        got = dict(_leaves(tree))
        assert got.keys() == ref.keys()
        for k, v in got.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(ref[k]))
    for k, v in _leaves(back):
        np.testing.assert_array_equal(np.asarray(v), np.asarray(ref[k]))


def test_init_unet_matches_jax_tree_layout(style4):
    port = dict(_leaves(init_unet(0, mid_chan=4, style=True)))
    ref = dict(_leaves(style4))
    assert port.keys() == ref.keys()
    for k, v in port.items():
        assert tuple(v.shape) == tuple(ref[k].shape), k
    key = ("params", "conv_c", "conv_0", "weight")
    assert dict(_leaves(init_unet(0, mid_chan=4, style=True)))[key].equal(port[key])  # seeded


def test_modulated_tree_matches_jax(style4):
    port = modulate_emulator_parameters(params_from_jax(style4), Z, OM)
    ref = dict(_leaves(jmodulate(style4, Z, OM)))
    got = dict(_leaves(port))
    assert got.keys() == ref.keys()
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(ref[k]), rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# The model itself (unpacked) vs JAX
# ---------------------------------------------------------------------------


def test_core_apply_matches_jax(style4):
    """levels=1 keeps the JAX side quick; the forward is level-generic."""
    mid, levels, n = 4, 1, 40
    jp = jmodulate(JStyleCore(mid_chan=mid, levels=levels).init(jax.random.key(3)), Z, OM)
    x = np.random.default_rng(2).standard_normal((2, 3, n, n, n)).astype(np.float32)
    dz = np.array([0.7, 0.9], np.float32)
    ref = JCore(mid_chan=mid, levels=levels).apply(jp, jnp.asarray(x), jnp.asarray(dz))
    port = NBodyEmulatorCore(mid_chan=mid, levels=levels).apply(
        params_from_jax(jp), torch.from_numpy(x), torch.from_numpy(dz)
    )
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


def test_hierarchical_matches_model_forward(style4, box):
    """The port's runtime equals the port's own model on the wrap-padded box."""
    emu = create_emulator(premodulate=True, compute_vel=False, params=params_from_jax(style4),
                          premodulate_z=Z, premodulate_Om=OM, mid_chan=4, device="cpu")
    ref = emu.apply(_wrap_pad(torch.from_numpy(box)[None], 48), Z, OM)[0].numpy()
    np.testing.assert_allclose(_port_box(style4, 4, box), ref, rtol=2e-4, atol=2e-5)


# ---------------------------------------------------------------------------
# Packed blocks vs the JAX packed blocks
# ---------------------------------------------------------------------------


def _block(style, name):
    return jmodulate(style, Z, OM)["params"][name]


def _xp(shape, seed=5):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x), jnp.asarray(x)


@pytest.mark.parametrize("name,seq", [("conv_l1", "CACA"), ("conv_r01", "CAC")])
def test_resnet_block_packed(style4, name, seq):
    p = _block(style4, name)
    xt, xj = _xp((1, 10, 12, 7, 8))
    ref = jblocks.apply_resnet_block_packed(jblocks.pack_resnet_params(p, seq), xj, seq)
    port = tblocks.apply_resnet_block_packed(
        tblocks.pack_resnet_params(params_from_jax(p), seq), xt, seq
    )
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


def test_resnet_block_packed_cat(style4):
    p = _block(style4, "conv_r00")
    (at, aj), (bt, bj) = _xp((1, 10, 12, 7, 8), 5), _xp((1, 10, 12, 7, 8), 6)
    ref = jblocks.apply_resnet_block_packed_cat(
        jblocks.pack_resnet_params(p, "CACA", groups=2), (aj, bj), "CACA"
    )
    port = tblocks.apply_resnet_block_packed_cat(
        tblocks.pack_resnet_params(params_from_jax(p), "CACA", groups=2), (at, bt), "CACA"
    )
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name,seq", [("down_l1", "DA"), ("up_r1", "UA")])
def test_resample_block_packed(style4, name, seq):
    p = _block(style4, name)
    xt, xj = _xp((1, 6, 8, 4, 8))
    ref = jblocks.apply_resample_block_packed(jblocks.pack_resample_params(p, seq), xj, seq)
    port = tblocks.apply_resample_block_packed(
        tblocks.pack_resample_params(params_from_jax(p), seq), xt, seq
    )
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


def test_resnet_entry_packed(style4):
    p = _block(style4, "conv_l00")
    xt, xj = _xp((1, 3, 12, 10, 14))
    ref = jblocks.apply_resnet_entry_packed(jblocks.pack_resnet_entry_params(p, "CACA"), xj)
    port = tblocks.apply_resnet_entry_packed(
        tblocks.pack_resnet_entry_params(params_from_jax(p), "CACA"), xt
    )
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


def test_wino_block_packed_mid64(style64):
    """Winograd-eligible sites (packed 128 -> 128, and the 256-wide decoder
    convs) run the plain version on the CPU; bf16 operands by contract."""
    p = _block(style64, "conv_r1")
    (at, aj), (bt, bj) = _xp((1, 10, 10, 6, 128), 5), _xp((1, 10, 10, 6, 128), 6)
    ref = jblocks.apply_resnet_block_packed_cat(
        jblocks.pack_resnet_params(p, "CACA", groups=2), (aj, bj), "CACA"
    )
    pp = tblocks.pack_resnet_params(params_from_jax(p), "CACA", groups=2, wino=True)
    assert [tuple(w.shape) for w in pp["conv_0"]["wh"]] == [(4, 4, 2, 128, 256)] * 2
    assert tuple(pp["conv_1"]["wh"].shape) == (4, 4, 2, 256, 128)
    port = tblocks.apply_resnet_block_packed_cat(pp, (at, bt), "CACA")
    assert rel_max(port.numpy(), ref) < 0.02


# ---------------------------------------------------------------------------
# The slice: create_emulator(...).process_box vs JAX HierarchicalProcessor
# ---------------------------------------------------------------------------


def test_slice_matches_jax_mid4(style4, box):
    ref = _jax_box(style4, 4, box)
    out = _port_box(style4, 4, box)
    assert out.shape == (3, N, N, N) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-5)


def test_slice_invariant_to_slab_and_tiles(style4, box):
    a = _port_box(style4, 4, box)
    b = _port_box(style4, 4, box, slab=16, slab_h=8, tile=(16, 16, 8))
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def jax_box64(style64, box):
    return _jax_box(style64, 64, box)


def test_slice_matches_jax_mid64(style64, box, jax_box64):
    np.testing.assert_allclose(_port_box(style64, 64, box, wino=False), jax_box64,
                               rtol=2e-4, atol=2e-5)


def test_slice_wino_matches_jax_mid64(style64, box, jax_box64, monkeypatch):
    from jax_nbody_emulator_with_dj_tpu_torch.ops import winograd as twino

    calls = []
    plain = twino.conv3_packed_wino

    def counting(*a, **k):
        calls.append(a[0].shape)
        return plain(*a, **k)

    monkeypatch.setattr("jax_nbody_emulator_with_dj_tpu_torch.ops.winograd_cuda.conv3_packed_wino",
                        counting)
    out = _port_box(style64, 64, box, wino=True)
    assert len(calls) > 0  # the Winograd sites ran (plain version on the CPU)
    assert np.isfinite(out).all()
    assert rel_max(out, jax_box64) < 0.02


# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(size=(16,) * 3, slab=6),
    dict(size=(16,) * 3, slab=8, slab_h=6),
    dict(size=(16,) * 3, slab=8, tile=(6, 8, 8)),
    dict(size=(20,) * 3, slab=4, tile=(10, 10, 10)),
    dict(size=(16,) * 3, slab=8, tile1=4),
    dict(size=(16,) * 3, slab=8, tile=(8, 8, 2)),
])
def test_config_validation_matches_jax(kw):
    with pytest.raises(ValueError):
        JConfig(**kw)
    with pytest.raises(ValueError):
        HierarchicalConfig(**kw)


def test_config_defaults_match_jax():
    for size in [(16,) * 3, (128,) * 3, (512, 512, 256)]:
        kw = dict(size=size, slab=8, tile=size)
        assert HierarchicalConfig(**kw).tile1 == JConfig(**kw).tile1


def test_wino_default_follows_device(style4):
    cfg = HierarchicalConfig(size=(N,) * 3, slab=8, tile=(8, 8, 8))
    tree = modulate_emulator_parameters(params_from_jax(style4), Z, OM)
    model = NBodyEmulatorCore(mid_chan=4)
    proc = HierarchicalProcessor(model, tree, cfg, device="cpu")
    assert proc.device.type == "cpu" and proc.wino is False
    # No device named: the card, and no quiet step down to the CPU without one.
    if torch.cuda.is_available():
        assert HierarchicalProcessor(model, tree, cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            HierarchicalProcessor(model, tree, cfg)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            create_emulator(premodulate=True, compute_vel=False, params=params_from_jax(style4),
                            premodulate_z=Z, premodulate_Om=OM, mid_chan=4)


def test_style_emulator_is_ported(style4, box):
    """``premodulate=False`` builds the style disp core, whose forward and
    runtime equal the premodulated ones with the style folded at the same
    (z, Om): the displacement bit for bit on the runtime, rtol 1e-5 / atol 1e-6
    for the model's forward (a fold against modulation around one conv)."""
    style = create_emulator(premodulate=False, compute_vel=False, params=params_from_jax(style4),
                            mid_chan=4, device="cpu")
    assert type(style.model).__name__ == "StyleNBodyEmulatorCore" and not style.premodulate
    premod = create_emulator(premodulate=True, compute_vel=False, params=params_from_jax(style4),
                             premodulate_z=Z, premodulate_Om=OM, mid_chan=4, device="cpu")
    x = _wrap_pad(torch.from_numpy(box)[None], 48)
    np.testing.assert_allclose(style.apply(x, Z, OM).numpy(), premod.apply(x, Z, OM).numpy(),
                               rtol=1e-5, atol=1e-6)
    cfg = HierarchicalConfig(size=(N,) * 3, slab=8, tile=(8, 8, 8), dtype=torch.float32,
                             output_dtype=torch.float32)
    style = create_emulator(premodulate=False, compute_vel=False, params=params_from_jax(style4),
                            processor_config=cfg, mid_chan=4, device="cpu")
    np.testing.assert_array_equal(style.process_box(box, Z, OM), _port_box(style4, 4, box))


# ---------------------------------------------------------------------------
# The port never imports JAX
# ---------------------------------------------------------------------------


def test_port_sources_do_not_reference_jax():
    import re

    pattern = re.compile(r"^\s*(import jax|from jax)\b|\bjax\.", re.M)
    files = sorted(PORT_DIR.rglob("*.py")) + [PORT_DIR.parent / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        assert not pattern.search(f.read_text()), f


@pytest.mark.parametrize("sub", ["models", "ops"])
def test_subpackage_exports_cover_the_jax_package(sub):
    """The JAX package's ``models`` and ``ops`` names, importable from the port's."""
    import importlib

    jmod = importlib.import_module(f"jax_nbody_emulator_with_dj_tpu.{sub}")
    tmod = importlib.import_module(f"jax_nbody_emulator_with_dj_tpu_torch.{sub}")
    assert set(jmod.__all__) <= set(tmod.__all__)
    for name in tmod.__all__:
        assert callable(getattr(tmod, name)), name


def test_port_import_loads_no_jax():
    code = (
        "import sys, jax_nbody_emulator_with_dj_tpu_torch as t\n"
        "import jax_nbody_emulator_with_dj_tpu_torch.ops.winograd_cuda\n"
        "import jax_nbody_emulator_with_dj_tpu_torch.native\n"
        "import jax_nbody_emulator_with_dj_tpu_torch.experiments.memory_points\n"
        "import jax_nbody_emulator_with_dj_tpu_torch.science\n"
        "import jax_nbody_emulator_with_dj_tpu_torch.pipeline\n"
        "import jax_nbody_emulator_with_dj_tpu_torch.utils.timing\n"
        "import jax_nbody_emulator_with_dj_tpu_torch.utils.profiling\n"
        "from jax_nbody_emulator_with_dj_tpu_torch.science import halos\n"
        "assert halos.native_fof is t.native.fof_labels\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m.startswith('jax_nbody_emulator_with_dj_tpu.')\n"
        "       or m == 'jax_nbody_emulator_with_dj_tpu']\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=PORT_DIR.parent, timeout=120)
