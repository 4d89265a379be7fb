"""Command-line drivers and examples of the PyTorch port.

One module per driver of the JAX package, each run as
``python -m jax_nbody_emulator_with_dj_tpu_torch.cli.<name>`` and callable
in-process as ``main(argv) -> dict``:

- ``run_emulator``: IC -> 1LPT -> emulator -> density (``scripts/run_emulator.py``);
- ``run_batch``: displacement files through one emulator (``scripts/run_jax_emulator.py``);
- ``quijote_comparison``: the emulator against a target field (``scripts/quijote_comparison.py``);
- ``halos``: FoF catalogue and mass function (``scripts/halos.py``);
- ``fof_scale_demo``: FoF timings at scale (``scripts/fof_scale_demo.py``);
- ``upsampling``: the mode-injection upsampling diagnostic (``scripts/test_upsampling.py``);
- ``basic_usage``: the worked examples (``examples/basic_usage.py``);
- ``run_pod``: the sharded driver (``examples/run_pod.py``).

Each takes the JAX script's arguments and defaults and writes its files and
metadata keys, plus ``--device`` (default: the CUDA card; ``cpu`` runs on the
CPU).  Figures are off by default (``--plots`` needs matplotlib); their data
is always written.
"""
