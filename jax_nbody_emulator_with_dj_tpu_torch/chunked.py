"""Chunked hierarchical runtime: boxes larger than one card's buffer memory.

Counterpart of ``jax_nbody_emulator_with_dj_tpu/chunked.py``.  The
hierarchical runtime (``hierarchical.py``) keeps level-1 feature volumes
resident on the device; a bfloat16 velocity box of 1024^3 needs more of them
than an 80 GB card holds.  This wrapper splits the global periodic box into
``chunks`` sub-volumes, pads each by the network's full receptive margin (48
voxels, ``models.unet.input_margin``) with periodic wrap, runs every padded
chunk as an independent periodic box through ``HierarchicalProcessor``, and
keeps only the exact center crop.

Why the center crop is exact: the padded chunk differs from the true
periodic environment only within ``pad`` voxels of the chunk boundary (the
inner run wraps the chunk onto itself instead of seeing the real
neighbours).  A VALID-conv U-Net output voxel depends on inputs within the
48-voxel receptive radius, so every voxel of the center crop, at least
``pad >= 48`` from the boundary, sees only genuine data.  Chunk anchors and
pads are multiples of 8 (16 packed), which keeps the three stride-2
lattices aligned with the global grid; equality with the monolithic runtime
is asserted in tests.

Overhead against the monolithic run is the pad recompute, prod_i((c_i +
2*pad)/c_i) over split axes, while the peak device memory drops by roughly
the chunk ratio.

Host inputs (numpy) are gathered chunk by chunk into a pinned host buffer
(``native.periodic_gather``, else numpy's fancy index) and uploaded
asynchronously; the next chunk is gathered while the card computes the
current one.  Device inputs are cut on the device (modular ``index_select``,
as ``hierarchical._wrap_pad`` pads) and, with ``as_numpy=False``, the crops
are scattered into device outputs.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .hierarchical import HierarchicalConfig, HierarchicalProcessor, resolve_device
from .models.unet import input_margin


def _largest_divisor(n: int, cap: int, mult: int) -> int:
    """Largest d <= cap with d % mult == 0 and n % d == 0 (or mult if none)."""
    for d in range(min(cap, n), mult - 1, -1):
        if d % mult == 0 and n % d == 0:
            return d
    return mult


@dataclass
class ChunkedHierarchicalConfig:
    """Decomposition geometry for :class:`ChunkedHierarchicalProcessor`.

    ``slab`` / ``slab_h`` / ``tile`` / ``tile1`` configure the *inner*
    hierarchical run on one padded chunk; unset values are derived divisors
    of the padded chunk extent.
    """

    size: tuple[int, int, int]
    chunks: tuple[int, int, int] = (2, 1, 1)
    pad: int = 48  # receptive margin per side of each split axis
    slab: int | None = None
    slab_h: int | None = None
    tile: tuple[int, int, int] | None = None
    tile1: int | None = None
    dtype: torch.dtype = torch.bfloat16
    output_dtype: torch.dtype = torch.float16
    in_chan: int = 3
    packed: bool = True
    buf_dtype: torch.dtype | None = None  # see HierarchicalConfig.buf_dtype
    # derived in __post_init__
    chunk_size: tuple[int, int, int] = field(init=False)
    pads: tuple[int, int, int] = field(init=False)
    inner_size: tuple[int, int, int] = field(init=False)

    def __post_init__(self):
        self.size = tuple(int(s) for s in self.size)
        self.chunks = tuple(int(c) for c in self.chunks)
        margin = input_margin(3)
        if self.pad < margin or self.pad % 8:
            raise ValueError(
                f"pad {self.pad} must be a multiple of 8 and >= the receptive "
                f"margin {margin} (smaller pads would let the inner run's "
                f"periodic wrap contaminate the kept crop)"
            )
        align = 16 if self.packed else 8
        for s, c in zip(self.size, self.chunks):
            if c < 1 or s % c:
                raise ValueError(f"chunks {self.chunks} must divide size {self.size}")
            if c > 1 and (s // c) % align:
                raise ValueError(
                    f"chunk extent {s // c} must be a multiple of {align} "
                    f"(stride-lattice and W-packing alignment)"
                )
        self.chunk_size = tuple(s // c for s, c in zip(self.size, self.chunks))
        self.pads = tuple(self.pad if c > 1 else 0 for c in self.chunks)
        self.inner_size = tuple(cs + 2 * p for cs, p in zip(self.chunk_size, self.pads))

    def inner_config(self) -> HierarchicalConfig:
        inner = self.inner_size
        slab = self.slab or _largest_divisor(inner[0], 32, 2)
        tile = self.tile or (
            _largest_divisor(inner[0], 128, 2),
            _largest_divisor(inner[1], 128, 2),
            _largest_divisor(inner[2], 128, 4 if self.packed else 2),
        )
        return HierarchicalConfig(
            size=inner,
            slab=slab,
            slab_h=self.slab_h,
            tile=tile,
            tile1=self.tile1,
            dtype=self.dtype,
            output_dtype=self.output_dtype,
            in_chan=self.in_chan,
            packed=self.packed,
            buf_dtype=self.buf_dtype,
        )


class ChunkedHierarchicalProcessor:
    """Big-box runtime for boxes whose hierarchical buffers overflow the card.

    Same ``process_box(box, z, Om)`` contract as the other runtimes.  Host
    (numpy) inputs are gathered chunk by chunk on the host and assembled into
    host output arrays; device inputs are cut on the device and, with
    ``as_numpy=False``, scattered into device output tensors.  Supports all
    four model cores (a style model is folded once per chunk, inside the
    shared inner processor).
    """

    def __init__(self, model, params, config: ChunkedHierarchicalConfig, device=None):
        self.config = config
        self.device = resolve_device(device)
        self.inner = HierarchicalProcessor(model, params, config.inner_config(), device=self.device)
        self.compute_vel = self.inner.compute_vel
        self.last_timings = {}
        self.last_peaks = {}

    def _resume_fingerprint(self, input_box, z, Om) -> str:
        """Identity of one (input, cosmology, geometry) run for ``resume_dir``.

        Chunk files are keyed by anchor only, so resuming with another input
        box, (z, Om) or decomposition would assemble stale chunks; this
        fingerprint (a hash of a strided sample of the input and of the run's
        parameters, cheap for multi-GiB boxes) catches that.
        """
        import hashlib

        cfg = self.config
        stride = max(1, input_box.shape[-1] // 16)
        sample = input_box[..., ::stride, ::stride, ::stride]
        if torch.is_tensor(sample):
            sample = sample.detach().float().cpu().numpy()
        sample = np.ascontiguousarray(np.asarray(sample, np.float32))
        dtype = str(input_box.dtype).replace("torch.", "")
        h = hashlib.sha256()
        h.update(sample.tobytes())
        h.update(repr((
            tuple(input_box.shape), dtype, float(z), float(Om), cfg.size, cfg.chunks, cfg.pad,
            str(cfg.dtype), str(cfg.output_dtype),
        )).encode())
        return h.hexdigest()

    def _check_resume_manifest(self, rdir, input_box, z, Om) -> None:
        """Refuse to mix chunks from another run into this one."""
        import json

        manifest = rdir / "manifest.json"
        fp = self._resume_fingerprint(input_box, z, Om)
        if manifest.exists():
            try:
                stored = json.loads(manifest.read_text()).get("fingerprint")
            except (OSError, ValueError):
                stored = None
            if stored != fp:
                raise ValueError(
                    f"resume_dir {rdir} holds chunks from a different run "
                    f"(input box, z/Om, or decomposition changed); delete "
                    f"it or pass a fresh directory"
                )
        else:
            tmp = manifest.with_suffix(".json.tmp")
            tmp.write_text(json.dumps({"fingerprint": fp}))
            tmp.replace(manifest)

    def _anchors(self):
        cfg = self.config
        return [
            tuple(i * cs for i, cs in zip(idx, cfg.chunk_size))
            for idx in itertools.product(*(range(c) for c in cfg.chunks))
        ]

    def _starts(self, a):
        cfg = self.config
        return tuple((ai - p) % n for ai, p, n in zip(a, cfg.pads, cfg.size))

    def _extract(self, box, start):
        """The padded chunk at ``start`` of a device box, by modular index_select
        (extents wider than the box tile the torus)."""
        for ax, (s, m, n) in enumerate(zip(start, self.config.inner_size, box.shape[1:])):
            idx = torch.arange(s, s + m, device=box.device) % n
            box = box.index_select(ax + 1, idx)
        return box

    def _crop(self, t):
        """The kept center of an inner output (C, D, H, W), a view."""
        (p0, p1, p2), (c0, c1, c2) = self.config.pads, self.config.chunk_size
        return t[:, p0:p0 + c0, p1:p1 + c1, p2:p2 + c2]

    def process_box(self, input_box, z, Om, as_numpy: bool = True, profile: bool = False,
                    resume_dir=None):
        """Emulate a full periodic box chunk by chunk.

        The global input stays alive across all chunks, so there is no
        ``donate_input`` here; each *chunk* is donated into the inner run.
        With ``profile=True`` the inner runs' per-phase times are summed over
        chunks into ``self.last_timings``, beside ``stage`` (host gather and
        upload, or the device cut) and ``crop_to_host`` (the crops' copy into
        the host outputs), and ``self.last_peaks`` holds each phase's largest
        peak over the chunks.

        ``resume_dir`` (host assembly only) makes long runs restartable:
        every finished chunk's center crop is written to
        ``<dir>/chunk_<anchor>_<out>.npy`` (atomically), and chunks whose
        files exist are loaded instead of recomputed.  The caller may delete
        the directory once the returned arrays are kept.
        """
        cfg = self.config
        if tuple(input_box.shape) != (cfg.in_chan,) + cfg.size:
            raise ValueError(f"box shape {tuple(input_box.shape)} != {(cfg.in_chan,) + cfg.size}")
        if torch.is_tensor(input_box) and input_box.device.type == "cpu" \
                and self.device.type != "cpu":
            input_box = input_box.numpy()  # a host box: staged chunk by chunk
        host_in = not torch.is_tensor(input_box)
        if host_in:
            input_box = np.asarray(input_box)
        nout = 2 if self.compute_vel else 1
        shape = (cfg.in_chan,) + cfg.size
        if as_numpy:
            odt = torch.empty((), dtype=cfg.output_dtype).numpy().dtype
            outs = [np.empty(shape, odt) for _ in range(nout)]
        else:
            if resume_dir is not None:
                raise ValueError("resume_dir needs host assembly (as_numpy=True)")
            outs = [torch.zeros(shape, dtype=cfg.output_dtype, device=self.device)
                    for _ in range(nout)]
        timings: dict[str, float] = {}
        peaks: dict[str, int] = {}
        anchors = self._anchors()

        def dst(a):
            return (slice(None),) + tuple(slice(ai, ai + c) for ai, c in zip(a, cfg.chunk_size))

        chunk_files = None
        if resume_dir is not None:
            from pathlib import Path

            rdir = Path(resume_dir)
            rdir.mkdir(parents=True, exist_ok=True)
            self._check_resume_manifest(rdir, input_box, z, Om)

            def chunk_files(a):  # one file per output array
                tag = "_".join(str(ai) for ai in a)
                return [rdir / f"chunk_{tag}_{i}.npy" for i in range(nout)]

            done, pending = [], []
            for a in anchors:
                (done if all(f.exists() for f in chunk_files(a)) else pending).append(a)
            for a in done:
                for o, f in zip(outs, chunk_files(a)):
                    o[dst(a)] = np.load(f).astype(o.dtype)
            anchors = pending
            if not anchors:
                if profile:
                    self.last_timings, self.last_peaks = {}, {}
                return tuple(outs) if self.compute_vel else outs[0]

        # Two pinned host buffers, used in turns: chunk i+1 is gathered into one
        # while the upload of chunk i from the other may still be queued.  Each
        # upload records an event; a buffer is written again only after its
        # last upload's event (nothing else orders the host against the copy).
        pinned, uploaded = [], []
        pin = host_in and self.device.type == "cuda"
        if host_in:
            cshape = (cfg.in_chan,) + cfg.inner_size
            pinned = [torch.empty(cshape, dtype=torch.from_numpy(input_box[:1, :1, :1, :1]).dtype,
                                  pin_memory=pin) for _ in range(min(2, len(anchors)))]
            uploaded = [None] * len(pinned)
            contiguous = input_box.flags.c_contiguous

        def fetch(i, a):
            """Stage the padded chunk at anchor ``a`` onto the device."""
            t0 = time.perf_counter()
            start = self._starts(a)
            if not host_in:
                chunk = self._extract(input_box, start)
            else:
                from .native import periodic_gather

                slot = i % len(pinned)
                if uploaded[slot] is not None:
                    uploaded[slot].synchronize()
                buf = pinned[slot]
                out = buf.numpy()
                if not contiguous or periodic_gather(input_box, start, cfg.inner_size, out) is None:
                    idx = [(np.arange(s, s + m) % n)
                           for s, m, n in zip(start, cfg.inner_size, cfg.size)]
                    out[...] = input_box[:, idx[0][:, None, None], idx[1][None, :, None],
                                         idx[2][None, None, :]]
                chunk = buf.to(self.device, non_blocking=pin)
                if pin:
                    uploaded[slot] = torch.cuda.Event()
                    uploaded[slot].record()
            if profile:
                timings["stage"] = timings.get("stage", 0.0) + time.perf_counter() - t0
            return chunk

        # One-chunk software pipeline: the host gather (and the upload) of chunk
        # i+1 is issued while the card computes chunk i (the inner run returns
        # without waiting for the device); the crops' copy to the host is what
        # waits.  Only ONE inner run is ever in flight (two would double the
        # level buffers), so the extra residency is a single input chunk.
        # Prefetch only with host assembly: without a blocking copy nothing
        # waits, and an early cut would only raise the peak.
        prefetch = as_numpy
        staged = [fetch(0, anchors[0])]
        for ci, a in enumerate(anchors):
            # the list hands the chunk over: the inner run holds its only reference
            res = self.inner.process_box(staged.pop(), z, Om, as_numpy=False, profile=profile,
                                         donate_input=True)
            nxt = anchors[ci + 1] if ci + 1 < len(anchors) else None
            if prefetch and nxt is not None:
                staged.append(fetch(ci + 1, nxt))
            res = res if self.compute_vel else (res,)
            if profile:
                for k, v in self.inner.last_timings.items():
                    timings[k] = timings.get(k, 0.0) + v
                for k, v in self.inner.last_peaks.items():
                    peaks[k] = max(peaks.get(k, 0), v)
            t0 = time.perf_counter()
            # by index: a loop variable bound to an output would keep it alive
            # through the next chunk's inner run
            for i, o in enumerate(outs):
                crop = self._crop(res[i])
                if as_numpy:
                    # crop on the device before the copy: the pads are pure overhead
                    # on the device-to-host link
                    o[dst(a)] = crop.cpu().numpy()
                    if chunk_files is not None:
                        f = chunk_files(a)[i]
                        tmp = f.with_suffix(".npy.tmp")
                        with open(tmp, "wb") as fh:  # a file handle: np.save must not
                            np.save(fh, o[dst(a)])  # append ".npy"
                        tmp.replace(f)  # atomic: a partial write never resumes
                else:
                    o[dst(a)] = crop
            del res, crop
            if profile:
                timings["crop_to_host"] = (timings.get("crop_to_host", 0.0)
                                           + time.perf_counter() - t0)
            if not prefetch and nxt is not None:
                staged.append(fetch(ci + 1, nxt))
        if profile:
            self.last_timings, self.last_peaks = timings, peaks
        return (outs[0], outs[1]) if self.compute_vel else outs[0]
