"""Resident serving: a reusable ``Predictor``, a directory-watch server, and
the export of the predict program with ``torch.export``.

The port of the JAX package's ``serving.py``. The expensive parts of a
prediction are one-time (model build, checkpoint load, kernel build), so
this module keeps them resident:

* ``Predictor`` builds the model and its forward once, then predicts any
  number of volumes through the same device programs as the batch CLI
  (``ops/sliding_window.py``); ``sync=False`` returns a fetch thunk so that
  a caller can overlap uploads and writes with the card's work.
* ``serve`` watches ``config.watch_dir`` and writes a mask for each volume
  that appears to ``<hydra_path>/pred_file/pred-<stem><save_suffix>``::

      python -m general_medical_image_segmentation_cnn_framework_tpu_torch.serving \\
          config=unet config.ckpt=<port .pt> config.watch_dir=<dir> [config.serve_once=true]

* ``export_predictor`` / ``load_exported_predictor`` save the predict
  program of one volume shape with ``torch.export`` (``config.export_path=
  <file.pt2> "config.export_spatial=256, 256, 128"`` on the CLI) and replay
  it without the model-building code. The weights are an argument of the
  program, as in the JAX package; every eval conv in it is the registered
  hand-kernel operator (``ops.conv3d_bn_relu``).

The port serves on one device: the card (``cuda:0``), or the CPU with
``config.platform=cpu``. Model code is imported inside ``Predictor`` only,
so that loading an exported program needs the port's ``ops`` alone.
"""

from __future__ import annotations

import json
import math
import time
import zipfile
from io import BytesIO
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from .config import compose, log_ignored_keys, resolve_device
from .data.io import Volume, read_volume, write_volume
from .data.pipeline import grid_locations
from .data.transforms import ZNormalization
from .logging_utils import get_logger, log_config
from .ops.sliding_window import prepare_volume, sliding_window_predict, whole_volume_predict

_META = "meta.json"  # the exported program's extra file


def _parse_overlap(config) -> tuple:
    """The overlap of the JAX serving layer: int or 'x, y, z', clamped below
    the patch extent; half the patch when ``patch_overlap`` is unset (the
    batch CLI's ``predict.overlap_of`` has no default)."""
    overlap = getattr(config, "patch_overlap", None)
    if overlap is None:
        overlap = tuple(int(p) // 2 for p in config.patch_size)
    if isinstance(overlap, str):
        overlap = tuple(int(v) for v in overlap.split(","))
    elif isinstance(overlap, int):
        overlap = (overlap,) * 3
    return tuple(min(int(o), int(p) - 1) for o, p in zip(overlap, config.patch_size))


class Predictor:
    """One-time setup (model, weights, forward), many predicts.

    config  composed run config (``network``, ``patch_size``, ...; ``ckpt``
            unless ``params`` is given; ``platform`` picks the device).
    model   optional module to serve (default ``models.build_model``).
    params  optional port state dict, which skips loading the checkpoint
            (tests, a hand-off from a trainer).
    """

    def __init__(self, config, model=None, params=None, logger=None):
        from .models import build_model, is_2d, pad_multiple
        from .predict import make_forward_fn

        self.config, self.logger = config, logger
        self.device = resolve_device(config)
        self.model = model if model is not None else build_model(config)
        source = "the given params"
        if params is None:
            from .checkpoint import load_checkpoint

            source = f"checkpoint {config.ckpt!r}"
            params = load_checkpoint(config.ckpt).get("params", {})
        try:
            self.model.load_state_dict(params)
        except RuntimeError as e:
            raise ValueError(f"{source} does not match network '{config.network}': {e}") from e
        self.model.to(self.device).eval()
        self.forward = make_forward_fn(config, self.model)
        if self.device.type == "cuda" and torch.cuda.device_count() > 1 and logger:
            logger.info(
                f"serving on cuda:0 only; {torch.cuda.device_count() - 1} more cards stay idle "
                "(the multi-card mesh is ROADMAP queue 1 item 12)"
            )

        self.overlap = _parse_overlap(config)
        self.whole_volume = bool(getattr(config, "whole_volume", False)) and not is_2d(config.network)
        self.bucket = int(getattr(config, "shape_bucket", 0) or 0)
        self.in_dtype = torch.bfloat16 if getattr(config, "precision", "") == "bfloat16" else torch.float32
        self.wv_pad = None
        if self.whole_volume:
            pm = pad_multiple(config.network)
            self.wv_pad = math.lcm(pm, self.bucket) if self.bucket else pm
        self._znorm = ZNormalization()

    # -- volume preparation ------------------------------------------------

    def prepare(self, src: np.ndarray):
        """z-normalise and pad a raw [C, X, Y, Z] volume (to the bucket, or
        to the whole-volume multiple), and upload it as [X, Y, Z, C].

        Returns ``(volume on the device, true spatial shape)``."""
        src = self._znorm.normalize_array(np.asarray(src, np.float32))
        orig_shape = src.shape[1:]
        pad_to = self.wv_pad if self.whole_volume else self.bucket
        if pad_to:
            padded = tuple(-(-s // pad_to) * pad_to for s in orig_shape)
            src = np.pad(src, [(0, 0)] + [(0, p - s) for p, s in zip(padded, orig_shape)])
        return prepare_volume(src, self.device, self.in_dtype), orig_shape

    # -- prediction ---------------------------------------------------------

    def predict_array(self, src: np.ndarray, sync: bool = True, on_dispatch: Optional[Callable] = None):
        """Predict a raw (not normalised) [C, X, Y, Z] volume.

        Returns the int32 [1, X, Y, Z] mask, or with ``sync=False`` a thunk
        of it: the work is enqueued now and fetched when the thunk is called."""
        vol, orig_shape = self.prepare(src)
        return self.predict_prepared(vol, orig_shape, sync=sync, on_dispatch=on_dispatch)

    def predict_prepared(self, vol, orig_shape, sync: bool = True, on_dispatch: Optional[Callable] = None):
        """Predict a volume from :meth:`prepare`."""
        config = self.config
        if self.whole_volume:
            thunk = whole_volume_predict(
                self.forward, vol, pad_multiple=self.wv_pad, on_dispatch=on_dispatch, sync=False,
            )

            def fetch():
                return thunk()[:, : orig_shape[0], : orig_shape[1], : orig_shape[2]]

        else:
            fetch = sliding_window_predict(
                self.forward, vol, config.patch_size, self.overlap, int(config.batch_size),
                overlap_mode=getattr(config, "blend", "crop") or "crop",
                true_spatial=orig_shape if self.bucket else None,
                on_dispatch=on_dispatch, sync=False,
            )
        return fetch() if sync else fetch

    def predict_file(self, in_path, out_path=None) -> np.ndarray:
        """Read a volume file, predict, and write the mask (float32, with the
        source's affine) to ``out_path`` if given."""
        vol = read_volume(in_path)
        mask = self.predict_array(vol.data)
        if out_path is not None:
            write_volume(Path(out_path), Volume(mask.astype(np.float32), vol.affine))
        return mask

    def warmup(self, spatial=(128, 128, 128)) -> None:
        """Run one prediction of a zero volume of ``spatial`` (the kernels'
        build and the allocator's first blocks)."""
        self.predict_array(np.zeros((int(self.config.in_classes), *spatial), np.float32))


# -- directory-watch server ----------------------------------------------

_VOLUME_SUFFIXES = (".nii", ".nii.gz", ".mhd")


def _list_volumes(watch_dir: Path):
    files = []
    for p in sorted(watch_dir.iterdir()) if watch_dir.is_dir() else []:
        name = p.name.lower()
        if any(name.endswith(s) for s in _VOLUME_SUFFIXES):
            files.append(p)
    return files


def serve(config, logger=None, once: bool = False, poll_s: float = 2.0):
    """Watch ``config.watch_dir`` and predict volumes as they appear.

    Masks go to ``<config.hydra_path>/pred_file/pred-<stem><save_suffix>``.
    A file is taken only once its size is the same over two polls (an
    upload still being written waits). ``once=True`` handles what is in the
    directory and returns. A mask that exists already (a restart) counts as
    done: it is neither predicted again nor returned.
    Returns ``{input name: mask path}``.
    """
    if not getattr(config, "watch_dir", None):
        raise ValueError("config.watch_dir is required for serve")
    watch_dir = Path(config.watch_dir)
    out_dir = Path(config.hydra_path) / "pred_file"
    out_dir.mkdir(parents=True, exist_ok=True)

    predictor = Predictor(config, logger=logger)
    if logger:
        logger.info(f"serving {watch_dir} -> {out_dir}")

    suffix = getattr(config, "save_suffix", ".nii.gz") or ".nii.gz"
    done: dict = {}
    sizes: dict = {}
    while True:
        progressed = False
        for p in _list_volumes(watch_dir):
            if p.name in done:
                continue
            size = p.stat().st_size
            if not once and sizes.get(p.name) != size:
                sizes[p.name] = size  # wait one poll for the size to settle
                continue
            stem = p.name
            for s in _VOLUME_SUFFIXES:
                if stem.lower().endswith(s):
                    stem = stem[: len(stem) - len(s)]
                    break
            out_path = out_dir / f"pred-{stem}{suffix}"
            if out_path.exists():
                # a mask from an earlier serve process: done, not predicted again, not returned
                done.setdefault(p.name, None)
                continue
            t0 = time.perf_counter()
            predictor.predict_file(p, out_path)
            dt = time.perf_counter() - t0
            done[p.name] = str(out_path)
            progressed = True
            if logger:
                logger.info(f"{p.name} -> {out_path.name} ({dt * 1e3:.0f} ms)")
        if once:
            return {k: v for k, v in done.items() if v is not None}
        if not progressed:
            time.sleep(poll_s)


# -- export ----------------------------------------------------------------


class _Program(torch.nn.Module):
    """The predict program of one volume shape: ``(state, volume) -> int8
    mask`` on the device. ``run`` is a plain function, so that the model's
    own tensors stay out of the graph: the weights come in as ``state``."""

    def __init__(self, run: Callable):
        super().__init__()
        self.run = run

    def forward(self, state, volume):
        return self.run(state, volume)


def export_predictor(predictor: Predictor, spatial, path=None, batch_size: Optional[int] = None) -> bytes:
    """Save the predict program for one volume shape with ``torch.export``.

    The program is the one the Predictor runs: the whole-volume forward and
    argmax on the padded shape, or the crop-mode sliding window with its
    tile starts fixed by the grid of ``spatial`` (the last batch padded by
    repeats of the last start). Its arguments are the model's state dict
    (parameters and BatchNorm statistics, traced through
    ``torch.func.functional_call``) and the z-normalised [X, Y, Z, C]
    volume. Tensors made inside the program carry the device it was
    exported on, so an artifact belongs to that device; the meta (an extra
    file, JSON) records it beside the JAX package's keys. Returns the
    artifact's bytes, also written to ``path`` if given."""
    from .predict import make_forward_fn

    config, model = predictor.config, predictor.model
    spatial = tuple(int(s) for s in spatial)
    meta = {
        "whole_volume": predictor.whole_volume,
        "spatial": list(spatial),
        "pack": False,  # the port fetches the mask as int8, not bit-packed
        "in_dtype": str(predictor.in_dtype).removeprefix("torch."),
        "device": predictor.device.type,
    }

    def forward(state):
        return make_forward_fn(config, lambda *inputs: torch.func.functional_call(model, state, inputs))

    if predictor.whole_volume:
        pad = predictor.wv_pad
        shape = tuple(-(-s // pad) * pad for s in spatial)
        meta["padded"] = list(shape)

        def run(state, volume):
            return whole_volume_predict(forward(state), volume, pad_multiple=pad)

    else:
        blend = getattr(config, "blend", "crop") or "crop"
        if blend != "crop":
            raise ValueError(f"export_predictor exports the crop blend only, not config.blend={blend!r}")
        patch, overlap = tuple(int(p) for p in config.patch_size), predictor.overlap
        bs = int(batch_size or config.batch_size)
        starts = grid_locations(spatial, patch, overlap)[:, :3].tolist()
        meta["starts"] = starts + [starts[-1]] * (-len(starts) % bs)
        shape = spatial

        def run(state, volume):
            return sliding_window_predict(forward(state), volume, patch, overlap, bs)

    state = dict(sorted(model.state_dict().items()))
    volume = torch.zeros((*shape, int(config.in_classes)), dtype=predictor.in_dtype, device=predictor.device)
    program = torch.export.export(_Program(run), (state, volume), strict=False)
    program.example_inputs = None  # the artifact keeps no copy of the weights
    buf = BytesIO()
    torch.export.save(program, buf, extra_files={_META: json.dumps(meta)})
    blob = buf.getvalue()
    if path is not None:
        Path(path).write_bytes(blob)
    return blob


def load_exported_predictor(source) -> Callable:
    """Load an :func:`export_predictor` artifact (a path or its bytes).

    Returns ``predict(params, volume[C, X, Y, Z] z-normalised) -> int32
    [1, X, Y, Z] mask``, ``params`` the port state dict the program was
    exported with, and ``predict.program`` (the ``ExportedProgram``) and
    ``predict.meta`` beside it. Only the port's ``ops`` are imported (the
    operators the program calls); no model code runs. An artifact exported
    on the card needs a card, and a volume must have the exported spatial
    shape.""" 
    from .ops import conv3d_bn_relu  # noqa: F401 (registers the operators the program calls)

    blob = source if isinstance(source, bytes) else Path(source).read_bytes()
    with zipfile.ZipFile(BytesIO(blob)) as archive:  # the meta first: a CUDA program loads only with a card
        (name,) = [n for n in archive.namelist() if n.endswith(f"/extra/{_META}")]
        meta = json.loads(archive.read(name))
    device = torch.device(meta["device"])
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the exported predict program was exported on a CUDA card and needs one; "
                           "torch.cuda.is_available() is False")
    program = torch.export.load(BytesIO(blob))
    call = program.module()
    spatial = tuple(meta["spatial"])
    dtype = getattr(torch, meta["in_dtype"])

    def predict(params, volume: np.ndarray) -> np.ndarray:
        volume = np.asarray(volume, np.float32)
        if volume.shape[1:] != spatial:
            raise ValueError(f"exported for spatial {spatial}, got {volume.shape[1:]}")
        if meta["whole_volume"]:
            volume = np.pad(volume, [(0, 0)] + [(0, t - s) for t, s in zip(meta["padded"], spatial)])
        state = {k: v.to(device) for k, v in sorted(params.items())}
        with torch.inference_mode():
            mask = call(state, prepare_volume(volume, device, dtype))
        mask = mask.cpu().numpy()[: spatial[0], : spatial[1], : spatial[2]]
        return mask[None].astype(np.int32)

    predict.program, predict.meta = program, meta
    return predict


def main(argv: Optional[list] = None):
    """CLI: ``python -m <package>.serving config=unet config.ckpt=<path>
    config.watch_dir=<dir>``; with ``config.export_path=<file>`` it exports
    the predict program for ``config.export_spatial`` and returns."""
    import sys

    overrides = argv if argv is not None else sys.argv[1:]
    config = compose(overrides, job_name="serve")
    if not config.ckpt:
        raise ValueError("config.ckpt is required for serve")
    logger = get_logger(config)
    log_config(logger, config)
    log_ignored_keys(config, logger)
    export_path = getattr(config, "export_path", None)
    if export_path:
        spatial = getattr(config, "export_spatial", None) or "256, 256, 128"
        if isinstance(spatial, str):
            spatial = tuple(int(v) for v in spatial.split(","))
        predictor = Predictor(config, logger=logger)
        t0 = time.perf_counter()
        blob = export_predictor(predictor, spatial, path=export_path)
        logger.info(
            f"exported predict program for spatial {tuple(spatial)} ({len(blob) / 1e6:.2f} MB) in "
            f"{time.perf_counter() - t0:.1f} s -> {export_path}"
        )
        return None
    return serve(config, logger=logger, once=bool(getattr(config, "serve_once", False)))


if __name__ == "__main__":
    main()
