"""Patch pipeline: subject discovery, training patch queue, inference grid.

The PyTorch port's own copy of the JAX package's host-side module
``data/pipeline.py`` (same names and behaviour; it imports no JAX, and the
patch queue's ``process_index`` defaults to 0 instead of asking JAX for the
process rank). It replaces the reference's TorchIO stack with an
asynchronous host pipeline:

* ``get_subjects``     — sorted ``*.nii.gz`` pairing, predict-dir switch by
                         job name (reference dataloader.py:30-49);
* ``PatchQueueDataset``— semantics of ``tio.Queue(queue_length=10,
                         samples_per_volume=10, UniformSampler(patch_size))``
                         (reference dataloader.py:52-67) but with a
                         background producer thread and volume caching — the
                         reference's queue is fully synchronous
                         (num_workers=0, SURVEY §2.8), which starves the
                         accelerator; ours overlaps host I/O with device
                         compute and emits channels-last NDHWC batches;
* ``grid_locations``   — tio.inference.GridSampler location grid
                         (reference predict.py:100);
* ``GridAggregator``   — tio.inference.GridAggregator's crop and average
                         overlap modes (reference predict.py:117-118).
"""

from __future__ import annotations

import queue as queue_mod
import threading
from pathlib import Path
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .io import Volume, read_volume
from .transforms import Subject, Transform, build_transform


def get_subjects(config) -> List[Tuple[Path, Path]]:
    """Pair sorted image/label files (reference dataloader.py:30-49).

    Picks the predict dirs when 'predict' is in the job name, mirroring the
    reference's substring dispatch (dataloader.py:35-40).
    """
    if "predict" in getattr(config, "job_name", "train"):
        img_path = Path(config.pred_data_path)
        gt_path = Path(config.pred_gt_path)
    else:
        img_path = Path(config.data_path)
        gt_path = Path(config.gt_path)
    sources = sorted(img_path.glob("*.nii.gz"))
    gts = sorted(gt_path.glob("*.nii.gz"))
    return list(zip(sources, gts))


def load_subject(pair: Tuple[Path, Path]) -> Subject:
    source = read_volume(pair[0])
    gt = read_volume(pair[1])
    return Subject(source, gt)


def sample_patch_origin(
    rng: np.random.Generator, spatial_shape: Sequence[int], patch_size: Sequence[int]
) -> Tuple[int, int, int]:
    """UniformSampler: origin ~ U{0 .. shape - patch} per axis."""
    return tuple(
        int(rng.integers(0, s - p + 1)) for s, p in zip(spatial_shape, patch_size)
    )


class PatchQueueDataset:
    """Iterable of training batches of uniform random patches.

    Each epoch: subjects are visited in shuffled order; each subject is
    loaded (from an in-memory cache after the first epoch), transformed, and
    ``samples_per_volume`` patches are drawn. Patches stream through a
    bounded queue filled by a producer thread so host preprocessing overlaps
    device compute.

    Yields ``(x, y)`` with ``x: [B, D, H, W, C] float32`` (channels-last) and ``y: [B, D, H, W, 1] float32``.
    """

    def __init__(
        self,
        config,
        is_train: bool = True,
        transform: Optional[Transform] = None,
        cache_volumes: bool = True,
        process_index: int = 0,
    ):
        self.config = config
        self.pairs = get_subjects(config)
        if not self.pairs:
            raise FileNotFoundError(
                f"no .nii.gz pairs found under {config.data_path} / {config.gt_path}"
            )
        self.patch_size = tuple(config.patch_size)
        self.batch_size = int(config.batch_size)
        self.samples_per_volume = int(getattr(config, "samples_per_volume", 10))
        self.queue_length = int(getattr(config, "queue_length", 10))
        # reference hardcodes num_workers=0 (fully synchronous); >1 here
        # augments that many volumes concurrently (numpy/scipy release the
        # GIL on the big ops) for many-core hosts. Default 1: on a 1-core
        # host threads only contend (measured), and the serial producer
        # already sustains ~15 patches/s of full augmentation at 160^3 —
        # above the 12.2 patches/s the train step consumes.
        self.num_workers = int(getattr(config, "num_workers", 1) or 1)
        self.transform = transform or build_transform(config, is_train)
        self.cache_volumes = cache_volumes
        self._cache: dict = {}
        # Multi-process: each process draws a disjoint patch stream (its rank
        # is folded into the rng seed so processes never train on duplicate
        # data). The port runs one process, rank 0, unless told otherwise.
        self.process_index = int(process_index)
        self.seed = int(getattr(config, "seed", 0) or 0) + self.process_index * 1_000_003
        self._epoch = 0

    def __len__(self) -> int:
        """Batches per epoch (drop_last=True, reference train.py:158)."""
        return (len(self.pairs) * self.samples_per_volume) // self.batch_size

    def _get_subject(self, idx: int) -> Subject:
        if self.cache_volumes:
            if idx not in self._cache:
                self._cache[idx] = load_subject(self.pairs[idx])
            return self._cache[idx].copy()
        return load_subject(self.pairs[idx])

    def _patches_for(self, idx: int, vol_rng: np.random.Generator):
        """Load + transform one volume, cut its samples_per_volume patches."""
        subject = self._get_subject(int(idx))
        subject = self.transform(subject, vol_rng)
        src = subject.source.data  # [C, X, Y, Z]
        gt = subject.gt.data if subject.gt is not None else None
        shape = src.shape[1:]
        patches = []
        for _ in range(self.samples_per_volume):
            o = sample_patch_origin(vol_rng, shape, self.patch_size)
            sl = tuple(slice(o[d], o[d] + self.patch_size[d]) for d in range(3))
            x = np.moveaxis(src[(slice(None),) + sl], 0, -1).astype(np.float32)
            y = (
                np.moveaxis(gt[(slice(None),) + sl], 0, -1).astype(np.float32)
                if gt is not None
                else None
            )
            patches.append((x, y))
        return patches

    def _produce(self, out_q: queue_mod.Queue, rng: np.random.Generator, stop: threading.Event, epoch: int):
        """Volume order comes from the epoch rng; each volume's transform +
        patch draws use a per-volume child generator (SeedSequence spawn), so
        the stream is deterministic whether volumes are processed serially or
        by a worker pool (config.num_workers > 1), and output order is always
        the shuffled volume order."""
        order = rng.permutation(len(self.pairs))
        # `epoch` is captured by __iter__ BEFORE it bumps self._epoch and
        # passed in as an argument: re-reading the mutable attribute here
        # raced with a consumer that abandons one iterator and immediately
        # starts the next (duplicate augmentation streams; ADVICE r3).
        children = np.random.SeedSequence((self.seed, epoch, 0xA46)).spawn(len(order))
        def put(item) -> bool:
            # stop-aware put: never block forever on a full queue whose
            # consumer already exited (it only sets `stop` in its finally)
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.5)
                    return True
                except queue_mod.Full:
                    continue
            return False

        try:
            if self.num_workers <= 1:
                for pos, idx in enumerate(order):
                    if stop.is_set():
                        return
                    for p in self._patches_for(int(idx), np.random.default_rng(children[pos])):
                        if not put(p):
                            return
            else:
                from collections import deque
                from concurrent.futures import ThreadPoolExecutor

                pool = ThreadPoolExecutor(max_workers=self.num_workers)
                try:
                    pending: deque = deque()
                    nxt = 0

                    def top_up():
                        nonlocal nxt
                        # bounded prefetch: at most num_workers+1 transformed
                        # volumes in flight (memory stays O(workers))
                        while (
                            not stop.is_set()
                            and nxt < len(order)
                            and len(pending) <= self.num_workers
                        ):
                            pending.append(
                                pool.submit(
                                    self._patches_for,
                                    int(order[nxt]),
                                    np.random.default_rng(children[nxt]),
                                )
                            )
                            nxt += 1

                    top_up()
                    while pending:  # consume in submission order: deterministic
                        if stop.is_set():
                            return
                        fut = pending.popleft()
                        patches = fut.result()
                        top_up()
                        for p in patches:
                            if not put(p):
                                return
                finally:
                    # don't block on in-flight volume transforms when the
                    # consumer aborted mid-epoch; cancel whatever hasn't
                    # started (a `with` block would wait for everything)
                    pool.shutdown(wait=False, cancel_futures=True)
        except BaseException as exc:  # surface producer failures to the consumer
            put(exc)
        finally:
            put(None)  # sentinel (skipped if the consumer already stopped)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        epoch = self._epoch
        rng = np.random.default_rng(self.seed + epoch)
        self._epoch += 1
        # queue_length counts buffered patches, matching tio.Queue's
        # max_length semantics (dataloader.py:56); keep at least one batch.
        out_q: queue_mod.Queue = queue_mod.Queue(
            maxsize=max(self.queue_length, self.batch_size)
        )
        stop = threading.Event()
        producer = threading.Thread(
            target=self._produce, args=(out_q, rng, stop, epoch), daemon=True
        )
        producer.start()
        try:
            batch_x, batch_y = [], []
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item  # a corrupt volume must fail the run, not
                    # silently truncate the epoch
                batch_x.append(item[0])
                batch_y.append(item[1])
                if len(batch_x) == self.batch_size:
                    yield np.stack(batch_x), np.stack(batch_y)
                    batch_x, batch_y = [], []
            # drop_last=True: leftover partial batch is discarded
        finally:
            stop.set()
            producer.join(timeout=5.0)


def grid_locations(
    spatial_shape: Sequence[int],
    patch_size: Sequence[int],
    patch_overlap: Sequence[int],
) -> np.ndarray:
    """TorchIO GridSampler locations: [N, 6] rows (i0, j0, k0, i1, j1, k1).

    Starts advance by ``patch_size - overlap``; a final start clamped to
    ``size - patch`` guarantees full coverage (tio semantics for
    reference predict.py:100).
    """
    starts_per_dim = []
    for size, patch, overlap in zip(spatial_shape, patch_size, patch_overlap):
        assert patch <= size, f"patch {patch} larger than volume dim {size}"
        step = patch - overlap
        assert step > 0, f"overlap {overlap} must be < patch {patch}"
        starts = list(range(0, size - patch + 1, step))
        if starts[-1] != size - patch:
            starts.append(size - patch)
        starts_per_dim.append(starts)
    locations = []
    for i in starts_per_dim[0]:
        for j in starts_per_dim[1]:
            for k in starts_per_dim[2]:
                locations.append(
                    (i, j, k, i + patch_size[0], j + patch_size[1], k + patch_size[2])
                )
    return np.asarray(locations, dtype=np.int32)


class GridAggregator:
    """Overlap aggregation matching tio.inference.GridAggregator.

    ``overlap_mode='crop'`` (the reference's default at predict.py:117-118):
    each patch is cropped by half the overlap on every side before being
    written, except where it touches the volume border. ``'average'`` mode
    accumulates values + counts and divides at the end.
    """

    def __init__(
        self,
        spatial_shape: Sequence[int],
        patch_overlap: Sequence[int],
        overlap_mode: str = "crop",
        num_channels: int = 1,
        dtype=np.float32,
    ):
        self.spatial_shape = tuple(spatial_shape)
        self.patch_overlap = tuple(patch_overlap)
        self.overlap_mode = overlap_mode
        self.output = np.zeros((num_channels,) + self.spatial_shape, dtype=dtype)
        if overlap_mode == "average":
            self.counts = np.zeros(self.spatial_shape, dtype=np.float32)

    def add_batch(self, patches: np.ndarray, locations: np.ndarray) -> None:
        """patches: [B, C, pX, pY, pZ]; locations: [B, 6]."""
        half = [o // 2 for o in self.patch_overlap]
        for patch, loc in zip(patches, locations):
            i0, j0, k0, i1, j1, k1 = (int(v) for v in loc)
            if self.overlap_mode == "average":
                self.output[:, i0:i1, j0:j1, k0:k1] += patch
                self.counts[i0:i1, j0:j1, k0:k1] += 1.0
                continue
            # crop mode: trim half-overlap per side unless at the border
            crops = []
            for d, (lo, hi, size) in enumerate(
                ((i0, i1, self.spatial_shape[0]), (j0, j1, self.spatial_shape[1]), (k0, k1, self.spatial_shape[2]))
            ):
                c_lo = 0 if lo == 0 else half[d]
                c_hi = 0 if hi == size else half[d]
                crops.append((c_lo, c_hi))
            (ci0, ci1), (cj0, cj1), (ck0, ck1) = crops
            pi1 = patch.shape[1] - ci1
            pj1 = patch.shape[2] - cj1
            pk1 = patch.shape[3] - ck1
            self.output[
                :, i0 + ci0 : i1 - ci1, j0 + cj0 : j1 - cj1, k0 + ck0 : k1 - ck1
            ] = patch[:, ci0:pi1, cj0:pj1, ck0:pk1]

    def get_output_tensor(self) -> np.ndarray:
        if self.overlap_mode == "average":
            return self.output / np.maximum(self.counts, 1.0)[None]
        return self.output
