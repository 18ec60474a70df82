"""Whole-epoch training with no host work between steps: one CUDA graph of
the train step, replayed once per step of the epoch.

The counterpart of the JAX package's ``ops/epoch_scan.py``, whose epoch is
one ``lax.scan`` XLA program. With the device data backend every volume
already lives on the card, stacked into one ``[V, X, Y, Z, C]`` store
(zero-padded to the largest extent; each epoch's plan samples origins
within each volume's TRUE extent, so a patch never reads padding). One
train step (the patch gather, forward, loss, backward, optimizer step, and
the writes of ``losses[k]`` / ``dices[k]``) reads its step index ``k`` from
a device counter that the step itself advances, so the same captured graph
serves every step: the host replays it, with no ``.item()``, no host copy
and no host branch between replays, and reads the per-step losses and dices
once after the epoch.

* The capture: the epoch's step 0 runs eagerly on a side stream first, as
  the warm-up (it loads the kernels' libraries, sets each kernel shape's
  attributes, creates the library handles and the optimizer's state); it
  is a real step, which advances the counter to 1. The step is then
  captured (nothing runs) and replayed for steps 1 on. A later epoch
  replays every step.
* The learning rate: Adam and AdamW keep it and their step counts on the
  device (``optim.make_capturable``), so the per-epoch schedule
  (``optim.set_lr``) reaches the replays; an SGD step holds the float it
  was captured with, so an epoch whose learning rate differs is captured
  again, after its step 0.
* Launch counts: a wrapper counts the launches it makes, not those it
  records into the graph (``_build.count_launch``); ``eager_steps`` and
  ``replays`` count the steps run each way.
* Dropout: each ``nn.blocks.Dropout`` generator is registered with the
  graph, so every replay draws a new mask.
* ``config.aug=true``: the raw store is augmented on the device at the start
  of each epoch (``data/device_aug.augment_pair``, eagerly, before the
  steps, with the epoch's ``device_aug.aug_generator``) into the store the
  graph reads; like JAX, this needs volumes of one shape.

On the CPU the same step runs eagerly in a loop (``step``): the plain
version, which the tests hold against the JAX package's scan. On a card
every step but the warm-up step 0 of a capturing epoch runs from the
graph; a capture or replay that fails raises.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.device_aug import aug_generator, augment_pair
from ..nn.blocks import Dropout
from ..optim import make_capturable


def build_epoch_plan(
    n_volumes: int,
    samples_per_volume: int,
    batch_size: int,
    spatial_shape,
    patch_size,
    rng: np.random.Generator,
) -> Tuple[np.ndarray, np.ndarray]:
    """(vol_idx [steps, bs], origins [steps, bs, 3]) for one epoch,
    mirroring the queue sampler: shuffled volume order, samples_per_volume
    uniform patches each, drop_last.

    ``spatial_shape`` is either one [3] shape shared by all volumes or a
    [n_volumes, 3] array of per-volume TRUE extents — origins are sampled
    within each sampled volume's own extent, so heterogeneous datasets
    keep exact uniform-sampler semantics even though storage is padded.
    The JAX package's function, line for line: the same ``rng`` gives the
    same arrays.
    """
    vol_order = np.repeat(rng.permutation(n_volumes), samples_per_volume)
    n_steps = len(vol_order) // batch_size
    vol_order = vol_order[: n_steps * batch_size]
    shapes = np.asarray(spatial_shape, dtype=np.int64)
    if shapes.ndim == 1:
        shapes = np.broadcast_to(shapes, (n_volumes, 3))
    maxs = shapes - np.asarray(patch_size, dtype=np.int64)  # [V, 3]
    if (maxs < 0).any():
        bad = int(np.argmin(maxs.min(axis=1)))
        raise ValueError(
            f"volume {bad} spatial {tuple(shapes[bad])} smaller than patch "
            f"{tuple(patch_size)}"
        )
    per = maxs[vol_order]  # [N, 3] inclusive upper bounds
    # rng.integers broadcasts over the per-volume bounds and is exact
    # (floor(random()*(n)) can round up to n when n is a power of two)
    origins = rng.integers(per + 1)
    return (
        vol_order.reshape(n_steps, batch_size).astype(np.int32),
        origins.reshape(n_steps, batch_size, 3).astype(np.int32),
    )


def stack_store(volumes: Sequence[torch.Tensor]) -> torch.Tensor:
    """[V, X, Y, Z, C] of channels-last volumes, each zero-padded at the far
    end of every spatial axis to the largest extent."""
    shape = [max(int(v.shape[i]) for v in volumes) for i in range(3)]
    store = volumes[0].new_zeros((len(volumes), *shape, volumes[0].shape[-1]))
    for i, v in enumerate(volumes):
        store[i, : v.shape[0], : v.shape[1], : v.shape[2]] = v
    return store


def gather_patches(store: torch.Tensor, idx: torch.Tensor, origins: torch.Tensor,
                   patch_size: Sequence[int]) -> torch.Tensor:
    """[B, *patch, C] patches of ``store`` [V, X, Y, Z, C]: patch b is volume
    ``idx[b]`` from ``origins[b]`` on; one indexed gather on the device
    from device indices (no host read, so a graph replays it for any plan)."""
    ax = [origins[:, i, None] + torch.arange(p, device=store.device) for i, p in enumerate(patch_size)]
    return store[idx[:, None, None, None], ax[0][:, :, None, None], ax[1][:, None, :, None], ax[2][:, None, None, :]]


class EpochScan:
    """``scan(vol_idx, origins) -> (losses [steps], dices [steps])``: one
    epoch of ``train_step`` over the plan, on the store's device. See the
    module docstring."""

    def __init__(self, train_step: Callable, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                 volumes: torch.Tensor, labels: torch.Tensor, patch_size: Sequence[int],
                 aug_seed: Optional[int] = None):
        self.train_step, self.model, self.optimizer = train_step, model, optimizer
        self.patch_size = tuple(int(p) for p in patch_size)
        self.device = volumes.device
        self.raw, self.aug_seed, self.epoch = None, aug_seed, 0
        if aug_seed is not None:  # the graph reads a store that each epoch's augmentation rewrites
            self.raw = (volumes, labels)
            volumes, labels = torch.empty_like(volumes), torch.empty_like(labels)
        self.volumes, self.labels = volumes, labels
        self.counter = torch.zeros(1, dtype=torch.long, device=self.device)
        self.vol_idx = self.origins = self.losses = self.dices = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.lr_on_device = self.device.type == "cuda" and make_capturable(optimizer)
        self._captured_lrs: List = []
        self.eager_steps = self.replays = 0  # on the card

    def augment(self) -> None:
        """The raw store through ``augment_pair`` with this epoch's
        generator, volume by volume, into the store the step reads."""
        generator = aug_generator(self.aug_seed, self.epoch, self.device)
        for v, (src, gt) in enumerate(zip(*self.raw)):
            s, g = augment_pair(generator, src.movedim(-1, 0), gt.movedim(-1, 0))
            self.volumes[v].copy_(s.movedim(0, -1))
            self.labels[v].copy_(g.movedim(0, -1))

    def start_epoch(self, vol_idx: np.ndarray, origins: np.ndarray) -> None:
        """The plan into the step's device buffers (made at the first epoch,
        the same every epoch after), the augmentation, the counter at 0."""
        vol_idx, origins = torch.from_numpy(np.asarray(vol_idx)).long(), torch.from_numpy(np.asarray(origins)).long()
        if self.vol_idx is None or self.vol_idx.shape != vol_idx.shape:
            self.vol_idx = torch.empty(vol_idx.shape, dtype=torch.long, device=self.device)
            self.origins = torch.empty(origins.shape, dtype=torch.long, device=self.device)
            self.losses = torch.zeros(len(vol_idx), dtype=torch.float32, device=self.device)
            self.dices = torch.zeros(len(vol_idx), dtype=torch.float32, device=self.device)
            self.graph = None
        self.vol_idx.copy_(vol_idx)
        self.origins.copy_(origins)
        if self.raw is not None:
            self.augment()
        self.epoch += 1
        self.counter.zero_()

    def step(self) -> None:
        """One train step at the device counter, which it advances: the plain
        version, eager (and the body that the graph captures)."""
        k = self.counter
        idx, org = self.vol_idx.index_select(0, k)[0], self.origins.index_select(0, k)[0]
        x = gather_patches(self.volumes, idx, org, self.patch_size)
        y = gather_patches(self.labels, idx, org, self.patch_size)
        loss, dice = self.train_step(x, y)
        self.losses.index_copy_(0, k, loss.detach().float().reshape(1))
        self.dices.index_copy_(0, k, dice.detach().float().reshape(1))
        self.counter += 1

    def __call__(self, vol_idx: np.ndarray, origins: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
        self.start_epoch(vol_idx, origins)
        steps = len(self.vol_idx)
        if self.device.type == "cuda":
            lrs = [] if self.lr_on_device else [g["lr"] for g in self.optimizer.param_groups]
            if self.graph is None or lrs != self._captured_lrs:
                self.capture()  # runs step 0
                self._captured_lrs = lrs
                steps -= 1
            for _ in range(steps):
                self.graph.replay()
                self.replays += 1
        else:
            for _ in range(steps):
                self.step()
        return self.losses.clone(), self.dices.clone()

    def dropout_generators(self) -> List[torch.Generator]:
        return [m.generator_on(self.device) for m in self.model.modules() if isinstance(m, Dropout)]

    def capture(self) -> None:
        """The step at the counter, eagerly on a side stream (the warm-up; it
        advances the counter), then the step captured into ``self.graph``."""
        self.graph = None
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self.step()
        torch.cuda.current_stream(self.device).wait_stream(side)
        self.eager_steps += 1
        graph = torch.cuda.CUDAGraph()
        for gen in self.dropout_generators():
            graph.register_generator_state(gen)
        self.optimizer.zero_grad(set_to_none=True)
        with torch.cuda.graph(graph, stream=side):
            self.step()
        self.graph = graph


def make_epoch_scan(config, model: torch.nn.Module, optimizer: torch.optim.Optimizer, train_step: Callable,
                    volumes: torch.Tensor, labels: torch.Tensor) -> EpochScan:
    """The epoch function of ``config`` over the stacked stores (``stack_store``):
    ``train_step(x, gt) -> (loss, dice)`` is the training loop's step
    (``train.make_train_step``, which holds the forward, the criterion and
    ``optimizer``). With ``config.aug`` the stores hold the raw volumes, of
    one shape, and every epoch re-augments them on the device, drawing from
    ``device_aug.aug_generator(config.seed, epoch)``."""
    aug_seed = int(getattr(config, "seed", 0) or 0) if bool(getattr(config, "aug", False)) else None
    return EpochScan(train_step, model, optimizer, volumes, labels, config.patch_size, aug_seed)
