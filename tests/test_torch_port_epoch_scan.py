"""The port's ``epoch_scan`` (``ops/epoch_scan.py``) against the JAX
package's on the CPU, where the port runs its step eagerly in a loop (the
plain version of the CUDA graph): ``build_epoch_plan`` array for array, one
epoch of UNet3D from the same weights on the same plan (per-step losses and
dices, every parameter and BatchNorm statistic, in f64), and ``train.main``
with ``epoch_scan=true`` for the networks, losses and data the per-step loop
takes, with JAX's refusals. The graph on the card is held to this eager
step in ``tests/test_torch_port_epoch_graph.py``."""

import numpy as np
import pytest
import torch
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

pytest.importorskip("flax")  # the JAX package is this file's oracle: without it the file skips
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from general_medical_image_segmentation_cnn_framework_tpu import train as jax_train  # noqa: E402
from general_medical_image_segmentation_cnn_framework_tpu.config import ConfigDict  # noqa: E402
from general_medical_image_segmentation_cnn_framework_tpu.nn import norm as jax_norm  # noqa: E402
from general_medical_image_segmentation_cnn_framework_tpu.ops import epoch_scan as jax_scan  # noqa: E402
from general_medical_image_segmentation_cnn_framework_tpu_torch import train as port_train  # noqa: E402
from general_medical_image_segmentation_cnn_framework_tpu_torch.convert import state_dict_from_flax  # noqa: E402
from general_medical_image_segmentation_cnn_framework_tpu_torch.data.io import Volume, write_nifti  # noqa: E402
from general_medical_image_segmentation_cnn_framework_tpu_torch.models.three_d.unet3d import UNet3D  # noqa: E402
from general_medical_image_segmentation_cnn_framework_tpu_torch.ops import epoch_scan as port_scan  # noqa: E402
from test_torch_port_train import _train_args  # noqa: E402
from test_torch_port_unet3d import jax_unet, port_unet  # noqa: E402
from torch_port_zoo3d import _NormsInF64  # noqa: E402

PLANS = [
    (3, 4, 2, (32, 32, 32), (16, 16, 16)),
    (3, 50, 2, ((32, 32, 32), (24, 40, 20), (16, 16, 48)), (16, 16, 16)),
    (2, 5, 3, ((20, 21, 22), (17, 30, 16)), (1, 16, 16)),
]


@pytest.mark.parametrize("case", range(len(PLANS)))
def test_build_epoch_plan_equals_jax(case):
    n, spv, bs, shapes, patch = PLANS[case]
    got = port_scan.build_epoch_plan(n, spv, bs, np.asarray(shapes), patch, np.random.default_rng(case))
    want = jax_scan.build_epoch_plan(n, spv, bs, np.asarray(shapes), patch, np.random.default_rng(case))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    maxs = np.broadcast_to(np.asarray(shapes), (n, 3)) - np.asarray(patch)
    assert (got[1] >= 0).all() and (got[1] <= maxs[got[0]]).all()  # within each volume's true extent


def test_build_epoch_plan_refuses_a_volume_smaller_than_the_patch():
    shapes = np.asarray([(32, 32, 32), (12, 32, 32)])
    with pytest.raises(ValueError) as want:
        jax_scan.build_epoch_plan(2, 4, 2, shapes, (16, 16, 16), np.random.default_rng(2))
    with pytest.raises(ValueError) as got:
        port_scan.build_epoch_plan(2, 4, 2, shapes, (16, 16, 16), np.random.default_rng(2))
    assert str(got.value) == str(want.value) and "smaller than patch" in str(got.value)


def test_stack_store_pads_and_the_gather_crops():
    rng = np.random.default_rng(4)
    vols = [torch.from_numpy(rng.normal(size=s + (2,)).astype(np.float32)) for s in ((5, 6, 7), (7, 4, 6))]
    store = port_scan.stack_store(vols)
    assert store.shape == (2, 7, 6, 7, 2)
    assert torch.equal(store[1, :, :4, :6], vols[1]) and not store[1, :, 4:].any() and not store[0, 5:].any()
    idx, origins = torch.tensor([1, 0]), torch.tensor([[2, 0, 1], [0, 3, 4]])
    got = port_scan.gather_patches(store, idx, origins, (3, 2, 2))
    assert torch.equal(got[0], vols[1][2:5, 0:2, 1:3]) and torch.equal(got[1], vols[0][0:3, 3:5, 4:6])


def test_each_epoch_augments_the_store_with_that_epochs_generator():
    """With ``aug`` the scan's store is the raw store through
    ``augment_pair``, volume by volume, drawing from
    ``device_aug.aug_generator(seed, epoch)``: the device backend's per-step
    loop draws from the same generator for the same epoch."""
    from general_medical_image_segmentation_cnn_framework_tpu_torch.data.device_aug import aug_generator, augment_pair

    rng = np.random.default_rng(5)
    vols = torch.from_numpy(rng.normal(size=(2, 12, 12, 12, 1)).astype(np.float32))
    labels = torch.from_numpy((rng.uniform(size=(2, 12, 12, 12, 1)) > 0.5).astype(np.float32))
    scan = port_scan.EpochScan(None, torch.nn.Module(), torch.optim.SGD([torch.zeros(1)], lr=0.1), vols, labels,
                               (8, 8, 8), aug_seed=3)
    plan = (np.zeros((1, 2), np.int32), np.zeros((1, 2, 3), np.int32))
    for epoch in range(2):
        scan.start_epoch(*plan)
        generator = aug_generator(3, epoch, "cpu")
        for v in range(2):
            src, gt = augment_pair(generator, vols[v].movedim(-1, 0), labels[v].movedim(-1, 0))
            assert torch.equal(scan.volumes[v], src.movedim(0, -1)) and torch.equal(scan.labels[v], gt.movedim(0, -1))


def test_one_epoch_matches_jax_make_epoch_scan_in_f64():
    """UNet3D f=4 from the same weights over a 2-volume store (24^3), 3 steps
    of 4 patches of 16^3 on the same plan; both in f64 (JAX with its norms'
    statistics in f64, the port's model and optimizer in f64; both losses
    on the f32 logits the models return): per-step losses within 1e-6 and
    dices within 1e-6, every parameter (relative L2) and BatchNorm statistic
    within 1e-6. SGD with momentum: Adam would turn the rounding noise of
    the conv biases' zero gradients (BatchNorm removes any shift) into
    +-lr steps that differ between any two programs."""
    cfg = ConfigDict(network="unet", in_classes=1, out_classes=2, loss="bce", optimizer="sgd", momentum=0.9,
                     init_lr=1e-2, precision="float32", grad_accum=1, pipeline_stages=0,
                     patch_size=(16, 16, 16), aug=False)
    model, variables = jax_unet(4, seed=21)
    rng = np.random.default_rng(22)
    volumes = rng.normal(size=(2, 24, 24, 24, 1))
    labels = (rng.uniform(size=(2, 24, 24, 24, 1)) > 0.5).astype(np.float64)
    vol_idx, origins = port_scan.build_epoch_plan(2, 6, 4, (24, 24, 24), (16, 16, 16), np.random.default_rng(23))

    def as64(tree):
        return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)

    with jax.enable_x64(True), pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax_norm, "jnp", _NormsInF64())
        module = model.clone(dtype=jnp.float64)
        tx = jax_train.make_optimizer(cfg)
        epoch_fn = jax_scan.make_epoch_scan(cfg, module, tx, jax_train.make_forward(cfg, module),
                                            jax_train.make_loss_and_metric(cfg))
        params = jax.tree_util.tree_map(jnp.asarray, as64(variables["params"]))
        stats = jax.tree_util.tree_map(jnp.asarray, as64(variables["batch_stats"]))
        params, stats, _, losses, dices = epoch_fn(
            params, stats, tx.init(params), jnp.asarray(volumes), jnp.asarray(labels),
            jnp.asarray(vol_idx.astype(np.int64)), jnp.asarray(origins.astype(np.int64)), jax.random.PRNGKey(0),
        )
        want = state_dict_from_flax(as64(params), as64(stats))
        losses, dices = np.asarray(losses), np.asarray(dices)

    net = port_unet(variables, 4, dtype=torch.float64).double().train()
    optimizer = port_train.make_optimizer(cfg, net.parameters())
    step = port_train.make_train_step(net, optimizer, port_train.make_loss_and_metric(cfg))
    scan = port_scan.make_epoch_scan(cfg, net, optimizer, step, torch.from_numpy(volumes), torch.from_numpy(labels))
    got_losses, got_dices = scan(vol_idx, origins)
    assert got_losses.shape == (3,) and scan.graph is None  # the CPU runs the eager step
    np.testing.assert_allclose(got_losses.numpy(), losses, rtol=1e-6)
    np.testing.assert_allclose(got_dices.numpy(), dices, rtol=0, atol=1e-6)
    state = net.state_dict()
    for name, w in want.items():
        got, w = state[name].double(), w.double()
        assert float((got - w).norm()) <= 1e-6 * float(w.norm()), name
    assert not torch.equal(state["blocks.0.bn.running_mean"].float(), port_unet(variables, 4).state_dict()[
        "blocks.0.bn.running_mean"])  # the statistics moved


@pytest.fixture(scope="module")
def scan_data(tmp_path_factory):
    """Two 24^3 volumes and a 20x24x28 one (heterogeneous), bright ball = fg."""
    root = tmp_path_factory.mktemp("scan_data")
    for split in ("source", "label"):
        (root / split).mkdir()
    for i, shape in enumerate(((24, 24, 24), (24, 24, 24), (20, 24, 28))):
        r = np.random.default_rng(40 + i)
        grid = np.stack(np.meshgrid(*[np.arange(s) for s in shape], indexing="ij"))
        label = (np.sqrt(((grid - np.asarray(shape)[:, None, None, None] / 2) ** 2).sum(0)) < 6).astype(np.float32)
        write_nifti(root / "source" / f"vol-{i:02d}.nii.gz", Volume((2 * label + r.normal(0, 0.3, shape))[None]))
        write_nifti(root / "label" / f"vol-{i:02d}.nii.gz", Volume(label[None]))
    return root


def _scan_args(root, out, *extra, uniform=True):
    data = root
    if uniform:  # the two 24^3 volumes alone
        data = out.parent / "uniform"
        if not data.exists():
            for split in ("source", "label"):
                (data / split).mkdir(parents=True)
                for i in range(2):
                    (data / split / f"vol-{i:02d}.nii.gz").symlink_to(root / split / f"vol-{i:02d}.nii.gz")
    args = [a for a in _train_args(data, out) if not a.startswith(("config.data_path", "config.gt_path",
                                                                    "config.samples_per_volume"))]
    return args + [f"config.data_path={data}/source", f"config.gt_path={data}/label", "config.epoch_scan=true",
                   "config.samples_per_volume=2", *extra]


class _Scalars:
    """TBWriter stand-in that keeps the steps it is given."""

    steps = []

    def __init__(self, logdir):
        pass

    def add_scalar(self, tag, value, step):
        if tag == "Training/Loss":
            _Scalars.steps.append((step, value))

    def close(self):
        pass


def _small_unet(config):
    return UNet3D(1, int(config.out_classes), 4, init_type=config.init_type)


def test_train_main_epoch_scan_logs_each_step_and_resumes(scan_data, tmp_path, monkeypatch):
    """UNet3D (f=4) for 2 epochs of 2 steps: TensorBoard gets one loss per
    step of each epoch's plan, finite; the checkpoints hold the trained
    state, and a per-step run resumes from them."""
    monkeypatch.setattr(port_train, "build_model", _small_unet)
    monkeypatch.setattr(port_train, "TBWriter", _Scalars)
    _Scalars.steps = []
    out = port_train.main(_scan_args(scan_data, tmp_path / "runs", "config.epochs=2"))
    assert [s for s, _ in _Scalars.steps] == [1, 2, 3, 4] and all(np.isfinite([v for _, v in _Scalars.steps]))
    assert np.isfinite(out["loss"]) and 0.0 <= out["dice"] <= 1.0
    (run,) = (tmp_path / "runs").glob("train-*/*")
    resume = _scan_args(scan_data, tmp_path / "resume", "config.epochs=3", "config.load_mode=1",
                        f"config.ckpt={run / 'latest_checkpoint.ckpt'}")
    _Scalars.steps = []
    port_train.main([a for a in resume if a != "config.epoch_scan=true"])
    assert [s for s, _ in _Scalars.steps] == [5, 6]


@pytest.mark.parametrize("extra", [
    ("config.aug=true",), ("config.loss=dice",), ("config.loss=focal",), ("config.loss=bce+dice",),
    ("config.out_classes=3",), ("config.network=IS",), ("config=unet2d", "config.patch_size=1, 16, 16"),
    ("config.optimizer=sgd", "config.momentum=0.9"), ("config.optimizer=adamw", "config.grad_clip=1.0"),
])
def test_train_main_epoch_scan_trains(scan_data, tmp_path, monkeypatch, extra):
    """One epoch through ``train.main`` under each of: on-device augmentation
    of the store, every criterion but the fused BCE (dice, focal, bce+dice,
    softmax cross entropy over 3 classes), IS (its FFT bands and tuple
    output), UNet2D (the slice adapter on (1, H, W) patches), SGD, AdamW
    with the global-norm clip."""
    import general_medical_image_segmentation_cnn_framework_tpu_torch.models.registry as registry

    if "config.network=IS" in extra:
        monkeypatch.setattr(port_train, "build_model", lambda c: registry.model_class("IS")(1, 2, 4))
    elif "config=unet2d" not in extra:
        monkeypatch.setattr(port_train, "build_model", _small_unet)
    args = _scan_args(scan_data, tmp_path / "runs", "config.epochs=1", *extra)
    if "config=unet2d" in extra:
        args = [a for a in args if a not in ("config=unet", "config.patch_size=16, 16, 16")]
    out = port_train.main(args)
    (run,) = (tmp_path / "runs").glob("train-*/*")
    losses = [float(line.split(":", 1)[1]) for line in (run / "train.log").read_text().splitlines()
              if line.startswith("Loss: ")]
    assert len(losses) == 2 and all(np.isfinite(losses)) and np.isfinite(out["loss"])


def test_train_main_epoch_scan_on_heterogeneous_volumes(scan_data, tmp_path, monkeypatch):
    monkeypatch.setattr(port_train, "build_model", _small_unet)
    out = port_train.main(_scan_args(scan_data, tmp_path / "runs", "config.epochs=1", uniform=False))
    assert np.isfinite(out["loss"])
    with pytest.raises(ValueError, match="epoch_scan with aug=true needs uniform volume shapes"):
        port_train.main(_scan_args(scan_data, tmp_path / "aug", "config.aug=true", uniform=False))


@pytest.mark.parametrize("extra, error", [
    (("config.grad_accum=2",), "grad_accum > 1 is a per-step-loop feature"),
    (("config.ema_decay=0.99",), "ema_decay is a per-step-loop feature"),
    (("config.data_backend=threaded",), "epoch_scan requires data_backend=device"),
    (("config.device_dataset_gb=1e-9",), "epoch_scan requires data_backend=device"),
])
def test_train_main_epoch_scan_refuses_as_jax(scan_data, tmp_path, monkeypatch, extra, error):
    """JAX's refusals, in its words (its ``requires data_backend=device`` is an
    assert, the port's a ValueError): grad_accum, ema_decay, another backend,
    and the device backend's fallback to the threaded one over budget."""
    monkeypatch.setattr(port_train, "build_model", _small_unet)
    with pytest.raises(ValueError, match=error.replace("(", "\\(")):
        port_train.main(_scan_args(scan_data, tmp_path / "runs", *extra))
