"""The port's training path against the JAX package's: weight init, train-mode
BatchNorm, one train step's gradients, a 4-step Adam trajectory with the
BatchNorm running statistics it leaves, resuming a JAX run from its
converted checkpoint, the train CLI round trip, and the device-resident
patch sampler. All on the CPU, UNet3D at init_features=4 on 16^3 patches,
f32, where the port runs its kernels' plain versions."""

import numpy as np
import pytest
import torch
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

pytest.importorskip("flax")  # the JAX package is this file's oracle: without it the file skips
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from general_medical_image_segmentation_cnn_framework_tpu import train as jax_train
from general_medical_image_segmentation_cnn_framework_tpu.checkpoint import save_checkpoint as jax_save_checkpoint
from general_medical_image_segmentation_cnn_framework_tpu.config import ConfigDict
from general_medical_image_segmentation_cnn_framework_tpu.nn import init as jax_init
from general_medical_image_segmentation_cnn_framework_tpu.nn.norm import BatchNorm as FlaxBatchNorm
from general_medical_image_segmentation_cnn_framework_tpu_torch import predict as port_predict
from general_medical_image_segmentation_cnn_framework_tpu_torch import train as port_train
from general_medical_image_segmentation_cnn_framework_tpu_torch.checkpoint import (
    load_checkpoint,
    restore_training_state,
)
from general_medical_image_segmentation_cnn_framework_tpu_torch.config import compose
from general_medical_image_segmentation_cnn_framework_tpu_torch.convert import (
    convert_checkpoint,
    unet3d_state_dict_from_flax,
)
from general_medical_image_segmentation_cnn_framework_tpu_torch.data import make_dataset
from general_medical_image_segmentation_cnn_framework_tpu_torch.data.device_prep import DevicePatchDataset
from general_medical_image_segmentation_cnn_framework_tpu_torch.data.pipeline import PatchQueueDataset
from general_medical_image_segmentation_cnn_framework_tpu_torch.models.three_d.unet3d import UNet3D
from general_medical_image_segmentation_cnn_framework_tpu_torch.nn import init as port_init
from general_medical_image_segmentation_cnn_framework_tpu_torch.nn.norm import BatchNorm
from test_torch_port_unet3d import jax_unet, port_unet

CONFIG = ConfigDict(
    network="unet", in_classes=1, out_classes=2, loss="bce", optimizer="adam", init_lr=1e-3,
    precision="float32", grad_accum=1, pipeline_stages=0,
)


@pytest.mark.parametrize("init_type", ["normal", "xavier", "xavier_uniform", "kaiming", "orthogonal", "none"])
def test_kernel_init_follows_the_jax_distribution(init_type):
    """Same std (to 5%, from 13,824 draws each) and, for the uniform modes,
    the same bound (to 2%); orthogonal: orthonormal columns times 0.02."""
    shape = (3, 3, 3, 16, 32)
    want = np.asarray(jax_init.kernel_initializer(init_type)(jax.random.PRNGKey(0), shape, jnp.float32))
    got = port_init.kernel_initializer(init_type)(shape, torch.Generator().manual_seed(0)).numpy()
    assert got.shape == shape and got.dtype == np.float32
    assert abs(got.std() / want.std() - 1) < 0.05
    if init_type in ("xavier_uniform", "none"):
        assert 0.98 < np.abs(got).max() / np.abs(want).max() < 1.02
    if init_type == "orthogonal":
        m = got.reshape(-1, 32)
        np.testing.assert_allclose(m.T @ m, 0.02**2 * np.eye(32), atol=1e-7)
    assert not port_init.bias_initializer(init_type)((5,), None).any()


def test_head_init_follows_flax_lecun_normal():
    import flax.linen as nn

    shape = (1, 1, 1, 256, 64)
    want = np.asarray(nn.initializers.lecun_normal()(jax.random.PRNGKey(0), shape, jnp.float32))
    got = port_init.lecun_normal(shape, torch.Generator().manual_seed(0)).numpy()
    assert abs(got.std() / want.std() - 1) < 0.05
    assert np.abs(got).max() <= 2 * (1 / 256) ** 0.5 / 0.87962566103423978 * (1 + 1e-6)
    model = UNet3D(1, 2, 4, init_type="kaiming", seed=3)
    assert torch.equal(model.blocks[5].conv.weight, UNet3D(1, 2, 4, init_type="kaiming", seed=3).blocks[5].conv.weight)
    assert not model.blocks[5].conv.bias.any() and not model.head.bias.any()


def test_batchnorm_train_mode_gradient_matches_flax():
    """Output, running-stat update and the input/scale/bias gradients of
    train-mode BatchNorm against the Flax module (f32)."""
    rng = np.random.default_rng(3)
    x = rng.normal(1.0, 2.0, size=(2, 3, 4, 5, 6)).astype(np.float32)
    ct = rng.normal(size=x.shape).astype(np.float32)
    scale, bias = np.linspace(0.5, 1.5, 6, dtype=np.float32), np.linspace(-0.2, 0.3, 6, dtype=np.float32)
    stats = {"mean": np.full(6, 0.1, np.float32), "var": np.full(6, 1.5, np.float32)}
    bn = FlaxBatchNorm(use_running_average=False)

    def loss(params, x):
        y, upd = bn.apply({"params": params, "batch_stats": stats}, x, mutable=["batch_stats"])
        return jnp.sum(y * ct), upd

    (_, upd), (g_params, g_x) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        {"scale": scale, "bias": bias}, jnp.asarray(x)
    )
    port = BatchNorm(6)
    port.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias),
                          "running_mean": torch.from_numpy(stats["mean"]),
                          "running_var": torch.from_numpy(stats["var"])})
    xt = torch.from_numpy(x).requires_grad_()
    (port.train()(xt) * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(port.weight.grad.numpy(), np.asarray(g_params["scale"]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(port.bias.grad.numpy(), np.asarray(g_params["bias"]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(port.running_mean.numpy(), upd["batch_stats"]["mean"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(port.running_var.numpy(), upd["batch_stats"]["var"], rtol=1e-5, atol=1e-6)


def _batches(n, bs=2, patch=16, seed=0):
    rng = np.random.default_rng(seed)
    return [
        (rng.normal(size=(bs, patch, patch, patch, 1)).astype(np.float32),
         (rng.uniform(size=(bs, patch, patch, patch, 1)) > 0.5).astype(np.float32))
        for _ in range(n)
    ]


def _port_trainer(variables):
    model = port_unet(variables, 4).train()
    optimizer = port_train.make_optimizer(CONFIG, model.parameters())
    return model, optimizer, port_train.make_train_step(model, optimizer, port_train.make_loss_and_metric(CONFIG))


def test_one_train_step_gradients_match_jax():
    """Every parameter's gradient of one step against ``value_and_grad`` of
    the JAX train step's loss (``train.py`` micro_grads): within 1e-3 of the
    tensor's largest gradient, except the conv biases before BatchNorm,
    whose true gradient is 0 (BatchNorm removes any shift): their f32 noise
    is held to 1e-6 absolute. Batch 4: at batch 2 the 1^3 bottleneck's
    BatchNorm normalises two values per channel, whose output is +-1
    whatever its input, so every gradient through it is rounding noise."""
    model, variables = jax_unet(4, seed=11)
    (x, gt), = _batches(1, bs=4, seed=12)
    forward = jax_train.make_forward(CONFIG, model)
    loss_and_metric = jax_train.make_loss_and_metric(CONFIG)

    def loss_fn(p):
        pred, _ = forward({"params": p, "batch_stats": variables["batch_stats"]}, jnp.asarray(x),
                          True, {"dropout": jax.random.PRNGKey(0)}, ["batch_stats"])
        return loss_and_metric(pred, jnp.asarray(gt))[0]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    want = unet3d_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, grads))
    port = port_unet(variables, 4).train()
    got_loss, _ = port_train.make_loss_and_metric(CONFIG)(port(torch.from_numpy(x)), torch.from_numpy(gt))
    got_loss.backward()
    assert abs(got_loss.item() - float(loss)) <= 1e-5 * float(loss)
    for name, p in port.named_parameters():
        w = want[name].numpy()
        if name.endswith("conv.bias"):
            np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=1e-6, err_msg=name)
        else:
            np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=1e-3 * np.abs(w).max(), err_msg=name)


def test_adam_trajectory_running_stats_and_resume_from_jax(tmp_path):
    """4 Adam steps on fixed batches from one init: loss and dice per step
    (the tolerances of test_train_parity_torch.py) and the BatchNorm running
    statistics after them. Then a JAX checkpoint written after step 2,
    converted (params, batch_stats and Adam state), resumes in the port and
    tracks JAX's steps 3 and 4. Batch 4, as in the gradient test: at batch
    2 the bottleneck's gradients are noise, which Adam turns into +-lr walks
    of its weights that differ between the two packages."""
    model, variables = jax_unet(4, seed=13)
    batches = _batches(4, bs=4, seed=14)
    tx = optax.inject_hyperparams(optax.adam)(learning_rate=CONFIG.init_lr)
    step = jax_train.make_train_step(CONFIG, model, tx)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])
    opt_state = tx.init(params)
    jax_losses, jax_dices = [], []
    for i, (x, gt) in enumerate(batches):
        params, stats, opt_state, loss, dice = step(params, stats, opt_state, jnp.asarray(x), jnp.asarray(gt),
                                                    jax.random.PRNGKey(0))
        jax_losses.append(float(loss))
        jax_dices.append(float(dice))
        if i == 1:
            jax_ckpt = tmp_path / "latest_checkpoint.ckpt"
            jax_save_checkpoint(jax_ckpt, params, stats, opt_state, epoch=2)

    port, _, port_step = _port_trainer(variables)
    losses, dices = zip(*[(float(l), float(d)) for l, d in (port_step(torch.from_numpy(x), torch.from_numpy(gt))
                                                          for x, gt in batches)])
    np.testing.assert_allclose(losses, jax_losses, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(dices, jax_dices, atol=2e-3)
    # the running mean carries the conv bias, on which Adam walks up to lr
    # per step from noise gradients (the bias itself cancels in BatchNorm):
    # after 4 steps at momentum 0.1 that is at most about 1e-3
    for i in range(18):
        bn, want = port.blocks[i].bn, stats[f"ConvBlock_{i}"]["BatchNorm_0"]
        np.testing.assert_allclose(bn.running_mean.numpy(), want["mean"], rtol=0, atol=1e-3)
        np.testing.assert_allclose(bn.running_var.numpy(), want["var"], rtol=3e-4, atol=0)

    port_ckpt = tmp_path / "resume.pt"
    convert_checkpoint(jax_ckpt, port_ckpt)
    resumed = UNet3D(1, 2, 4).train()
    optimizer = port_train.make_optimizer(CONFIG, resumed.parameters())
    assert restore_training_state(port_ckpt, resumed, optimizer, "adam") == 2
    assert int(optimizer.state_dict()["state"][0]["step"]) == 2
    resumed_step = port_train.make_train_step(resumed, optimizer, port_train.make_loss_and_metric(CONFIG))
    tail = [float(resumed_step(torch.from_numpy(x), torch.from_numpy(gt))[0]) for x, gt in batches[2:]]
    np.testing.assert_allclose(tail, jax_losses[2:], rtol=2e-3, atol=2e-4)


def _train_args(synthetic_dataset, out, *extra):
    return [
        "config=unet", "config.platform=cpu",
        f"config.data_path={synthetic_dataset}/train/source", f"config.gt_path={synthetic_dataset}/train/label",
        f"config.pred_data_path={synthetic_dataset}/test/source", f"config.pred_gt_path={synthetic_dataset}/test/label",
        f"config.output_dir={out}", "config.patch_size=16, 16, 16", "config.batch_size=2",
        "config.samples_per_volume=1", "config.epochs_per_checkpoint=2", "config.precision=float32",
        *extra,
    ]


def test_train_cli_writes_checkpoints_predict_reads_them_and_resume_continues(synthetic_dataset, tmp_path, monkeypatch):
    # the CLI builds the f=32 UNet3D of from_config; this test trains the f=4 one
    monkeypatch.setattr(port_train, "build_model", lambda config: UNet3D(1, 2, 4, init_type=config.init_type))
    out = port_train.main(_train_args(synthetic_dataset, tmp_path / "runs", "config.epochs=2"))
    (run,) = (tmp_path / "runs").glob("train-*/*")
    latest = load_checkpoint(run / "latest_checkpoint.ckpt")
    assert latest["epoch"] == 2 and latest["optimizer"] == "adam" and latest["opt_state"]["state"]
    assert (run / "checkpoint_0002.ckpt").exists() and np.isfinite(out["loss"])
    assert latest["params"].keys() == UNet3D(1, 2, 4).state_dict().keys()

    monkeypatch.setattr(port_predict, "build_model", lambda config: UNet3D(1, 2, 4))
    port_predict.main(_train_args(synthetic_dataset, tmp_path / "pred", "config.patch_overlap=4, 4, 4",
                                  f"config.ckpt={run / 'latest_checkpoint.ckpt'}"))
    (metrics_csv,) = (tmp_path / "pred").glob("predict-*/*/metrics.csv")
    assert len(metrics_csv.read_text().splitlines()) == 4  # header, two volumes, the mean

    resume = _train_args(synthetic_dataset, tmp_path / "resume", "config.epochs=3", "config.load_mode=1",
                         f"config.ckpt={run / 'latest_checkpoint.ckpt'}")
    port_train.main(resume)
    (run2,) = (tmp_path / "resume").glob("train-*/*")
    after = load_checkpoint(run2 / "latest_checkpoint.ckpt")
    assert after["epoch"] == 3 and not (run2 / "checkpoint_0002.ckpt").exists()
    assert not torch.equal(after["params"]["blocks.3.conv.weight"], latest["params"]["blocks.3.conv.weight"])

    latest["optimizer"] = "sgd"
    torch.save(latest, tmp_path / "sgd.ckpt")
    with pytest.raises(ValueError, match="optimizer 'sgd'"):
        port_train.main(resume[:-1] + [f"config.ckpt={tmp_path / 'sgd.ckpt'}"])
    with pytest.raises(NotImplementedError, match="epoch_scan=True \\(ROADMAP queue 1 item 9\\)"):
        port_train.main(resume + ["config.epoch_scan=true"])
    with pytest.raises(NotImplementedError, match="pipeline_stages=2 \\(ROADMAP queue 1 item 12\\)"):
        port_train.main(resume + ["config.pipeline_stages=2"])


def test_device_dataset_crops_the_znormalised_volumes(synthetic_dataset):
    cfg = compose(_train_args(synthetic_dataset, "/nonexistent", "config.patch_size=8, 12, 16",
                              "config.samples_per_volume=3", "config.batch_size=4"), make_run_dir=False)
    ds = make_dataset(cfg)  # data_backend=device is the default
    assert isinstance(ds, DevicePatchDataset) and len(ds) == 2  # 9 patches, the last partial batch dropped
    plan = ds.epoch_plan(0)
    from general_medical_image_segmentation_cnn_framework_tpu_torch.data.pipeline import get_subjects, load_subject

    subjects = [load_subject(p) for p in get_subjects(cfg)]
    for b, (x, y) in enumerate(ds):
        assert x.shape == (4, 8, 12, 16, 1) and y.shape == (4, 8, 12, 16, 1) and x.dtype == torch.float32
        for j, (idx, (o0, o1, o2)) in enumerate(plan[4 * b : 4 * b + 4]):
            src = subjects[idx].source.data[0].astype(np.float64)
            src = (src - src.mean()) / src.std()
            sl = (slice(o0, o0 + 8), slice(o1, o1 + 12), slice(o2, o2 + 16))
            np.testing.assert_allclose(x[j, ..., 0].numpy(), src[sl], rtol=0, atol=1e-5)
            np.testing.assert_array_equal(y[j, ..., 0].numpy(), subjects[idx].gt.data[0][sl])
    assert ds.epoch_plan(1) != plan
    cfg.device_dataset_gb = 1e-9
    assert isinstance(make_dataset(cfg), PatchQueueDataset)  # over budget: the threaded backend
    cfg.device_dataset_gb, cfg.aug = 8.0, True
    with pytest.raises(NotImplementedError, match="device_aug"):
        make_dataset(cfg)
    cfg.data_backend = "grain"
    with pytest.raises(NotImplementedError, match="item 9"):
        make_dataset(cfg)


def test_train_cli_unet2d_trains_on_slices_and_refuses_a_deep_patch(synthetic_dataset, tmp_path):
    """``train.main config=unet2d`` at UNet2D's full width on the CPU: patch
    "1, 32, 32" slices of the 32^3 volumes, 3 steps of batch 2, finite
    losses, the checkpoints hold UNet2D's state; a patch deeper than 1 is
    refused with the JAX package's message."""
    from general_medical_image_segmentation_cnn_framework_tpu_torch.models.two_d.unet2d import UNet2D

    args = [a.replace("config=unet", "config=unet2d") for a in _train_args(synthetic_dataset, tmp_path / "runs")]
    args = [a for a in args if not a.startswith("config.patch_size")] + [
        "config.patch_size=1, 32, 32", "config.samples_per_volume=2", "config.epochs=1",
        "config.epochs_per_checkpoint=1",
    ]
    out = port_train.main(args)
    (run,) = (tmp_path / "runs").glob("train-*/*")
    losses = [float(line.split(":", 1)[1]) for line in (run / "train.log").read_text().splitlines()
              if line.startswith("Loss: ")]
    assert len(losses) == 3 and all(np.isfinite(losses)) and np.isfinite(out["loss"])
    assert isinstance(out["model"], UNet2D)
    latest = load_checkpoint(run / "latest_checkpoint.ckpt")
    assert latest["epoch"] == 1 and (run / "checkpoint_0001.ckpt").exists()
    assert latest["params"].keys() == UNet2D().state_dict().keys()
    with pytest.raises(ValueError, match="needs patch_size '1, H, W', got depth 2"):
        port_train.main(args + ["config.patch_size=2, 32, 32"])
