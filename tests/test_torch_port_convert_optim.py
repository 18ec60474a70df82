"""``convert.py`` on the optimizer states of the JAX package's
``make_optimizer``: adamw, sgd with momentum 0.9 and 0, adam + clip and
adamw + clip (the default adam state is held so in
``test_torch_port_train.py``). For each, the JAX state after two updates is written by
the JAX ``save_checkpoint``, converted, and resumed in the port
(``restore_training_state``); then the port's optimizer and the JAX one
take the same third step from the same gradients, and the parameters must
agree. The gradients are seeded random trees, so that this holds the
optimizer state and update alone (the train step around them is held to
JAX in ``test_torch_port_optim.py``); UNet3D at init_features=2, f32 on
the CPU."""

import functools

import numpy as np
import pytest
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

pytest.importorskip("flax")  # the JAX package is this file's oracle: without it the file skips
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from general_medical_image_segmentation_cnn_framework_tpu import train as jax_train
from general_medical_image_segmentation_cnn_framework_tpu.checkpoint import save_checkpoint as jax_save_checkpoint
from general_medical_image_segmentation_cnn_framework_tpu.config import ConfigDict
from general_medical_image_segmentation_cnn_framework_tpu_torch import train as port_train
from general_medical_image_segmentation_cnn_framework_tpu_torch.checkpoint import (
    load_checkpoint,
    restore_training_state,
)
from general_medical_image_segmentation_cnn_framework_tpu_torch.convert import (
    convert_checkpoint,
    optimizer_state_from_optax,
    state_dict_from_flax,
)
from general_medical_image_segmentation_cnn_framework_tpu_torch.models.three_d.unet3d import UNet3D
from test_torch_port_unet3d import jax_unet

# (optimizer, lr, momentum, weight_decay, grad_clip); the clips bite (the gradients' norm is about 25)
TREES = {
    "adamw": ("adamw", 1e-3, 0.0, 0.5, 0.0),
    "sgd_momentum": ("sgd", 0.01, 0.9, 0.0, 0.0),
    "sgd_plain": ("sgd", 0.01, 0.0, 0.0, 0.0),
    "adam_clip": ("adam", 1e-3, 0.0, 0.0, 5.0),
    "adamw_clip": ("adamw", 1e-3, 0.0, 0.5, 5.0),
}


@functools.lru_cache(maxsize=None)
def _variables():
    return jax_unet(2, seed=31)[1]


@pytest.mark.parametrize("case", sorted(TREES))
def test_converted_optimizer_state_resumes_the_jax_step(case, tmp_path):
    name, lr, momentum, wd, clip = TREES[case]
    cfg = ConfigDict(optimizer=name, init_lr=lr, momentum=momentum, weight_decay=wd, grad_clip=clip)
    variables = _variables()
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    rng = np.random.default_rng(32)
    grads = [jax.tree_util.tree_map(lambda p: rng.normal(size=p.shape).astype(np.float32), variables["params"])
             for _ in range(3)]
    tx = jax_train.make_optimizer(cfg)
    opt_state = jax.jit(tx.init)(params)
    update = jax.jit(tx.update)
    for g in grads[:2]:
        updates, opt_state = update(g, opt_state, params)
        params = optax.apply_updates(params, updates)
    src = tmp_path / "latest_checkpoint.ckpt"
    jax_save_checkpoint(src, params, variables["batch_stats"], opt_state, epoch=2)
    updates, _ = update(grads[2], opt_state, params)
    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, optax.apply_updates(params, updates)))

    dst = tmp_path / "converted.pt"
    convert_checkpoint(src, dst)
    assert load_checkpoint(dst)["optimizer"] == name
    model = UNet3D(1, 2, 2)
    optimizer = port_train.make_optimizer(cfg, model.parameters())
    assert restore_training_state(dst, model, optimizer, name) == 2
    # the hyperparameters are the run's config, not the converted file's placeholders
    assert all(group["lr"] == lr for group in optimizer.param_groups)
    if name == "adamw":
        assert [group["weight_decay"] for group in optimizer.param_groups] == [wd, 0.0]
    g3 = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, grads[2]))
    for n, p in model.named_parameters():
        p.grad = g3[n].clone()
    optimizer.step()
    for n, p in model.named_parameters():
        w = want[n].numpy()
        np.testing.assert_allclose(p.detach().numpy(), w, rtol=0, atol=1e-6 * np.abs(w).max(), err_msg=n)
    other = "sgd" if name != "sgd" else "adam"
    with pytest.raises(ValueError, match=f"written by optimizer '{name}'"):
        restore_training_state(dst, UNet3D(1, 2, 2), port_train.make_optimizer(ConfigDict(optimizer=other, init_lr=lr),
                                                                                 model.parameters()), other)


def test_orbax_directory_and_unknown_trees_are_refused_by_name(tmp_path):
    orbax_dir = tmp_path / "latest_checkpoint.ckpt"
    orbax_dir.mkdir()
    with pytest.raises(ValueError, match="orbax checkpoint \\(checkpoint_backend=orbax\\)"):
        convert_checkpoint(orbax_dir, tmp_path / "out.pt")
    model = UNet3D(1, 2, 2)
    lamb = {"count": 0, "hyperparams": {"learning_rate": 0.1},
            "inner_state": {"0": {"count": 0, "mu": {}, "nu": {}}, "1": {"norm": 1.0}, "2": {}}}
    with pytest.raises(ValueError, match="does not know.* 1: \\{norm: float\\}"):
        optimizer_state_from_optax(lamb, model)
    with pytest.raises(ValueError, match="no inner_state"):
        optimizer_state_from_optax({"mu": {}}, model)
