"""Helpers of the ``test_torch_port_zoo3d_*.py`` and ``test_torch_port_zoo_*.py``
files, which hold the port's zoo against the JAX package's in f32 (and
f64) on the CPU.

Blocks (``against_jax``): a block's output, input gradient and parameter
gradients against the Flax block's, the weights carried by ``convert.py``'s
map. Networks (``check_*``): the zoo's networks with the same weights
carried across by ``convert.py`` (the network and its widths told from the
Flax tree). Each JAX tree comes from ``jax.eval_shape`` filled by seeded
numpy draws (``fill``), and each JAX function runs once under ``jax.jit``
(never eager ``model.init`` / ``model.apply``). The narrow widths:
res_unet base_n_filter 4 at 32^3 (its four stride-2 convs leave 2^3),
CSR-Net and IS init_features 4, Double U-Net 8 (coarse 4), FusionNet 4 and
4 around the fixed-width V-Net, all at 16^3; V-Net, HighResNet, ER-Net,
RE-Net, DenseVoxelNet, SkipDenseNet3D (16^3), FCN3D (24^3, the least its
k7 VALID head and crops allow), HighRes2DNet, SegNet and UNet++ (32^2
slices; a 2-D net's batch is [n, s, s, 1]) have fixed widths; UNETR at
embed 32, 4 heads (its decoder's widths are fixed) and VT-UNet at embed 12,
window 4, both at 32^3 (the JAX ``tests/test_zoo.py`` sizes).

The JAX package needs flax, which the card's machine lacks (its only test
here is the blocks' ``cuda`` case): the network checks' imports are made
where flax is, and their files call ``pytest.importorskip("flax")`` first.
"""

import contextlib
import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

from general_medical_image_segmentation_cnn_framework_tpu_torch.checkpoint import load_checkpoint
from general_medical_image_segmentation_cnn_framework_tpu_torch.convert import (
    convert_checkpoint,
    module_state_dict_from_flax,
    network_of,
)
from general_medical_image_segmentation_cnn_framework_tpu_torch.models import make_forward
from general_medical_image_segmentation_cnn_framework_tpu_torch.models.registry import model_class
from general_medical_image_segmentation_cnn_framework_tpu_torch.optim import make_optimizer

if importlib.util.find_spec("flax") is not None:
    import jax
    import jax.numpy as jnp

    from general_medical_image_segmentation_cnn_framework_tpu import train as jax_train
    from general_medical_image_segmentation_cnn_framework_tpu.checkpoint import save_checkpoint
    from general_medical_image_segmentation_cnn_framework_tpu.config import ConfigDict
    from general_medical_image_segmentation_cnn_framework_tpu.models.three_d import (
        csrnet, densenet3d, densevoxelnet3d, double_unet, er_net, fcn3d, fusionnet, highresnet, is_net, re_net,
        residual_unet3d, unetr, vnet3d, vtnet,
    )
    from general_medical_image_segmentation_cnn_framework_tpu.models.two_d import (
        deeplab, fcn2d, highresnet2d, miniseg, pspnet, segnet, unetpp,
    )
    from general_medical_image_segmentation_cnn_framework_tpu.nn import attention as jax_attention
    from general_medical_image_segmentation_cnn_framework_tpu.nn import norm as jax_norm
    from general_medical_image_segmentation_cnn_framework_tpu.ops.fft import band_split


# -- blocks

@pytest.fixture(scope="module")
def jx():
    """The JAX side, imported only where flax is (the card's machine has none)."""
    pytest.importorskip("flax")
    import jax
    import jax.numpy as jnp

    return jax, jnp


def rand(shape, seed, loc=0.0, scale=1.0):
    return (loc + scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def fill(tree, seed):
    """Seeded values for a Flax variable tree of shapes (as the zoo tests draw them)."""
    rng = np.random.default_rng(seed)
    draw = {
        "kernel": lambda s: rng.normal(0.0, np.prod(s[:-1]) ** -0.5, s),
        "bias": lambda s: rng.normal(0.0, 0.1, s), "scale": lambda s: rng.uniform(0.5, 1.5, s),
        "mean": lambda s: rng.normal(0.0, 0.2, s), "var": lambda s: rng.uniform(0.5, 2.0, s),
        "alpha": lambda s: rng.uniform(0.1, 0.4, s), "mix": lambda s: rng.uniform(0.5, 1.5, s),
        "upscore_kernel": lambda s: rng.normal(0.0, np.prod(s[:-1]) ** -0.5, s),
        # the transformers' own parameters, far from their zero / 0.02 init so that they move the output
        "position_embeddings": lambda s: rng.normal(0.0, 0.5, s),
        "relative_position_bias_table": lambda s: rng.normal(0.0, 0.5, s),
    }

    def walk(t):
        return {k: walk(v) if isinstance(v, dict) else draw[k](v.shape).astype(np.float32) for k, v in t.items()}

    return walk(dict(tree))


def against_jax(jx, flax_module, port_module, x, seed=0, mutable=False, **apply_kw):
    """Output, input gradient and parameter gradients of ``port_module``
    (its weights from the Flax module's, seeded) against the Flax module's
    for a seeded cotangent; returns (max |dy|, relative L2 of dx, worst
    relative L2 of a parameter's gradient, or for one whose JAX gradient is
    0 up to f32 noise its absolute L2 distance)."""
    jax, jnp = jx
    variables = fill(jax.eval_shape(lambda: flax_module.init(jax.random.PRNGKey(0), jnp.asarray(x), **apply_kw)), seed)
    params, stats = variables.get("params", {}), variables.get("batch_stats")

    def f(p, x):
        v = {"params": p} if stats is None else {"params": p, "batch_stats": stats}
        out = flax_module.apply(v, x, mutable=["batch_stats"] if mutable else False, **apply_kw)
        return out[0] if mutable else out

    y, vjp = jax.vjp(jax.jit(f), params, jnp.asarray(x))
    ct = rand(y.shape, 10_000 + seed)  # drawn apart from x: a cotangent parallel to x hides what a norm removes
    g_params, g_x = vjp(jnp.asarray(ct))
    port_module.load_state_dict(module_state_dict_from_flax(port_module, params, stats))
    xt = torch.from_numpy(x).requires_grad_()
    yt = port_module(xt)
    (yt * torch.from_numpy(ct)).sum().backward()
    want = module_state_dict_from_flax(port_module, jax.tree_util.tree_map(np.asarray, g_params))
    rel = []
    for n, p in port_module.named_parameters():
        diff, norm = float((p.grad - want[n]).norm()), float(want[n].norm())
        # a bias that a norm removes has a true gradient of 0: its f32 noise is held absolute
        rel.append(diff / norm if norm > 1e-4 else diff)
    g_x = np.array(g_x)
    dx = float((xt.grad - torch.from_numpy(g_x)).norm() / np.linalg.norm(g_x))
    return float(np.abs(yt.detach().numpy() - np.asarray(y)).max()), dx, max(rel, default=0.0)


# -- networks

# case -> (config.network, the JAX module at a narrow width, spatial size)
NETS = {
    "res_unet": ("res_unet", lambda: residual_unet3d.ResidualUNet3D(1, 2, 4), 32),
    "vnet": ("vnet", lambda: vnet3d.VNet(True, 1, 2), 16),
    "highresnet": ("highresnet", lambda: highresnet.HighRes3DNet(1, 2), 16),
    "csrnet": ("csrnet", lambda: csrnet.CSRNet(1, 2, 4), 16),
    "er_net": ("er_net", lambda: er_net.ERNet(2, 1), 16),
    "re_net": ("re_net", lambda: re_net.RENet(), 16),
    "IS": ("IS", lambda: is_net.ISNet(1, 2, 4), 16),
    "dunet": ("dunet", lambda: double_unet.DoubleUNet(1, 2, 8), 16),
    "fusionnet": ("fusionnet", lambda: fusionnet.FusionNet(1, 2, 4, 4), 16),
    "densevoxelnet": ("densevoxelnet", lambda: densevoxelnet3d.DenseVoxelNet(1, 2), 16),
    "densenet": ("densenet", lambda: densenet3d.SkipDenseNet3D(1, 2), 16),
    "fcn3d": ("fcn3d", lambda: fcn3d.FCN3D(1, 2), 24),
    "highres2dnet": ("highres2dnet", lambda: highresnet2d.HighRes2DNet(1, 2), 32),
    "segnet": ("segnet", lambda: segnet.SegNet(1, 2), 32),
    "unetpp": ("unetpp", lambda: unetpp.UNetPlusPlus(1, 2), 32),
    "miniseg": ("miniseg", lambda: miniseg.MiniSeg(1, 2), 32),
    "pspnet": ("pspnet", lambda: pspnet.PSPNet(1, 2), 32),
    "deeplab": ("deeplab", lambda: deeplab.DeepLabV3(1, 2), 32),
    # the backbone a test patches into the JAX module (test_torch_port_zoo2d_train_deeplab.py): layers (1, 1, 2, 1)
    "deeplab_shallow": ("deeplab", lambda: deeplab.DeepLabV3(1, 2), 32),
    "fcn2d": ("fcn2d", lambda: fcn2d.FCN32s(1, 2), 32),
    "fcn2d_16": ("fcn2d", lambda: fcn2d.FCN32s(1, 2), 16),  # FCN32s's least size: fc6 sees 1^2
    # the transformers at the JAX tests' narrow sizes (tests/test_zoo.py): UNETR's 16^3 patches give 2^3 tokens
    "unetr": ("unetr", lambda: unetr.UNETR((32,) * 3, 1, 2, embed_dim=32, num_heads=4), 32),
    "vtnet": ("vtnet", lambda: vtnet.VTUNet(2, 1, embed_dim=12, win_size=4, img_size=(32,) * 3), 32),
    # UNETR's train step on 32x16x16: 2 tokens (not 1, where the softmax is constant), a quarter of 32^3's convs
    "unetr_step": ("unetr", lambda: unetr.UNETR((32, 16, 16), 1, 2, embed_dim=32, num_heads=4), (32, 16, 16)),
}
# what the port's ``from_flax`` cannot read from a case's tree: UNETR's heads
PORT_KW = {"unetr": dict(num_heads=4), "unetr_step": dict(num_heads=4)}
# cases whose JAX train step compiles at XLA's backend optimisation level 0 (``compiled``'s ``fast``)
FAST_STEP = {"vtnet": True}
TWO_D = ("highres2dnet", "segnet", "unetpp", "miniseg", "pspnet", "deeplab", "deeplab_shallow", "fcn2d", "fcn2d_16")


def spatial(case):
    """The spatial shape of the case's model input: s^3, or s^2 for a 2-D net (or the case's own shape)."""
    s = NETS[case][2]
    return s if isinstance(s, tuple) else (s,) * (2 if case in TWO_D else 3)


def config_of(case):
    return ConfigDict(network=NETS[case][0], in_classes=1, out_classes=2, loss="bce", optimizer="adam",
                      init_lr=1e-3, precision="float32", grad_accum=1, pipeline_stages=0)


def jax_args(case, x):
    """The JAX model's inputs for the batch x, as the JAX drivers give them."""
    return (x, *band_split(x, limit=0.04)) if NETS[case][0] == "IS" else (x,)


@contextlib.contextmanager
def conv_route(native):
    """The JAX package's ``GMIST_NATIVE_CONV3D`` switch (read while tracing):
    with ``native`` its TorchConv is XLA's own conv (params in a ``Conv_0``
    child), which compiles faster than the default tap-grouped route."""
    before = os.environ.pop("GMIST_NATIVE_CONV3D", None)
    if native:
        os.environ["GMIST_NATIVE_CONV3D"] = "1"
    try:
        yield
    finally:
        os.environ.pop("GMIST_NATIVE_CONV3D", None)
        if before is not None:
            os.environ["GMIST_NATIVE_CONV3D"] = before


def compiled(native, f, *args, fast=True):
    """``jax.jit(f)`` traced for ``args`` on the conv route ``native`` and
    compiled, with ``fast`` at XLA's backend optimisation level 0: half the
    compile on the CPU, f32 results within 1e-6 (not where V-Net's k5 convs
    make the level-0 code slow to run)."""
    with conv_route(native):
        lowered = jax.jit(f).lower(*args)
        return lowered.compile({"xla_backend_optimization_level": 0}) if fast else lowered.compile()


@functools.lru_cache(maxsize=None)
def jax_model(case, native=False, seed=1):
    """(module, variables) of the case: a Flax tree of the module's shapes
    (traced, not compiled, on the conv route ``native``) filled from a
    numpy seed: fan-in scaled kernels, and non-trivial BatchNorm statistics
    and affine parameters, conv biases and PReLU slopes."""
    module = NETS[case][1]()
    x = jnp.zeros((1, *spatial(case), 1))
    with conv_route(native):
        shapes = jax.eval_shape(lambda: module.init(
            {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, *jax_args(case, x), train=False))
    variables = fill(shapes, seed)
    variables.setdefault("batch_stats", {})
    return module, variables


def batch(case, n=2, seed=5):
    """A seeded batch of the model's input: [n, s, s, s, 1], or [n, s, s, 1] for a 2-D net."""
    return np.random.default_rng(seed).normal(size=(n, *spatial(case), 1)).astype(np.float32)


def port_model(case, variables, **kwargs):
    """The port model of the tree's network and widths (and ``kwargs``, for
    the constructor), with its weights."""
    assert network_of(variables["params"]) == NETS[case][0]
    model = model_class(NETS[case][0]).from_flax(variables["params"], **PORT_KW.get(case, {}), **kwargs)
    model.load_state_dict(module_state_dict_from_flax(model, variables["params"], variables["batch_stats"]))
    return model


def jax_logits(case, variables, x, native=False):
    module = jax_model(case, native)[0]

    def run(v, x):
        out = module.apply(v, *jax_args(case, x), train=False)
        return out[0] if isinstance(out, tuple) else out

    x = jnp.asarray(x)
    return np.asarray(compiled(native, run, variables, x, fast=not native)(variables, x))


def check_eval_logits(case, native=False, scaled=False):
    """Eval logits of the port (through ``models.make_forward``) against
    JAX's: f32, atol 2e-4, rtol 1e-3 (the UNet3D test's bar); with
    ``scaled``, atol 2e-4 of the logits' largest magnitude (for a network
    whose seeded weights give logits far from 1, where f32 rounding of the
    scale moves the values near 0 by more than 2e-4)."""
    _, variables = jax_model(case, native)
    assert network_of(variables["params"]) == NETS[case][0]
    x = batch(case)
    want = jax_logits(case, variables, x, native)
    model = port_model(case, variables).eval()
    with torch.inference_mode():
        if case in TWO_D:  # train and predict give [B, 1, H, W, C] patches; the adapter drops and restores the depth
            got = make_forward(config_of(case), model)(torch.from_numpy(x[:, None])).numpy()[:, 0]
        else:
            got = make_forward(config_of(case), model)(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape == x.shape[:-1] + (2,)
    np.testing.assert_allclose(got, want, atol=2e-4 * (max(1.0, float(np.abs(want).max())) if scaled else 1.0),
                               rtol=1e-3)


def check_checkpoint_converts(case, tmp_path, with_adam=True, native=False):
    """A JAX msgpack ``.ckpt`` (with an Adam state whose mu and nu are
    seeded draws, so that every tensor differs, or weights alone) converts
    and loads:
    the parameters and statistics map one to one (a shared module is one
    port parameter), the optimizer's state loads into the port's Adam over
    the model's parameters, and its exp_avg / exp_avg_sq are JAX's mu / nu."""
    _, variables = jax_model(case, native)
    opt_state = {}
    if with_adam:
        tx = jax_train.make_optimizer(config_of(case))
        opt_state = jax.jit(tx.init)(variables["params"])
        rng = np.random.default_rng(7)
        mu, nu = (jax.tree_util.tree_map(lambda p: rng.uniform(0.1, 1.0, p.shape).astype(np.float32),
                                         variables["params"]) for _ in range(2))
        adam, *rest = opt_state.inner_state
        opt_state = opt_state._replace(inner_state=(adam._replace(mu=mu, nu=nu), *rest))
    src, dst = tmp_path / "latest_checkpoint.ckpt", tmp_path / "port.pt"
    try:  # both files go before the test returns: the largest are hundreds of MB
        save_checkpoint(src, variables["params"], variables["batch_stats"], opt_state, epoch=3)
        convert_checkpoint(src, dst)
        state = load_checkpoint(dst)
    finally:
        src.unlink(missing_ok=True)
        dst.unlink(missing_ok=True)
    model = port_model(case, variables)
    assert state["epoch"] == 3 and state["optimizer"] == ("adam" if with_adam else None)
    assert state["params"].keys() == model.state_dict().keys()
    for k, v in model.state_dict().items():
        torch.testing.assert_close(state["params"][k], v, rtol=0, atol=0)
    if not with_adam:
        return
    optimizer = make_optimizer(config_of(case), model.parameters())
    optimizer.load_state_dict(state["opt_state"])
    want = {key: module_state_dict_from_flax(model, tree) for key, tree in (("exp_avg", mu), ("exp_avg_sq", nu))}
    for name, p in model.named_parameters():
        for key, tensors in want.items():
            torch.testing.assert_close(optimizer.state[p][key], tensors[name], rtol=0, atol=0)


def check_converted_predict(case, tmp_path, raw):
    """A JAX msgpack ``.ckpt`` of the case (weights only) converted by
    ``convert.py``: its tensors are the port model's one to one, and served
    by the port (``serving.Predictor`` on the CPU, f32, the case's model
    given, its weights from the converted file) the mask of the raw [1, X,
    Y, Z] volume (one tile: ``patch_size`` is its shape) is the argmax of the
    JAX model's logits on the z-normalised volume. Returns the mask's
    foreground share."""
    from general_medical_image_segmentation_cnn_framework_tpu_torch.config import ConfigDict as PortConfig
    from general_medical_image_segmentation_cnn_framework_tpu_torch.data.transforms import ZNormalization
    from general_medical_image_segmentation_cnn_framework_tpu_torch.serving import Predictor

    _, variables = jax_model(case)
    src, dst = tmp_path / "latest_checkpoint.ckpt", tmp_path / "port.pt"
    try:
        save_checkpoint(src, variables["params"], variables["batch_stats"], {}, epoch=1)
        convert_checkpoint(src, dst)
        params = load_checkpoint(dst)["params"]
    finally:
        src.unlink(missing_ok=True)
        dst.unlink(missing_ok=True)
    model = port_model(case, variables)
    assert params.keys() == model.state_dict().keys()
    for k, v in model.state_dict().items():
        torch.testing.assert_close(params[k], v, rtol=0, atol=0)
    cfg = PortConfig(network=NETS[case][0], in_classes=1, out_classes=2, patch_size=raw.shape[1:],
                     patch_overlap=(4, 4, 4), batch_size=1, precision="float32", platform="cpu")
    mask = Predictor(cfg, model=model, params=params).predict_array(raw)
    x = ZNormalization().normalize_array(raw).transpose(1, 2, 3, 0)[None]
    logits = jax_logits(case, variables, x)
    assert mask.shape == (1, *raw.shape[1:]) and mask.dtype == np.int32
    assert_mask_of(mask, logits)
    return float(logits.argmax(-1).mean())


def assert_mask_of(mask, logits):
    """``mask`` is the argmax of the JAX ``logits`` [1, X, Y, Z, 2] but where
    the two logits are within 4e-4 of their scale (twice the eval logits'
    bar of ``check_eval_logits``: f32 rounding may flip such a voxel)."""
    want = logits.argmax(-1)
    flips = mask != want
    margin = np.abs(logits[..., 1] - logits[..., 0])
    assert (margin[flips] <= 4e-4 * max(1.0, float(np.abs(logits).max()))).all(), margin[flips].max()
    assert flips.mean() <= 1e-3, flips.mean()


def check_registry(network):
    """``build_model`` at the JAX ``from_config`` width (bf16 compute, f32
    parameters) has the JAX model's parameter count, from the
    ``jax.eval_shape`` tree of the JAX registry's model."""
    from general_medical_image_segmentation_cnn_framework_tpu.models.registry import build_model as jax_build_model
    from general_medical_image_segmentation_cnn_framework_tpu_torch.config import ConfigDict as PortConfig
    from general_medical_image_segmentation_cnn_framework_tpu_torch.models import build_model

    config = dict(network=network, in_classes=1, out_classes=2, precision="bfloat16")
    model = build_model(PortConfig(**config))
    assert model.dtype == torch.bfloat16 and all(p.dtype == torch.float32 for p in model.parameters())
    flax_model = jax_build_model(ConfigDict(**config))
    x = jnp.zeros((1, 32, 32, 1) if network in TWO_D else (1, 32, 32, 32, 1))
    args = (x, x, x) if network == "IS" else (x,)
    shapes = jax.eval_shape(lambda: flax_model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, *args, train=False))
    want = sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in model.parameters()) == want


class _NoDropout:
    """Stands in for ``flax.linen.Dropout`` in the train-step tests: the
    identity (the port's rate is set to 0 on its side)."""

    def __init__(self, *args, **kwargs):
        pass

    def __call__(self, x, *args, **kwargs):
        return x


def _jax_step(case, module, variables, inputs, gt, f64=True):
    """(loss, batch_stats updates, gradients) of one JAX train step, in f64
    (or with ``f64`` False in f32): the model's apply as ``train.py``'s
    ``make_forward`` calls it (train mode, the first output) at an f64
    compute dtype, with the norms' f32 statistics raised to f64
    (``_NormsInF64``), and ``make_loss_and_metric``'s binary BCE on the f32
    logits the model returns; one jit on XLA's native conv route at its
    default level (its level-0 f64 code runs several times slower than it
    compiles faster), or at level 0 for a case in ``FAST_STEP`` (VT-UNet:
    no conv, and a compile that level 0 cuts from 36 to 23 s)."""
    if f64:
        as64 = functools.partial(jax.tree_util.tree_map, lambda a: np.asarray(a, np.float64))
        module, variables, inputs = module.clone(dtype=jnp.float64), as64(variables), as64(inputs)
    loss_and_metric = jax_train.make_loss_and_metric(config_of(case))

    def loss_fn(params, gt, *inputs):
        pred, updates = module.apply({"params": params, "batch_stats": variables["batch_stats"]}, *inputs,
                                     train=True, rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"])
        pred = pred[0] if isinstance(pred, tuple) else pred
        return loss_and_metric(pred, gt)[0], updates

    with jax.enable_x64(f64), pytest.MonkeyPatch.context() as patch:
        if f64:
            for source in (jax_norm, jax_attention, unetr):
                patch.setattr(source, "jnp", _NormsInF64())
        args = (variables["params"], jnp.asarray(gt), *map(jnp.asarray, inputs))
        step = compiled(True, jax.value_and_grad(loss_fn, has_aux=True), *args, fast=FAST_STEP.get(case, False))
        (loss, updates), grads = step(*args)
        return float(loss), jax.tree_util.tree_map(np.asarray, updates), jax.tree_util.tree_map(np.asarray, grads)


def _port_step(case, model, inputs, gt):
    """(loss, the model) after one port train step's forward and backward,
    dropout off: ``models.make_forward``'s call (the first output) and the
    train loop's ``make_loss_and_metric``."""
    from general_medical_image_segmentation_cnn_framework_tpu_torch import train as port_train
    from general_medical_image_segmentation_cnn_framework_tpu_torch.nn.blocks import Dropout

    model.train()
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    out = model(*(torch.from_numpy(t.copy()) for t in inputs))
    loss, _ = port_train.make_loss_and_metric(config_of(case))(out[0] if isinstance(out, tuple) else out,
                                                              torch.from_numpy(gt))
    loss.backward()
    return loss.item(), model


def gradient_distances(model, jax_grads, zero_floor=1e-9):
    """{parameter: distance of the port's gradient to JAX's}: relative L2,
    or, for a gradient JAX gives as 0 to within ``zero_floor`` of the norm
    of all of them (a conv bias in front of a norm, which removes any
    shift; IS's second and third decoders and out2 head, which do not reach
    the loss; an attention's key bias, whose shift the softmax ignores),
    the absolute L2 over that norm."""
    want = module_state_dict_from_flax(model, jax_grads)
    named = dict(model.named_parameters())
    assert named.keys() == want.keys()
    total = float(sum(w.double().square().sum() for w in want.values())) ** 0.5
    out = {}
    for name, w in want.items():
        got = named[name].grad if named[name].grad is not None else torch.zeros_like(w)
        diff, norm = float((got.double() - w.double()).norm()), float(w.double().norm())
        out[name] = diff / norm if norm > zero_floor * total else diff / total
    return out


class _NormsInF64:
    """``jax.numpy`` as the JAX package's ``nn/norm.py``, ``nn/attention.py``
    and UNETR see it in the f64 step: its ``float32`` is float64, so that
    the norms' statistics and the attention's softmax, which they compute in
    f32 whatever the input, follow the model's f64. Looked up when used, not
    when the class is made: this module is imported where flax, and so
    ``jnp`` here, is missing (the card's machine)."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


def check_train_step(case, monkeypatch, n=4, stats_tol=(1e-5, 1e-6), grad_tol=1e-6, f32_tol=1e-2):
    """One train step of the port against the JAX package's (binary BCE;
    IS with the same FFT bands on both sides, JAX's ``band_split``: the
    port's is held to it in ``test_torch_port_zoo3d_layers.py``), dropout
    (and the transformers' DropPath) off on both sides. The JAX step runs in
    f64 (``_jax_step``): the exact value of the JAX function, up to the f32
    logits and loss both packages keep (UNETR's JAX logits stay f64 there,
    as ``_NormsInF64`` reaches its final cast).

    The port's f32 step: its loss within 1e-5 of JAX's, the BatchNorm
    running statistics the forward leaves within ``stats_tol`` (rtol,
    atol), and the gradient of every parameter together within 1e-2 in
    relative L2 norm (``f32_tol``). The port's f64 step (the model built with an f64
    compute dtype): every parameter's gradient on its own within
    ``grad_tol`` of JAX's (``gradient_distances``).

    Why the gradients are held leaf by leaf in f64: at these narrow widths
    and small sizes (BatchNorm over as few as 4 values a channel at the
    bottom of a U-Net) the step is so badly conditioned that f32 rounding
    alone moves single parameters' gradients by parts in a thousand, in
    either package. Measured against the f64 step: CSR-Net's f32 port
    gradients up to 2.7e-3 off on a leaf, JAX's f32 1e-4 on its native conv
    route and 1.2e-3 on its default one; ER-Net's f32 JAX gradients up to
    8.5e-3 off, the port's 1.7e-5; res_unet's 2.4e-3 (JAX) and 6e-4
    (port). Two JAX f32 compiles share such errors where they share the
    arithmetic (its E[x^2] - E[x]^2 variance), so neither is a noise floor
    for a leaf. In f64 the two packages' gradients agree leaf by leaf to
    within 7e-8 (the f32 rounding of the parameters' gradients); a wiring
    fault moves a leaf by order one."""
    import flax.linen

    monkeypatch.setattr(flax.linen, "Dropout", _NoDropout)
    monkeypatch.setattr(jax_attention.DropPath, "__call__", lambda self, x, train: x)
    module, variables = jax_model(case, True)
    x = batch(case, n=n, seed=12)
    gt = (np.random.default_rng(13).uniform(size=x.shape) > 0.5).astype(np.float32)
    inputs = [np.asarray(t) for t in jax_args(case, jnp.asarray(x))]
    loss, updates, grads = _jax_step(case, module, variables, inputs, gt)

    got, model = _port_step(case, port_model(case, variables), inputs, gt)
    assert abs(got - loss) <= 1e-5 * loss
    want = module_state_dict_from_flax(model, grads)
    named = dict(model.named_parameters())
    # IS's second and third decoders and its out2 head do not reach out1, the loss's logits: no gradient
    diff = sum(float(((named[k].grad if named[k].grad is not None else 0.0) - w).square().sum())
               for k, w in want.items())
    norm = sum(float(w.square().sum()) for w in want.values())
    assert (diff / norm) ** 0.5 <= f32_tol, (diff / norm) ** 0.5
    want_state = module_state_dict_from_flax(model, variables["params"], updates.get("batch_stats", {}))
    for k, v in model.state_dict().items():
        if "running_" in k:
            np.testing.assert_allclose(v.numpy(), want_state[k].numpy(), *stats_tol, err_msg=k)

    model64 = port_model(case, variables, dtype=torch.float64)
    _port_step(case, model64, [t.astype(np.float64) for t in inputs], gt)
    distance = gradient_distances(model64, grads)
    worst = max(distance, key=distance.get)
    assert distance[worst] <= grad_tol, (worst, distance[worst])
    return distance


# -- AdamW on the parameters that do not reach the loss

LR, WD = 1e-3, 0.01
# the port's names of the parameters whose gradient is 0
UNUSED = {"IS": ("decoders.1.", "decoders.2.", "head2."),
          "densevoxelnet": ("block2.", "up_conv.", "up_bn.", "up1.", "up2.")}


def check_adamw_unused(case, monkeypatch):
    """One AdamW step (wd 0.01) of ``case`` in both packages, dropout off:
    the parameters without a gradient decayed as JAX decays them (test
    files ``test_torch_port_adamw_unused_*.py``, whose docstring says why)."""
    import flax.linen

    from general_medical_image_segmentation_cnn_framework_tpu_torch import train as port_train
    from general_medical_image_segmentation_cnn_framework_tpu_torch.config import ConfigDict as PortConfig
    from general_medical_image_segmentation_cnn_framework_tpu_torch.nn.blocks import Dropout

    monkeypatch.setattr(flax.linen, "Dropout", _NoDropout)
    module, variables = jax_model(case, True)
    x = batch(case, n=2, seed=12)
    gt = (np.random.default_rng(13).uniform(size=x.shape) > 0.5).astype(np.float32)
    cfg = config_of(case)
    cfg.optimizer, cfg.weight_decay, cfg.init_lr = "adamw", WD, LR
    tx = jax_train.make_optimizer(cfg)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    step = jax_train.make_train_step(cfg, module, tx)
    with conv_route(native=True):  # the tree's route: XLA's own conv, traced at the first call
        out = step(params, jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]), tx.init(params),
                   jnp.asarray(x), jnp.asarray(gt), jax.random.PRNGKey(0))
    want = module_state_dict_from_flax(port_model(case, variables), jax.tree_util.tree_map(np.asarray, out[0]))

    model = port_model(case, variables).train()
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    pcfg = PortConfig(network=case, out_classes=2, loss="bce", optimizer="adamw", weight_decay=WD, init_lr=LR)
    optimizer = port_train.make_optimizer(pcfg, model.parameters())
    port_train.make_train_step(make_forward(pcfg, model), optimizer, port_train.make_loss_and_metric(pcfg))(
        torch.from_numpy(x), torch.from_numpy(gt))

    unused = 0
    for name, p in model.named_parameters():
        if name.startswith(UNUSED[case]):
            unused += 1
            decayed = before[name] * (1 - LR * WD) if p.dim() > 1 else before[name]
            torch.testing.assert_close(want[name], decayed, rtol=1e-6, atol=0, msg=name)
            torch.testing.assert_close(p.detach(), want[name], rtol=1e-6, atol=0, msg=name)
        else:
            torch.testing.assert_close(p.detach(), want[name], rtol=0, atol=2 * LR, msg=name)
    assert unused > 10
    assert all(float(optimizer.state[p]["step"]) == 1.0 for p in model.parameters())


def check_train_step_f32(case, monkeypatch, n, leaf_tol, zero_floor=1e-9):
    """One train step of the port against the JAX package's, both in f32,
    dropout off on both sides, for a network whose f64 JAX step is too slow
    for tier 1 (FCN32s, UNETR): the loss within 1e-5 and every parameter's
    gradient on its own within ``leaf_tol`` of JAX's
    (``gradient_distances``, with ``zero_floor``: in f32 a gradient that is
    0 but for rounding, a conv bias in front of BatchNorm, is f32 noise,
    not 1e-9 of the whole); the test states how ``leaf_tol`` follows from
    the distance of the JAX package's own f32 gradients to its f64 ones.
    Returns the distances."""
    import flax.linen

    monkeypatch.setattr(flax.linen, "Dropout", _NoDropout)
    monkeypatch.setattr(jax_attention.DropPath, "__call__", lambda self, x, train: x)
    module, variables = jax_model(case, True)
    x = batch(case, n=n, seed=12)
    gt = (np.random.default_rng(13).uniform(size=x.shape) > 0.5).astype(np.float32)
    loss, _, grads = _jax_step(case, module, variables, [x], gt, f64=False)
    got, model = _port_step(case, port_model(case, variables), [x], gt)
    assert abs(got - loss) <= 1e-5 * loss
    distance = gradient_distances(model, grads, zero_floor)
    worst = max(distance, key=distance.get)
    assert distance[worst] <= leaf_tol, (worst, distance[worst])
    return distance
