"""The port's predict options against the JAX package's at the function
level, f32 on the CPU with the same weights: ``wrap_tta`` logits (UNet3D at
init_features=4, UNet2D at full width on 32^2 slices) and its errors, the
``mean_logits`` and ``average`` blends of the sliding window,
``whole_volume_predict`` with and without a shape bucket, and bucketed
crop-mode masks against unbucketed ones; the deferred fetch against the
mask it defers."""

import math

import numpy as np
import pytest
import torch
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

pytest.importorskip("flax")  # the JAX package is this file's oracle: without it the file skips
import jax.numpy as jnp  # noqa: E402

from general_medical_image_segmentation_cnn_framework_tpu import predict as jax_predict
from general_medical_image_segmentation_cnn_framework_tpu.ops import sliding_window as jax_sw
from general_medical_image_segmentation_cnn_framework_tpu_torch import predict as port_predict
from general_medical_image_segmentation_cnn_framework_tpu_torch.config import ConfigDict
from general_medical_image_segmentation_cnn_framework_tpu_torch.ops import sliding_window as port_sw
from test_torch_port_unet3d import jax_unet, port_unet, random_variables

CPU = torch.device("cpu")


def _jax_forward(config, model):
    return jax_predict.make_forward_fn(config, model)


@pytest.fixture(scope="module")
def unet3d():
    model, variables = jax_unet(4, seed=15)  # masks of about 40% foreground
    return model, variables, port_unet(variables, 4)


@pytest.mark.parametrize("network, spec", [
    ("unet", ""), ("unet", "flips"), ("unet", "flips:hw"), ("unet", "flips:d"), ("unet2d", "flips:hw"),
])
def test_wrap_tta_logits_match_jax(network, spec, unet3d):
    """The flip-averaged logits of both packages' forwards on the same tiles
    [B, D, H, W, 1], within 1e-5 of the logits' scale; under flips they
    differ from the plain forward."""
    config = ConfigDict(network=network, tta=spec)
    rng = np.random.default_rng(22)
    if network == "unet":
        model, variables, port_model = unet3d
        x = rng.normal(size=(2, 16, 16, 16, 1)).astype(np.float32)
    else:
        from general_medical_image_segmentation_cnn_framework_tpu.models.two_d.unet2d import UNet2D as FlaxUNet2D
        from general_medical_image_segmentation_cnn_framework_tpu_torch.convert import state_dict_from_flax
        from general_medical_image_segmentation_cnn_framework_tpu_torch.models.two_d.unet2d import UNet2D

        model = FlaxUNet2D(in_channels=1, classes=2)
        variables = random_variables(model, jnp.zeros((1, 32, 32, 1)), seed=23)
        port_model = UNet2D(1, 2)
        port_model.load_state_dict(state_dict_from_flax(variables["params"], variables["batch_stats"]))
        port_model.eval()
        x = rng.normal(size=(2, 1, 32, 32, 1)).astype(np.float32)
    want = np.asarray(_jax_forward(config, model)(variables, jnp.asarray(x)))
    with torch.inference_mode():
        forward = port_predict.make_forward_fn(config, port_model)
        got = forward(torch.from_numpy(x)).numpy()
        plain = port_predict.make_forward_fn(ConfigDict(network=network, tta=""), port_model)(torch.from_numpy(x))
    assert got.shape == want.shape and got.dtype == np.float32
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-5 * scale
    assert (forward is port_model) == (spec == "" and network == "unet")
    if spec:
        assert np.abs(got - plain.numpy()).max() > 1e-4 * scale


@pytest.mark.parametrize("network, spec", [
    ("unet", "rot90"), ("unet", "flips:xq"), ("unet", "flips:"), ("unet2d", "flips:dh"),
])
def test_wrap_tta_refuses_what_jax_refuses_with_its_words(network, spec):
    config = ConfigDict(network=network, tta=spec)
    with pytest.raises(KeyError) as want:
        jax_predict.wrap_tta(config, lambda v, t: t)
    with pytest.raises(KeyError) as got:
        port_predict.wrap_tta(config, lambda t: t)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("mode", ["mean_logits", "average"])
def test_blend_masks_match_jax_sliding_window(mode, unet3d):
    """A 24x20x32 volume, patch 16, overlap 6,4,8, batch 3 (the last batch
    padded with repeats of the last tile, which weigh nothing): the masks
    of the JAX ``sliding_window_predict`` in that overlap mode, the same
    values and dtype (int32 for mean_logits, the host aggregator's float64
    for average); mean_logits also as an int8 mask on the device, and
    average as a thunk with sync=True too."""
    model, variables, port_model = unet3d
    vol = np.random.default_rng(24).normal(size=(1, 24, 20, 32)).astype(np.float32)
    patch, overlap = (16, 16, 16), (6, 4, 8)

    def forward(v, tiles):
        return model.apply(v, tiles, train=False)

    want = jax_sw.sliding_window_predict(forward, variables, vol, patch, overlap, batch_size=3, overlap_mode=mode)
    dev_vol = port_sw.prepare_volume(vol, CPU, torch.float32)
    calls = []
    got = port_sw.sliding_window_predict(port_model, dev_vol, patch, overlap, 3, overlap_mode=mode, sync=False,
                                         on_dispatch=lambda: calls.append(1))()
    assert calls == [1]
    assert got.dtype == want.dtype and got.shape == want.shape == (1, 24, 20, 32)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(want)) > 2 if mode == "average" else set(np.unique(want)) == {0, 1}
    synced = port_sw.sliding_window_predict(port_model, dev_vol, patch, overlap, 3, overlap_mode=mode)
    if mode == "mean_logits":
        assert synced.dtype == torch.int8
        np.testing.assert_array_equal(synced.numpy(), want[0])
    else:  # the host aggregator's result is always a thunk
        np.testing.assert_array_equal(synced(), want)


@pytest.mark.parametrize("mode", ["crop", "mean_logits", "whole_volume"])
def test_deferred_fetch_is_the_synced_mask(mode):
    """sync=False: ``on_dispatch`` runs once before the thunk is called, and
    the thunk gives the synced mask as the JAX package's int32 [1, X, Y, Z],
    class ids above 1 included (three logit channels, Z = 21)."""
    def forward(tiles):
        x = tiles[..., 0]
        return torch.stack([x, -x, x * x - 1.0], dim=-1)

    vol = torch.from_numpy(np.random.default_rng(25).normal(size=(19, 17, 21, 1)).astype(np.float32))
    if mode == "whole_volume":
        def run(**kw):
            return port_sw.whole_volume_predict(forward, vol, pad_multiple=8, **kw)
    else:
        def run(**kw):
            return port_sw.sliding_window_predict(forward, vol, (8, 8, 8), (2, 2, 4), 3, overlap_mode=mode, **kw)
    calls = []
    thunk = run(sync=False, on_dispatch=lambda: calls.append(1))
    assert calls == [1] and callable(thunk)
    synced = run()
    got = thunk()
    assert synced.dtype == torch.int8 and got.dtype == np.int32 and got.shape == (1, 19, 17, 21)
    np.testing.assert_array_equal(got[0], synced.numpy())
    assert set(np.unique(got)) == {0, 1, 2}


@pytest.mark.parametrize("bucket", [0, 32])
def test_whole_volume_masks_match_jax(bucket, unet3d):
    """A 20x18x13 volume in one forward, padded to 16 (UNet3D's four pools)
    or, bucketed, to lcm(16, 32) = 32 as predict pads it, and cropped back:
    the JAX ``whole_volume_predict``'s mask, fetched to the host."""
    model, variables, port_model = unet3d
    vol = np.random.default_rng(26).normal(size=(1, 20, 18, 13)).astype(np.float32)
    pad = math.lcm(16, bucket) if bucket else 16

    def forward(v, x):
        return model.apply(v, x, train=False)

    want = jax_sw.whole_volume_predict(forward, variables, vol, pad_multiple=pad)
    got = port_sw.whole_volume_predict(port_model, port_sw.prepare_volume(vol, CPU, torch.float32),
                                       pad_multiple=pad, sync=False)()
    assert got.dtype == np.int32 and got.shape == want.shape == (1, 20, 18, 13)
    np.testing.assert_array_equal(got, want)
    assert 0 < want.mean() < 1


def test_bucketed_crop_masks_are_the_unbucketed_bytes(unet3d):
    """A 21x18x19 volume padded to multiples of 8 with the grid and crop on
    the true extent: the same mask as unbucketed, byte for byte, and both
    the JAX package's."""
    model, variables, port_model = unet3d
    vol = np.random.default_rng(27).normal(size=(1, 21, 18, 19)).astype(np.float32)
    patch, overlap = (16, 16, 16), (4, 4, 4)

    def forward(v, tiles):
        return model.apply(v, tiles, train=False)

    want = jax_sw.sliding_window_predict(forward, variables, vol, patch, overlap, batch_size=2)
    dev_vol = port_sw.prepare_volume(vol, CPU, torch.float32)
    padded = port_sw.pad_volume(dev_vol, 8)
    assert tuple(padded.shape) == (24, 24, 24, 1) and torch.equal(padded[:21, :18, :19], dev_vol)
    plain = port_sw.sliding_window_predict(port_model, dev_vol, patch, overlap, 2, sync=False)()
    bucketed = port_sw.sliding_window_predict(port_model, padded, patch, overlap, 2, true_spatial=(21, 18, 19),
                                              sync=False)()
    assert bucketed.shape == (1, 21, 18, 19) and bucketed.tobytes() == plain.tobytes()
    np.testing.assert_array_equal(plain, want)


def test_pad_multiple_is_the_jax_table():
    from general_medical_image_segmentation_cnn_framework_tpu.models import registry as jax_registry
    from general_medical_image_segmentation_cnn_framework_tpu_torch.models import pad_multiple

    for network in ("unet", "unet2d", "vtnet", "unetr", "highresnet", "res_unet", "vnet"):
        assert pad_multiple(network) == jax_registry.pad_multiple(network)


@pytest.mark.parametrize("overlap", [(4, 4, 4), (5, 3, 7)])
def test_crop_is_the_aggregators_crop(overlap):
    """The crop-mode mask against the copy of TorchIO's ``GridAggregator``
    on the tiles' own masks, on a 19x17x23 volume with
    6x8x10 tiles (clamped last tiles; odd overlaps keep one voxel twice, the
    later tile winning), for a forward whose masks at a voxel differ from
    tile to tile (voxel above its tile's mean)."""
    from general_medical_image_segmentation_cnn_framework_tpu_torch.data.pipeline import GridAggregator, grid_locations

    def forward(tiles):
        x = tiles[..., 0]
        return torch.stack([x.mean(dim=(1, 2, 3), keepdim=True).expand_as(x), x], dim=-1)

    vol = torch.from_numpy(np.random.default_rng(28).normal(size=(19, 17, 23, 1)).astype(np.float32))
    patch = (6, 8, 10)
    got = port_sw.sliding_window_predict(forward, vol, patch, overlap, 4)
    locations = grid_locations((19, 17, 23), patch, overlap)
    tiles = np.stack([vol[i0:i1, j0:j1, k0:k1, 0].numpy() for i0, j0, k0, i1, j1, k1 in locations])
    aggregator = GridAggregator((19, 17, 23), overlap, overlap_mode="crop", num_channels=1, dtype=np.int8)
    aggregator.add_batch((tiles > tiles.mean(axis=(1, 2, 3), keepdims=True)).astype(np.int8)[:, None], locations)
    np.testing.assert_array_equal(got.numpy(), aggregator.get_output_tensor()[0])
