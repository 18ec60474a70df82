"""The port's 2-D Swin -> 3-D VT-UNet inflation
(``…_torch/utils/inflate_vtunet.py``) against the JAX package's: one
synthetic 2-D Swin state dict (torch naming, RGB stem, 7x7 windows; no Swin
checkpoint is in the repository) inflated into VT-UNet (embed 12, window 4)
by both; the JAX result, carried by ``convert.py``'s map, equals the port's
tensor for tensor, bit for bit, with the same tensors loaded and skipped;
the inflated model runs. The bicubic resize of the bias tables is held to
``torch.nn.functional.interpolate(mode='bicubic')``."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

from general_medical_image_segmentation_cnn_framework_tpu_torch.utils.inflate_vtunet import (
    bicubic_resize_table,
    inflate_swin2d_into_vtunet,
)


def swin2d_state_dict(embed=12, heads=(3, 6, 12, 24), depths=(2, 2, 2, 1), win2d=7, in_chans=3):
    """A seeded 2-D Swin checkpoint with torch naming (torch tensors), with
    the index and mask buffers the inflation drops."""
    rng = np.random.default_rng(0)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    sd = {"patch_embed.proj.weight": t(embed, in_chans, 4, 4), "patch_embed.proj.bias": t(embed),
          "patch_embed.norm.weight": t(embed), "patch_embed.norm.bias": t(embed), "norm.weight": t(8 * embed)}
    for i, depth in enumerate(depths):
        dim = embed * 2**i
        for j in range(depth):
            p = f"layers.{i}.blocks.{j}."
            sd.update({p + "norm1.weight": t(dim), p + "norm1.bias": t(dim), p + "norm2.weight": t(dim),
                       p + "norm2.bias": t(dim), p + "attn.qkv.weight": t(3 * dim, dim),
                       p + "attn.qkv.bias": t(3 * dim),
                       p + "attn.proj.weight": t(dim, dim), p + "attn.proj.bias": t(dim),
                       p + "attn.relative_position_bias_table": t((2 * win2d - 1) ** 2, heads[i]),
                       p + "attn.relative_position_index": torch.zeros(win2d**4, dtype=torch.int64),
                       p + "attn_mask": torch.zeros(1), p + "mlp.fc1.weight": t(4 * dim, dim),
                       p + "mlp.fc1.bias": t(4 * dim), p + "mlp.fc2.weight": t(dim, 4 * dim),
                       p + "mlp.fc2.bias": t(dim)})
        if i < len(depths) - 1:
            sd.update({f"layers.{i}.downsample.reduction.weight": t(2 * dim, 4 * dim),
                       f"layers.{i}.downsample.norm.weight": t(4 * dim),
                       f"layers.{i}.downsample.norm.bias": t(4 * dim)})
    return sd


@pytest.mark.parametrize("s_in, out", [(13, (7, 7)), (3, (7, 5)), (7, (13, 13))])
def test_bicubic_resize_is_torch_interpolate(s_in, out):
    table = np.random.default_rng(s_in).normal(size=(s_in * s_in, 3)).astype(np.float32)
    want = F.interpolate(torch.from_numpy(table).T.reshape(1, 3, s_in, s_in), size=out, mode="bicubic",
                         align_corners=False)
    got = bicubic_resize_table(table, out)
    assert got.shape == (out[0] * out[1], 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want.reshape(3, -1).T.numpy(), rtol=0, atol=1e-5)


def test_inflation_matches_jax():
    pytest.importorskip("flax")  # the JAX package is this test's oracle
    import jax
    import jax.numpy as jnp
    from torch_port_zoo3d import fill

    from general_medical_image_segmentation_cnn_framework_tpu.models.three_d.vtnet import VTUNet as JaxVTUNet
    from general_medical_image_segmentation_cnn_framework_tpu.utils.inflate_vtunet import (
        inflate_swin2d_into_vtunet as jax_inflate,
    )
    from general_medical_image_segmentation_cnn_framework_tpu_torch.convert import module_state_dict_from_flax
    from general_medical_image_segmentation_cnn_framework_tpu_torch.models.three_d.vtnet import VTUNet

    module = JaxVTUNet(2, 1, embed_dim=12, win_size=4, img_size=(32, 32, 32))
    shapes = jax.eval_shape(lambda: module.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                                                jnp.zeros((1, 32, 32, 32, 1)), train=False))
    params = fill(shapes, 3)["params"]
    sd = swin2d_state_dict()
    inflated, jax_report = jax_inflate({k: v.numpy() for k, v in sd.items()}, params, window_size=(4, 4, 4))

    model = VTUNet(2, 1, embed_dim=12, win_size=4)
    model.load_state_dict(module_state_dict_from_flax(model, params))
    state, report = inflate_swin2d_into_vtunet(sd, model, window_size=(4, 4, 4))
    want = module_state_dict_from_flax(model, inflated)
    assert state.keys() == want.keys()
    for k, v in want.items():
        torch.testing.assert_close(state[k], v, rtol=0, atol=0, msg=k)
    loaded = [r for r in report if r.startswith("loaded")]
    assert len(loaded) == sum(r.startswith("loaded") for r in jax_report) == 4 + 7 * 13 + 3 * 3
    assert state["swin.patch_embed.weight"].shape == (4, 4, 4, 1, 12)  # RGB averaged into one channel
    before = model.state_dict()
    changed = {k for k in state if not torch.equal(state[k], before[k])}
    assert all(k.startswith(("swin.patch_embed.", "swin.patch_norm.", "swin.layers.")) for k in changed)
    assert not any(k.startswith(("swin.layers_up.", "swin.head.")) for k in changed)
    model.load_state_dict(state)
    with torch.inference_mode():
        y = model.eval()(torch.randn(1, 32, 32, 32, 1))
    assert y.shape == (1, 32, 32, 32, 2) and torch.isfinite(y).all()
