"""The transformers' blocks (``nn/attention.py``, ``nn/norm.LayerNorm``,
VT-UNet's patch merge and expands, UNETR's transformer block) against the
JAX package's on the CPU.

Each block runs in f64 on both sides (the JAX side under ``jax.enable_x64``,
with the f32 casts of its norms and attention raised to f64 as in the f64
train steps, ``torch_port_zoo3d._NormsInF64``), its weights carried by
``convert.py``'s map: every output array, the input's gradient and every
parameter's gradient for a seeded cotangent, within 1e-10 (relative L2 for
the gradients); a gradient that is 0 but for rounding (a key bias) within
1e-7 of the norm of all of them. The bias tables and position embeddings are drawn far from
their init so that they move the output. The index and mask helpers are
held to JAX's exactly; LayerNorm also in f32 and bf16."""

import numpy as np
import pytest
import torch
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

from general_medical_image_segmentation_cnn_framework_tpu_torch import convert
from general_medical_image_segmentation_cnn_framework_tpu_torch.convert import module_state_dict_from_flax
from general_medical_image_segmentation_cnn_framework_tpu_torch.models.three_d import unetr as port_unetr
from general_medical_image_segmentation_cnn_framework_tpu_torch.models.three_d import vt_unet as port_vt
from general_medical_image_segmentation_cnn_framework_tpu_torch.nn import attention as port_attn
from general_medical_image_segmentation_cnn_framework_tpu_torch.nn.norm import LayerNorm

flax = pytest.importorskip("flax")  # the JAX package is this file's oracle: without it the file skips

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch_port_zoo3d import _NormsInF64, fill, rand  # noqa: E402

from general_medical_image_segmentation_cnn_framework_tpu.models.three_d import unetr as jax_unetr  # noqa: E402
from general_medical_image_segmentation_cnn_framework_tpu.models.three_d import vt_unet as jax_vt  # noqa: E402
from general_medical_image_segmentation_cnn_framework_tpu.nn import attention as jax_attn  # noqa: E402
from general_medical_image_segmentation_cnn_framework_tpu.nn import norm as jax_norm  # noqa: E402

F64 = torch.float64
ZERO_TOL = 1e-7


def _arrays(out):
    """The arrays of a block's output (a tuple may hold None)."""
    return [o for o in (out if isinstance(out, tuple) else (out,)) if o is not None]


def check_f64(flax_module, port_module, x, *rest, seed=0, tol=1e-10, kw=(("train", False),)):
    """``flax_module.apply(v, x, *rest, **kw)`` against ``port_module(x,
    *rest)`` in f64 (the module docstring); ``rest`` holds numpy arrays,
    None or tuples of arrays, held constant. Returns the three distances
    (outputs, input gradient, parameter gradients)."""

    rest = [tuple(np.asarray(t, np.float64) for t in r) if isinstance(r, tuple)
            else (None if r is None else np.asarray(r, np.float64)) for r in rest]

    def jax_rest():
        return [tuple(map(jnp.asarray, r)) if isinstance(r, tuple) else (None if r is None else jnp.asarray(r))
                for r in rest]

    def port_rest():
        return [tuple(map(torch.from_numpy, r)) if isinstance(r, tuple)
                else (None if r is None else torch.from_numpy(r)) for r in rest]

    with jax.enable_x64(True), pytest.MonkeyPatch.context() as patch:
        for source in (jax_norm, jax_attn, jax_unetr):
            patch.setattr(source, "jnp", _NormsInF64())
        x = np.asarray(x, np.float64)
        shapes = jax.eval_shape(lambda: flax_module.init(jax.random.PRNGKey(0), jnp.asarray(x), *jax_rest(),
                                                         **dict(kw)))
        params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), fill(shapes, seed)["params"])

        def f(p, x):
            return tuple(_arrays(flax_module.apply({"params": p}, x, *jax_rest(), **dict(kw))))

        ys, vjp = jax.vjp(jax.jit(f), params, jnp.asarray(x))
        cts = tuple(rand(y.shape, 10_000 + seed + i).astype(np.float64) for i, y in enumerate(ys))
        g_params, g_x = vjp(tuple(map(jnp.asarray, cts)))
    port_module = port_module.double().eval()
    port_module.load_state_dict(module_state_dict_from_flax(port_module, params), strict=True)
    xt = torch.from_numpy(x).requires_grad_()
    outs = _arrays(port_module(xt, *port_rest()))
    assert len(outs) == len(ys)
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cts)).backward()
    dy = max(float(np.abs(o.detach().numpy() - np.asarray(y)).max() / max(1.0, np.abs(np.asarray(y)).max()))
             for o, y in zip(outs, ys))
    g_x = np.asarray(g_x)
    dx = float(np.linalg.norm(xt.grad.numpy() - g_x) / np.linalg.norm(g_x))
    with pytest.MonkeyPatch.context() as patch:  # the map's leaves in f64 (convert.py reads f32 checkpoints)
        patch.setattr(convert, "_t", lambda a: torch.from_numpy(np.array(a, dtype=np.float64)))
        want = module_state_dict_from_flax(port_module, jax.tree_util.tree_map(np.asarray, g_params))
    named = dict(port_module.named_parameters())
    assert named.keys() == want.keys()
    # a gradient that is 0 but for rounding (a key bias: softmax ignores a shift shared by a row's scores)
    # is held absolute, within ZERO_TOL of the norm of all of them
    total = float(sum(w.square().sum() for w in want.values())) ** 0.5
    dws = {k: float((named[k].grad - want[k]).norm()) / float(want[k].norm()) for k in want
           if float(want[k].norm()) > ZERO_TOL * total}
    zeros = {k: float((named[k].grad - want[k]).norm()) / total for k in want.keys() - dws.keys()}
    dw = max(dws.values())
    assert dy <= tol and dx <= tol and dw <= tol and max(zeros.values(), default=0.0) <= ZERO_TOL, (dy, dx, dws, zeros)
    return dy, dx, dw


# -- helpers: exact


@pytest.mark.parametrize("window", [(4, 4, 4), (2, 3, 4), (7, 2, 1)])
def test_relative_position_index_is_jax_s(window):
    np.testing.assert_array_equal(port_attn.relative_position_index(window), jax_attn._relative_position_index(window))


@pytest.mark.parametrize("grid, window, shift, masked", [
    ((8, 8, 8), (4, 4, 4), (2, 2, 2), True),  # shifted on every axis
    ((8, 8, 8), (4, 4, 4), (2, 0, 0), True),  # shifted on D alone
    ((21, 21, 21), (7, 7, 7), (3, 3, 3), True),  # VT-UNet's window at a padded 16^3 grid
    # H and W clamped to the grid (equality clamps), D shifted: the region slices [:-w] of a clamped axis are
    # empty, so nothing is masked (VT-UNet's stages from H = W = 4 at 64^3 patches)
    ((8, 4, 4), (4, 4, 4), (2, 0, 0), False),
    ((8, 2, 2), (4, 2, 2), (0, 0, 0), False),  # unshifted: one region
])
def test_compute_mask_is_jax_s(grid, window, shift, masked):
    got = port_attn.compute_mask(*grid, window, shift)
    want = np.asarray(jax_attn.compute_mask(*grid, window, shift))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(np.unique(want).tolist()) <= {0.0, -100.0} and bool((want != 0).any()) == masked


@pytest.mark.parametrize("x_size, window, shift", [
    ((16, 16, 16), (7, 7, 7), (3, 3, 3)), ((16, 4, 2), (7, 4, 4), (3, 2, 2)), ((7, 8, 9), (7, 7, 7), None)])
def test_get_window_size_clamps_as_jax(x_size, window, shift):
    assert port_attn.get_window_size(x_size, window, shift) == jax_attn.get_window_size(x_size, window, shift)


def test_window_partition_and_reverse_are_jax_s():
    x = rand((2, 8, 6, 4, 3), 1)
    got = port_attn.window_partition(torch.from_numpy(x), (4, 3, 2))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_attn.window_partition(jnp.asarray(x), (4, 3, 2))))
    np.testing.assert_array_equal(port_attn.window_reverse(got, (4, 3, 2), 2, 8, 6, 4).numpy(), x)


@pytest.mark.parametrize("shape, channels", [((2, 4, 3, 5), 12), ((1, 8, 2, 2), 96), ((1, 3, 3, 3), 7)])
def test_positional_encoding_is_jax_s(shape, channels):
    got = port_attn.PositionalEncoding3D(channels)(shape, channels)
    want = np.asarray(jax_attn.PositionalEncoding3D(channels)(shape, channels))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_flax(dtype):
    """Flax's LayerNorm (eps 1e-6, E[x^2] - E[x]^2 in f32) at a mean far
    from zero: f32 within 1e-5 of the output's scale, bf16 within one bf16
    rounding of it (the f32 results round to neighbouring bf16 values where
    they sit near a rounding boundary)."""
    x = rand((3, 5, 40), 2, loc=4.0, scale=0.7)
    rng = np.random.default_rng(3)
    scale, bias = rng.uniform(0.5, 1.5, 40).astype(np.float32), rng.normal(0, 0.1, 40).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(flax.linen.LayerNorm(dtype=jdt).apply(
        {"params": {"scale": scale, "bias": bias}}, jnp.asarray(x).astype(jdt)).astype(jnp.float32))
    port = LayerNorm(40, dtype=tdt)
    port.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias)})
    got = port(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    lim = (1e-5 if dtype == "float32" else 2**-8) * np.abs(want).max()
    assert np.abs(got.float().detach().numpy() - want).max() <= lim


# -- blocks in f64


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("with_prev", [False, True])
def test_window_attention_matches_jax(with_mask, with_prev):
    """Eight windows of 4x2x2 (16 positions) on 2 samples, 12 channels in 3
    heads, the bias table for a 4^3 window (343 rows, sliced [:16, :16] as
    for a clamped window); the shift mask of an 8x4x4 grid (1,184 of its
    2,048 entries masked); the decoder's cached (v, k, q)."""
    b_, n, c, heads = 16, 16, 12, 3
    x = rand((b_, n, c), 4)
    mask = np.asarray(jax_attn.compute_mask(8, 4, 4, (4, 2, 2), (2, 1, 1))) if with_mask else None
    prev = tuple(rand((b_, heads, n, c // heads), 5 + i) for i in range(3)) if with_prev else None
    check_f64(jax_attn.WindowAttention3D(c, (4, 4, 4), heads, dtype=jnp.float64),
              port_attn.WindowAttention3D(c, (4, 4, 4), heads, dtype=F64), x, mask, prev)


@pytest.mark.parametrize("case", ["shifted", "clamped", "decoder"])
def test_swin_block_matches_jax(case):
    """A shifted block on an 8x6x5 grid (window 4: every axis padded and
    rolled, with the stage's mask), a block whose small 8x2x3 grid clamps
    the window to 4x2x3 (shifted on D alone; its mask is all 0, as the
    JAX package's), and a decoder block (with the cached v, k, q: the
    cross-attention and ``forward_part3``'s blend)."""
    dim, heads = 12, 3
    grid = {"shifted": (8, 6, 5), "clamped": (8, 2, 3), "decoder": (8, 6, 5)}[case]
    x = rand((2, *grid, dim), 6)
    ws, ss = jax_attn.get_window_size(grid, (4, 4, 4), (2, 2, 2))
    padded = [int(np.ceil(g / w)) * w for g, w in zip(grid, ws)]
    mask = np.asarray(jax_attn.compute_mask(*padded, ws, ss))
    prev = None
    if case == "decoder":
        windows = 2 * int(np.prod([p // w for p, w in zip(padded, ws)]))
        prev = tuple(rand((windows, heads, int(np.prod(ws)), dim // heads), 7 + i) for i in range(3))
    check_f64(jax_attn.SwinTransformerBlock3D(dim, heads, (4, 4, 4), (2, 2, 2), dtype=jnp.float64),
              port_attn.SwinTransformerBlock3D(dim, heads, (4, 4, 4), (2, 2, 2), dtype=F64), x, mask, prev)


def test_patch_merging_on_odd_hw_matches_jax():
    check_f64(jax_vt.PatchMerging(6, jnp.float64), port_vt.PatchMerging(6, F64), rand((2, 3, 5, 7, 6), 8), kw=())


def test_patch_expand_matches_jax():
    check_f64(jax_vt.PatchExpand(12, jnp.float64), port_vt.PatchExpand(12, F64), rand((2, 3, 2, 4, 12), 9), kw=())


def test_final_patch_expand_x4_matches_jax():
    check_f64(jax_vt.FinalPatchExpandX4(6, 4, jnp.float64), port_vt.FinalPatchExpandX4(6, 4, F64),
              rand((1, 2, 3, 2, 6), 10), kw=())


def test_unetr_transformer_block_matches_jax():
    """Pre-norm attention (4 heads of 8) and the 2048-wide ReLU feed-forward on 2 x 8 tokens."""
    check_f64(jax_unetr._TransformerBlock(32, 4, 0.1, jnp.float64),
              port_unetr._TransformerBlock(32, 4, 0.1, F64, torch.Generator().manual_seed(0)), rand((2, 8, 32), 11))


def test_drop_path_draws_one_per_sample():
    """Each sample kept whole with probability 1 - rate and scaled by 1 / (1 - rate), or zeroed; inert in eval."""
    x = torch.ones(4000, 2, 3, 2, 5)
    drop = port_attn.DropPath(0.25, torch.Generator().manual_seed(4)).train()
    y = drop(x)
    per_sample = y.reshape(4000, -1)
    kept = per_sample[:, 0] != 0
    assert torch.equal(per_sample[kept], torch.full_like(per_sample[kept], 1 / 0.75))
    assert torch.equal(per_sample[~kept], torch.zeros_like(per_sample[~kept]))
    assert abs(kept.float().mean().item() - 0.75) < 0.03
    assert torch.equal(drop.eval()(x), x) and torch.equal(port_attn.DropPath(0.0).train()(x), x)
