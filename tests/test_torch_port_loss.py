"""The port's fused BCE + dice loss/metric, its losses and its device-side
metrics against the JAX package's, on the same numpy-seeded inputs.

On the CPU the port's ``fused_bce_dice_metrics`` runs the kernels' plain
versions; it is held against the JAX Pallas kernels in interpret mode and
against the JAX reference composition (one-hot target, BCE, argmax dice).
Tolerances: loss 1e-5 relative (f32 sums in another order), jaccard and
dice 1e-6 (ratios of exact counts), gradient 1e-6 of its scale s = 1/(2V)
(the gradient is (sigmoid(l) - t) * s with |sigmoid(l) - t| <= 1, so this is
1e-6 absolute in units of s: a few f32 roundings of the sigmoid, and an
all-zero or wrong gradient fails it at any V). One exception, on the JAX side: where the
voxel count is not a multiple of 1024 the Pallas path pads and subtracts
2*log(2) per padded voxel in f32, which its own test bounds at 1e-4
absolute (tests/test_fused_ops.py); there the port's loss is also held to
a float64 numpy sum at 1e-6 relative.

The edge cases (voxel counts 1, 2, 3, 5, 7 and 105, an all-background
mask with an all-background prediction, ties l0 == l1, logits of +-30) hold
the port's loss, jaccard, dice and gradient against the JAX package's
``fused_bce_dice_metrics`` through ``_reference_sums`` (loss 1e-5 relative)
and through the Pallas kernels in interpret mode (the padding exception
above), the counts exactly, jaccard and dice within 1e-6 relative and the
gradient within 1e-6 * s.

The CUDA kernels run only on a card: the ``cuda``-marked cases skip
without one; on the card, ``python -m pytest --noconftest
tests/test_torch_port_loss.py -m cuda``.
"""

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from general_medical_image_segmentation_cnn_framework_tpu_torch import losses as port_losses
from general_medical_image_segmentation_cnn_framework_tpu_torch import metrics as port_metrics
from general_medical_image_segmentation_cnn_framework_tpu_torch.ops import fused_bce_dice
from general_medical_image_segmentation_cnn_framework_tpu_torch.ops.fused_bce_dice import (
    bce_dice_grads,
    bce_dice_grads_reference,
    bce_dice_sums,
    bce_dice_sums_reference,
    fused_bce_dice_metrics,
)

SHAPES = [(2, 8, 8, 8), (1, 5, 7, 3)]  # 1024 voxels, and 105: not a multiple of 1024


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0.0, 2.0, size=shape + (2,)).astype(np.float32)
    gt = (rng.uniform(size=shape + (1,)) > 0.6).astype(np.float32)
    return logits, gt


def _port(logits, gt):
    lt = torch.from_numpy(logits).requires_grad_()
    loss, jac, dice = fused_bce_dice_metrics(lt, torch.from_numpy(gt))
    loss.backward()
    return loss.item(), jac.item(), dice.item(), lt.grad.numpy()


def _assert_close(got, want, loss_atol=0.0):
    loss, jac, dice, grad = got
    w_loss, w_jac, w_dice, w_grad = want
    assert abs(loss - w_loss) <= max(1e-5 * abs(w_loss), loss_atol)
    assert abs(jac - w_jac) <= 1e-6 and abs(dice - w_dice) <= 1e-6
    scale = 1.0 / grad.size  # s = 1/(2V): the loss is the mean of 2V BCE terms
    np.testing.assert_allclose(grad, w_grad, rtol=0, atol=1e-6 * scale)


@pytest.mark.parametrize("shape", SHAPES)
def test_fused_matches_jax_pallas_interpret_and_reference(shape, monkeypatch):
    import jax
    import jax.numpy as jnp

    from general_medical_image_segmentation_cnn_framework_tpu import losses, metrics
    from general_medical_image_segmentation_cnn_framework_tpu.ops import fused

    logits, gt = _inputs(shape, seed=sum(shape))
    got = _port(logits, gt)
    x, t = logits.astype(np.float64), np.concatenate([1 - gt, gt], -1).astype(np.float64)
    exact = np.mean(np.maximum(x, 0) - x * t + np.log1p(np.exp(-np.abs(x))))
    assert abs(got[0] - exact) <= 1e-6 * exact
    g = jnp.asarray(gt)
    padded = np.prod(shape) % 1024 != 0

    def jax_fused(l):
        return fused.fused_bce_dice_metrics(l, g)

    def jax_reference(l):
        gt2 = losses.one_hot_background(g)
        jac, dice = metrics.dice_jaccard(jnp.argmax(gt2, -1), jnp.argmax(l, -1))
        return losses.bce_with_logits(l, gt2), jac, dice

    monkeypatch.setattr(fused, "_FORCE_PALLAS", True)
    monkeypatch.setattr(fused, "_INTERPRET", True)
    for fn in (jax_fused, jax_reference):
        loss, jac, dice = fn(jnp.asarray(logits))
        grad = jax.grad(lambda l: fn(l)[0])(jnp.asarray(logits))
        atol = 1e-4 if fn is jax_fused and padded else 0.0
        _assert_close(got, (float(loss), float(jac), float(dice), np.asarray(grad)), atol)


def _edge_inputs(case):
    """(logits, gt) of one edge case, made with numpy from a fixed seed."""
    rng = np.random.default_rng(11)
    if case.startswith("v"):  # a voxel count that is no multiple of 4 (or 1024)
        shape = (1, int(case[1:]), 1, 1)
        return _inputs(shape, seed=int(case[1:]))
    shape = (2, 3, 4, 5)
    if case == "all_background":  # gt 0 and l0 > l1 everywhere: the counts are 0, dice and jaccard 0 / smooth
        l0 = np.abs(rng.normal(0.0, 2.0, shape)) + 0.5
        logits = np.stack([l0, -l0 + rng.uniform(-0.4, 0.4, shape)], -1)
        gt = np.zeros(shape + (1,))
    elif case == "ties":  # l0 == l1: argmax picks index 0, background
        l0 = rng.normal(0.0, 2.0, shape)
        logits = np.stack([l0, l0], -1)
        gt = (rng.uniform(size=shape + (1,)) > 0.5).astype(np.float64)
    else:  # saturated: logits of +-30
        logits = 30.0 * np.where(rng.uniform(size=shape + (2,)) > 0.5, 1.0, -1.0)
        gt = (rng.uniform(size=shape + (1,)) > 0.5).astype(np.float64)
    return logits.astype(np.float32), gt.astype(np.float32)


EDGE_CASES = ["v1", "v2", "v3", "v5", "v7", "v105", "all_background", "ties", "saturated"]


def _zero_loss_planes(logits, gt):
    """l0, l1, g as (rows, 128) planes padded to whole 1024-voxel tiles with
    voxels that add exactly 0 to every sum (l0 = 100, l1 = -100, g = 0: both
    BCE terms are log1p(exp(-100)) = 0 in f32, background predicted), so the
    JAX package's sums need no padding correction."""
    import jax.numpy as jnp

    v = logits.size // 2
    pad = -v % 1024
    planes = [np.pad(a.ravel(), (0, pad), constant_values=c)
              for a, c in ((logits[..., 0], 100.0), (logits[..., 1], -100.0), (gt, 0.0))]
    return [jnp.asarray(p.reshape(-1, 128)) for p in planes]


@pytest.mark.parametrize("case", EDGE_CASES)
def test_fused_edge_cases_match_jax(case, monkeypatch):
    """The sums against the JAX package's (the Pallas kernel in interpret mode
    and ``_reference_sums``): loss within 1e-5 relative, counts exact; jaccard
    and dice within 1e-6 relative and the gradient within 1e-6 * s of the JAX
    ``fused_bce_dice_metrics`` and its ``jax.grad``, through the Pallas kernels
    in interpret mode and through ``_reference_sums``. The JAX function's own
    loss is not the oracle here: it pads to 1024 voxels and subtracts
    pad * 2 * log(2) in f32, which at V = 1 is off by about 1e-3."""
    import jax
    import jax.numpy as jnp

    from general_medical_image_segmentation_cnn_framework_tpu.ops import fused

    logits, gt = _edge_inputs(case)
    v = logits.size // 2
    loss, jac, dice, grad = _port(logits, gt)
    sums = bce_dice_sums(torch.from_numpy(logits), torch.from_numpy(gt)).tolist()
    if case == "all_background":
        assert sums[1:] == [0.0, 0.0, 0.0] and jac == 0.0 and dice == 0.0
    if case == "ties":
        assert sums[3] == 0.0  # no voxel is predicted foreground
    x = logits.astype(np.float64)
    t = np.concatenate([1 - gt, gt], -1).astype(np.float64)
    exact = np.mean(np.maximum(x, 0) - x * t + np.log1p(np.exp(-np.abs(x))))
    assert abs(loss - exact) <= 1e-6 * exact
    planes = _zero_loss_planes(logits, gt)
    g_jax = jnp.asarray(gt)

    def jax_fused(lg):
        return fused.fused_bce_dice_metrics(lg, g_jax)

    for pallas in (False, True):  # _reference_sums; the Pallas kernels in interpret mode
        monkeypatch.setattr(fused, "_FORCE_PALLAS", pallas)
        monkeypatch.setattr(fused, "_INTERPRET", pallas)
        w_sums = [float(c) for c in (fused._pallas_sums if pallas else fused._reference_sums)(*planes)]
        assert sums[1:] == w_sums[1:], (pallas, sums, w_sums)
        w_loss = float(np.float32(w_sums[0]) / np.float32(2 * v))
        assert abs(loss - w_loss) <= 1e-5 * abs(w_loss), (pallas, loss, w_loss)
        _, w_jac, w_dice = (float(r) for r in jax_fused(jnp.asarray(logits)))
        w_grad = np.asarray(jax.grad(lambda lg: jax_fused(lg)[0])(jnp.asarray(logits)))
        assert abs(jac - w_jac) <= 1e-6 * abs(w_jac) and abs(dice - w_dice) <= 1e-6 * abs(w_dice)
        np.testing.assert_allclose(grad, w_grad, rtol=0, atol=1e-6 * 0.5 / v)


def test_losses_and_device_metrics_match_jax():
    import jax.numpy as jnp

    from general_medical_image_segmentation_cnn_framework_tpu import losses, metrics

    logits, gt = _inputs((2, 4, 5, 3), seed=7)
    gt2 = port_losses.one_hot_background(torch.from_numpy(gt))
    np.testing.assert_array_equal(gt2.numpy(), np.asarray(losses.one_hot_background(jnp.asarray(gt))))
    got = port_losses.bce_with_logits(torch.from_numpy(logits), gt2)
    want = losses.bce_with_logits(jnp.asarray(logits), jnp.asarray(gt2.numpy()))
    assert got.dtype == torch.float32 and abs(float(got) - float(want)) <= 1e-6 * abs(float(want))
    pred = logits.argmax(-1)
    counts = port_metrics.confusion_counts(torch.from_numpy(gt[..., 0]), torch.from_numpy(pred))
    np.testing.assert_array_equal(
        [float(c) for c in counts],
        [float(c) for c in metrics.confusion_counts(jnp.asarray(gt[..., 0]), jnp.asarray(pred))],
    )
    jac, dice = port_metrics.dice_jaccard(torch.from_numpy(gt[..., 0]), torch.from_numpy(pred))
    w_jac, w_dice = metrics.dice_jaccard(jnp.asarray(gt[..., 0]), jnp.asarray(pred))
    assert abs(float(jac) - float(w_jac)) <= 1e-7 and abs(float(dice) - float(w_dice)) <= 1e-7


def test_wrappers_on_cpu_run_the_plain_versions_and_count_nothing():
    logits, gt = (torch.from_numpy(a) for a in _inputs((1, 3, 4, 5), seed=2))
    scale = torch.tensor([0.25])
    before = (bce_dice_sums.launches, bce_dice_grads.launches)
    torch.testing.assert_close(bce_dice_sums(logits, gt), bce_dice_sums_reference(logits, gt), rtol=0, atol=0)
    torch.testing.assert_close(
        bce_dice_grads(logits, gt, scale), bce_dice_grads_reference(logits, gt, scale), rtol=0, atol=0
    )
    assert (bce_dice_sums.launches, bce_dice_grads.launches) == before
    with pytest.raises(ValueError):
        bce_dice_sums(logits, gt[..., :2, :])
    with pytest.raises(TypeError):
        bce_dice_sums(logits, gt.double())
    with pytest.raises(TypeError):  # the model's logits are float32; no bf16 variant
        bce_dice_grads(logits.bfloat16(), gt, scale)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


CUDA_SHAPES = [(1, 1, 1, 1), (1, 5, 7, 3), (2, 8, 8, 8), (3, 17, 19, 23), (16, 64, 64, 64), (16, 1, 128, 128)]


def _assert_kernels_match(logits, gt, s, full_size=True):
    """Both kernels against their plain versions on the card: loss sum within
    1e-5 relative, counts exact, the gradient at scale s within 1e-6 * s (and,
    where ``full_size``, of size about s, so that the limit is far under it)."""
    scale = torch.tensor([s], device=logits.device)
    got, d = bce_dice_sums(logits, gt), bce_dice_grads(logits, gt, scale)
    want, d_want = bce_dice_sums_reference(logits, gt), bce_dice_grads_reference(logits, gt, scale)
    torch.cuda.synchronize()
    assert got.shape == (4,) and got.dtype == torch.float32
    assert abs(got[0].item() - want[0].item()) <= 1e-5 * abs(want[0].item())
    assert got[1:].tolist() == want[1:].tolist()  # the counts are exact
    assert d.dtype == torch.float32 and d.shape == logits.shape
    assert d_want.abs().max().item() >= 0.5 * s or not full_size
    assert (d - d_want).abs().max().item() <= 1e-6 * s


@pytest.mark.parametrize("shape", CUDA_SHAPES)
@pytest.mark.parametrize("train_scale", [True, False])
@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions(cuda_device, shape, train_scale):
    """The gradient at the train step's scale s = 1/(2V) and at s = 1, each
    within 1e-6 * s (the gradient is (sigmoid(l) - t) * s, |.| <= s); three
    calls give the same bits."""
    logits, gt = (torch.from_numpy(a).to(cuda_device) for a in _inputs(shape, seed=len(shape)))
    s = 0.5 / logits[..., 0].numel() if train_scale else 1.0
    before = (bce_dice_sums.launches, bce_dice_grads.launches)
    _assert_kernels_match(logits, gt, s)
    assert (bce_dice_sums.launches, bce_dice_grads.launches) == (before[0] + 1, before[1] + 1)
    scale = torch.tensor([s], device=cuda_device)
    runs = [(bce_dice_sums(logits, gt), bce_dice_grads(logits, gt, scale)) for _ in range(3)]
    for sums, d in runs[1:]:  # the same on every run: a fixed order of summation, no float atomics
        assert torch.equal(sums, runs[0][0]) and torch.equal(d, runs[0][1])


# (logits, gt) storage offsets in floats: 16-byte aligned; the scalar path (no head
# aligns both); vector paths after a head of 3, 1 and 2 voxels (2: the gradient too)
OFFSETS = [(0, 0), (1, 0), (0, 1), (2, 1), (2, 3), (0, 2)]


@pytest.mark.parametrize("voxels", [4097, 4098, 4099, 5])  # V mod 4 = 1, 2, 3, and a V under one turn
@pytest.mark.parametrize("offsets", OFFSETS)
@pytest.mark.cuda
def test_cuda_kernels_ragged_and_unaligned(cuda_device, voxels, offsets):
    logits, gt = (torch.from_numpy(a) for a in _inputs((1, voxels, 1, 1), seed=voxels))
    lo, go = offsets
    lbuf = torch.empty(lo + logits.numel(), device=cuda_device)
    gbuf = torch.empty(go + gt.numel(), device=cuda_device)
    logits = lbuf[lo:].view(logits.shape).copy_(logits)
    gt = gbuf[go:].view(gt.shape).copy_(gt)
    assert logits.data_ptr() % 16 == 4 * lo and gt.data_ptr() % 16 == 4 * go
    for s in (0.5 / voxels, 1.0):
        _assert_kernels_match(logits, gt, s)


@pytest.mark.parametrize("case", EDGE_CASES)
@pytest.mark.cuda
def test_cuda_kernels_edge_cases(cuda_device, case):
    """The CPU edge cases on the card: both kernels against their plain
    versions (logits of +-30 test the fast sigmoid where it saturates), and
    the fused function against its CPU path."""
    logits, gt = _edge_inputs(case)
    x, g = torch.from_numpy(logits).to(cuda_device), torch.from_numpy(gt).to(cuda_device)
    v = logits.size // 2
    for s in (0.5 / v, 1.0):
        _assert_kernels_match(x, g, s, full_size=False)
    want = _port(logits, gt)
    x.requires_grad_()
    loss, jac, dice = fused_bce_dice_metrics(x, g)
    (grad,) = torch.autograd.grad(loss, x, torch.ones((), device=cuda_device))
    assert abs(loss.item() - want[0]) <= 1e-5 * abs(want[0])
    assert abs(jac.item() - want[1]) <= 1e-6 * abs(want[1]) and abs(dice.item() - want[2]) <= 1e-6 * abs(want[2])
    np.testing.assert_allclose(grad.cpu().numpy(), want[3], rtol=0, atol=1e-6 * 0.5 / v)


@pytest.mark.cuda
def test_cuda_fused_metrics_match_cpu_and_launch_one_kernel_each_way(cuda_device):
    """fused_bce_dice_metrics on the card against its CPU path (loss 1e-5
    relative, jaccard and dice 1e-6 relative, gradient 1e-6 * s), with one
    forward launch and one backward launch, and nothing else on the card."""
    shape = (16, 1, 128, 128)
    logits, gt = _inputs(shape, seed=5)
    want = _port(logits, gt)
    x = torch.from_numpy(logits).to(cuda_device).requires_grad_()
    g = torch.from_numpy(gt).to(cuda_device)
    one = torch.ones((), device=cuda_device)
    before = (bce_dice_sums.launches, bce_dice_grads.launches)
    loss, jac, dice = fused_bce_dice_metrics(x, g)
    assert (bce_dice_sums.launches, bce_dice_grads.launches) == (before[0] + 1, before[1])
    assert not jac.requires_grad and not dice.requires_grad and loss.requires_grad
    (grad,) = torch.autograd.grad(loss, x, one)
    assert (bce_dice_sums.launches, bce_dice_grads.launches) == (before[0] + 1, before[1] + 1)
    got = (loss.item(), jac.item(), dice.item())
    assert all(t.shape == () and t.dtype == torch.float32 for t in (loss, jac, dice))
    assert abs(got[0] - want[0]) <= 1e-5 * abs(want[0])
    assert abs(got[1] - want[1]) <= 1e-6 * abs(want[1]) and abs(got[2] - want[2]) <= 1e-6 * abs(want[2])
    np.testing.assert_allclose(grad.cpu().numpy(), want[3], rtol=0, atol=1e-6 * 0.5 / (logits.size // 2))

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            loss, _, _ = fused_bce_dice_metrics(x, g)
            torch.autograd.grad(loss, x, one)
        torch.cuda.synchronize()
    kernels = {e.key: e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA}
    assert len(kernels) == 2 and sorted(kernels.values()) == [3, 3], kernels
    assert any("bce_dice_forward" in k for k in kernels) and any("bce_dice_backward" in k for k in kernels)


@pytest.mark.cuda
def test_cuda_kernels_on_two_streams(cuda_device):
    """Calls interleaved on two streams, each with its own workspace, give
    the results of calls on one stream."""
    inputs = [tuple(torch.from_numpy(a).to(cuda_device) for a in _inputs((4, 33, 32, 31), seed=k)) for k in (1, 2)]
    scale = torch.tensor([0.5], device=cuda_device)
    want = [(bce_dice_sums(lg, g).clone(), bce_dice_grads(lg, g, scale)) for lg, g in inputs]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    got = [[], []]
    for _ in range(5):
        for k, st in enumerate(streams):
            with torch.cuda.stream(st):
                lg, g = inputs[k]
                got[k].append((bce_dice_sums(lg, g), bce_dice_grads(lg, g, scale)))
    torch.cuda.synchronize()
    for k in range(2):
        for sums, d in got[k]:
            assert torch.equal(sums, want[k][0]) and torch.equal(d, want[k][1])


@pytest.mark.cuda
def test_cuda_loss_path_replays_in_a_cuda_graph(cuda_device):
    """Forward and backward captured in one CUDA graph: the replay, on new
    logits copied into the captured input, gives the bits of an eager call
    (the capture takes a workspace of its own, zeroed by a memset that every
    replay runs)."""
    shape = (16, 1, 128, 128)
    first, gt = (torch.from_numpy(a).to(cuda_device) for a in _inputs(shape, seed=3))
    second = torch.from_numpy(_inputs(shape, seed=4)[0]).to(cuda_device)
    x = first.clone().requires_grad_()
    one = torch.ones((), device=cuda_device)

    def step():
        loss, jac, dice = fused_bce_dice_metrics(x, gt)
        (grad,) = torch.autograd.grad(loss, x, one)
        return loss, jac, dice, grad

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()  # warm-up off the default stream, as capture asks
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = step()
    for logits in (first, second, first):
        with torch.no_grad():
            x.copy_(logits)
        graph.replay()
        eager = step()
        torch.cuda.synchronize()
        for got, want in zip(captured, eager):
            assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_capture_first_then_eager_calls_and_a_second_graph_on_the_capture_stream(cuda_device):
    """The first call on a stream is made in a CUDA graph capture: an eager
    call on that stream before any replay, a second graph captured on it, and
    the replays of both give the results of calls on other streams."""
    shape = (4, 33, 32, 31)
    logits, gt = (torch.from_numpy(a).to(cuda_device) for a in _inputs(shape, seed=6))
    scale = torch.tensor([0.5], device=cuda_device)
    want = (bce_dice_sums(logits, gt).clone(), bce_dice_grads(logits, gt, scale))
    x = logits.clone().requires_grad_()
    one = torch.ones((), device=cuda_device)

    def step():  # outputs detached: no autograd graph outlives a step
        loss, jac, dice = fused_bce_dice_metrics(x, gt)
        return tuple(t.detach() for t in (loss, jac, dice, torch.autograd.grad(loss, x, one)[0]))

    side, capture = torch.cuda.Stream(), torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        want_step = step()  # warm-up off the default stream, as capture asks, and never on `capture`
    capture.wait_stream(side)
    graphs = [torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()]
    with torch.cuda.graph(graphs[0], stream=capture):
        captured = [step()]
    # a workspace made in a capture holds no zeros until a replay: none is kept for eager calls
    assert not any(stream == capture.cuda_stream for _, stream in fused_bce_dice._WORKSPACES)
    with torch.cuda.stream(capture):
        eager = [(bce_dice_sums(logits, gt), bce_dice_grads(logits, gt, scale)) for _ in range(2)]
    assert any(stream == capture.cuda_stream for _, stream in fused_bce_dice._WORKSPACES)
    with torch.cuda.graph(graphs[1], stream=capture):
        captured.append(step())
    torch.cuda.current_stream().wait_stream(capture)
    torch.cuda.synchronize()
    for sums, d in eager:
        assert torch.equal(sums, want[0]) and torch.equal(d, want[1])
    for _ in range(2):
        for graph, outs in zip(graphs, captured):
            graph.replay()
            torch.cuda.synchronize()
            for got, expected in zip(outs, want_step):
                assert torch.equal(got, expected)
