"""The port's training path against the JAX package's, on the CPU in fp32.

One train step from shared parameters on a shared batch, at the narrow
trunk with hiera_l's geometry at 352 of tests/test_torch_model_cpu.py
(batch 2): strips (K5's plain version), transitions (K9's), valid groups
with n_pad = 0 (K7's) and with the pad key (the reference recompute), a
global block, the plain stage 3->4 transition, tails (K2's) and adapters
(K3's). The JAX side is `jax.value_and_grad` of the engine's loss with
`batch_stats` mutable, then optax's AdamW; the port's is `train_step`.
Compared: the loss, every trainable gradient, the BatchNorm statistics and
the parameters after the AdamW step. A second step at hiera_s's geometry
(windows 8/4/14/7) at 576 px, where the global block has 1296 tokens: past
`long_sequence` and past 1024, so its backward route is K11, and the
port's global block runs as the card's autograd node (the long form and
`_long_window_block_backward`, each kernel wrapper inside it taking its
plain version on CPU tensors). There also: `remat=True` gives the same loss
and gradients. Also the data pipeline, the loss, the device metrics and the
eval postprocess against the JAX package's.

BatchNorm running variance: the port keeps torch's convention (the
reference's), the unbiased batch variance n/(n-1) var; the JAX package
stores the biased one (tests/test_train_semantics.py:31-41). The test
converts between the two with each layer's n.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_model_960_cpu import TRUNK as TRUNK_960
from test_torch_model_cpu import TRUNK, _perturb

from sam2unet_torch.configs import HieraConfig as PortHieraConfig
from sam2unet_torch.configs import SAM2UNetConfig as PortConfig
from sam2unet_torch.data.dataset import EvalDataset as PortEvalDataset
from sam2unet_torch.data.dataset import TrainDataset as PortTrainDataset
from sam2unet_torch.eval.metrics_device import (
    batched_semantic_metrics as port_metrics,
)
from sam2unet_torch.interop.from_jax import jax_to_state_dict
import sam2unet_torch.models.hiera as port_hiera
import sam2unet_torch.ops.fused_attention_block as port_fab
from sam2unet_torch.models.sam2unet import SAM2UNet as PortSAM2UNet
from sam2unet_torch.ops.pooling import avg_pool2d_same as port_avg_pool
from sam2unet_torch.train import engine as port_engine
from sam2unet_torch.train.loss import multi_head_loss as port_loss
from sam2unet_torch.train.optim import is_trainable, make_optimizer
from sam2unet_tpu.configs import HieraConfig, SAM2UNetConfig
from sam2unet_tpu.data.dataset import EvalDataset, TrainDataset
from sam2unet_tpu.eval.metrics_device import batched_semantic_metrics
from sam2unet_tpu.models.sam2unet import SAM2UNet
from sam2unet_tpu.ops.pooling import avg_pool2d_same
from sam2unet_tpu.train import engine
from sam2unet_tpu.train.loss import multi_head_loss
from sam2unet_tpu.train.optim import make_optimizer as jax_optimizer
from sam2unet_tpu.train.optim import merge_params, partition_params

SIZE, BATCH = 352, 2
LR, WD, EPOCHS = 1e-3, 5e-4, 4
# fp32 both sides, sums in other orders. The loss agrees to 1e-5 relative.
# The gradients of the neck and decoder are ill-conditioned here: train-mode
# BatchNorm chains with ReLU and max-pool kinks, so the port's own fp32
# gradients move by up to 4.2e-3 of a leaf's max |g| between 1 and 8 CPU
# threads (summation order alone), and by 4.0e-3 under a 1e-6 relative
# change of the input. Against the JAX package the worst leaf differs by
# 9.9e-3 of its max |g| (L2 8e-3, correlation >= 0.99997; measured). Bounds:
# 2e-2 of the leaf's max |g|, and correlation >= 0.9999 per leaf.
LOSS_RTOL, GRAD_TOL, GRAD_CORR = 1e-5, 2e-2, 0.9999


def _batch(rng):
    x = rng.standard_normal((BATCH, SIZE, SIZE, 3)).astype(np.float32)
    yy, xx = np.mgrid[:SIZE, :SIZE]
    masks = [((yy - cy) ** 2 + (xx - cx) ** 2 < r * r)
             for cy, cx, r in ((150, 180, 90), (200, 120, 60))]
    y = np.stack(masks)[..., None].astype(np.float32)
    return x, y


def _unflatten(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = np.asarray(v)
    return out


def _one_step(trunk: dict, x: np.ndarray, y: np.ndarray) -> dict:
    """One train step on both sides from shared parameters: (JAX results,
    port model after the step, port results)."""
    size = x.shape[1]
    model = SAM2UNet(SAM2UNetConfig(trunk=HieraConfig(**trunk)))
    x0 = np.zeros((1, size, size, 3), np.float32)
    variables = jax.jit(model.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), x0, train=False)
    variables = _perturb(dict(jax.tree_util.tree_map(np.asarray, variables)),
                         np.random.default_rng(0))

    trainable, frozen = partition_params(variables["params"])

    def loss_fn(tr):
        preds, new = model.apply(
            {"params": merge_params(tr, frozen),
             "batch_stats": variables["batch_stats"]},
            x, train=True, mutable=["batch_stats"])
        return multi_head_loss(preds, y), new["batch_stats"]

    (loss, new_stats), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(trainable)
    opt = jax_optimizer(lr=LR, weight_decay=WD, epochs=EPOCHS,
                        steps_per_epoch=1)
    updates, _ = opt.update(grads, opt.init(trainable), trainable)
    new_params = jax.tree_util.tree_map(lambda p, u: p + u, trainable, updates)

    port = PortSAM2UNet(PortConfig(trunk=PortHieraConfig(**trunk)))
    state = jax_to_state_dict(variables, port.state_dict().keys())
    port.load_state_dict(state, strict=True)
    names = [n for n, p in port.named_parameters() if is_trainable(n)]
    jax_grads = jax_to_state_dict({"params": _unflatten(grads)}, names)
    jax_new = jax_to_state_dict({"params": _unflatten(new_params)}, names)
    jax_stats = jax_to_state_dict(
        {"batch_stats": jax.tree_util.tree_map(np.asarray, new_stats)},
        [k for k in state if k.endswith(("running_mean", "running_var"))])

    bn_n = {}
    for name, mod in port.named_modules():
        if isinstance(mod, torch.nn.BatchNorm2d):
            mod.register_forward_hook(
                lambda m, a, o, name=name: bn_n.__setitem__(
                    name, a[0].numel() // a[0].shape[1]))
    optimizer = make_optimizer(port, lr=LR, weight_decay=WD)
    got_loss = port_engine.train_step(port, optimizer, torch.from_numpy(x),
                                      torch.from_numpy(y))
    return dict(loss=float(loss), jax_grads=jax_grads, jax_new=jax_new,
                jax_stats=jax_stats, old=state, port=port, got_loss=float(got_loss),
                names=names, bn_n=bn_n)


@pytest.fixture(scope="module")
def step():
    return _one_step(TRUNK, *_batch(np.random.default_rng(5)))


def test_train_step_loss_matches_jax(step):
    assert abs(step["got_loss"] - step["loss"]) <= LOSS_RTOL * abs(step["loss"])


def _assert_grads_match(step):
    params = dict(step["port"].named_parameters())
    assert len(step["names"]) == len(step["jax_grads"]) > 0
    for name in step["names"]:
        g, want = params[name].grad, step["jax_grads"][name]
        assert g is not None, name
        scale = float(want.abs().max())
        err = float((g - want).abs().max())
        assert err <= GRAD_TOL * scale, (name, err, scale)
        if g.numel() > 1:
            pair = torch.stack([g.flatten(), want.flatten()]).double()
            assert float(torch.corrcoef(pair)[0, 1]) >= GRAD_CORR, name


def test_train_step_grads_match_jax(step):
    _assert_grads_match(step)


def test_only_the_trainable_set_gets_gradients(step):
    """The frozen trunk and the never-called up4 get none."""
    for name, p in step["port"].named_parameters():
        assert (p.grad is not None) == (name in step["names"]), name


def test_batchnorm_statistics_match_jax(step):
    """Running means to 1e-5 of their max; running variances in torch's
    unbiased convention, old*0.9 + 0.1*var*n/(n-1) with the JAX package's
    biased var recovered from its update, to 1e-4 (flax takes the batch
    variance as E[x^2] - E[x]^2, torch in two passes: measured 1.2e-5)."""
    buffers = dict(step["port"].named_buffers())
    for key, want in step["jax_stats"].items():
        got, old = buffers[key], step["old"][key]
        layer = key.rsplit(".", 1)[0]
        if layer not in step["bn_n"]:  # up4, never called: unchanged
            assert torch.equal(got, old) and torch.equal(want, old), key
            continue
        tol = 1e-5
        if key.endswith("running_var"):
            n = step["bn_n"][layer]
            want = 0.9 * old + (want - 0.9 * old) * n / (n - 1)
            tol = 1e-4
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= tol * scale, key


def test_adamw_step_matches_jax(step):
    """Parameters after one AdamW step. Adam's first update is
    g / (|g| + eps), +-1 for any gradient well above eps, so an element whose
    gradient is within the gradient tolerance of zero may move by up to
    2 lr in one framework and not the other; every other element agrees to
    1e-2 lr (its update is +-lr plus the weight decay in both)."""
    params = dict(step["port"].named_parameters())
    for name in step["names"]:
        g = step["jax_grads"][name]
        near_zero = g.abs() <= GRAD_TOL * float(g.abs().max())
        allowed = torch.where(near_zero, torch.full_like(g, 2 * LR),
                              torch.full_like(g, 1e-2 * LR))
        err = (params[name].detach() - step["jax_new"][name]).abs()
        assert bool((err <= allowed).all()), (name, float(err.max()))


# ---------------------------------------- hiera_s's geometry, the K11 route

SIZE_960 = 576   # grids 144/72/36/18: the global block sees 36 * 36 tokens


def _batch_960(rng):
    x = rng.standard_normal((1, SIZE_960, SIZE_960, 3)).astype(np.float32)
    yy, xx = np.mgrid[:SIZE_960, :SIZE_960]
    y = ((yy - 250) ** 2 + (xx - 300) ** 2 < 150 ** 2)
    return x, y[None, ..., None].astype(np.float32)


def _card_node_for_long_blocks(mp, seen):
    """Make hiera.py's `fused_window_block` record, for a window past 1024
    tokens, the autograd node it records on the card (forward
    `_window_block_kernel`, which takes the long form there, backward
    `_window_block_backward`), on the CPU tensors of the test: the kernel
    wrappers inside take their plain versions."""
    real, real_bwd = port_hiera.fused_window_block, port_fab.flash_attention_bwd

    def block(x, *weights, num_heads, n_pad=0, residual=True):
        if x.shape[1] <= 1024:
            return real(x, *weights, num_heads=num_heads, n_pad=n_pad,
                        residual=residual)
        seen.append(("long", x.shape[1]))
        assert port_fab.long_sequence(x.shape[1], x.shape[2])
        assert port_fab.window_block_bwd_route(x.shape[1], x.shape[2], 0,
                                               False) == "K11"
        return port_fab._differentiable(
            port_fab._window_block_kernel, port_fab._window_block_backward, x,
            weights, num_heads=num_heads, n_pad=n_pad, residual=residual)

    def bwd(*a, **k):
        seen.append(("K11", a[0].shape[1]))
        return real_bwd(*a, **k)

    mp.setattr(port_hiera, "fused_window_block", block)
    mp.setattr(port_fab, "flash_attention_bwd", bwd)


@pytest.fixture(scope="module")
def step_960():
    seen = []
    with pytest.MonkeyPatch.context() as mp:
        _card_node_for_long_blocks(mp, seen)
        out = _one_step(TRUNK_960, *_batch_960(np.random.default_rng(6)))
    return dict(out, seen=seen)


def test_train_step_through_the_k11_route_matches_jax(step_960):
    """Loss and every trainable gradient, with the 1296-token global block
    differentiated through the long form's backward (K10 again, then K11's
    plain version) where the JAX package differentiates its XLA recompute."""
    assert step_960["seen"] == [("long", 1296), ("K11", 1296)]
    assert (abs(step_960["got_loss"] - step_960["loss"])
            <= LOSS_RTOL * abs(step_960["loss"]))
    _assert_grads_match(step_960)


def test_remat_gives_the_same_loss_and_gradients(step_960):
    """`remat=True` (each trunk block under torch.utils.checkpoint) changes
    what is kept, not what is computed: the same loss and gradients, on the
    card's node for the long block too."""
    x, y = (torch.from_numpy(a) for a in _batch_960(np.random.default_rng(6)))
    runs = []
    for remat in (False, True):
        port = PortSAM2UNet(PortConfig(trunk=PortHieraConfig(**TRUNK_960)),
                            remat=remat).train()
        port.load_state_dict(step_960["old"], strict=True)
        seen = []
        with pytest.MonkeyPatch.context() as mp:
            _card_node_for_long_blocks(mp, seen)
            loss = port_loss(port(x), y)
            loss.backward()
        # with remat the block's forward runs again in the backward
        assert [k for k, _ in seen] == ["long"] * (1 + remat) + ["K11"]
        runs.append((float(loss.detach()), {n: p.grad for n, p in port.named_parameters()
                                   if p.grad is not None}))
    (l0, g0), (l1, g1) = runs
    assert l0 == l1 and g0.keys() == g1.keys() and len(g0) == len(step_960["names"])
    for n in g0:
        scale = float(g0[n].abs().max())
        assert float((g1[n] - g0[n]).abs().max()) <= 1e-6 * scale, n


# ------------------------------------------------------------ the rest


def _images(root, n, rng):
    for split in ("images", "masks"):
        (root / split).mkdir(parents=True)
    for i in range(n):
        h, w = int(rng.integers(60, 120)), int(rng.integers(60, 120))
        img = (rng.random((h, w, 3)) * 255).astype(np.uint8)
        mask = ((rng.random((h, w)) > 0.6) * 255).astype(np.uint8)
        Image.fromarray(img).save(root / "images" / f"s{i}.jpg")
        Image.fromarray(mask).save(root / "masks" / f"s{i}.png")


def test_train_batches_match_jax(tmp_path, monkeypatch):
    """Same order, per-sample seeds and augmentation (PIL decode on both
    sides), for two epochs, with a wrap-filled tail batch."""
    monkeypatch.setenv("SAM2UNET_NO_NATIVE_LOADER", "1")
    _images(tmp_path, 5, np.random.default_rng(0))
    args = (str(tmp_path / "images"), str(tmp_path / "masks"), 64)
    for epoch in (0, 1):
        want = list(TrainDataset(*args, seed=3).epoch(2, epoch, num_workers=2))
        got = list(PortTrainDataset(*args, seed=3).epoch(2, epoch,
                                                         num_workers=2))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert g.valid == w.valid
            np.testing.assert_allclose(g.image, w.image, rtol=0, atol=1e-6)
            np.testing.assert_array_equal(g.label, w.label)


def test_eval_batches_with_letterboxed_gt_match_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("SAM2UNET_NO_NATIVE_LOADER", "1")
    _images(tmp_path, 3, np.random.default_rng(1))
    args = (str(tmp_path / "images"), str(tmp_path / "masks"), 64)
    for g, w in zip(PortEvalDataset(*args).batches(2, letterbox_gt=True),
                    EvalDataset(*args).batches(2, letterbox_gt=True)):
        np.testing.assert_allclose(g["image"], w["image"], atol=1e-6)
        np.testing.assert_array_equal(g["gt_letterboxed"], w["gt_letterboxed"])
        assert [tuple(p) for p in g["padding"]] == [
            tuple(p) for p in w["padding"][: w["valid"]]]


@pytest.mark.parametrize("weighted_bce", [False, True])
def test_loss_matches_jax(weighted_bce):
    rng = np.random.default_rng(2)
    preds = [rng.standard_normal((2, 40, 48, 1)).astype(np.float32) * 3
             for _ in range(3)]
    mask = (rng.random((2, 40, 48, 1)) > 0.7).astype(np.float32)
    want = multi_head_loss([jnp.asarray(p) for p in preds], jnp.asarray(mask),
                           weighted_bce)
    got = port_loss([torch.from_numpy(p) for p in preds],
                    torch.from_numpy(mask), weighted_bce)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_avg_pool2d_same_matches_jax():
    x = np.random.default_rng(3).random((2, 40, 37, 1)).astype(np.float32)
    np.testing.assert_allclose(port_avg_pool(torch.from_numpy(x), 31).numpy(),
                               np.asarray(avg_pool2d_same(jnp.asarray(x), 31)),
                               rtol=1e-5, atol=1e-6)


def test_device_metrics_and_postprocess_match_jax():
    rng = np.random.default_rng(4)
    b, size = 4, 48
    logits = rng.standard_normal((b, size, size, 1)).astype(np.float32) * 2
    pads = np.array([[3, 0, 5, 0], [0, 7, 0, 2], [0, 0, 0, 0], [1, 1, 1, 1]],
                    np.int32)
    gt = (rng.random((b, size, size)) > 0.5).astype(np.float32) * 255
    valid = np.arange(b) < 3
    want_p = engine.postprocess_logits(jnp.asarray(logits), jnp.asarray(pads),
                                       size)[..., 0]
    want_pix = engine.letterbox_valid_mask(jnp.asarray(pads), size, size,
                                           size)[..., 0]
    want = batched_semantic_metrics(want_p, jnp.asarray(gt), jnp.asarray(valid),
                                    want_pix)
    tp = torch.from_numpy(pads.astype(np.int64))
    got_p = port_engine.postprocess_logits(torch.from_numpy(logits), tp,
                                           size)[..., 0]
    got_pix = port_engine.letterbox_valid_mask(tp, size, size, size)[..., 0]
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(got_pix.numpy(), np.asarray(want_pix))
    got = port_metrics(got_p, torch.from_numpy(gt), torch.from_numpy(valid),
                       got_pix)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
