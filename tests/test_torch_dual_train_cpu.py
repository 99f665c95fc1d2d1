"""Dual-train proxy, the port against the JAX package: the counterpart of
scripts/dual_train_proxy.py (which trains the JAX package against the
reference tree) with the port in the reference's place.

Both train the hiera_test SAM2-UNet from one init (the JAX package's,
moved into the port by `interop/from_jax.py`) on the same synthetic discs
(`make_data`: pre-letterboxed, normalised once in numpy, fed to both
byte-identically in a fixed order, no augmentation), 8 images at 64 px in
batches of 4, 3 epochs of AdamW with the cosine schedule at its per-step
rate. The JAX package trains on one device and saves its train state after
the first epoch (`save_train_state`); the port trains its first epoch on 2
gloo ranks with SyncBN from the shared init, then resumes from that
JAX-written state and trains the other two epochs on the 2 ranks. Compared:
the loss curve, step by step, and the final evaluation report (the
reference's test postprocess, then the port's evaluator for both sides'
predictions).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_dist_worker import run_ranks

from sam2unet_torch.configs import HIERA_TEST as PORT_HIERA_TEST
from sam2unet_torch.configs import SAM2UNetConfig as PortConfig
from sam2unet_torch.eval.metrics import (
    evaluate_dataset,
    evaluate_segmentation_performance,
)
from sam2unet_torch.interop.from_jax import jax_to_state_dict
from sam2unet_torch.models.sam2unet import SAM2UNet as PortSAM2UNet
from sam2unet_tpu.configs import HIERA_TEST, SAM2UNetConfig
from sam2unet_tpu.models.sam2unet import SAM2UNet
from sam2unet_tpu.train.checkpoints import save_train_state
from sam2unet_tpu.train.engine import create_train_state, make_train_step
from sam2unet_tpu.train.optim import make_optimizer
from scripts.dual_train_proxy import make_data, postprocess

SIZE, N_TRAIN, N_TEST, BATCH, EPOCHS, LR, WD = 64, 8, 4, 4, 3, 1e-3, 5e-4
RESUME_EPOCH = 1
# fp32 both sides, SyncBN's moments against flax's global-batch BatchNorm,
# sums in other orders: measured 2.9e-6 on the losses and 5.4e-6 on mIoU
# and mDice; bounds 1e-4 and 1e-3 (the reference proxy allows 5e-3)
LOSS_ATOL, REPORT_TOL = 1e-4, 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the suite runs several test processes on the
    machine's cores, where torch's own thread pool would oversubscribe
    them and a small train step would take seconds."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _report(logits: list[np.ndarray], y_test: np.ndarray) -> dict:
    gts = [(y[..., 0] * 255).astype(np.uint8) for y in y_test]
    return evaluate_dataset([evaluate_segmentation_performance(postprocess(l), g)
                             for l, g in zip(logits, gts)])


@pytest.fixture(scope="module")
def dual(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dual")
    x_tr, y_tr = make_data(N_TRAIN, SIZE, 0)
    x_te, y_te = make_data(N_TEST, SIZE, 1)
    model = SAM2UNet(SAM2UNetConfig(trunk=HIERA_TEST))
    variables = jax.jit(model.init)(jax.random.PRNGKey(0),
                                    jnp.zeros((1, SIZE, SIZE, 3)))
    spe = N_TRAIN // BATCH
    opt = make_optimizer(lr=LR, weight_decay=WD, epochs=EPOCHS,
                         steps_per_epoch=spe)
    state = create_train_state(variables, opt)
    step = make_train_step(model, opt, donate=False)
    jax_losses = []
    for epoch in range(EPOCHS):
        if epoch == RESUME_EPOCH:
            save_train_state(str(tmp / "jax_state"), state)
        for b in range(0, N_TRAIN, BATCH):
            state, metrics = step(state, x_tr[b: b + BATCH], y_tr[b: b + BATCH])
            jax_losses.append(float(metrics["loss"]))
    apply = jax.jit(lambda v, x: model.apply(v, x, train=False)[0])
    jax_logits = [np.asarray(apply(state.variables(), x_te[i: i + 1]))[0, ..., 0]
                  for i in range(N_TEST)]

    keys = PortSAM2UNet(PortConfig(trunk=PORT_HIERA_TEST)).state_dict().keys()
    init = jax_to_state_dict(jax.tree.map(np.asarray, variables), keys)
    ranks = run_ranks("dual", {
        "state": init, "x": torch.from_numpy(x_tr), "y": torch.from_numpy(y_tr),
        "x_test": torch.from_numpy(x_te), "batch": BATCH, "epochs": EPOCHS,
        "lr": LR, "wd": WD, "resume_epoch": RESUME_EPOCH,
        "resume": str(tmp / "jax_state")}, tmp / "ranks")
    return dict(jax_losses=jax_losses, ranks=ranks,
                jax_report=_report(jax_logits, y_te),
                port_report=_report([l.numpy() for l in ranks[0]["logits"]],
                                    y_te))


def test_the_loss_curves_agree(dual):
    """Every step's global loss, the first epoch's from the shared init and
    the others' from the JAX-written state, within LOSS_ATOL."""
    r0, r1 = dual["ranks"]
    assert r0["step"] == r1["step"] == EPOCHS * N_TRAIN // BATCH
    assert r0["losses"] == r1["losses"]
    assert len(r0["losses"]) == len(dual["jax_losses"]) == 6
    np.testing.assert_allclose(r0["losses"], dual["jax_losses"], rtol=0,
                               atol=LOSS_ATOL)


def test_the_final_reports_agree(dual):
    """mIoU and mDice of the final models within REPORT_TOL; the same
    number of ground-truth instances."""
    got, want = dual["port_report"], dual["jax_report"]
    for k in ("mIoU", "mDice"):
        assert abs(float(got[k]) - float(want[k])) <= REPORT_TOL, (k, got[k], want[k])
    assert got["images_count"] == want["images_count"] >= N_TEST
