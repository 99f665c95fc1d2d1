"""The port's data parallelism (`parallel/mesh.py`, `SyncBatchNorm2d`, the
train step and the train CLI across ranks) on the CPU: two ranks, each a
process on gloo over localhost with one torch thread
(tests/torch_dist_worker.py), joined under a deadline of 120 s.

  (a) SyncBatchNorm2d at 2 ranks against nn.BatchNorm2d in one process on
      the whole batch: output, running statistics, input and weight
      gradients, fp32.
  (b) the 2-rank port step (hiera_test, SyncBN, SGD) against the JAX
      package's shard_map step on a 2-device mesh (`bn_axis=DATA_AXIS`):
      the loss, the trainable parameters and the BatchNorm statistics at
      tests/test_torch_train_cpu.py's one-step tolerances.
  (c) `shard_batch` and the dataset's rows: a rank's rows are those of the
      one-process batch, augmentation and the wrap-filled tail included.
  (d) a batch that does not split over the ranks exits with the JAX CLI's
      message.
  (e) the train CLI on 2 ranks: only rank 0 writes (every write under the
      save path recorded by an audit hook), and its parameters are the
      1-process run's; its two evaluators give every rank the one-process
      report.
  (f) `make_mesh` picks the card torchrun gives a rank, or the one asked
      for without torchrun (two cards, mocked).
  (g) the model's SyncBatchNorm2d's fold and export.
"""

from __future__ import annotations

import jax
import numpy as np
import optax
import pytest
import torch
from test_torch_model_cpu import _perturb
from torch_dist_worker import run_ranks

from sam2unet_torch.cli import train_cli
from sam2unet_torch.configs import HIERA_TEST as PORT_HIERA_TEST
from sam2unet_torch.configs import SAM2UNetConfig as PortConfig
from sam2unet_torch.data.dataset import TrainDataset as PortTrainDataset
from sam2unet_torch.interop.from_jax import jax_to_state_dict
from sam2unet_torch.models.sam2unet import SAM2UNet as PortSAM2UNet
from sam2unet_torch.parallel import mesh as port_mesh
from sam2unet_torch.train.optim import is_trainable
from sam2unet_tpu.cli import train_cli as jax_cli
from sam2unet_tpu.configs import HIERA_TEST, SAM2UNetConfig
from sam2unet_tpu.models.sam2unet import SAM2UNet
from sam2unet_tpu.parallel.mesh import DATA_AXIS, make_mesh
from sam2unet_tpu.train.engine import create_train_state, make_train_step

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the suite runs several test processes on the
    machine's cores, where torch's own thread pool would oversubscribe
    them and a small train step would take seconds."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# (a): fp32, the one-process form sums in two passes and SyncBN from the
# moments: 1e-5 of each tensor's max
BN_TOL = 1e-5


def test_syncbn_at_two_ranks_equals_batchnorm_on_the_whole_batch(tmp_path):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((4, 6, 5, 7)).astype(np.float32) + 3)
    w_out = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    bn = torch.nn.BatchNorm2d(6, eps=1e-5)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, 6).astype(np.float32)))
        bn.bias.copy_(torch.from_numpy(rng.standard_normal(6).astype(np.float32)))
        bn.running_mean.uniform_(-1, 1)
        bn.running_var.uniform_(0.5, 2)
    spec = {"x": x, "w_out": w_out,
            "state": {k: v.clone() for k, v in bn.state_dict().items()}}
    ranks = run_ranks("syncbn", spec, tmp_path)
    xg = x.clone().requires_grad_(True)
    y = bn.train()(xg)
    (y * w_out).sum().backward()

    def close(got, want):
        assert float((got - want).abs().max()) <= BN_TOL * float(want.abs().max())

    close(torch.cat([r["y"] for r in ranks]), y.detach())
    close(torch.cat([r["x_grad"] for r in ranks]), xg.grad)
    close(sum(r["weight_grad"] for r in ranks), bn.weight.grad)
    close(sum(r["bias_grad"] for r in ranks), bn.bias.grad)
    for r in ranks:
        for k in ("running_mean", "running_var"):
            close(r["state"][k], bn.state_dict()[k])
        assert int(r["state"]["num_batches_tracked"]) == 1


# (b): from the same perturbed start (every BatchNorm statistic and gain
# off its init), the one-step tolerances of tests/test_torch_train_cpu.py: the loss
# to 1e-5 relative, each leaf's gradient (here its SGD step over the rate)
# to 2e-2 of its max and correlation 0.9999, the running means to 1e-5 and
# variances to 1e-4 of their max. A leaf whose gradient is zero by
# construction (a BatchNorm bias whose shift the next BatchNorm removes,
# rounding noise ~1e-10) is held to 1e-6 of the largest gradient.
LOSS_RTOL, GRAD_TOL, GRAD_CORR, NOISE = 1e-5, 2e-2, 0.9999, 1e-6
SGD_LR, SIZE = 0.1, 64


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    model = SAM2UNet(SAM2UNetConfig(trunk=HIERA_TEST), bn_axis=DATA_AXIS)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0),
                                    jax.numpy.zeros((1, SIZE, SIZE, 3)))
    variables = _perturb(dict(jax.tree.map(np.asarray, variables)),
                         np.random.default_rng(0))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, SIZE, SIZE, 3)).astype(np.float32)
    y = (rng.random((4, SIZE, SIZE, 1)) > 0.5).astype(np.float32)
    opt = optax.sgd(SGD_LR)
    step = make_train_step(model, opt, mesh=make_mesh(2), donate=False,
                           use_shard_map=True)
    state, metrics = step(create_train_state(variables, opt), x, y)
    keys = PortSAM2UNet(PortConfig(trunk=PORT_HIERA_TEST)).state_dict().keys()
    start = jax_to_state_dict(variables, keys)
    ranks = run_ranks("step", {"state": start, "x": torch.from_numpy(x),
                               "y": torch.from_numpy(y), "lr": SGD_LR},
                      tmp_path_factory.mktemp("step"))
    want = jax_to_state_dict(jax.tree.map(np.asarray, state.variables()), keys)
    return dict(start=start, want=want, loss=float(metrics["loss"]), ranks=ranks)


def test_two_rank_step_loss_matches_the_jax_shard_map_step(steps):
    for r in steps["ranks"]:   # the global mean on every rank
        assert abs(r["loss"] - steps["loss"]) <= LOSS_RTOL * abs(steps["loss"])


def test_two_rank_step_parameters_match_the_jax_shard_map_step(steps):
    start, want = steps["start"], steps["want"]
    got0, got1 = (r["state"] for r in steps["ranks"])
    names = [k for k in start if is_trainable(k) and not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))]
    grads = {k: (start[k] - want[k]) / SGD_LR for k in names}
    top = max(float(g.abs().max()) for g in grads.values())
    for k in start:
        assert torch.equal(got0[k], got1[k]), k    # replicas stay equal
        if k not in names:
            continue
        g, gw = (start[k] - got0[k]) / SGD_LR, grads[k]
        scale = float(gw.abs().max())
        if scale < NOISE * top:
            assert float((g - gw).abs().max()) <= NOISE * top, k
            continue
        assert float((g - gw).abs().max()) <= GRAD_TOL * scale, k
        if g.numel() > 1:
            pair = torch.stack([g.flatten(), gw.flatten()]).double()
            assert float(torch.corrcoef(pair)[0, 1]) >= GRAD_CORR, k
    frozen = [k for k in start if not is_trainable(k) and "running" not in k
              and "num_batches" not in k]
    assert frozen and all(torch.equal(got0[k], start[k]) for k in frozen)


def test_two_rank_step_batchnorm_statistics_match_the_jax_shard_map_step(steps):
    """The JAX package keeps the biased variance, the port torch's unbiased
    one over the global count n: old*0.9 + 0.1*var*n/(n-1)."""
    start, want, r0 = steps["start"], steps["want"], steps["ranks"][0]
    checked = 0
    for key in start:
        if not key.endswith(("running_mean", "running_var")):
            continue
        layer = key.rsplit(".", 1)[0]
        got, old, w = r0["state"][key], start[key], want[key]
        if layer not in r0["bn_n"]:     # up4, never called
            assert torch.equal(got, old) and torch.equal(w, old), key
            continue
        tol = 1e-5
        if key.endswith("running_var"):
            n = r0["bn_n"][layer]
            w = 0.9 * old + (w - 0.9 * old) * n / (n - 1)
            tol = 1e-4
        assert float((got - w).abs().max()) <= tol * float(w.abs().max()), key
        checked += 1
    assert checked > 50


def test_a_ranks_rows_are_the_one_process_batchs(tmp_path, monkeypatch):
    """`shard_batch` / `rows` split a batch of 8 over 2 and 4 ranks into
    consecutive equal parts; a rank's rows of the train dataset's batches
    (augmented, shuffled, the tail wrap-filled) equal those rows of the
    whole batch, bit for bit; a batch that does not split raises."""
    from test_torch_train_cli_cpu import _write_split

    monkeypatch.setenv("SAM2UNET_NO_NATIVE_LOADER", "1")
    batch = np.arange(8 * 3).reshape(8, 3)
    for world in (1, 2, 4):
        parts = [port_mesh.shard_batch(port_mesh.Mesh(r, world, CPU), batch)
                 for r in range(world)]
        assert torch.equal(torch.cat(parts), torch.from_numpy(batch))
        assert len({len(p) for p in parts}) == 1
    with pytest.raises(ValueError, match="does not split"):
        port_mesh.rows(6, port_mesh.Mesh(0, 4, CPU))
    _write_split(tmp_path / "train", 5, np.random.default_rng(2))
    data = PortTrainDataset(str(tmp_path / "train" / "images"),
                            str(tmp_path / "train" / "masks"), 64)
    for epoch in (0, 1):
        whole = list(data.epoch(4, epoch, num_workers=2))
        assert [b.valid for b in whole] == [4, 1]
        for r in range(2):
            own = port_mesh.rows(4, port_mesh.Mesh(r, 2, CPU))
            for w, b in zip(whole, data.epoch(4, epoch, num_workers=2, rows=own)):
                assert b.valid == w.valid
                np.testing.assert_array_equal(b.image, w.image[own])
                np.testing.assert_array_equal(b.label, w.label[own])


@pytest.mark.parametrize("env, asked, want, backend", [
    ({}, "cuda:1", 1, None),
    ({}, "cuda", 1, None),
    ({"RANK": "1", "WORLD_SIZE": "2", "LOCAL_RANK": "1"}, "cuda:0", 1,
     "nccl"),
    ({"RANK": "1", "WORLD_SIZE": "2", "LOCAL_RANK": "1",
      "LOCAL_WORLD_SIZE": "2"}, "cuda", 1, "nccl"),
    ({"RANK": "3", "WORLD_SIZE": "4", "LOCAL_RANK": "3"}, "cuda:0", 1,
     "gloo"),
], ids=["no_torchrun_keeps_the_device", "no_torchrun_the_current_card",
        "torchrun_takes_local_rank", "torchrun_local_world",
        "torchrun_ranks_share_cards"])
def test_make_mesh_picks_the_card(monkeypatch, env, asked, want, backend):
    """Without torchrun's environment `make_mesh` keeps the card it was
    given (the current one, cuda:1 here, where it names none) and starts
    no group; under torchrun a rank takes `cuda:LOCAL_RANK` (modulo the
    cards) and NCCL, or gloo where ranks share a card. Two cards, mocked;
    `set_device` requires an index, as torch's does."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    chosen, started = [], []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)

    def set_device(d):   # as torch's: an index is required
        assert isinstance(d, torch.device) and d.index is not None, d
        chosen.append(d)

    monkeypatch.setattr(torch.cuda, "set_device", set_device)
    monkeypatch.setattr(port_mesh.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(port_mesh.dist, "init_process_group",
                        lambda backend, **kw: started.append(backend))
    mesh = port_mesh.make_mesh(asked)
    assert mesh.device == torch.device("cuda", want)
    assert chosen == [mesh.device]
    assert started == ([backend] if backend else [])


def test_a_batch_that_does_not_split_exits_with_the_jax_clis_message(
        tmp_path, monkeypatch):
    from test_torch_train_cli_cpu import _write_split

    _write_split(tmp_path / "train", 2, np.random.default_rng(4))
    _write_split(tmp_path / "test", 1, np.random.default_rng(5))
    argv = ["--save_path", str(tmp_path / "out"),
            "--train_image_path", str(tmp_path / "train" / "images"),
            "--train_mask_path", str(tmp_path / "train" / "masks"),
            "--test_image_path", str(tmp_path / "test" / "images"),
            "--test_gt_path", str(tmp_path / "test" / "masks"),
            "--size", "64", "--model_cfg", "hiera_test", "--num_workers", "1"]
    monkeypatch.setattr(jax_cli, "make_mesh", lambda: make_mesh(2))
    monkeypatch.setattr(train_cli, "make_mesh",
                        lambda device: port_mesh.Mesh(0, 2, CPU))
    for extra in (["--batch_size", "3"], ["--batch_size", "4",
                                          "--eval_batch_size", "5"]):
        messages = []
        for cli, dev in ((jax_cli, []), (train_cli, ["--device", "cpu"])):
            with pytest.raises(SystemExit) as e:
                cli.main(cli.build_parser().parse_args(argv + extra + dev))
            messages.append(str(e.value.code))
        assert messages[0] == messages[1]
        assert "2-device data axis" in messages[1]
    assert not (tmp_path / "out").exists()


def test_the_evaluators_on_two_ranks_score_the_whole_set(tmp_path):
    """`evaluate` (the device metrics, summed over the ranks) and
    `full_evaluate` (the host evaluator, each image's metrics gathered in
    order) on 2 ranks, 5 images in global batches of 4 (the last padded),
    give every rank the one-process report: the same images, the same
    metrics (eval mode: each image's logits are its own; fp32 sums in
    other orders, 1e-6)."""
    from test_torch_train_cli_cpu import _write_split

    from sam2unet_torch.cli.train_cli import full_evaluate
    from sam2unet_torch.data.dataset import EvalDataset
    from sam2unet_torch.train.engine import evaluate

    _write_split(tmp_path / "test", 5, np.random.default_rng(8))
    torch.manual_seed(8)
    model = PortSAM2UNet(PortConfig(trunk=PORT_HIERA_TEST))
    spec = {"state": model.state_dict(), "size": SIZE, "batch": 4,
            "images": str(tmp_path / "test" / "images"),
            "gts": str(tmp_path / "test" / "masks")}
    ranks = run_ranks("eval", spec, tmp_path / "ranks")
    data = EvalDataset(spec["images"], spec["gts"], SIZE)
    want = {"device": evaluate(model, data, 4, SIZE, CPU),
            "host": full_evaluate(model, data, 4, SIZE, CPU)}
    for name, (report, forwards) in want.items():
        assert report["images_count"] >= 5 and forwards == 2
        for r in ranks:
            got, got_forwards = r[name]
            assert got_forwards == forwards and got.keys() == report.keys()
            for k, v in report.items():
                assert got[k] == pytest.approx(v, rel=1e-6, abs=1e-9), (name, k)


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    from test_torch_train_cli_cpu import _write_split

    root = tmp_path_factory.mktemp("dp_cli")
    rng = np.random.default_rng(6)
    _write_split(root / "train", 6, rng)
    _write_split(root / "test", 3, rng)
    torch.manual_seed(6)
    torch.save(PortSAM2UNet(PortConfig(trunk=PORT_HIERA_TEST)).state_dict(),
               root / "start.pth")

    def argv(name):
        return ["--save_path", str(root / name), "--checkpoint",
                str(root / "start.pth"),
                "--train_image_path", str(root / "train" / "images"),
                "--train_mask_path", str(root / "train" / "masks"),
                "--test_image_path", str(root / "test" / "images"),
                "--test_gt_path", str(root / "test" / "masks"),
                "--epoch", "1", "--batch_size", "4", "--eval_batch_size", "2",
                "--size", "64", "--model_cfg", "hiera_test",
                "--base_mean_iou", "-1", "--num_workers", "2",
                "--save_train_state", "--shard_map", "--device", "cpu"]

    one = train_cli.main(train_cli.build_parser().parse_args(argv("one")))
    two = run_ranks("cli", {"argv": argv("two"), "save_path": str(root / "two")},
                    root / "ranks")
    return root, one, two


def test_the_train_cli_on_two_ranks_writes_only_from_rank_0(cli_runs):
    root, one, (r0, r1) = cli_runs
    assert r1["writes"] == [] and r0["writes"]
    assert (r0["stats"]["world"], r1["stats"]["world"]) == (2, 2)
    assert r1["stats"]["saved"] == [] and r1["stats"]["log"] is None
    written = sorted(p.name for p in (root / "two").iterdir())
    assert written == sorted(p.name for p in (root / "one").iterdir())
    assert any(w.endswith("log.txt") for w in r0["writes"])
    assert len(written) == 3   # log.txt, the snapshot, its train state


# (e): two AdamW steps from one state; the 2-rank step differs from the
# 1-process one by SyncBN's moments and the mean of two gradients, rounding
# alone. Adam's update is +-lr for any gradient well above eps, so an
# element whose gradient is near zero may move by up to 2 lr a step in one
# run and not the other; every other element agrees to 1e-2 lr. The
# running statistics (after the two steps' forwards) agree to 1e-4 of the
# layer's variance, the means of its standard deviation.
def test_the_train_cli_on_two_ranks_trains_the_one_process_parameters(cli_runs):
    root, one, (r0, r1) = cli_runs
    assert r0["stats"]["steps"] == one["steps"] == 2
    np.testing.assert_allclose(r0["stats"]["losses"], one["losses"], rtol=1e-5)
    np.testing.assert_allclose(r1["stats"]["losses"], one["losses"], rtol=1e-5)
    a = torch.load(one["saved"][-1], weights_only=True)
    b = torch.load(r0["stats"]["saved"][-1], weights_only=True)
    lr = one["lrs"][0]
    loose = total = 0
    for k, v in a.items():
        err = (b[k].float() - v.float()).abs()
        if not is_trainable(k) or "running" in k or "num_batches" in k:
            if "running" in k:   # to 1e-4 of the layer's variance / std
                var = a[k.rsplit(".", 1)[0] + ".running_var"]
                scale = float(var.max()) ** (0.5 if "mean" in k else 1)
                assert float(err.max()) <= 1e-4 * scale, k
            else:
                assert torch.equal(b[k], v), k
            continue
        assert float(err.max()) <= 2 * 2 * lr, k
        loose += int((err > 1e-2 * lr).sum())
        total += err.numel()
    assert loose <= 1e-3 * total, (loose, total)


def test_the_sync_bn_model_folds_and_exports(tmp_path):
    """The neck's and decoder's BatchNorms are SyncBatchNorm2d's, with
    nn.BatchNorm2d's state dict: the model folds (`fold_model`) to the
    forward it had, and its `.pt2` program (eval mode, where they are
    nn.BatchNorm2d's) runs that forward. fp32, to 1e-5 of each output's
    max."""
    from sam2unet_torch.interop import export
    from sam2unet_torch.nn.fold_bn import fold_model
    from sam2unet_torch.nn.layers import SyncBatchNorm2d

    torch.manual_seed(7)
    model = PortSAM2UNet(PortConfig(trunk=PORT_HIERA_TEST)).eval()
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    assert bns and all(isinstance(m, SyncBatchNorm2d) for m in bns)
    with torch.no_grad():   # statistics and affine no fold leaves as is
        for m in bns:
            m.running_mean.normal_(0, 0.1)
            m.running_var.uniform_(0.2, 0.8)
            m.weight.normal_(1, 0.1)
            m.bias.normal_(0, 0.1)
    x = torch.randn(1, SIZE, SIZE, 3)
    with torch.no_grad():
        want = model(x)
        fold_model(model)
        got = model(x)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())
    export.export_program(model, SIZE, str(tmp_path / "m.pt2"), device="cpu")
    got = export.load_exported(str(tmp_path / "m.pt2"), "cpu")(x)
    for name, w in zip(export.OUTPUT_NAMES, want):
        assert float((got[name] - w).abs().max()) <= 1e-5 * float(w.abs().max())
