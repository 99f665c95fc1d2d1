"""Resuming across the two packages, on the CPU in fp32: the JAX package's
train state (an Orbax directory of its `TrainState`) in the port, the
port's in the JAX package, and the port's --resume against the JAX CLI's.

  (a) a `TrainState` that `sam2unet_tpu.train.checkpoints.save_train_state`
      wrote after one JAX step (hiera_test at 64 px, batch 2) restores
      into the port exactly: every parameter and BatchNorm statistic, and
      AdamW's `exp_avg` / `exp_avg_sq` / `step` from optax's `mu` / `nu` /
      `count`.
  (b) the next step from it, the port's `train_step` at the rate
      `cosine_step_lr` gives the step, against the JAX package's next step:
      the loss, every trainable parameter, `mu` / `nu` against `exp_avg` /
      `exp_avg_sq`.
  (c) the port's `save_jax_train_state` after that step restores in the JAX
      package's `restore_train_state` (from the JAX template) bit for bit.
  (d) --resume at a step that is no multiple of the epoch's steps, from
      the port's file and from a JAX directory of the same state: the
      port's train CLI trains the epochs (and so the shuffle seeds) and the
      per-step rates of the JAX CLI from the same directory at the same
      settings; the JAX CLI's steps are its own optimizer's updates on zero
      gradients, from which the rate it applies is read back.
  (e) `interop/orbax.py`'s keys: tuple keys, sequence indices and an empty
      node round-trip; another key type fails the read.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam2unet_torch.cli import train_cli
from sam2unet_torch.configs import HIERA_TEST as PORT_HIERA_TEST
from sam2unet_torch.configs import SAM2UNetConfig as PortConfig
from sam2unet_torch.interop.from_jax import jax_to_state_dict, state_dict_to_jax
from sam2unet_torch.models.sam2unet import SAM2UNet as PortSAM2UNet
from sam2unet_torch.train import checkpoints as port_ckpt
from sam2unet_torch.train.engine import fp32_state_dict, train_step
from sam2unet_torch.train.optim import (
    cosine_step_lr,
    make_optimizer,
    set_lr,
    trainable_parameters,
)
from sam2unet_tpu.cli import train_cli as jax_cli
from sam2unet_tpu.configs import HIERA_TEST, SAM2UNetConfig
from sam2unet_tpu.models.sam2unet import SAM2UNet
from sam2unet_tpu.parallel.mesh import make_mesh as jax_make_mesh
from sam2unet_tpu.train import checkpoints as jax_ckpt
from sam2unet_tpu.train.engine import create_train_state, make_train_step
from sam2unet_tpu.train.optim import make_optimizer as jax_optimizer
from sam2unet_tpu.train.optim import merge_params

SIZE, BATCH, LR, WD, EPOCHS = 64, 2, 1e-3, 5e-4, 4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the suite runs several test processes on the
    machine's cores, where torch's own thread pool would oversubscribe
    them and a small train step would take seconds."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed: int):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((BATCH, SIZE, SIZE, 3)).astype(np.float32)
    yy, xx = np.mgrid[:SIZE, :SIZE]
    y = np.stack([((yy - 20 - 8 * i) ** 2 + (xx - 30) ** 2 < 15 ** 2)
                  for i in range(BATCH)])[..., None].astype(np.float32)
    return x, y


def _flat_to_port(flat: dict, names) -> dict[str, torch.Tensor]:
    """A flax-flattened params dict (tuple keys) as port tensors."""
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.asarray(v)
    return jax_to_state_dict({"params": tree}, names)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("resume")
    model = SAM2UNet(SAM2UNetConfig(trunk=HIERA_TEST))
    variables = jax.jit(model.init)(jax.random.PRNGKey(0),
                                    jnp.zeros((1, SIZE, SIZE, 3)))
    opt = jax_optimizer(lr=LR, weight_decay=WD, epochs=EPOCHS,
                        steps_per_epoch=1)
    step = make_train_step(model, opt, donate=False)
    (x1, y1), (x2, y2) = _batch(1), _batch(2)
    state1, _ = step(create_train_state(variables, opt), x1, y1)
    jax_ckpt.save_train_state(str(tmp / "jax_1"), state1)
    state2, metrics2 = step(state1, x2, y2)

    port = PortSAM2UNet(PortConfig(trunk=PORT_HIERA_TEST))
    optimizer = make_optimizer(port, LR, WD)
    restored = port_ckpt.restore_train_state(str(tmp / "jax_1"), port,
                                             optimizer)
    after_restore = ({k: v.clone() for k, v in port.state_dict().items()},
                     {i: {k: v.clone() for k, v in s.items()}
                      for i, s in optimizer.state_dict()["state"].items()})
    set_lr(optimizer, cosine_step_lr(LR, 1, EPOCHS, 1))
    loss2 = train_step(port, optimizer, torch.from_numpy(x2),
                       torch.from_numpy(y2))
    port_ckpt.save_jax_train_state(str(tmp / "port_2"),
                                   fp32_state_dict(port, {}), port, optimizer, 2)
    from_port = jax_ckpt.restore_train_state(str(tmp / "port_2"), state2)
    return dict(state1=state1, state2=state2, loss2=float(metrics2["loss"]),
                restored=restored, after_restore=after_restore, port=port,
                optimizer=optimizer, got_loss2=float(loss2),
                from_port=from_port)


def test_a_jax_train_state_restores_into_the_port_exactly(runs):
    state1 = runs["state1"]
    model_state, opt_state = runs["after_restore"]
    assert runs["restored"] == 1
    want = jax_to_state_dict(jax.tree.map(np.asarray, state1.variables()),
                             model_state.keys())
    for k, v in model_state.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, want[k]), k
    names = [n for n, _ in trainable_parameters(runs["port"])]
    adam = state1.opt_state[0]
    for slot, moment in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        want = _flat_to_port(moment, names)
        for i, n in enumerate(names):
            assert torch.equal(opt_state[i][slot], want[n]), (slot, n)
    assert all(float(s["step"]) == 1 for s in opt_state.values())
    assert len(opt_state) == len(names) == len(state1.trainable)


# the next step's tolerances, fp32 both sides (sums in other orders;
# measured on this batch: loss 2.1e-7 relative, mu 6.3e-6 and nu 8.5e-6 of
# a leaf's max, parameters 1.3e-3 lr). A leaf whose gradient is zero by
# construction (a BatchNorm bias whose shift the next BatchNorm removes:
# |mu| ~1e-10, rounding noise) is held to 1e-6 of the largest |mu| and may
# move by up to 2 lr (Adam normalises the noise to +-lr).
LOSS_RTOL, MOMENT_TOL, PARAM_TOL = 1e-5, 1e-4, 1e-2
NOISE = 1e-6


def test_the_next_step_matches_the_jax_packages_next_step(runs):
    assert abs(runs["got_loss2"] - runs["loss2"]) <= LOSS_RTOL * abs(runs["loss2"])
    port, state2 = runs["port"], runs["state2"]
    names = [n for n, _ in trainable_parameters(port)]
    params = dict(port.named_parameters())
    adam = state2.opt_state[0]
    mu, nu = _flat_to_port(adam.mu, names), _flat_to_port(adam.nu, names)
    new = _flat_to_port(state2.trainable, names)
    got = runs["optimizer"].state_dict()["state"]
    lr = cosine_step_lr(LR, 1, EPOCHS, 1)
    top = max(float(m.abs().max()) for m in mu.values())
    noise = 0
    for i, n in enumerate(names):
        assert float(got[i]["step"]) == 2
        if float(mu[n].abs().max()) < NOISE * top:
            noise += 1
            for slot, want in (("exp_avg", mu), ("exp_avg_sq", nu)):
                assert float((got[i][slot] - want[n]).abs().max()) <= NOISE * top
            assert float((params[n].detach() - new[n]).abs().max()) <= 2 * lr
            continue
        for slot, want in (("exp_avg", mu), ("exp_avg_sq", nu)):
            err = float((got[i][slot] - want[n]).abs().max())
            assert err <= MOMENT_TOL * float(want[n].abs().max()), (slot, n, err)
        err = float((params[n].detach() - new[n]).abs().max())
        assert err <= PARAM_TOL * lr, (n, err / lr)
    assert noise <= 8


def test_the_jax_package_restores_a_port_written_state_bit_for_bit(runs):
    """From the JAX template (the state after its own second step), every
    leaf of the port's directory: the step, the parameters and statistics
    through `state_dict_to_jax`, the moments as `mu` / `nu`, both counts."""
    got, port, opt = runs["from_port"], runs["port"], runs["optimizer"]
    assert int(got.step) == 2 and got.step.dtype == jnp.int32
    assert int(got.opt_state[0].count) == int(got.opt_state[2].count) == 2
    want = state_dict_to_jax(fp32_state_dict(port, {}))
    named = trainable_parameters(port)
    moments = {slot: state_dict_to_jax(
        {n: opt.state[p][slot] for n, p in named})["params"]
        for slot in ("exp_avg", "exp_avg_sq")}
    pairs = [(got.params, want["params"]), (got.batch_stats, want["batch_stats"]),
             (merge_params(got.opt_state[0].mu, {}), moments["exp_avg"]),
             (merge_params(got.opt_state[0].nu, {}), moments["exp_avg_sq"])]
    for a, b in pairs:
        la, lb = jax.tree_util.tree_leaves_with_path(a), \
            jax.tree_util.tree_leaves_with_path(b)
        assert [p for p, _ in la] == [p for p, _ in lb]
        for (path, x), (_, y) in zip(la, lb):
            x = np.asarray(x)
            assert x.dtype == np.float32 and np.array_equal(x, y), path


# ------------------------------------- --resume against the JAX CLI's run

CFG, CLI_SIZE, CLI_BATCH, CLI_EPOCHS = "hiera_test", 64, 4, 3
RESUME_STEP = 3   # 6 images at batch 4: two steps an epoch


@pytest.fixture(scope="module")
def resume_case(tmp_path_factory):
    """A dataset of 6 images, and one training state at step 3 in both
    formats: the port's older file and a JAX TrainState directory."""
    from test_torch_train_cli_cpu import _write_split

    root = tmp_path_factory.mktemp("resume_cli")
    rng = np.random.default_rng(3)
    _write_split(root / "train", 6, rng)
    _write_split(root / "test", 2, rng)
    torch.manual_seed(3)
    model = PortSAM2UNet(PortConfig(trunk=PORT_HIERA_TEST))
    optimizer = make_optimizer(model, LR, WD)
    for s in range(RESUME_STEP):
        x, y = _batch(10 + s)
        set_lr(optimizer, cosine_step_lr(LR, s, CLI_EPOCHS, 2))
        train_step(model, optimizer, torch.from_numpy(x), torch.from_numpy(y))
    state = fp32_state_dict(model, {})
    # the train-state file this package wrote before (an older run's)
    torch.save({"model": state, "optimizer": optimizer.state_dict(),
                "epoch": 1, "step": RESUME_STEP}, root / "state.pth")
    port_ckpt.save_jax_train_state(str(root / "state_jax"), state, model,
                                   optimizer, RESUME_STEP)
    argv = ["--train_image_path", str(root / "train" / "images"),
            "--train_mask_path", str(root / "train" / "masks"),
            "--test_image_path", str(root / "test" / "images"),
            "--test_gt_path", str(root / "test" / "masks"),
            "--epoch", str(CLI_EPOCHS), "--batch_size", str(CLI_BATCH),
            "--size", str(CLI_SIZE), "--model_cfg", CFG, "--lr", str(LR),
            "--save_interval", "1", "--num_workers", "2"]
    return root, argv


def _record(monkeypatch, dataset_cls, policy_cls, seen):
    epoch, save = dataset_cls.epoch, policy_cls.maybe_save

    def recorded_epoch(self, batch_size, epoch_index=0, **kw):
        seen["epochs"].append(epoch_index)
        seen["shuffle_seeds"].append(self.seed + epoch_index)
        return epoch(self, batch_size, epoch_index, **kw)

    def recorded_save(self, epoch1, *a, **kw):
        seen["policy_epochs"].append(epoch1)
        return save(self, epoch1, *a, **kw)

    monkeypatch.setattr(dataset_cls, "epoch", recorded_epoch)
    monkeypatch.setattr(policy_cls, "maybe_save", recorded_save)


def _jax_cli_run(monkeypatch, argv, state_dir) -> dict:
    """The JAX CLI resumed from `state_dir` on one device, each step its
    optimizer's update on zero gradients and zero moments (the update is
    then -lr * wd * p, which gives back the rate it applied); the eval
    forward returns zeros."""
    seen = {"epochs": [], "shuffle_seeds": [], "policy_epochs": [],
            "steps": [], "lrs": []}
    _record(monkeypatch, jax_cli.TrainDataset, jax_cli.CheckpointPolicy, seen)

    def make_train_step(model, optimizer, **kw):
        def probe(state):
            zeros = jax.tree.map(jnp.zeros_like, state.trainable)
            adam = state.opt_state[0]._replace(mu=zeros, nu=zeros)
            return optimizer.update(zeros, (adam,) + tuple(state.opt_state[1:]),
                                    state.trainable)

        probe = jax.jit(probe)

        def step(state, images, labels):
            updates, opt_state = probe(state)
            key = max(state.trainable,
                      key=lambda k: float(jnp.abs(state.trainable[k]).max()))
            p = np.asarray(state.trainable[key], np.float64).ravel()
            i = int(np.abs(p).argmax())
            u = np.asarray(updates[key], np.float64).ravel()[i]
            seen["lrs"].append(-u / (WD * p[i]))
            seen["steps"].append(int(state.step))
            return (state.replace(step=state.step + 1, opt_state=opt_state),
                    {"loss": jnp.zeros((), jnp.float32)})
        return step

    def make_eval_step(model, **kw):
        return lambda v, x: (jnp.zeros(x.shape[:3] + (1,)),) * 3

    monkeypatch.setattr(jax_cli, "make_mesh", lambda: jax_make_mesh(1))
    monkeypatch.setattr(jax_cli, "make_train_step", make_train_step)
    monkeypatch.setattr(jax_cli, "make_eval_step", make_eval_step)
    jax_cli.main(jax_cli.build_parser().parse_args(
        argv + ["--resume", str(state_dir)]))
    return seen


@pytest.mark.parametrize("form", ["port_file", "jax_directory"])
def test_resume_follows_the_jax_cli(resume_case, form, tmp_path, monkeypatch):
    """Resumed at step 3 (mid-epoch: two steps an epoch) with --epoch 3, the
    port runs the JAX CLI's epochs 0, 1, 2 (their shuffle seeds and
    checkpoint epochs 1-3, six steps) at its per-step rates: the schedule at
    global steps 3-8, which moves inside the first epoch (steps 3 and 4 fall
    in schedule epochs 1 and 2). Before the repair the port ran epochs 1-2
    at per-epoch rates."""
    root, argv = resume_case
    jax_seen = _jax_cli_run(monkeypatch, argv + ["--save_path",
                                                 str(tmp_path / "jax")],
                            root / "state_jax")
    port_seen = {"epochs": [], "shuffle_seeds": [], "policy_epochs": []}
    _record(monkeypatch, train_cli.TrainDataset, train_cli.CheckpointPolicy,
            port_seen)
    source = root / ("state.pth" if form == "port_file" else "state_jax")
    got = train_cli.main(train_cli.build_parser().parse_args(
        argv + ["--save_path", str(tmp_path / "port"), "--device", "cpu",
                "--resume", str(source)]))
    assert jax_seen["epochs"] == [0, 1, 2]
    assert jax_seen["steps"] == list(range(RESUME_STEP, RESUME_STEP + 6))
    for k in ("epochs", "shuffle_seeds", "policy_epochs"):
        assert port_seen[k] == jax_seen[k], k
    assert (got["steps"], got["global_step"]) == (6, RESUME_STEP + 6)
    np.testing.assert_allclose(got["lrs"], jax_seen["lrs"], rtol=1e-5)
    assert got["lrs"][0] != got["lrs"][1]


def test_orbax_tree_keys_round_trip_and_unknown_key_types_fail(tmp_path):
    """The keys a train state's tree holds: strings, flax's flattened tuple
    keys (written as the tuple's string), optax's sequence indices (ints)
    and an empty node (None); read back as written, the metadata as the
    JAX package writes it. A key of another key_type fails the read."""
    import json

    from sam2unet_torch.interop import orbax

    tree = {"step": np.asarray(7, np.int32),
            "trainable": {("encoder", "blocks_0", "bias"): np.arange(3.0)},
            "opt_state": {0: {"count": np.asarray(7, np.int32)}, 1: None}}
    orbax.write_tree(tmp_path / "t", tree)
    back = orbax.read_tree(tmp_path / "t")
    assert back["step"].shape == () and int(back["step"]) == 7
    assert list(back["trainable"]) == [("encoder", "blocks_0", "bias")]
    np.testing.assert_array_equal(
        back["trainable"][("encoder", "blocks_0", "bias")], np.arange(3.0))
    assert back["opt_state"][1] is None and int(back["opt_state"][0]["count"]) == 7
    meta = json.loads((tmp_path / "t" / "_METADATA").read_text())
    leaf = meta["tree_metadata"]["('opt_state', '0', 'count')"]
    assert [k["key_type"] for k in leaf["key_metadata"]] == [2, 1, 2]
    assert meta["tree_metadata"]["('opt_state', '1')"]["value_metadata"] == {
        "value_type": "None", "skip_deserialize": True}
    assert "('trainable', \"('encoder', 'blocks_0', 'bias')\")" in meta["tree_metadata"]
    leaf["key_metadata"][1]["key_type"] = 3
    (tmp_path / "t" / "_METADATA").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="unknown key_type 3"):
        orbax.read_tree(tmp_path / "t")
    with pytest.raises(TypeError, match="not a str"):
        orbax.write_tree(tmp_path / "u", {1.5: np.zeros(1)})
