"""The port's tensor parallelism (`parallel/sharding.py`, the 2-D mesh of
`parallel/mesh.py`, `train/engine.py::create_sharded_train_state` and its
step) against the JAX package's, on the CPU in fp32. The port's ranks are
processes on gloo over localhost (tests/torch_dist_worker.py); the JAX step
is GSPMD on a (2, 2) mesh of the conftest's virtual devices.

  - `leaf_spec`'s decision on every leaf of the hiera_test SAM2-UNet (the
    dry run's, min 128) and of hiera_s's (the default 65536) equals the JAX
    one, leaf by leaf under the JAX names.
  - the 4-rank (2, 2) step of the dry run's tiny phase equals the JAX GSPMD
    TP step from the same parameters on the same batch: the loss, every
    trainable gradient, the parameters after AdamW and the BatchNorm
    statistics, at tests/test_torch_train_cpu.py's one-step tolerances.
  - a rank holds half of each split leaf and of its AdamW moments.
  - the same step with the gradient mean and SyncBN reduced over every rank
    instead of the data group (each row then counts twice) fails those
    comparisons, on the running variances: the test above catches the
    fault.
  - the mesh's layout: rank r at data index r // mp, model index r % mp,
    and a rank's rows those of its data index.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
from test_torch_model_cpu import _perturb
from test_torch_train_cpu import GRAD_CORR, GRAD_TOL, LOSS_RTOL, _unflatten
from torch_dist_worker import run_ranks

from sam2unet_torch.configs import HIERA_S as PORT_HIERA_S
from sam2unet_torch.configs import HIERA_TEST as PORT_HIERA_TEST
from sam2unet_torch.configs import SAM2UNetConfig as PortConfig
from sam2unet_torch.interop.from_jax import jax_leaf, jax_to_state_dict
from sam2unet_torch.models.sam2unet import SAM2UNet as PortSAM2UNet
from sam2unet_torch.parallel import dryrun
from sam2unet_torch.parallel import mesh as port_mesh
from sam2unet_torch.parallel.sharding import leaf_spec
from sam2unet_torch.train.optim import is_trainable
from sam2unet_tpu.configs import HIERA_S, HIERA_TEST, SAM2UNetConfig
from sam2unet_tpu.models.sam2unet import SAM2UNet
from sam2unet_tpu.parallel import sharding as jax_sharding
from sam2unet_tpu.parallel.mesh import MODEL_AXIS, make_mesh, shard_batch
from sam2unet_tpu.train.engine import create_sharded_train_state, make_train_step
from sam2unet_tpu.train.loss import multi_head_loss
from sam2unet_tpu.train.optim import make_optimizer, merge_params, partition_params

CPU = torch.device("cpu")
LR, WD, MIN_SHARD, SIZE, WORLD = 1e-3, 5e-4, 128, 64, 4


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


# --------------------------------------------------------------- the policy


@pytest.mark.parametrize("trunk, port_trunk, min_size", [
    (HIERA_TEST, PORT_HIERA_TEST, MIN_SHARD),
    (HIERA_S, PORT_HIERA_S, None)], ids=["hiera_test", "hiera_s"])
def test_leaf_spec_decisions_equal_the_jax_ones(trunk, port_trunk, min_size):
    kw = {} if min_size is None else {"min_size": min_size}
    rfb = {"rfb_out": 8} if min_size else {}
    model = SAM2UNet(SAM2UNetConfig(trunk=trunk, **rfb))
    shapes = jax.eval_shape(
        lambda r, x: model.init(r, x, train=False), jax.random.PRNGKey(0),
        jax.ShapeDtypeStruct((1, 64, 64, 3), np.float32))
    mesh = make_mesh(WORLD, model_parallel=2)
    want = {path: MODEL_AXIS in jax_sharding.leaf_spec(leaf, mesh, **kw).spec
            for path, leaf in _flat(shapes).items()}
    port = PortSAM2UNet(PortConfig(trunk=port_trunk, **rfb))
    pmesh = port_mesh.Mesh(0, WORLD, CPU, model_parallel=2)
    got = {}
    for key, t in port.state_dict().items():
        place = jax_leaf(key, t.dim())
        if place is None:
            continue
        coll, path, axes = place
        dim = leaf_spec(key, t, pmesh, **kw)
        got[(coll,) + path] = dim is not None
        if dim is not None:   # the torch axis of the last JAX axis
            assert dim == axes[-1], key
    assert got == want
    assert 0 < sum(want.values()) < len(want)


def test_a_one_sized_model_axis_replicates_everything():
    port = PortSAM2UNet(PortConfig(trunk=PORT_HIERA_TEST, rfb_out=8))
    pmesh = port_mesh.Mesh(0, WORLD, CPU)
    assert all(leaf_spec(k, t, pmesh, MIN_SHARD) is None
               for k, t in port.state_dict().items())


def test_the_mesh_lays_ranks_out_as_the_jax_mesh():
    mesh = make_mesh(WORLD, model_parallel=2)
    devs = np.vectorize(lambda d: d.id)(mesh.devices)
    batch = np.arange(8)
    for r in range(WORLD):
        m = port_mesh.Mesh(r, WORLD, CPU, model_parallel=2)
        d, i = np.argwhere(devs == r)[0]
        assert (m.data_index, m.model_index, m.data_size) == (d, i, 2)
        assert torch.equal(port_mesh.shard_batch(m, batch),
                           torch.from_numpy(batch[4 * d: 4 * d + 4]))


# ------------------------------------------------------------- the TP step


@pytest.fixture(scope="module")
def tp_steps(tmp_path_factory):
    """The JAX GSPMD TP step and its one-process gradients; the port's
    4-rank step, and the same with the world reductions."""
    model = SAM2UNet(SAM2UNetConfig(trunk=HIERA_TEST, rfb_out=8))
    variables = jax.jit(model.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), np.zeros((1, SIZE, SIZE, 3), np.float32),
        train=False)
    variables = _perturb(dict(jax.tree_util.tree_map(np.asarray, variables)),
                         np.random.default_rng(0))
    x, y = dryrun.phase_batch(WORLD, SIZE, seed=dryrun.phase_seed("tiny"))
    mesh = make_mesh(WORLD, model_parallel=2)
    opt = make_optimizer(lr=LR, weight_decay=WD, epochs=2, steps_per_epoch=2)
    state = create_sharded_train_state(variables, opt, mesh,
                                       min_shard_size=MIN_SHARD)
    sharded = sum(MODEL_AXIS in leaf.sharding.spec
                  for leaf in jax.tree_util.tree_leaves(state.params))
    step = make_train_step(model, opt, mesh=mesh, donate=False)
    new, metrics = step(state, shard_batch(mesh, x), shard_batch(mesh, y))
    trainable, frozen = partition_params(variables["params"])

    def loss_fn(tr):
        preds, _ = model.apply(
            {"params": merge_params(tr, frozen),
             "batch_stats": variables["batch_stats"]},
            x, train=True, mutable=["batch_stats"])
        return multi_head_loss(preds, y)

    grads = jax.jit(jax.grad(loss_fn))(trainable)

    port = PortSAM2UNet(PortConfig(trunk=PORT_HIERA_TEST, rfb_out=8))
    keys = port.state_dict().keys()
    start = jax_to_state_dict(variables, keys)
    names = [n for n, _ in port.named_parameters() if is_trainable(n)]
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    want = dict(
        loss=float(metrics["loss"]),
        grads=jax_to_state_dict({"params": _unflatten(np_tree(grads))}, names),
        params=jax_to_state_dict({"params": _unflatten(np_tree(new.trainable))},
                                 names),
        stats=jax_to_state_dict(
            {"batch_stats": np_tree(new.batch_stats)},
            [k for k in keys if k.endswith(("running_mean", "running_var"))]),
        sharded=sharded)
    spec = {"state": start, "x": torch.from_numpy(x), "y": torch.from_numpy(y),
            "lr": LR, "wd": WD, "min_shard": MIN_SHARD}
    root = tmp_path_factory.mktemp("tp")
    right = run_ranks("tp_step", spec, root / "right", world=WORLD)
    wrong = run_ranks("tp_step", dict(spec, world_reduce=True), root / "wrong",
                      world=WORLD)
    return want, start, right, wrong


# At 64 px five BatchNorm biases of rfb3 and rfb4 have a gradient that is 0
# in exact arithmetic: each feeds the next ConvBN through a convolution that
# sees only its centre tap on the 4x4 and 2x2 grids (the rest is padding),
# and that BatchNorm removes the shift. Their gradients are rounding noise,
# ~1e-9 against the largest leaf's 0.42 (measured, in both packages), and
# differ between any two summation orders by their own size. A leaf's scale
# is therefore at least this share of the largest gradient.
NOISE_FLOOR = 1e-6


def _faults(got: dict, want: dict, start: dict) -> list[str]:
    """Where the port's step departs from the JAX step, at
    tests/test_torch_train_cpu.py's one-step tolerances."""
    bad = []
    if abs(got["loss"] - want["loss"]) > LOSS_RTOL * abs(want["loss"]):
        bad.append("loss")
    floor = NOISE_FLOOR * max(float(w.abs().max()) for w in want["grads"].values())
    for name, w in want["grads"].items():
        g = got["grads"][name]
        scale = max(float(w.abs().max()), floor)
        if float((g - w).abs().max()) > GRAD_TOL * scale:
            bad.append(f"grad {name}")
        elif scale > floor and g.numel() > 1 and float(torch.corrcoef(
                torch.stack([g.flatten(), w.flatten()]).double())[0, 1]) < GRAD_CORR:
            bad.append(f"grad corr {name}")
        near_zero = w.abs() <= GRAD_TOL * scale
        allowed = torch.where(near_zero, torch.full_like(w, 2 * LR),
                              torch.full_like(w, 1e-2 * LR))
        if not bool(((got["params"][name] - want["params"][name]).abs()
                     <= allowed).all()):
            bad.append(f"param {name}")
    for key, w in want["stats"].items():
        old, g = start[key], got["stats"][key]
        if key.rsplit(".", 1)[0] not in got["bn_n"]:   # up4, never called
            if not (torch.equal(g, old) and torch.equal(w, old)):
                bad.append(f"stat {key}")
            continue
        tol = 1e-5
        if key.endswith("running_var"):   # JAX's biased var -> torch's
            n = got["bn_n"][key.rsplit(".", 1)[0]]
            w = 0.9 * old + (w - 0.9 * old) * n / (n - 1)
            tol = 1e-4
        if float((g - w).abs().max()) > tol * float(w.abs().max()):
            bad.append(f"stat {key}")
    return bad


def test_the_4_rank_tp_step_equals_the_jax_gspmd_step(tp_steps):
    want, start, right, _ = tp_steps
    for r in right:
        assert _faults(r, want, start) == []
    for r in right[1:]:
        assert r["loss"] == right[0]["loss"]
        for k, v in right[0]["params"].items():
            assert torch.equal(r["params"][k], v), k


def test_a_rank_holds_half_of_each_split_leaf_and_moment(tp_steps):
    """Both AdamW moments of every split trainable leaf, none of a frozen
    one; as many split leaves as the JAX state has; every rank's share of
    the bytes is half."""
    want, _, right, _ = tp_steps
    for r in right:
        held = r["held"]
        assert len(held) == want["sharded"] > 0
        for name, (parts, whole, dim) in held.items():
            assert len(parts) == (3 if is_trainable(name) else 1), name
            assert all(2 * n == whole for n in parts), name
        assert 2 * r["bytes"][0] == r["bytes"][1] > 0


def test_reducing_over_every_rank_is_caught(tp_steps):
    """The fault the data group prevents: on the (2, 2) mesh an all-reduce
    over the 4 ranks counts each row twice. SyncBN's moments survive it,
    and so do the gradients: the cotangent summed over the model axis's
    copies too is twice as large, and the doubled count halves it again,
    and the mean over 4 ranks of pairwise equal gradients is the mean over
    the 2 data indices. The running variance's unbiased correction
    n / (n - 1) takes the doubled count, and the comparison above fails
    on it."""
    want, start, _, wrong = tp_steps
    bad = _faults(wrong[0], want, start)
    assert bad and all(b.startswith("stat") and b.endswith("running_var")
                       for b in bad), bad
