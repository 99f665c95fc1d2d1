"""The port's sequence-parallel attention (`ops/sp_attention.py`) and
Hiera's sequence-parallel global blocks against the JAX package's, on the
CPU in fp32. The port's ranks are processes on gloo over localhost
(tests/torch_dist_worker.py), the JAX forms run under `shard_map` on a mesh
of as many of the conftest's virtual devices.

  - `allgather_sdpa` and `ring_sdpa` at 2 and 4 ranks: each rank's slice of
    the output against the JAX forms' and against the dense `sdpa`, and the
    gradients of sum(out * cot) against `jax.grad` through the JAX forms,
    at 2e-5 of the largest magnitude; the ring also with one key block
    30x larger (the online softmax's uneven case).
  - the Hiera trunk of tests/test_sp_attention.py (a global block inside a
    3-block first stage, 16x16 = 256 tokens at 64 px) with the global block
    split over 2 ranks against the JAX dense forward, with one ring call.
  - SAM2-UNet's state-dict keys with the sequence-parallel arguments equal
    the dense model's (checkpoints interchange).
  - the per-block routes under sequence parallelism (the grouped layout
    off): the kernel wrappers' calls and the ring calls per forward, at
    narrow width and full depth, against spies on the JAX package's
    dispatch inside `shard_map` (traced by `jax.eval_shape`, nothing
    compiles), as tests/test_torch_grouped_cpu.py spies on the dense
    routes.
"""

from __future__ import annotations

import collections
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from test_torch_grouped_cpu import _narrow
from torch_dist_worker import run_ranks

import sam2unet_torch.models.hiera as port_hiera
import sam2unet_tpu.models.hiera as jax_hiera
import sam2unet_tpu.ops.pallas.dispatch as jax_dispatch
import sam2unet_tpu.ops.pallas.fused_attention_block as jax_fab
import sam2unet_tpu.ops.pallas.fused_mlp as jax_mlp
import sam2unet_tpu.ops.pallas.fused_transition as jax_tra
import sam2unet_tpu.ops.sp_attention as jax_spa
from sam2unet_torch.configs import HIERA_S as PORT_HIERA_S
from sam2unet_torch.configs import HIERA_TEST as PORT_HIERA_TEST
from sam2unet_torch.configs import HieraConfig as PortHieraConfig
from sam2unet_torch.configs import SAM2UNetConfig as PortConfig
from sam2unet_torch.interop.from_jax import jax_to_state_dict
from sam2unet_torch.models.sam2unet import SAM2UNet as PortSAM2UNet
from sam2unet_tpu.configs import HIERA_L, HIERA_S, HieraConfig
from sam2unet_tpu.models.hiera import Hiera
from sam2unet_tpu.ops.attention import sdpa

TOL = 2e-5


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, (what, err, scale)


def _qkv(seed, uneven=False, b=2, s=64, h=3, d=16):
    rng = np.random.default_rng(seed)
    q, k, v, cot = (rng.standard_normal((b, s, h, d)).astype(np.float32)
                    for _ in range(4))
    if uneven:   # one key block dominates (tests/test_sp_attention.py)
        k[:, 24:32] *= 30.0
    return q, k, v, cot


CASES = [("allgather_sdpa", False), ("ring_sdpa", False), ("ring_sdpa", True)]


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def sp_runs(request, tmp_path_factory):
    """Every case on `world` ranks of the port, and under shard_map over as
    many JAX devices: outputs and gradients."""
    world = request.param
    devs = jax.devices()
    mesh = Mesh(np.array(devs[:world]), ("seq",))
    spec = NamedSharding(mesh, P(None, "seq"))
    cases, want = [], []
    for i, (fn, uneven) in enumerate(CASES):
        q, k, v, cot = _qkv(i, uneven)
        cases.append({"fn": fn, "q": torch.from_numpy(q),
                      "k": torch.from_numpy(k), "v": torch.from_numpy(v),
                      "cot": torch.from_numpy(cot)})
        jfn = getattr(jax_spa, fn)
        sharded = jax.shard_map(lambda q, k, v, jfn=jfn: jfn(q, k, v, "seq"),
                                mesh=mesh, in_specs=(P(None, "seq"),) * 3,
                                out_specs=P(None, "seq"))

        def loss(q, k, v, sharded=sharded, cot=cot):
            return jnp.sum(sharded(q, k, v) * cot)

        args = [jax.device_put(jnp.asarray(t), spec) for t in (q, k, v)]
        out = jax.jit(sharded)(*args)
        grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*args)
        want.append({"o": np.asarray(out), "dense": np.asarray(sdpa(*args)),
                     "grads": [np.asarray(g) for g in grads]})
    ranks = run_ranks("sp_attention", {"cases": cases},
                      tmp_path_factory.mktemp(f"sp{world}"), world=world)
    return world, ranks, want


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"{f}{'_uneven' if u else ''}" for f, u in CASES])
def test_sp_attention_matches_the_jax_forms_and_dense(sp_runs, case):
    world, ranks, want = sp_runs
    got = torch.cat([r["cases"][case]["o"] for r in ranks], dim=1).numpy()
    _close(got, want[case]["o"], "vs the JAX form")
    _close(got, want[case]["dense"], "vs dense sdpa")
    for i, name in enumerate(("dq", "dk", "dv")):
        g = torch.cat([r["cases"][case][name] for r in ranks], dim=1).numpy()
        _close(g, want[case]["grads"][i], f"{name} vs jax.grad")
    fn = CASES[case][0]
    assert ranks[0]["calls"][fn] == sum(f == fn for f, _ in CASES)


# -------------------------------------------------------------- the trunk

# tests/test_sp_attention.py:87-89: the global block at a dim-preserving
# position, block 1 of a 3-block first stage
SP_CFG = dict(embed_dim=8, stages=(3, 1, 1, 1), global_att_blocks=(1,),
              window_spec=(4, 2, 2, 2), window_pos_embed_bkg_spatial_size=(7, 7))


def test_hiera_sequence_parallel_forward_matches_the_jax_dense_forward(tmp_path):
    x = np.random.default_rng(0).standard_normal((1, 64, 64, 3)).astype(np.float32)
    dense = Hiera(HieraConfig(**SP_CFG))
    variables = jax.jit(lambda r, xx: dense.init(r, xx, train=False))(
        jax.random.PRNGKey(0), jnp.asarray(x))
    want = jax.jit(lambda v, xx: dense.apply(v, xx, train=False))(
        variables, jnp.asarray(x))
    keys = port_hiera.Hiera(PortHieraConfig(**SP_CFG)).state_dict().keys()
    state = jax_to_state_dict(jax.tree_util.tree_map(np.asarray, variables),
                              keys, wrap_blocks=False)
    ranks = run_ranks("sp_hiera", {"cfg": SP_CFG, "state": state,
                                   "x": torch.from_numpy(x)}, tmp_path)
    for r in ranks:
        assert r["calls"] == {"ring_sdpa": 1}   # the SP path engaged
        assert len(r["outs"]) == len(want) == 4
        for g, w in zip(r["outs"], want):
            _close(g.numpy(), w, "trunk output")


def test_sam2unet_sp_state_dict_keys_equal_the_dense_ones():
    """The sequence-parallel arguments change no key or shape (the group is
    only kept at construction)."""
    cfg = PortConfig(trunk=PORT_HIERA_TEST, rfb_out=8)
    dense = PortSAM2UNet(cfg).state_dict()
    sp = PortSAM2UNet(cfg, sp_group=object(), sp_degree=2).state_dict()
    assert list(sp) == list(dense)
    assert all(sp[k].shape == dense[k].shape for k in dense)
    big = PortConfig(trunk=dataclasses.replace(PORT_HIERA_S, embed_dim=16))
    assert list(PortSAM2UNet(big, sp_group=object(), sp_degree=2).state_dict()) \
        == list(PortSAM2UNet(big).state_dict())


# ------------------------------------------------------------ route spies

SP_DEGREE = 2
# (trunk, size, dtype): the dry run's SP forward (hiera_s@352, fp32), the
# same in bf16, and hiera_l@352 (its global blocks inside the 22x22 stage)
SPY_POINTS = {
    "hiera_s@352 fp32": (HIERA_S, 352, "float32"),
    "hiera_s@352 bf16": (HIERA_S, 352, "bfloat16"),
    "hiera_l@352 bf16": (HIERA_L, 352, "bfloat16"),
}


def _jax_sp_counts(cfg, size, dtype, monkeypatch) -> collections.Counter:
    counts = collections.Counter()
    cfg = HieraConfig(**_narrow(cfg))
    dt = getattr(jnp, dtype)
    x = jax.ShapeDtypeStruct((1, size, size, 3), dt)
    variables = jax.eval_shape(
        functools.partial(Hiera(cfg, use_adapters=True, dtype=dt).init,
                          train=False), jax.random.PRNGKey(0), x)

    def mlp(x, *a, ln_scale=None, **k):
        counts["K1 tail" if ln_scale is not None else "K1 adapter"] += 1
        return x

    def window_block(x, *a, n_pad=0, **k):
        counts[("K6", x.shape[1], n_pad)] += 1
        return x

    def strips(x, *a, window, **k):
        h, w = x.shape[1], x.shape[2]
        rem = h % window or w % window or (window * window) % 16
        counts["K12" if rem else "K4"] += 1
        return x

    def transition(x, *a, window, **k):
        counts["K8"] += 1
        b, h, w, _ = x.shape
        return jnp.zeros((b, h // 2, w // 2, a[4].shape[-1]), x.dtype)

    def plain_attention(q, k, v, **kw):
        counts["plain attention"] += 1
        return jnp.zeros_like(q)

    def ring(q, k, v, axis_name, scale=None):
        counts["ring"] += 1
        return q

    monkeypatch.setattr(jax_dispatch, "xla_only", lambda: False)
    monkeypatch.setattr(jax_mlp, "fused_mlp", mlp)
    monkeypatch.setattr(jax_fab, "fused_window_block", window_block)
    monkeypatch.setattr(jax_fab, "fused_window_block_strips", strips)
    monkeypatch.setattr(jax_tra, "fused_transition_block", transition)
    monkeypatch.setattr(jax_hiera, "sdpa", plain_attention)
    monkeypatch.setattr(jax_spa, "ring_sdpa", ring)
    sp = Hiera(cfg, use_adapters=True, sp_axis="model", sp_degree=SP_DEGREE,
               dtype=dt)
    mesh = Mesh(np.array(jax.devices()[:SP_DEGREE]), ("model",))
    fn = jax.shard_map(lambda v, xx: sp.apply(v, xx, train=False), mesh=mesh,
                       in_specs=(P(), P()), out_specs=P(), check_vma=False)
    jax.eval_shape(fn, variables, x)
    return counts


def _port_sp_counts(cfg, size, dtype, monkeypatch) -> collections.Counter:
    counts = collections.Counter()

    def mlp(x, *a, ln_w=None, **k):
        counts["K1 tail" if ln_w is not None else "K1 adapter"] += 1
        return x

    def window_block(x, *a, n_pad=0, **k):
        counts[("K6", x.shape[1], n_pad)] += 1
        return x

    def named(name):
        def call(x, *a, **k):
            counts[name] += 1
            return x
        return call

    def transition(x, *a, **k):
        counts["K8"] += 1
        b, h, w, _ = x.shape
        return x.new_zeros(b, h // 2, w // 2, a[6].shape[0])

    def unfused(blk, x):
        counts["plain attention"] += 1
        b, h, w, _ = x.shape
        return x.new_zeros(b, -(-h // 2), -(-w // 2), blk.dim_out)

    def ring(q, k, v, group, scale=None):
        counts["ring"] += 1
        return q

    for attr, fn in (("fused_mlp", mlp), ("fused_window_block", window_block),
                     ("fused_window_block_strips", named("K4")),
                     ("fused_window_block_strips_rem", named("K12")),
                     ("fused_transition_block", transition)):
        monkeypatch.setattr(port_hiera, attr, fn)
    monkeypatch.setattr(port_hiera.MultiScaleBlock, "_unfused", unfused)
    spa = port_hiera.sp_attention
    monkeypatch.setattr(spa, "ring_sdpa", ring)
    monkeypatch.setattr(spa, "group_index", lambda group: 0)
    monkeypatch.setattr(spa, "gather_tokens",
                        lambda t, group, dim=1: torch.cat([t] * SP_DEGREE, dim))
    fields = {f.name for f in dataclasses.fields(PortHieraConfig)}
    trunk = {k: v for k, v in _narrow(cfg).items() if k in fields}
    model = port_hiera.Hiera(PortHieraConfig(**trunk), use_adapters=True,
                             sp_group=object(), sp_degree=SP_DEGREE)
    dt = getattr(torch, dtype)
    with torch.no_grad():
        model.to(dt).eval()(torch.zeros(1, size, size, 3, dtype=dt))
    return counts


@pytest.mark.parametrize("point", sorted(SPY_POINTS))
def test_sp_routes_equal_the_jax_package(point, monkeypatch):
    """Per forward with the global blocks sequence-parallel: the window
    blocks per block (no persistent layout), one ring call per global
    block, and no global block on the kernels."""
    cfg, size, dtype = SPY_POINTS[point]
    with monkeypatch.context() as mp:
        want = _jax_sp_counts(cfg, size, dtype, mp)
    with monkeypatch.context() as mp:
        got = _port_sp_counts(cfg, size, dtype, mp)
    assert got == want
    assert want["ring"] == len(cfg.global_att_blocks)
    assert want["K1 tail"] == want["K1 adapter"] == cfg.depth
    glob = size // 16
    assert not any(k[0] == "K6" and k[1] == glob * glob
                   for k in want if isinstance(k, tuple))
