"""The port's counterparts of the JAX driver's entry points
(`sam2unet_torch/parallel/dryrun.py`, after `__graft_entry__.py`) on the
CPU.

  - `entry("cpu")`: the flagship hiera_s SAM2-UNet in fp32, eval mode, a
    zero 352x352 image; its `fn` on the JAX SAM2-UNet's parameters against
    the JAX forward at 64 px, 2e-5 of each output's max.
  - `dryrun_multichip(4)` on ranks it starts itself (gloo on the CPU) with
    DRYRUN_BUDGET_S=-1, with and without DRYRUN_FULL: the same lines as the
    JAX function's on 4 of the conftest's virtual devices (the phases'
    names and order, the heavy phases' notice, a skip notice per phase),
    the elapsed seconds aside.
  - a rank that fails fails the call (ranks on the "meta" device, which no
    kernel wrapper takes).
  - the whole dry run on the CPU, every phase (`slow`; the card runs it
    through chip_smoke.py's s352mc path with every check).
"""

from __future__ import annotations

import dataclasses
import re

import jax
import numpy as np
import pytest
import torch
from test_torch_model_cpu import _perturb

import __graft_entry__
from sam2unet_torch.configs import HIERA_S as PORT_HIERA_S
from sam2unet_torch.interop.from_jax import jax_to_state_dict
from sam2unet_torch.parallel import dryrun
from sam2unet_tpu.configs import HIERA_S, SAM2UNetConfig
from sam2unet_tpu.models.sam2unet import SAM2UNet

SIZE = 64


def test_entry_is_the_flagship_forward_in_fp32_on_the_cpu():
    fn, (model, x) = dryrun.entry("cpu")
    assert dataclasses.asdict(model.cfg.trunk) == dataclasses.asdict(PORT_HIERA_S)
    assert not model.training and x.shape == (1, 352, 352, 3)
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert not x.any() and x.device == torch.device("cpu")
    jmodel = SAM2UNet(SAM2UNetConfig(trunk=HIERA_S))
    xs = np.random.default_rng(1).standard_normal((1, SIZE, SIZE, 3)).astype(
        np.float32)
    variables = jax.jit(jmodel.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), xs, train=False)
    variables = _perturb(dict(jax.tree_util.tree_map(np.asarray, variables)),
                         np.random.default_rng(1))
    want = jax.jit(lambda v, xx: jmodel.apply(v, xx, train=False))(variables, xs)
    model.load_state_dict(jax_to_state_dict(variables, model.state_dict().keys()))
    got = fn(model, torch.from_numpy(xs))
    assert len(got) == 3
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape == (1, SIZE, SIZE, 1)
        assert float(np.abs(g.numpy() - w).max()) <= 2e-5 * float(np.abs(w).max())


def _lines(text: str) -> list[str]:
    """The dry run's lines, elapsed seconds masked."""
    out = []
    for line in text.splitlines():
        if line.startswith(("[dryrun]", "dryrun_multichip(")):
            out.append(re.sub(r"\(\d+(\.\d+)?s", "(Ns", line))
    return out


@pytest.mark.parametrize("full", ["", "1"], ids=["default", "DRYRUN_FULL"])
def test_the_phases_and_knobs_are_the_jax_functions(full, capfd, monkeypatch):
    monkeypatch.setenv("DRYRUN_BUDGET_S", "-1")
    monkeypatch.setenv("DRYRUN_FULL", full)
    __graft_entry__.dryrun_multichip(4)
    want = _lines(capfd.readouterr().out)
    dryrun.dryrun_multichip(4, device="cpu")
    got = _lines(capfd.readouterr().out)
    assert got == want
    assert len([w for w in want if "SKIPPED" in w]) == (5 if full else 3)


def test_a_failing_rank_fails_the_call():
    with pytest.raises(RuntimeError, match="ranks failed"):
        dryrun.dryrun_multichip(2, device="meta")


@pytest.mark.slow
def test_dryrun_multichip_4_on_the_cpu(monkeypatch):
    """Every phase on 4 ranks on the CPU."""
    monkeypatch.setenv("DRYRUN_FULL", "1")
    monkeypatch.setenv("DRYRUN_BUDGET_S", "100000")
    dryrun.dryrun_multichip(4, device="cpu")
