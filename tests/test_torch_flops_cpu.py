"""The port's FLOP audit (`utils/flops_audit.py`) on the CPU, one torch
thread.

  (a) at sam2_hiera_t@128 against the JAX package's `audit` on the same
      config: FlopCounterMode counts matrix products, convolutions and
      attention, XLA's cost analysis elementwise work besides, and the JAX
      train step more backward work than the port's (measured at this
      config: port / JAX = 0.9889 forward, 0.8574 train step; at 256 px
      0.9761 and 0.8467; at sam2_hiera_s@128 0.9839 and 0.8397;
      sam2_hiera_l@128 0.9723 and 0.7772). Band: forward 0.95-1.0, train
      step 0.80-0.90.
  (b) the JAX test's sanity bounds (tests/test_flops_audit.py) on the
      port's count: train between 1.5x and 3.5x the forward, and 128 ->
      256 px scaling the forward between 3.0x and 5.5x.
  (c) exact counts: one linear layer 2*M*N*K; the K1 plain version
      (LN -> x @ W1 -> GELU -> @ W2) 2 * 2*M*C*H; and the
      audit's CLI prints one JSON line.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from sam2unet_torch.ops.fused_mlp import fused_mlp
from sam2unet_torch.utils import flops_audit
from sam2unet_tpu.utils.flops_audit import audit as jax_audit

INFER_BAND = (0.95, 1.0)
TRAIN_BAND = (0.80, 0.90)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the suite runs several test processes on the
    machine's cores, where torch's own pool would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port_128():
    return flops_audit.audit("sam2_hiera_t", 128, "both", "cpu")


def test_audit_sits_in_the_band_of_the_jax_audit(port_128):
    want = jax_audit("sam2_hiera_t", size=128, mode="both")
    infer = port_128["infer"] / want["infer"]
    train = port_128["train"] / want["train"]
    assert INFER_BAND[0] <= infer <= INFER_BAND[1], infer
    assert TRAIN_BAND[0] <= train <= TRAIN_BAND[1], train


def test_audit_holds_the_jax_sanity_bounds(port_128):
    assert np.isfinite(port_128["infer"]) and port_128["infer"] > 1e8
    assert 1.5 * port_128["infer"] < port_128["train"] < 3.5 * port_128["infer"]
    big = flops_audit.audit("sam2_hiera_t", 256, "infer", "cpu")
    assert set(big) == {"infer"}
    ratio = big["infer"] / port_128["infer"]
    assert 3.0 < ratio < 5.5, ratio


def test_a_linear_layer_counts_exactly():
    m, k, n = 37, 24, 10
    layer = torch.nn.Linear(k, n)
    x = torch.randn(m, k)
    assert flops_audit.count_flops(layer, x) == 2 * m * n * k


def test_the_k1_plain_version_counts_exactly():
    rows, c, h = 50, 16, 40
    g = torch.Generator().manual_seed(0)
    args = [torch.randn(rows, c, generator=g),
            torch.randn(h, c, generator=g), torch.randn(h, generator=g),
            torch.randn(c, h, generator=g), torch.randn(c, generator=g),
            torch.ones(c), torch.zeros(c)]
    assert flops_audit.count_flops(fused_mlp, *args) == 2 * 2 * rows * c * h


def test_the_cli_prints_one_json_line(capsys):
    out = flops_audit.main(["--model_cfg", "hiera_test", "--size", "64",
                            "--mode", "infer", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip()) == out
    assert set(out) == {"infer"} and out["infer"] > 0
