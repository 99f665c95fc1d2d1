"""The port's CUDA kernels against their plain versions on the card.

Marked `cuda`: they skip where no CUDA device is present (the decision is
made inside the fixture, never at import). Run on a machine with the card:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q

Shapes are small hiera_l-like geometries (head dim 72) and the hiera_s@960
geometries of K10 and K12 (head dim 96) at a small batch. Tolerances:
max|kernel - plain| <= 2e-2 * max|plain| in bf16, 1e-4 in fp32 (TF32 off).
"""

from __future__ import annotations

import math

import pytest
import torch

from sam2unet_torch.ops import dispatch
from sam2unet_torch.ops.flash_attention import flash_attention
from sam2unet_torch.ops.fused_attention_block import (
    fused_window_block,
    fused_window_block_strips,
    fused_window_block_strips_rem,
)
from sam2unet_torch.ops.fused_mlp import fused_mlp
from sam2unet_torch.ops.fused_transition import fused_transition_block

REL_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def _rnd(gen, dtype, *shape, scale=1.0, shift=0.0):
    t = torch.randn(*shape, generator=gen, device="cuda") * scale + shift
    return t.to(dtype)


def _lin(gen, dtype, o, i):
    return (_rnd(gen, dtype, o, i, scale=1 / math.sqrt(i)),
            _rnd(gen, dtype, o, scale=0.1))


def _compare(call, dtype):
    dispatch.reset_launches()
    got = call()
    assert sum(dispatch.launches.values()) == 1
    with dispatch.force_plain():
        want = call()
    torch.cuda.synchronize()
    for g, w in zip(*((got, want) if isinstance(got, tuple)
                      else ((got,), (want,)))):
        g, w = g.float(), w.float()
        err = (g - w).abs().max().item()
        assert err <= REL_TOL[dtype] * w.abs().max().item(), err


DTYPES = [torch.bfloat16, torch.float32]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c,hidden,ln", [(144, 576, True), (144, 32, False)])
def test_k1_kernel_matches_plain(gen, dtype, c, hidden, ln):
    x = _rnd(gen, dtype, 3, 50, c)
    w1, b1 = _lin(gen, dtype, hidden, c)
    w2, b2 = _lin(gen, dtype, c, hidden)
    kw = dict(ln_w=_rnd(gen, dtype, c, scale=0.1, shift=1.0),
              ln_b=_rnd(gen, dtype, c, scale=0.1)) if ln else dict(gelu_out=True)
    _compare(lambda: fused_mlp(x, w1, b1, w2, b2, residual=True, **kw), dtype)


def _attn_weights(gen, dtype, cin, cout):
    wq, bq = _lin(gen, dtype, 3 * cout, cin)
    wp, bp = _lin(gen, dtype, cout, cout)
    return (wq, bq, _rnd(gen, dtype, cin, scale=0.1, shift=1.0),
            _rnd(gen, dtype, cin, scale=0.1), wp, bp)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("grid,window", [(16, 8), (8, 4)])
def test_k4_kernel_matches_plain(gen, dtype, grid, window):
    x = _rnd(gen, dtype, 2, grid, grid, 144)
    w = _attn_weights(gen, dtype, 144, 144)
    _compare(lambda: fused_window_block_strips(x, *w, num_heads=2,
                                               window=window), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s,n_pad", [(256, 0), (96, 160), (9, 55), (484, 0)])
def test_k6_kernel_matches_plain(gen, dtype, s, n_pad):
    x = _rnd(gen, dtype, 2, s, 144)
    w = _attn_weights(gen, dtype, 144, 144)
    _compare(lambda: fused_window_block(x, *w, num_heads=2, n_pad=n_pad), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", [112, 192])  # head dims 56 (hiera_b+), 96 (t, s)
@pytest.mark.parametrize("s,n_pad", [(196, 0), (98, 98)])  # window 14 groups
def test_k6_kernel_other_head_dims(gen, dtype, c, s, n_pad):
    x = _rnd(gen, dtype, 2, s, c)
    w = _attn_weights(gen, dtype, c, c)
    _compare(lambda: fused_window_block(x, *w, num_heads=2, n_pad=n_pad), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("grid,window", [(16, 8), (8, 4)])
def test_k8_kernel_matches_plain(gen, dtype, grid, window):
    x = _rnd(gen, dtype, 2, grid, grid, 72)
    w = _attn_weights(gen, dtype, 72, 144)
    ws, bs = _lin(gen, dtype, 144, 72)
    _compare(lambda: fused_transition_block(x, *w, ws, bs, num_heads=2,
                                            window=window), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [72, 96])
@pytest.mark.parametrize("s", [3600, 1089])  # hiera_s@960 global; ragged
def test_k10_kernel_matches_plain(gen, dtype, d, s):
    """o and lse, with q/k/v as channel slices of one QKV buffer."""
    qkv = _rnd(gen, dtype, 1, s, 3, 2, d)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    _compare(lambda: flash_attention(q, k, v, return_lse=True), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_k10_kernel_cross_lengths(gen, dtype):
    q = _rnd(gen, dtype, 2, 160, 2, 96)
    k, v = _rnd(gen, dtype, 2, 330, 2, 96), _rnd(gen, dtype, 2, 330, 2, 96)
    _compare(lambda: flash_attention(q, k, v, return_lse=True), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_long_window_block_matches_plain(gen, dtype):
    """A global block past the live-VMEM gate: LN -> QKV -> K10 -> proj."""
    x = _rnd(gen, dtype, 1, 3600, 192)
    w = _attn_weights(gen, dtype, 192, 192)
    _compare(lambda: fused_window_block(x, *w, num_heads=2), dtype)
    assert dispatch.launches == {"flash_attention": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("h,w,c,heads,window", [
    (60, 60, 384, 4, 14), (30, 30, 768, 8, 7),   # hiera_s@960 stages 3, 4
    (28, 28, 192, 2, 14), (12, 18, 144, 2, 5)])  # unaligned; ragged both ways
def test_k12_kernel_matches_plain(gen, dtype, h, w, c, heads, window):
    x = _rnd(gen, dtype, 1, h, w, c)
    wts = _attn_weights(gen, dtype, c, c)
    _compare(lambda: fused_window_block_strips_rem(x, *wts, num_heads=heads,
                                                   window=window), dtype)
