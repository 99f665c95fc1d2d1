"""The port's CUDA kernels against their plain versions on the card.

Marked `cuda`: they skip where no CUDA device is present (the decision is
made inside the fixture, never at import). Run on a machine with the card:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q

Shapes are small hiera_l-like geometries (head dim 72) and the hiera_s@960
geometries of K10, K11 and K12 (head dim 96) at a small batch; K10 also
at head dim 256 (the video memory attention's). The backward
kernels (K2, K3, K5, K7, K9) are held against autograd through their plain
versions, at hiera_l@352's widths and head dim 96, with a ragged S for K7
and a tie case for K9's max-pool routing; K14 at every shape its paths
give it (strided views, key rows of 6 to 1024) and at head dim 256 (the
memory attention's under the "pallas" backend); K11 against
`plain_flash_attention_bwd` at S 3600 and 1089, head dims 72 and 96, cross
lengths, strided views, and through autograd and the long block's
backward; K15 and K16 (LN -> x@W, its q / k / v split), K2 without LN or
the residual, the masked whole-grid K6 / K7 (also against the valid-group
route), and the fp32 weight gate's plain route; K7's weight-gradient mode
(dx and the six weight gradients) at S 16 to 256 and widths 144 to 576,
K13 at hiera_s@960 / 1024's remainder grids and 12 x 18 window 5 without
the residual, and autograd through each (a trainable window block; the
frozen remainder strips through both wrappers). Tolerances: max|kernel -
plain| <= 2e-2 * max|plain| in bf16, 1e-4 in fp32 (TF32 off), for each
output (K9 in bf16: see K9_NEAR_TIE_SHARE).
"""

from __future__ import annotations

import math

import pytest
import torch

from sam2unet_torch.ops import dispatch
from sam2unet_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_delta,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
)
from sam2unet_torch.ops.fused_attention_block import (
    fused_window_block,
    fused_window_block_strips,
    fused_window_block_strips_rem,
    window_block_bwd,
    window_block_strips_bwd,
    window_block_strips_rem_bwd,
)
from sam2unet_torch.ops.fused_mlp import adapter_bwd, fused_mlp, mlp_bwd_dx
from sam2unet_torch.ops.fused_transition import (
    fused_transition_block,
    transition_bwd,
)

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


def _compare(call, dtype, near_ties=False, launches=1):
    """Every output within REL_TOL of max|plain|, after `launches` counted
    wrapper launches. With `near_ties` (K9 in
    bf16), up to max(2, K9_NEAR_TIE_SHARE * n) of the n tokens (rows of the
    last axis) may lie outside it, each within K9_NEAR_TIE_REL of
    max|plain|."""
    dispatch.reset_launches()
    got = call()
    assert sum(dispatch.launches.values()) == launches
    with dispatch.force_plain():
        want = call()
    torch.cuda.synchronize()
    for g, w in zip(*((got, want) if isinstance(got, tuple)
                      else ((got,), (want,)))):
        g, w = g.float(), w.float()
        scale = w.abs().max().item()
        err = (g - w).abs().reshape(-1, g.shape[-1]).amax(-1)
        off = err > REL_TOL[dtype] * scale
        assert torch.isfinite(g).all()
        allowed = max(2, int(K9_NEAR_TIE_SHARE * off.numel())) if near_ties else 0
        assert off.sum().item() <= allowed, (off.sum().item(), err.max().item(),
                                             scale)
        if near_ties:
            assert err.max().item() <= K9_NEAR_TIE_REL * scale, (
                err.max().item(), scale)


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
@pytest.mark.parametrize("b,sq,sk", [(2, 4096, 4096), (1, 1000, 1337),
                                     (3, 70, 4100)])
def test_k10_kernel_at_head_dim_256(gen, dtype, b, sq, sk):
    """K10 at the video memory attention's head dim (one head of 256; two
    objects over a 1024-px frame's 4096 tokens), a ragged last key tile and
    query tile, as strided views: q, k and v the head slices of wider
    buffers. o and lse against the plain version; the variant names d."""
    qbuf = _rnd(gen, dtype, b, sq, 2, 256)
    kvbuf = _rnd(gen, dtype, b, sk, 3, 256)
    q, k, v = qbuf[:, :, 1:], kvbuf[:, :, 0:1], kvbuf[:, :, 2:]
    _compare(lambda: flash_attention(q, k, v, return_lse=True), dtype)
    assert dispatch.variants == {("flash_attention", f"S={sk},d=256"): 1}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,sq,sk", [(2, 1024, 1024), (1, 100, 1000),
                                     (3, 70, 333)])
def test_k14_kernel_at_head_dim_256(gen, dtype, b, sq, sk):
    """K14 at the memory attention's head dim under the "pallas" backend
    (one head of 256; two objects over a 512-px frame's 1024 tokens), a
    ragged last key tile, query rows not a multiple of 64, as strided
    views: q, k and v the head slices of wider buffers. Against the plain
    version; the variant names d."""
    from sam2unet_torch.ops.flash_attention import full_attention

    qbuf = _rnd(gen, dtype, b, sq, 2, 256)
    kvbuf = _rnd(gen, dtype, b, sk, 3, 256)
    q, k, v = qbuf[:, :, 1:], kvbuf[:, :, 0:1], kvbuf[:, :, 2:]
    _compare(lambda: full_attention(q, k, v), dtype)
    assert dispatch.variants == {
        ("full_attention", f"Sq={sq},Sk={sk},d=256"): 1}


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["head dim 128", "head dim 264", "K14 at 128",
                                  "K11 at 256"])
def test_head_dims_the_port_does_not_instantiate_raise(gen, case):
    """Head dims without a kernel instance raise on the card, naming ROADMAP
    queue 2 (K10 and K14 have 256 besides up to 96; K11 only up to 96), and
    the backward of K10 at 256 raises rather than recompute through the
    plain version."""
    from sam2unet_torch.ops.flash_attention import full_attention

    d = {"head dim 128": 128, "head dim 264": 264, "K14 at 128": 128}.get(
        case, 256)
    q = _rnd(gen, torch.bfloat16, 1, 2048, 1, d)
    if case == "K14 at 128":
        with pytest.raises(ValueError, match="queue 2"):
            full_attention(q[:, :64], q[:, :64], q[:, :64])
    elif case == "K11 at 256":
        q.requires_grad_(True)
        o = flash_attention(q, q, q)
        with pytest.raises(NotImplementedError, match="K11 at head dim 256.*"
                                                      "queue 2"):
            o.sum().backward()
    else:
        with pytest.raises(ValueError, match="queue 2"):
            flash_attention(q, q, q)


def _k11_inputs(gen, dtype, b, sq, sk, nh, d):
    """q/k/v (channel slices of one QKV buffer when sq == sk), dO, K10's o
    and lse, and three views of one dqkv buffer to write into."""
    if sq == sk:
        qkv = _rnd(gen, dtype, b, sq, 3, nh, d)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    else:
        q = _rnd(gen, dtype, b, sq, nh, d)
        k, v = _rnd(gen, dtype, b, sk, nh, d), _rnd(gen, dtype, b, sk, nh, d)
    dqkv = torch.empty(b, max(sq, sk), 3, nh, d, dtype=dtype, device="cuda")
    outs = (dqkv[:, :sq, 0], dqkv[:, :sk, 1], dqkv[:, :sk, 2])
    o, lse = flash_attention(q, k, v, return_lse=True)
    return q, k, v, o, lse, _rnd(gen, dtype, b, sq, nh, d), outs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [72, 96])
@pytest.mark.parametrize("s", [3600, 1089])  # hiera_s@960 global; ragged
def test_k11_kernel_matches_plain(gen, dtype, d, s):
    """dq, dk and dv written into the channel blocks of one dqkv buffer."""
    q, k, v, o, lse, g, outs = _k11_inputs(gen, dtype, 1, s, s, 2, d)
    _compare(lambda: flash_attention_bwd(q, k, v, o, lse, g, out=outs), dtype,
             launches=3)
    assert dispatch.launches == {
        "flash_attention_bwd_delta": 1, "flash_attention_bwd_dq": 1,
        "flash_attention_bwd_dkv": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_k11_kernel_cross_lengths(gen, dtype):
    q, k, v, o, lse, g, _ = _k11_inputs(gen, dtype, 2, 160, 330, 2, 96)
    _compare(lambda: flash_attention_bwd(q, k, v, o, lse, g), dtype, launches=3)
    q, k, v, o, lse, g, _ = _k11_inputs(gen, dtype, 3, 333, 77, 3, 72)
    _compare(lambda: flash_attention_bwd(q, k, v, o, lse, g), dtype, launches=3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_k11_passes_match_plain_one_by_one(gen, dtype):
    """The delta pass (index b*heads + h with B, heads > 1), the dq pass and
    the dk/dv pass, each against its own plain version."""
    q, k, v, o, lse, g, outs = _k11_inputs(gen, dtype, 2, 200, 200, 3, 96)
    _compare(lambda: flash_attention_bwd_delta(o, g), torch.float32)
    delta = flash_attention_bwd_delta(o, g)
    scale = 1 / math.sqrt(96)
    _compare(lambda: flash_attention_bwd_dq(q, k, v, g, lse, delta, scale,
                                            out=outs[0]), dtype)
    _compare(lambda: flash_attention_bwd_dkv(q, k, v, g, lse, delta, scale,
                                             out=outs[1:]), dtype)


@pytest.mark.cuda
def test_k11_refuses_views_it_cannot_address(gen):
    q, k, v, o, lse, g, _ = _k11_inputs(gen, torch.bfloat16, 1, 64, 64, 2, 96)
    odd = torch.empty(1, 64, 2, 100, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="strides that are multiples of 8"):
        flash_attention_bwd(q, k, v, o, lse, g,
                            out=(odd[..., :96], odd[..., :96], odd[..., :96]))
    with pytest.raises(ValueError, match="lse must be contiguous fp32"):
        flash_attention_bwd(q, k, v, o, lse.t().contiguous().t(), g)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_backward_is_k11(gen, dtype):
    """Autograd through `flash_attention` on the card: one node that keeps
    o and lse, whose backward launches K11 (no second K10)."""
    qkv = _rnd(gen, dtype, 2, 1089, 3, 2, 96).requires_grad_()
    g = _rnd(gen, dtype, 2, 1089, 2, 96)

    def call():
        o = flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
        return torch.autograd.grad(o, qkv, g)[0]

    _compare(call, dtype, launches=4)
    assert dispatch.launches["flash_attention"] == 1
    assert dispatch.launches["flash_attention_bwd_dq"] == 1


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


# ------------------------------------------------------------- backward


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", [144, 576])
def test_k2_kernel_matches_plain(gen, dtype, c):
    x, gy = _rnd(gen, dtype, 3, 50, c), _rnd(gen, dtype, 3, 50, c)
    w1, b1 = _lin(gen, dtype, 4 * c, c)
    w2, b2 = _lin(gen, dtype, c, 4 * c)
    lw, lb = _rnd(gen, dtype, c, scale=0.1, shift=1.0), _rnd(gen, dtype, c, scale=0.1)
    _compare(lambda: mlp_bwd_dx(x, gy, w1, b1, w2, b2, lw, lb), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tokens,c", [(150, 144), (1200, 1152), (777, 576)])
def test_k3_kernel_matches_plain(gen, dtype, tokens, c):
    """dx and the four fp32 weight gradients; 1200 tokens span 5 chunks of
    the two-stage reduction."""
    x, gy = _rnd(gen, dtype, tokens, c), _rnd(gen, dtype, tokens, c)
    w1, b1 = _lin(gen, dtype, 32, c)
    w2, b2 = _lin(gen, dtype, c, 32)
    _compare(lambda: adapter_bwd(x, gy, w1, b1, w2, b2), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_k3_weight_gradients_are_deterministic(gen, dtype):
    x, gy = _rnd(gen, dtype, 4000, 144), _rnd(gen, dtype, 4000, 144)
    w1, b1 = _lin(gen, dtype, 32, 144)
    w2, b2 = _lin(gen, dtype, 144, 32)
    a = adapter_bwd(x, gy, w1, b1, w2, b2)
    b = adapter_bwd(x, gy, w1, b1, w2, b2)
    assert all(torch.equal(u, v) for u, v in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("grid,window,c,heads", [(16, 8, 144, 2), (8, 4, 288, 4),
                                                 (16, 8, 192, 2)])
def test_k5_kernel_matches_plain(gen, dtype, grid, window, c, heads):
    x, gy = _rnd(gen, dtype, 2, grid, grid, c), _rnd(gen, dtype, 2, grid, grid, c)
    w = _attn_weights(gen, dtype, c, c)
    _compare(lambda: window_block_strips_bwd(x, gy, *w, num_heads=heads,
                                             window=window), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s,c,heads", [(256, 144, 2), (64, 288, 4), (484, 144, 2),
                                       (100, 192, 2)])  # ragged; head dim 96
def test_k7_kernel_matches_plain(gen, dtype, s, c, heads):
    x, gy = _rnd(gen, dtype, 2, s, c), _rnd(gen, dtype, 2, s, c)
    w = _attn_weights(gen, dtype, c, c)
    _compare(lambda: window_block_bwd(x, gy, *w, num_heads=heads), dtype)


# K9's two 2x2 max-pools send each pooled gradient to one position: where
# the two recomputed forwards (the kernel's, the plain version's) round a
# near-tie of a cell differently, that channel's gradient goes to another
# of the cell's tokens, and the dx of those two tokens differ. In bf16 that
# happened to 1.6e-5 and 6.5e-5 of the tokens at hiera_l@352's two
# transitions (batch 16), off by at most 0.044 of max|plain|; here one such
# cell (two tokens) or 1e-3 of the tokens may, each within 0.1 of
# max|plain|. fp32 holds every token.
K9_NEAR_TIE_SHARE = 1e-3
K9_NEAR_TIE_REL = 0.1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("grid,window,cin,cout,heads", [
    (16, 8, 72, 144, 2), (8, 4, 144, 288, 4), (16, 8, 96, 192, 2)])
def test_k9_kernel_matches_plain(gen, dtype, grid, window, cin, cout, heads):
    x = _rnd(gen, dtype, 2, grid, grid, cin)
    gy = _rnd(gen, dtype, 2, grid // 2, grid // 2, cout)
    w = _attn_weights(gen, dtype, cin, cout)
    ws, bs = _lin(gen, dtype, cout, cin)
    _compare(lambda: transition_bwd(x, gy, *w, ws, bs, num_heads=heads,
                                    window=window), dtype,
             near_ties=dtype == torch.bfloat16)


def _cells(u, v):
    """x with each 2x2 cell [[u, v], [v, u]] from two (B, h, w, c) maps."""
    x = torch.stack([torch.stack([u, v], 3), torch.stack([v, u], 3)], 2)
    b, h, _, w, _, c = x.shape
    return x.reshape(b, 2 * h, 2 * w, c).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_k9_routes_exact_ties_to_the_first_position(gen, dtype):
    """The four tokens of every 2x2 cell are equal, so the projected q and
    the shortcut tie exactly in every channel in both versions, and every
    pooled gradient goes to the cell's first token."""
    u = _rnd(gen, dtype, 2, 8, 8, 72)
    x = _cells(u, u)
    gy = _rnd(gen, dtype, 2, 8, 8, 144)
    w = _attn_weights(gen, dtype, 72, 144)
    ws, bs = _lin(gen, dtype, 144, 72)
    _compare(lambda: transition_bwd(x, gy, *w, ws, bs, num_heads=2, window=8),
             dtype)


@pytest.mark.cuda
def test_k9_routes_anti_diagonal_ties_in_row_major_order(gen):
    """Cells [[u, v], [v, u]]: each channel ties on the diagonal or the
    anti-diagonal, and the first maximum in row-major order is (0, 0) or
    (0, 1), never (1, 0) (fp32, so no rounding near-ties)."""
    dtype = torch.float32
    x = _cells(_rnd(gen, dtype, 2, 8, 8, 72), _rnd(gen, dtype, 2, 8, 8, 72))
    gy = _rnd(gen, dtype, 2, 8, 8, 144)
    w = _attn_weights(gen, dtype, 72, 144)
    ws, bs = _lin(gen, dtype, 144, 72)
    _compare(lambda: transition_bwd(x, gy, *w, ws, bs, num_heads=2, window=8),
             dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_long_window_block_backward_matches_plain(gen, dtype):
    """A hiera_s@960 global block in miniature width (3600 tokens, head dim
    96): the forward is the long form over K10, the backward runs LN, QKV
    and K10 again and then K11, as the JAX package's recompute does."""
    x = _rnd(gen, dtype, 1, 3600, 192).requires_grad_()
    gy = _rnd(gen, dtype, 1, 3600, 192)
    w = _attn_weights(gen, dtype, 192, 192)

    def call():
        return torch.autograd.grad(fused_window_block(x, *w, num_heads=2), x,
                                   gy)[0]

    _compare(call, dtype, launches=5)
    assert dispatch.launches["flash_attention"] == 2
    assert dispatch.launches["flash_attention_bwd_dq"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", [16, 64, 196, 256])
@pytest.mark.parametrize("c,heads", [(144, 2), (384, 4), (576, 8)])
def test_k7_weight_gradient_mode_matches_plain(gen, dtype, s, c, heads):
    """K7's weight-gradient mode: dx and all six weight gradients (fp32)
    against autograd through the plain version, one launch."""
    x, gy = _rnd(gen, dtype, 3, s, c), _rnd(gen, dtype, 3, s, c)
    w = _attn_weights(gen, dtype, c, c)
    _compare(lambda: window_block_bwd(x, gy, *w, num_heads=heads,
                                      weight_grads=True), dtype)
    assert dict(dispatch.variants) == {("window_block_bwd", f"S={s},wgrad"): 1}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_trainable_window_block_trains_through_k7_weight_gradients(gen, dtype):
    """Autograd through `fused_window_block` with trainable fp32 master
    weights: K6 forward, K7's weight-gradient mode backward, the gradients
    in each weight's own dtype."""
    x, gy = _rnd(gen, dtype, 2, 256, 576), _rnd(gen, dtype, 2, 256, 576)
    w = [t.float().requires_grad_() for t in _attn_weights(gen, dtype, 576, 576)]

    def call():
        xx = x.detach().requires_grad_()
        return torch.autograd.grad(fused_window_block(xx, *w, num_heads=8),
                                   [xx, *w], gy)

    _compare(call, dtype, launches=2)
    assert dispatch.variants[("window_block_bwd", "S=256,wgrad")] == 1
    assert [g.dtype for g in call()] == [dtype] + [torch.float32] * 6


# (batch, H, W, c, heads, window, residual, the JAX package's kernel):
# hiera_s@960 / 1024's stage 3 and 4 grids at batch 1, and the JAX test's
# 12 x 18 window 5 without the residual
K13_SHAPES = [(1, 60, 60, 384, 4, 14, True, "K13b"),
              (1, 64, 64, 384, 4, 14, True, "K13b"),
              (1, 30, 30, 768, 8, 7, True, "K13a"),
              (1, 32, 32, 768, 8, 7, True, "K13a"),
              (2, 12, 18, 144, 2, 5, False, "K13a")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("geom", K13_SHAPES)
def test_k13_kernel_matches_plain(gen, dtype, geom):
    """K13: dx of K12 for a cotangent, the weights frozen, against autograd
    through the plain version; counted under the JAX package's kernel for
    the geometry in bf16."""
    b, h, w_, c, heads, window, residual, kernel = geom
    x, gy = _rnd(gen, dtype, b, h, w_, c), _rnd(gen, dtype, b, h, w_, c)
    w = _attn_weights(gen, dtype, c, c)
    _compare(lambda: window_block_strips_rem_bwd(
        x, gy, *w, num_heads=heads, window=window, residual=residual), dtype)
    (wrapper, variant), = dispatch.variants
    assert wrapper == "window_block_strips_rem_bwd"
    if dtype == torch.bfloat16:
        assert variant == f"window={window},{kernel}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fn", ["strips", "strips_rem"])
def test_frozen_remainder_strips_train_through_k13(gen, dtype, fn):
    """Autograd through the remainder strips with frozen weights: the
    forward K12 (both wrappers at 12 x 18 window 5, 4 window columns), the
    backward K13."""
    x, gy = _rnd(gen, dtype, 2, 12, 18, 144), _rnd(gen, dtype, 2, 12, 18, 144)
    w = _attn_weights(gen, dtype, 144, 144)
    wrapper = (fused_window_block_strips if fn == "strips"
               else fused_window_block_strips_rem)

    def call():
        xx = x.detach().requires_grad_()
        y = wrapper(xx, *w, num_heads=2, window=5)
        return (y,) + torch.autograd.grad(y, xx, gy)

    _compare(call, dtype, launches=2)
    assert dispatch.launches["fused_window_block_strips_rem"] == 1
    assert dispatch.launches["window_block_strips_rem_bwd"] == 1


# ------------------------------------------------------------------ K14

# (batch, q length, k length, heads, head dim) of every path that reaches
# K14: the stage 3->4 transition of SAM2 hiera_s@1024 (25 windows), the
# mask decoder's token self-attention and image->token attention (8
# tokens), SAM2-UNet's transitions at 960 (batch 2 here) and 352; a key
# row of 6, 9, 16 and 1024 keys, head dim 8
K14_SHAPES = [(25, 49, 196, 8, 96), (1, 8, 8, 8, 32), (1, 4096, 8, 8, 16),
              (50, 49, 196, 8, 96), (8, 64, 256, 16, 72), (2, 6, 6, 8, 32),
              (1, 4096, 9, 8, 16), (1, 16, 16, 8, 32), (3, 100, 1024, 2, 64),
              (2, 70, 17, 3, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", K14_SHAPES)
def test_k14_kernel_matches_plain(gen, dtype, shape):
    from sam2unet_torch.ops.flash_attention import full_attention

    b, sq, sk, nh, d = shape
    q = _rnd(gen, dtype, b, sq, nh, d)
    kv = _rnd(gen, dtype, b, sk, 2, nh, d)   # k and v: strided views
    _compare(lambda: full_attention(q, kv[:, :, 0], kv[:, :, 1]), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_k14_reads_the_qkv_channel_slices_of_the_trunk(gen, dtype):
    """q, k and v as the unfused transition's `sdpa` passes them: channel
    blocks of one (windows, tokens, 3c) QKV output."""
    from sam2unet_torch.ops.flash_attention import full_attention

    qkv = _rnd(gen, dtype, 25, 196, 3 * 768)
    q, k, v = (qkv[..., i * 768:(i + 1) * 768].reshape(25, 196, 8, 96)
               for i in range(3))
    _compare(lambda: full_attention(q[:, :49], k, v), dtype)


@pytest.mark.cuda
def test_k14_is_differentiable_through_the_plain_version(gen):
    """K14's backward is the JAX package's einsum recompute
    (`plain_full_attention_bwd`): in fp32 it equals autograd through the
    plain forward; in bf16 it keeps p in fp32, as the recompute does."""
    from sam2unet_torch.ops.flash_attention import (
        full_attention,
        plain_full_attention,
        plain_full_attention_bwd,
    )

    q, k, v = (_rnd(gen, torch.float32, 2, 40, 2, 32).requires_grad_(True)
               for _ in range(3))
    gy = _rnd(gen, torch.float32, 2, 40, 2, 32)
    got = torch.autograd.grad(full_attention(q, k, v), (q, k, v), gy)
    want = torch.autograd.grad(plain_full_attention(q, k, v), (q, k, v), gy)
    for g, w in zip(got, want):
        assert (g - w).abs().max() <= 1e-4 * w.abs().max()
    q, k, v, gy = (t.detach().bfloat16() for t in (q, k, v, gy))
    got = torch.autograd.grad(
        full_attention(*(t.requires_grad_(True) for t in (q, k, v))),
        (q, k, v), gy)
    want = plain_full_attention_bwd(q, k, v, gy)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert (g.float() - w.float()).abs().max() <= (
            1e-3 * w.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["1025 keys", "head dim 12", "head dim 104",
                                  "odd token stride", "mixed dtypes"])
def test_k14_refuses_what_it_cannot_take(gen, case):
    from sam2unet_torch.ops.flash_attention import full_attention

    q = _rnd(gen, torch.bfloat16, 1, 8, 2, 16)
    k = v = q
    if case == "1025 keys":
        k = v = _rnd(gen, torch.bfloat16, 1, 1025, 2, 16)
    elif case == "head dim 12":
        q = k = v = _rnd(gen, torch.bfloat16, 1, 8, 2, 12)
    elif case == "head dim 104":
        q = k = v = _rnd(gen, torch.bfloat16, 1, 8, 1, 104)
    elif case == "odd token stride":
        k = v = _rnd(gen, torch.bfloat16, 1, 8, 2 * 16 + 4)[..., :32].reshape(
            1, 8, 2, 16)
    else:
        k = v = q.float()
    with pytest.raises((ValueError, TypeError)):
        full_attention(q, k, v)


@pytest.mark.cuda
def test_pallas_backend_sends_the_decoder_and_transition_to_k14(gen):
    """Under `set_attention_impl("pallas")`: attention over at most 1024
    keys launches K14, 16 tokens against 4096 keys K10, 8 tokens against
    4096 keys nothing (no aligned block divides 8), as the JAX package's
    `_dispatch_fwd` does."""
    from sam2unet_torch.ops.attention import sdpa, set_attention_impl

    q8, q16 = (_rnd(gen, torch.bfloat16, 1, t, 8, 16) for t in (8, 16))
    img = _rnd(gen, torch.bfloat16, 1, 4096, 8, 16)
    set_attention_impl("pallas")
    try:
        for (q, k), want in (((q8, q8), "full_attention"),
                             ((img, q8), "full_attention"),
                             ((q16, img), "flash_attention"), ((q8, img), None)):
            dispatch.reset_launches()
            sdpa(q, k, k)
            assert dict(dispatch.launches) == ({want: 1} if want else {})
    finally:
        set_attention_impl(None)


# --------------------------------------------- K15, K16, K2 modes, masked


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("add_bias", [True, False])
@pytest.mark.parametrize("c", [144, 576])
def test_k15_k16_kernels_match_plain(gen, dtype, add_bias, c):
    """LN -> x@W [+ b] (K15) and its q / k / v split (K16, three separate
    contiguous tensors that equal K15's column blocks to the bit)."""
    from sam2unet_torch.ops.fused_mlp import fused_ln_matmul, fused_ln_qkv

    x = _rnd(gen, dtype, 3, 50, c)
    w, b = _lin(gen, dtype, 3 * c, c)
    lw, lb = _rnd(gen, dtype, c, scale=0.1, shift=1.0), _rnd(gen, dtype, c, scale=0.1)
    _compare(lambda: fused_ln_matmul(x, w, b, lw, lb, add_bias), dtype)
    _compare(lambda: fused_ln_qkv(x, w, b, lw, lb, add_bias), dtype)
    q, k, v = fused_ln_qkv(x, w, b, lw, lb, add_bias)
    assert all(t.is_contiguous() for t in (q, k, v))
    assert q.data_ptr() != k.data_ptr() != v.data_ptr()
    assert torch.equal(torch.cat([q, k, v], -1),
                       fused_ln_matmul(x, w, b, lw, lb, add_bias))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ln,residual", [(True, False), (False, True),
                                         (False, False)])
def test_k2_modes_match_plain(gen, dtype, ln, residual):
    """K2 without LN, without the residual, or without both, directly and
    as the backward of a frozen `fused_mlp` (K1 forward, K2 backward)."""
    c = 144
    x, gy = _rnd(gen, dtype, 3, 50, c), _rnd(gen, dtype, 3, 50, c)
    w1, b1 = _lin(gen, dtype, 4 * c, c)
    w2, b2 = _lin(gen, dtype, c, 4 * c)
    kw = dict(ln_w=_rnd(gen, dtype, c, scale=0.1, shift=1.0),
              ln_b=_rnd(gen, dtype, c, scale=0.1)) if ln else {}
    _compare(lambda: mlp_bwd_dx(x, gy, w1, b1, w2, b2, residual=residual, **kw),
             dtype)

    def call():
        xx = x.detach().requires_grad_()
        y = fused_mlp(xx, w1, b1, w2, b2, residual=residual, **kw)
        return torch.autograd.grad(y, xx, gy)[0]

    _compare(call, dtype, launches=2)
    assert dispatch.launches["mlp_bwd_dx"] == 1


@pytest.mark.cuda
def test_fp32_weight_gate_runs_the_plain_mlp(gen):
    """fp32 with more than 12 MiB of weights (c 768, hidden 3072) launches
    nothing, as the JAX package runs its XLA form there; bf16 launches."""
    c = 768
    w1, b1 = _lin(gen, torch.float32, 4 * c, c)
    w2, b2 = _lin(gen, torch.float32, c, 4 * c)
    for dtype, want in ((torch.float32, {}), (torch.bfloat16, {"fused_mlp": 1})):
        x = _rnd(gen, dtype, 10, c)
        dispatch.reset_launches()
        fused_mlp(x, w1, b1, w2, b2)
        assert dict(dispatch.launches) == want


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("grid,window,c,heads", [
    (22, 16, 576, 8), (11, 8, 1152, 16), (18, 14, 192, 2), (4, 3, 144, 2)])
def test_masked_k6_k7_match_plain(gen, dtype, grid, window, c, heads):
    """The masked whole-grid mode: K6 forward and K7's masked dx-only
    backward, and both equal to the valid-group route on the same grid."""
    from sam2unet_torch.ops.fused_attention_block import valid_group_blocks
    from sam2unet_torch.ops.windowing import grid_window_mask

    mask, lm = (torch.from_numpy(a).cuda() for a in grid_window_mask(
        grid, grid, window))
    x = _rnd(gen, dtype, 2, grid * grid, c)
    gy = _rnd(gen, dtype, 2, grid * grid, c)
    w = _attn_weights(gen, dtype, c, c)
    kw = dict(num_heads=heads, attn_mask=mask, pad_logmult=lm)
    _compare(lambda: fused_window_block(x, *w, **kw), dtype)
    _compare(lambda: window_block_bwd(x, gy, *w, **kw), dtype)
    masked = fused_window_block(x, *w, **kw).float()
    groups = valid_group_blocks(fused_window_block,
                                x.reshape(2, grid, grid, c), *w,
                                num_heads=heads, window=window)
    err = (masked.reshape(groups.shape) - groups.float()).abs().max().item()
    assert err <= REL_TOL[dtype] * groups.float().abs().max().item()
