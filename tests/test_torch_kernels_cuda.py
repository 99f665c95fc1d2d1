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
backward, and its bf16 passes on the Hopper kernels
(csrc/flash_attention_bwd_sm90.cu) at head dims 56-256 with S_q 1000
against S_k 1337, under autograd, beside neighbouring channel blocks they
must leave alone, and twice with the same bits; K10 and K14 in bf16 on the
Hopper forward (csrc/flash_attention_fwd_sm90.cu) at head dims 16-256 over
S_q 1000 against S_k 1337 (K14: 1024) and key rows of 7, 196 and 1024,
with no row written past S_q, twice with the same bits and under autograd
into K11; K15 and K16 (LN -> x@W, its q / k / v split), K2 without LN or
the residual, the masked whole-grid K6 / K7 (also against the valid-group
route), and the fp32 weight gate's plain route; K7's weight-gradient mode
(dx and the six weight gradients) at S 16 to 256 and widths 144 to 576,
K13 at hiera_s@960 / 1024's remainder grids and 12 x 18 window 5 without
the residual, and autograd through each (a trainable window block; the
frozen remainder strips through both wrappers); the head dims past the
16-byte-vector instances (csrc/attention_any*.cu): each window-family mode
at head dim 12, K10 / K11 / K14 at 12, 13, 44, 130, 264, K11 at 256,
views at any stride; the widths past the 16-byte-vector LN and GEMM
instances (csrc/gemm_any.cu): K1 / K2 / K3 at C 12, 13, 20 and 2056, K15 /
K16 at the JAX test's 12 -> 36, 13 -> 20, 2060 -> 24 and 572 -> 1716,
K6 / K7 in every mode at c 26, 20 and 2064, the strips and remainder
strips at c 26, K8 / K9 at 20 -> 40, 2056 -> 48 and an odd cout; K1 and
K2 in bf16 on the Hopper GEMM and adapter (csrc/mlp_sm90.cu) at every
main-path width and the window groups' row counts, with no row written past
M and twice with the same bits; K5 and K9 in bf16 on csrc/block_bwd_sm90.cu
at the main paths' window shapes, an odd count of w4 windows along W and
exactly tied cells, twice with the same bits, fp32 and head dim 144 on the
old sources.
Tolerances: max|kernel - plain| <= 2e-2 * max|plain| in bf16, 1e-4 in
fp32 (TF32 off), for each output (K9 in bf16: see K9_NEAR_TIE_SHARE).
"""

from __future__ import annotations

import math

import pytest
import torch

from sam2unet_torch.ops import dispatch
from sam2unet_torch.ops.flash_attention import (
    _bwd_library,
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
    # a copy: a call that writes into views it was given writes them again
    got = (tuple(t.clone() for t in got) if isinstance(got, tuple)
           else got.clone())
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
def test_head_dims_past_the_vector_instances_match_plain(gen, case):
    """Head dims past the 16-byte-vector instances: K10 at 128 and 264, K14
    at 128, and K10 at 256 under autograd, whose backward is K11 at 256 (its
    delta, dq and dk/dv passes), each against its plain version; the variant
    names d. fp32 and d 264 run csrc/attention_any*.cu, bf16 at 128 and 256
    the Hopper kernels."""
    from sam2unet_torch.ops.flash_attention import full_attention

    d = {"head dim 128": 128, "head dim 264": 264, "K14 at 128": 128}.get(
        case, 256)
    for dtype in DTYPES:
        q = _rnd(gen, dtype, 1, 2048, 1, d)
        if case == "K14 at 128":
            _compare(lambda: full_attention(q[:, :64], q[:, :64], q[:, :64]),
                     dtype)
            assert dispatch.variants == {("full_attention", "Sq=64,Sk=64,d=128"): 1}
        elif case == "K11 at 256":
            q.requires_grad_(True)
            g = _rnd(gen, dtype, 1, 2048, 1, d)

            def call():
                o = flash_attention(q, q * 0.5, q)
                return torch.autograd.grad(o, q, g)[0]
            _compare(call, dtype, launches=4)
            assert dispatch.launches["flash_attention_bwd_dkv"] == 1
        else:
            _compare(lambda: flash_attention(q, q, q, return_lse=True), dtype)
            assert dispatch.variants == {("flash_attention", f"S=2048,d={d}"): 1}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("view", ["odd token stride", "offset base"])
def test_head_dim_256_at_views_without_16_byte_vectors(gen, dtype, view):
    """K10 (o and lse, and under autograd with K11) and K14 at head dim 256
    on views the d256 forwards' 16-byte loads cannot read: a token stride of
    3 * 256 + 4 elements, or a base one element past an aligned one. They
    run the element-loading kernels; against the plain versions."""
    from sam2unet_torch.ops.flash_attention import full_attention

    if view == "odd token stride":
        buf = _rnd(gen, dtype, 2, 300, 3 * 256 + 4)[..., :3 * 256]
    else:
        buf = _rnd(gen, dtype, 2 * 300 * 3 * 256 + 1)[1:]
    qkv = buf.reshape(2, 300, 3, 1, 256).requires_grad_(True)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert q.stride(1) % 8 or q.data_ptr() % 16
    _compare(lambda: flash_attention(q.detach(), k.detach(), v.detach(),
                                     return_lse=True), dtype)
    assert dispatch.variants == {("flash_attention", "S=300,d=256"): 1}
    g = _rnd(gen, dtype, 2, 300, 1, 256)

    def grad():
        o = flash_attention(q, k, v)
        return torch.autograd.grad(o, qkv, g)[0]
    _compare(grad, dtype, launches=4)
    _compare(lambda: full_attention(q.detach()[:, :49], k.detach()[:, :196],
                                    v.detach()[:, :196]), dtype)
    assert dispatch.variants == {("full_attention", "Sq=49,Sk=196,d=256"): 1}


# head dims the vector instances do not take: the JAX kernel tests' 12, an
# odd 13 (2-byte rows), 44 (one chunk, element loads), 130 (three chunks,
# the last ragged) and 264
ANY_HEAD_DIMS = [12, 13, 44, 130, 264]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", ANY_HEAD_DIMS)
def test_flash_family_at_any_head_dim(gen, dtype, d):
    """K10 (o and lse) on strided views of one QKV buffer and on cross
    lengths, K11 through autograd (one launch each of K10, the delta, the
    dq and the dk/dv pass), K14 over 49 -> 196 keys, each against its plain
    version."""
    from sam2unet_torch.ops.flash_attention import full_attention

    qkv = _rnd(gen, dtype, 2, 300, 3, 2, d).requires_grad_(True)
    g = _rnd(gen, dtype, 2, 300, 2, d)
    _compare(lambda: flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                                     return_lse=True), dtype)
    q = _rnd(gen, dtype, 2, 77, 2, d)
    _compare(lambda: flash_attention(q, qkv[:, :, 1].detach(),
                                     qkv[:, :, 2].detach(), return_lse=True),
             dtype)

    def grad():
        o = flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
        return torch.autograd.grad(o, qkv, g)[0]
    _compare(grad, dtype, launches=4)
    kv = _rnd(gen, dtype, 2, 196, 2, 2, d)
    _compare(lambda: full_attention(q[:, :49], kv[:, :, 0], kv[:, :, 1]), dtype)
    assert dispatch.variants == {("full_attention", f"Sq=49,Sk=196,d={d}"): 1}


# each window-family mode at the JAX kernel tests' head dim 12: c 24 over
# 2 heads, the transition 24 -> 48 over 4 (tests/test_fused_ops.py)
WINDOW_MODES = ["K4", "K5", "K6", "K6 pad key", "K6 masked", "K7", "K7 masked",
                "K7 weight-grad", "K8", "K9", "K12", "K13"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", WINDOW_MODES)
def test_window_family_at_head_dim_12(gen, dtype, mode):
    """Each window-family kernel's mode at head dim 12 against its plain
    version, one launch of its wrapper; the backward kernels against
    autograd through the plain forward."""
    from sam2unet_torch.ops.windowing import grid_window_mask

    w = _attn_weights(gen, dtype, 24, 24)
    kw = dict(num_heads=2)
    if mode in ("K4", "K5", "K12", "K13"):
        grid = 16 if mode in ("K4", "K5") else 30
        x, gy = (_rnd(gen, dtype, 2, grid, grid, 24) for _ in range(2))
        call = {"K4": lambda: fused_window_block_strips(x, *w, window=8, **kw),
                "K12": lambda: fused_window_block_strips_rem(x, *w, window=8, **kw),
                "K5": lambda: window_block_strips_bwd(x, gy, *w, window=8, **kw),
                "K13": lambda: window_block_strips_rem_bwd(x, gy, *w, window=8,
                                                           **kw)}[mode]
    elif mode in ("K8", "K9"):
        x = _rnd(gen, dtype, 2, 16, 16, 24)
        gy = _rnd(gen, dtype, 2, 8, 8, 48)
        wt = _attn_weights(gen, dtype, 24, 48)
        ws, bs = _lin(gen, dtype, 48, 24)
        kw = dict(num_heads=4, window=8)
        call = ((lambda: fused_transition_block(x, *wt, ws, bs, **kw))
                if mode == "K8" else
                (lambda: transition_bwd(x, gy, *wt, ws, bs, **kw)))
    else:
        s = 144 if "masked" in mode else 64
        x, gy = (_rnd(gen, dtype, 4, s, 24) for _ in range(2))
        if "masked" in mode:
            mask, lm = (torch.from_numpy(a).cuda()
                        for a in grid_window_mask(12, 12, 8))
            kw.update(attn_mask=mask, pad_logmult=lm)
        if mode == "K6 pad key":
            kw.update(n_pad=16)
        if mode == "K7 weight-grad":
            kw.update(weight_grads=True)
        call = ((lambda: fused_window_block(x, *w, **kw)) if mode.startswith("K6")
                else (lambda: window_block_bwd(x, gy, *w, **kw)))
    _compare(call, dtype, near_ties=mode == "K9" and dtype == torch.bfloat16)


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
    wide = torch.empty(1, 64, 2, 192, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="unit stride over d"):
        flash_attention_bwd(q, k, v, o, lse, g,
                            out=(wide[..., ::2], wide[..., ::2], wide[..., ::2]))
    with pytest.raises(ValueError, match="lse must be contiguous fp32"):
        flash_attention_bwd(q, k, v, o, lse.t().contiguous().t(), g)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_k11_writes_views_at_any_stride(gen, dtype):
    """dq, dk and dv written into views whose head stride (100 elements) is
    no multiple of 8: the element-loading passes take them."""
    q, k, v, o, lse, g, _ = _k11_inputs(gen, dtype, 1, 64, 64, 2, 96)
    odd = torch.empty(1, 64, 3, 2, 100, dtype=dtype, device="cuda")
    outs = tuple(odd[:, :, i, :, :96] for i in range(3))
    _compare(lambda: flash_attention_bwd(q, k, v, o, lse, g, out=outs), dtype,
             launches=3)


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


# K11's dq and dk/dv passes in bf16 on csrc/flash_attention_bwd_sm90.cu:
# every padded instance (64, 96, 128, 256) and the head dims between them
SM90_HEAD_DIMS = [56, 64, 72, 96, 112, 128, 200, 256]
SM90 = "flash_attention_bwd_sm90"


def _k11_sm90_inputs(gen, b, sq, sk, nh, d):
    """bf16 q a channel block of a (b, sq, 2, nh, d) buffer, k and v those
    of a (b, sk, 2, nh, d) one, dO, K10's o and lse."""
    qb = _rnd(gen, torch.bfloat16, b, sq, 2, nh, d)
    kv = _rnd(gen, torch.bfloat16, b, sk, 2, nh, d)
    q, k, v = qb[:, :, 0], kv[:, :, 0], kv[:, :, 1]
    o, lse = flash_attention(q, k, v, return_lse=True)
    return q, k, v, o, lse, _rnd(gen, torch.bfloat16, b, sq, nh, d)


@pytest.mark.cuda
@pytest.mark.parametrize("d", SM90_HEAD_DIMS)
def test_k11_sm90_passes_match_plain_at_ragged_strided_shapes(gen, d):
    """S_q 1000 against S_k 1337 (no multiple of the 64-row tiles), strided
    q/k/v, the outputs into the channel blocks of one dqkv buffer: the dq
    pass, the dk/dv pass and the three passes, each on the Hopper library."""
    b, sq, sk, nh = 2, 1000, 1337, 2
    q, k, v, o, lse, g = _k11_sm90_inputs(gen, b, sq, sk, nh, d)
    dqkv = torch.empty(b, sk, 3, nh, d, dtype=torch.bfloat16, device="cuda")
    outs = (dqkv[:, :sq, 0], dqkv[:, :, 1], dqkv[:, :, 2])
    assert _bwd_library(q.dtype, d, q, k, v, g, outs[0]) == SM90
    assert _bwd_library(q.dtype, d, q, k, v, g, *outs[1:]) == SM90
    delta = flash_attention_bwd_delta(o, g)
    scale = 1 / math.sqrt(d)
    _compare(lambda: flash_attention_bwd_dq(q, k, v, g, lse, delta, scale,
                                            out=outs[0]), torch.bfloat16)
    _compare(lambda: flash_attention_bwd_dkv(q, k, v, g, lse, delta, scale,
                                             out=outs[1:]), torch.bfloat16)
    _compare(lambda: flash_attention_bwd(q, k, v, o, lse, g, out=outs),
             torch.bfloat16, launches=3)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
def test_k11_sm90_under_autograd(gen, d):
    """`flash_attention` differentiated on the card at the Hopper
    instances' widths: K10, then the delta, dq and dk/dv passes."""
    qkv = _rnd(gen, torch.bfloat16, 2, 1000, 3, 2, d).requires_grad_()
    g = _rnd(gen, torch.bfloat16, 2, 1000, 2, d)

    def call():
        o = flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
        return torch.autograd.grad(o, qkv, g)[0]

    _compare(call, torch.bfloat16, launches=4)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [72, 200])
def test_k11_sm90_writes_only_its_channel_block(gen, d):
    """dq, dk and dv as neighbouring blocks of each head of one (B, S,
    heads, 3, d) buffer: d 72 and 200 run the 96- and 256-wide instances,
    whose columns past d would land in the next block (dq's in dk's, dv's
    in the next head's dq). Each pass leaves the other blocks as they were."""
    b, s, nh = 2, 333, 2
    q, k, v, o, lse, g = _k11_sm90_inputs(gen, b, s, s, nh, d)
    buf = torch.full((b, s, nh, 3, d), 7.0, dtype=torch.bfloat16,
                     device="cuda")
    dq, dk, dv = buf[:, :, :, 0], buf[:, :, :, 1], buf[:, :, :, 2]
    assert _bwd_library(q.dtype, d, q, k, v, g, dq, dk, dv) == SM90
    delta = flash_attention_bwd_delta(o, g)
    scale = 1 / math.sqrt(d)
    flash_attention_bwd_dq(q, k, v, g, lse, delta, scale, out=dq)
    torch.cuda.synchronize()
    assert buf[:, :, :, 1:].eq(7.0).all()
    first = dq.clone()
    flash_attention_bwd_dkv(q, k, v, g, lse, delta, scale, out=(dk, dv))
    torch.cuda.synchronize()
    assert torch.equal(dq, first)
    got = (first, dk.clone(), dv.clone())
    with dispatch.force_plain():
        want = flash_attention_bwd(q, k, v, o, lse, g)
    for a, w in zip(got, want):
        w = w.float()
        assert (a.float() - w).abs().max() <= 2e-2 * w.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [96, 128, 256])
def test_k11_sm90_repeats_bit_for_bit(gen, d):
    """No atomics: each output row belongs to one block, so two calls give
    the same bits."""
    q, k, v, o, lse, g = _k11_sm90_inputs(gen, 2, 1000, 1337, 2, d)
    first = flash_attention_bwd(q, k, v, o, lse, g)
    second = flash_attention_bwd(q, k, v, o, lse, g)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# K10 and K14 in bf16 on csrc/flash_attention_fwd_sm90.cu: every padded
# instance (64, 96, 128, 256) and head dims between and below them
FWD_SM90_HEAD_DIMS = [16, 56, 64, 72, 96, 112, 128, 200, 256]
FWD_SM90 = "flash_attention_fwd_sm90"


def _fwd_views(gen, b, sq, sk, nh, d):
    """bf16 q the first channel block of a (b, sq, 2, nh, d) buffer, k and
    v the two of a (b, sk, 2, nh, d) one: strided views, as the model's
    QKV slices are."""
    q = _rnd(gen, torch.bfloat16, b, sq, 2, nh, d)[:, :, 0]
    kv = _rnd(gen, torch.bfloat16, b, sk, 2, nh, d)
    return q, kv[:, :, 0], kv[:, :, 1]


@pytest.mark.cuda
@pytest.mark.parametrize("d", FWD_SM90_HEAD_DIMS)
@pytest.mark.parametrize("kernel,sq,sk", [
    ("K10", 1000, 1337), ("K14", 1000, 1024),   # ragged, K14's two passes
    ("K10", 7, 7), ("K14", 7, 7),               # the mask decoder's key rows
    ("K10", 49, 196), ("K14", 49, 196),         # the q-pool transitions
    ("K10", 1024, 1024), ("K14", 1024, 1024)])
def test_fwd_sm90_matches_plain(gen, d, kernel, sq, sk):
    """K10 (o and lse) and K14 on the Hopper forward against their plain
    versions: key rows of one ragged tile (a zero key past S_k must score
    -inf), up to four tiles (K14's one pass) and past them, queries no
    multiple of the 64-row tiles, at every instance's head dim."""
    from sam2unet_torch.ops.flash_attention import _fwd_library, full_attention

    q, k, v = _fwd_views(gen, 2, sq, sk, 2, d)
    assert _fwd_library(q.dtype, d, q, k, v) == FWD_SM90
    if kernel == "K10":
        _compare(lambda: flash_attention(q, k, v, return_lse=True), torch.bfloat16)
    else:
        _compare(lambda: full_attention(q, k, v), torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [72, 200])
def test_fwd_sm90_writes_no_row_past_sq(gen, d):
    """The entry points write o rows and lse entries below S_q only: a
    sentinel past the end of the last batch entry's rows stays."""
    from sam2unet_torch.ops import build

    lib = build.library(FWD_SM90)
    b, sq, sk, nh = 2, 100, 333, 2
    q, k, v = _fwd_views(gen, b, sq, sk, nh, d)
    n = b * sq * nh * d
    o = torch.full((n + 4096,), 7.0, dtype=torch.bfloat16, device="cuda")
    lse = torch.full((b * nh * sq + 256,), 7.0, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    strides = (*q.stride()[:3], *k.stride()[:3])
    assert lib.k10_flash_attention_sm90(
        1, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b, sq, sk, nh, d, *strides, 1 / math.sqrt(d), stream) == 0
    torch.cuda.synchronize()
    assert o[n:].eq(7.0).all() and lse[b * nh * sq:].eq(7.0).all()
    o.fill_(7.0)
    assert lib.k14_full_attention_sm90(
        1, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, sq, sk,
        nh, d, *strides, 1 / math.sqrt(d), stream) == 0
    torch.cuda.synchronize()
    assert o[n:].eq(7.0).all()
    with dispatch.force_plain():
        from sam2unet_torch.ops.flash_attention import full_attention

        want = full_attention(q, k, v).float()
    got = o[:n].view(b, sq, nh, d).float()
    assert (got - want).abs().max() <= 2e-2 * want.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [96, 128, 256])
def test_fwd_sm90_repeats_bit_for_bit(gen, d):
    """No atomics: each output row belongs to one item, so two calls give
    the same bits (K10's o and lse, K14's o)."""
    from sam2unet_torch.ops.flash_attention import full_attention

    q, k, v = _fwd_views(gen, 2, 1000, 1024, 2, d)
    for call in (lambda: flash_attention(q, k, v, return_lse=True),
                 lambda: (full_attention(q, k, v),)):
        first, second = call(), call()
        torch.cuda.synchronize()
        for a, b in zip(first, second):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [56, 96, 128, 256])
def test_fwd_sm90_under_autograd(gen, d):
    """`flash_attention` differentiated on the card: the Hopper K10's o and
    lse feed K11 (its delta, dq and dk/dv passes), the gradient against
    autograd through the plain version."""
    qkv = _rnd(gen, torch.bfloat16, 2, 1000, 3, 2, d).requires_grad_()
    g = _rnd(gen, torch.bfloat16, 2, 1000, 2, d)

    def call():
        o = flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
        return (o.detach(), torch.autograd.grad(o, qkv, g)[0])

    _compare(call, torch.bfloat16, launches=4)


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
@pytest.mark.parametrize("case", ["1025 keys", "strided channels",
                                  "mixed dtypes"])
def test_k14_refuses_what_it_cannot_take(gen, case):
    from sam2unet_torch.ops.flash_attention import full_attention

    q = _rnd(gen, torch.bfloat16, 1, 8, 2, 16)
    k = v = q
    if case == "1025 keys":
        k = v = _rnd(gen, torch.bfloat16, 1, 1025, 2, 16)
    elif case == "strided channels":
        k = v = _rnd(gen, torch.bfloat16, 1, 8, 2, 32)[..., ::2]
    else:
        k = v = q.float()
    with pytest.raises((ValueError, TypeError)):
        full_attention(q, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["head dim 12", "head dim 104",
                                  "odd token stride"])
def test_k14_takes_any_head_dim_and_stride(gen, dtype, case):
    """What K14 refused before the element-loading kernels: head dims 12
    and 104, a token stride that is no multiple of 8; against the plain
    version."""
    from sam2unet_torch.ops.flash_attention import full_attention

    q = _rnd(gen, dtype, 1, 8, 2, 16)
    k = v = q
    if case == "head dim 12":
        q = k = v = _rnd(gen, dtype, 1, 8, 2, 12)
    elif case == "head dim 104":
        q = k = v = _rnd(gen, dtype, 1, 8, 1, 104)
    else:
        k = v = _rnd(gen, dtype, 1, 8, 2 * 16 + 4)[..., :32].reshape(1, 8, 2, 16)
        assert k.stride(1) == 36
    _compare(lambda: full_attention(q, k, v), dtype)


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


# --------------------------------------------------------- any width
# The widths the JAX MLP, LN-matmul and window kernels take past the
# 16-byte-vector instances (csrc/gemm_any.cu): not a multiple of 8 (the
# tiles copied 1, 2, 4 or 8 elements at a time as the rows allow), LN rows
# past 2048.

MLP_WIDTHS = [(12, 8), (13, 26), (20, 32), (2056, 64)]
BLOCK_WIDTHS = [(26, 2), (20, 4), (2064, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,n,add_bias", [
    ((5, 4, 4, 12), 36, True), ((5, 4, 4, 12), 36, False),
    ((3, 50, 13), 20, True), ((3, 50, 2060), 24, True),
    ((3, 50, 572), 1716, True)])
def test_k15_k16_at_any_width(gen, dtype, shape, n, add_bias):
    """K15 and K16 at the JAX test's C 12 -> 36 with and without the bias,
    K15 at C 13 -> 20 and at an LN row past 2048 (C 2060 -> 24), both at C
    572 -> 1716 (the timed ragged row's width)."""
    from sam2unet_torch.ops.fused_mlp import fused_ln_matmul, fused_ln_qkv

    c = shape[-1]
    x = _rnd(gen, dtype, *shape)
    w, b = _lin(gen, dtype, n, c)
    lw, lb = _rnd(gen, dtype, c, scale=0.1, shift=1.0), _rnd(gen, dtype, c, scale=0.1)
    _compare(lambda: fused_ln_matmul(x, w, b, lw, lb, add_bias), dtype)
    if n % 3 == 0:
        _compare(lambda: fused_ln_qkv(x, w, b, lw, lb, add_bias), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", ["ln tail", "adapter", "no ln, no residual"])
@pytest.mark.parametrize("c,hidden", MLP_WIDTHS)
def test_k1_at_any_width(gen, dtype, c, hidden, mode):
    """K1 in each of the JAX package's modes at C 12 / 13 / 20 / 2056."""
    x = _rnd(gen, dtype, 3, 50, c)
    w1, b1 = _lin(gen, dtype, hidden, c)
    w2, b2 = _lin(gen, dtype, c, hidden)
    kw = {"ln tail": dict(residual=True,
                          ln_w=_rnd(gen, dtype, c, scale=0.1, shift=1.0),
                          ln_b=_rnd(gen, dtype, c, scale=0.1)),
          "adapter": dict(residual=True, gelu_out=True),
          "no ln, no residual": {}}[mode]
    _compare(lambda: fused_mlp(x, w1, b1, w2, b2, **kw), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ln", [True, False], ids=["ln tail", "no ln, no residual"])
@pytest.mark.parametrize("c,hidden", MLP_WIDTHS)
def test_k2_at_any_width(gen, dtype, c, hidden, ln):
    """K2 directly and as the backward of a frozen `fused_mlp`."""
    x, gy = _rnd(gen, dtype, 3, 50, c), _rnd(gen, dtype, 3, 50, c)
    w1, b1 = _lin(gen, dtype, hidden, c)
    w2, b2 = _lin(gen, dtype, c, hidden)
    kw = dict(ln_w=_rnd(gen, dtype, c, scale=0.1, shift=1.0),
              ln_b=_rnd(gen, dtype, c, scale=0.1)) if ln else {}
    _compare(lambda: mlp_bwd_dx(x, gy, w1, b1, w2, b2, residual=ln, **kw), dtype)

    def call():
        xx = x.detach().requires_grad_()
        y = fused_mlp(xx, w1, b1, w2, b2, residual=ln, **kw)
        return torch.autograd.grad(y, xx, gy)[0]

    _compare(call, dtype, launches=2)
    assert dispatch.launches["mlp_bwd_dx"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c,hidden", MLP_WIDTHS[:3] + [(2056, 32)])
def test_k3_at_any_width(gen, dtype, c, hidden):
    """K3's dx and fp32 weight gradients, directly and through autograd of
    the trainable adapter."""
    x, gy = _rnd(gen, dtype, 3, 50, c), _rnd(gen, dtype, 3, 50, c)
    w1, b1 = _lin(gen, dtype, hidden, c)
    w2, b2 = _lin(gen, dtype, c, hidden)
    _compare(lambda: adapter_bwd(x, gy, w1, b1, w2, b2), dtype)

    def call():
        leaves = [t.detach().requires_grad_() for t in (x, w1, b1, w2, b2)]
        y = fused_mlp(*leaves, residual=True, gelu_out=True)
        return torch.autograd.grad(y, leaves, gy)

    _compare(call, dtype, launches=2)
    assert dispatch.launches["adapter_bwd"] == 1


BLOCK_MODES = ["K6", "K6 pad key", "K6 masked", "K7", "K7 masked",
               "K7 weight-grad"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", BLOCK_MODES)
@pytest.mark.parametrize("c,heads", BLOCK_WIDTHS)
def test_window_block_at_any_width(gen, dtype, c, heads, mode):
    """K6 / K7 in every mode on (2 windows, 16 tokens) at c 26 over 2 heads,
    20 over 4 and 2064 over 8 (the masked mode: a 4 x 4 grid, window 3)."""
    from sam2unet_torch.ops.windowing import grid_window_mask

    w = _attn_weights(gen, dtype, c, c)
    x, gy = (_rnd(gen, dtype, 2, 16, c) for _ in range(2))
    kw = dict(num_heads=heads)
    if "masked" in mode:
        mask, lm = (torch.from_numpy(a).cuda() for a in grid_window_mask(4, 4, 3))
        kw.update(attn_mask=mask, pad_logmult=lm)
    if mode == "K6 pad key":
        kw.update(n_pad=5)
    if mode == "K7 weight-grad":
        kw.update(weight_grads=True)
    call = ((lambda: fused_window_block(x, *w, **kw)) if mode.startswith("K6")
            else (lambda: window_block_bwd(x, gy, *w, **kw)))
    _compare(call, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", ["K4", "K5", "K12", "K13"])
def test_strips_at_any_width(gen, dtype, mode):
    """K4 / K5 on (2, 16, 16, 26) window 8, K12 / K13 on (2, 30, 30, 26)
    window 8, 2 heads."""
    w = _attn_weights(gen, dtype, 26, 26)
    grid = 16 if mode in ("K4", "K5") else 30
    x, gy = (_rnd(gen, dtype, 2, grid, grid, 26) for _ in range(2))
    kw = dict(num_heads=2, window=8)
    call = {"K4": lambda: fused_window_block_strips(x, *w, **kw),
            "K12": lambda: fused_window_block_strips_rem(x, *w, **kw),
            "K5": lambda: window_block_strips_bwd(x, gy, *w, **kw),
            "K13": lambda: window_block_strips_rem_bwd(x, gy, *w, **kw)}[mode]
    _compare(call, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", ["K8", "K9"])
@pytest.mark.parametrize("geom", [(2, 16, 20, 40, 4, 8), (1, 8, 2056, 48, 4, 4),
                                  (2, 8, 20, 27, 3, 4)])
def test_transition_at_any_width(gen, dtype, mode, geom):
    """K8 / K9 at (2, 16, 16, 20) -> 40 window 8 over 4 heads, an LN row
    past 2048 ((1, 8, 8, 2056) -> 48 window 4), and an odd cout (20 -> 27
    over 3 heads: the shortcut's 2x2 max-pool backward one channel a
    thread)."""
    b, hh, cin, cout, heads, window = geom
    x = _rnd(gen, dtype, b, hh, hh, cin)
    gy = _rnd(gen, dtype, b, hh // 2, hh // 2, cout)
    wt = _attn_weights(gen, dtype, cin, cout)
    ws, bs = _lin(gen, dtype, cout, cin)
    kw = dict(num_heads=heads, window=window)
    call = ((lambda: fused_transition_block(x, *wt, ws, bs, **kw))
            if mode == "K8" else
            (lambda: transition_bwd(x, gy, *wt, ws, bs, **kw)))
    _compare(call, dtype, near_ties=mode == "K9" and dtype == torch.bfloat16)


# K1 and K2 in bf16 on csrc/mlp_sm90.cu: every width of the main paths
# (hiera_s 96-768, hiera_l 144-1152; hidden 4C, and the adapter's 32) at row
# counts of the window groups (s960 batch 16's stage-4 corner 64, stage 3's
# corner 256, l352 batch 16's 576, stage 4's edge 896, stage 3's edge 3584)
# and at 200 (no multiple of the 128-row GEMM or 64-row adapter tile).
MLP_SM90 = "mlp_sm90"
MAIN_WIDTHS = [96, 144, 192, 288, 384, 576, 768, 1152]
MLP_ROWS = [64, 200, 256, 576, 896, 3584]


def _mlp_sm90_case(gen, rows, c, hd, ln):
    x, gy = _rnd(gen, torch.bfloat16, rows, c), _rnd(gen, torch.bfloat16, rows, c)
    w1, b1 = _lin(gen, torch.bfloat16, hd, c)
    w2, b2 = _lin(gen, torch.bfloat16, c, hd)
    lns = ((_rnd(gen, torch.bfloat16, c, scale=0.1, shift=1.0),
            _rnd(gen, torch.bfloat16, c, scale=0.1)) if ln else (None, None))
    return x, gy, w1, b1, w2, b2, lns


def _on_sm90(call, monkeypatch):
    """The libraries `call` asks for (the route it took)."""
    from sam2unet_torch.ops import build

    seen, library = [], build.library

    def spy(name):
        seen.append(name)
        return library(name)

    monkeypatch.setattr(build, "library", spy)
    call()
    monkeypatch.setattr(build, "library", library)
    return seen


@pytest.mark.cuda
@pytest.mark.parametrize("rows", MLP_ROWS)
@pytest.mark.parametrize("c", MAIN_WIDTHS)
def test_k1_sm90_matches_plain_at_main_path_widths(gen, monkeypatch, c, rows):
    """K1's tail (LN, hidden 4C, the residual) and adapter (hidden 32, GELU
    on the output, the residual: the streaming kernel) on csrc/mlp_sm90.cu."""
    for hd, ln in ((4 * c, True), (32, False)):
        x, _, w1, b1, w2, b2, (lw, lb) = _mlp_sm90_case(gen, rows, c, hd, ln)
        call = lambda: fused_mlp(x, w1, b1, w2, b2, lw, lb, residual=True,
                                 gelu_out=not ln)
        assert _on_sm90(call, monkeypatch) == [MLP_SM90]
        _compare(call, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", MLP_ROWS)
@pytest.mark.parametrize("c", MAIN_WIDTHS)
def test_k2_sm90_matches_plain_at_main_path_widths(gen, monkeypatch, c, rows):
    """K2 in its four modes on csrc/mlp_sm90.cu (the dual tile, dh W1, the
    LN passes), and under autograd through a frozen `fused_mlp`."""
    for ln, residual in ((True, True), (True, False), (False, True),
                         (False, False)):
        x, gy, w1, b1, w2, b2, (lw, lb) = _mlp_sm90_case(gen, rows, c, 4 * c, ln)
        call = lambda: mlp_bwd_dx(x, gy, w1, b1, w2, b2, lw, lb,
                                  residual=residual)
        assert _on_sm90(call, monkeypatch) == [MLP_SM90]
        _compare(call, torch.bfloat16)

    def grad():
        xx = x.detach().requires_grad_()
        y = fused_mlp(xx, w1, b1, w2, b2, lw, lb, residual=residual)
        return torch.autograd.grad(y, xx, gy)[0]

    _compare(grad, torch.bfloat16, launches=2)


@pytest.mark.cuda
@pytest.mark.parametrize("c", MAIN_WIDTHS)
def test_mlp_sm90_writes_no_row_past_m(gen, c):
    """The entry points called directly into outputs and scratch 77 rows
    longer than the 200 rows given, filled with a sentinel: no row past M
    changes (K1's tail and adapter, K2)."""
    from sam2unet_torch.ops import build

    lib, p = build.library(MLP_SM90), dispatch.ptr
    stream = torch.cuda.current_stream().cuda_stream
    m, pad = 200, 77
    for hd, ln in ((4 * c, True), (32, False)):
        x, gy, w1, b1, w2, b2, (lw, lb) = _mlp_sm90_case(gen, m, c, hd, ln)
        bufs = {n: torch.full((m + pad, w), 7.0, dtype=torch.bfloat16,
                              device="cuda")
                for n, w in (("xn", c), ("hidden", hd), ("out", c), ("dh", hd),
                             ("dz", c), ("dx", c))}
        assert lib.k1_fused_mlp_sm90(
            1, p(x), p(w1), p(b1), p(w2), p(b2), p(lw), p(lb), p(bufs["xn"]),
            p(bufs["hidden"]), p(bufs["out"]), m, c, hd, c, 1, int(not ln),
            stream) == 0
        assert lib.k2_mlp_bwd_dx_sm90(
            1, p(x), p(gy), p(w1), p(b1), p(w2), p(lw), p(lb), p(bufs["xn"]),
            p(bufs["dh"]), p(bufs["dz"]), p(bufs["dx"]), m, c, hd, c, 1,
            stream) == 0
        torch.cuda.synchronize()
        for n, t in bufs.items():
            assert (t[m:] == 7.0).all(), n
        with dispatch.force_plain():
            want = fused_mlp(x, w1, b1, w2, b2, lw, lb, residual=True,
                             gelu_out=not ln)
        err = (bufs["out"][:m].float() - want.float()).abs().max()
        assert err <= REL_TOL[torch.bfloat16] * want.float().abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("c,hd", [(384, 4 * 384), (2056, 32)])
def test_mlp_sm90_leaves_gelu_out_past_its_adapter_kernel(gen, monkeypatch, c, hd):
    """GELU on K1's output past the adapter kernel (hidden 4C, or C wider
    than its shared memory holds) runs csrc/fused_mlp.cu, and
    csrc/mlp_sm90.cu's entry point refuses such a call."""
    from sam2unet_torch.ops import build

    x, _, w1, b1, w2, b2, _ = _mlp_sm90_case(gen, 200, c, hd, False)
    call = lambda: fused_mlp(x, w1, b1, w2, b2, residual=True, gelu_out=True)
    seen = _on_sm90(call, monkeypatch)
    assert "fused_mlp" in seen and MLP_SM90 not in seen
    _compare(call, torch.bfloat16)
    p = dispatch.ptr
    hidden = torch.empty(200, hd, dtype=torch.bfloat16, device="cuda")
    out = torch.empty_like(x)
    assert build.library(MLP_SM90).k1_fused_mlp_sm90(
        1, p(x), p(w1), p(b1), p(w2), p(b2), p(None), p(None), p(None),
        p(hidden), p(out), 200, c, hd, c, 1, 1,
        torch.cuda.current_stream().cuda_stream) != 0


@pytest.mark.cuda
def test_mlp_sm90_repeats_bit_for_bit(gen):
    """No atomics: two calls give the same bits (K1's tail and adapter, K2)."""
    c = 384
    for hd, ln in ((4 * c, True), (32, False)):
        x, gy, w1, b1, w2, b2, (lw, lb) = _mlp_sm90_case(gen, 3584, c, hd, ln)
        for call in (lambda: fused_mlp(x, w1, b1, w2, b2, lw, lb, residual=True,
                                       gelu_out=not ln),
                     lambda: mlp_bwd_dx(x, gy, w1, b1, w2, b2, lw, lb)):
            assert torch.equal(call(), call())


# K3 and K7's dx-only unmasked mode in bf16 on csrc/block_bwd_sm90.cu: K3 at
# every main-path width and the window groups' row counts (and 200 rows, no
# multiple of the 64-row tile), K7 at every window shape of l352train and
# s960train (S 49, 64, 196, 256, 484; head dims 72 and 96) at a few windows
# and at a ragged S of 100, over head dims 64-128.
BLOCK_BWD = "block_bwd_sm90"
K7_SHAPES = [(4, 196, 384, 4), (4, 49, 768, 8), (3, 256, 576, 8),
             (3, 64, 1152, 16), (2, 484, 576, 8), (3, 100, 256, 4),
             (2, 100, 256, 2), (3, 100, 320, 5), (2, 100, 200, 5),
             (2, 64, 64, 4)]


def _k3_case(gen, rows, c):
    x, gy = _rnd(gen, torch.bfloat16, rows, c), _rnd(gen, torch.bfloat16, rows, c)
    w1, b1 = _lin(gen, torch.bfloat16, 32, c)
    w2, b2 = _lin(gen, torch.bfloat16, c, 32)
    return x, gy, w1, b1, w2, b2


@pytest.mark.cuda
@pytest.mark.parametrize("rows", MLP_ROWS + [200])
@pytest.mark.parametrize("c", MAIN_WIDTHS)
def test_k3_sm90_matches_plain_at_main_path_widths(gen, monkeypatch, c, rows):
    """dx and the four fp32 weight gradients of the adapter, with and
    without the residual, on csrc/block_bwd_sm90.cu."""
    x, gy, w1, b1, w2, b2 = _k3_case(gen, rows, c)
    for residual in (True, False):
        call = lambda: adapter_bwd(x, gy, w1, b1, w2, b2, residual=residual)
        assert _on_sm90(call, monkeypatch) == [BLOCK_BWD]
        _compare(call, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [32, 64, 136, 1408])
def test_k3_sm90_matches_plain_past_the_main_widths(gen, monkeypatch, c):
    """The widths the route takes beside the main paths': one 64-column
    chunk (C 32, 64: the second warpgroup owns none), a ragged last chunk
    (136), the widest plan (1408: two ring slots)."""
    x, gy, w1, b1, w2, b2 = _k3_case(gen, 200, c)
    call = lambda: adapter_bwd(x, gy, w1, b1, w2, b2)
    assert _on_sm90(call, monkeypatch) == [BLOCK_BWD]
    _compare(call, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,c", [(57600, 384), (3584, 384), (1936, 1152),
                                    (14400, 768)])
def test_k3_sm90_weight_gradients_repeat_bit_for_bit(gen, rows, c):
    """The blocks' partials are summed in a fixed order: two calls give the
    same bits (partials in shared memory at C 384, in device memory past
    it)."""
    args = _k3_case(gen, rows, c)
    first = adapter_bwd(*args)
    for a, b in zip(first, adapter_bwd(*args)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [96, 384, 1152])
def test_k3_sm90_writes_no_row_past_m(gen, c):
    """The entry point called directly into a dx 77 rows longer than the 200
    rows given, filled with a sentinel: no row past M changes."""
    from sam2unet_torch.ops import build

    m, pad = 200, 77
    x, gy, w1, b1, w2, b2 = _k3_case(gen, m, c)
    dx = torch.full((m + pad, c), 7.0, dtype=torch.bfloat16, device="cuda")
    f32 = dict(dtype=torch.float32, device="cuda")
    blocks = -(-m // 64)
    part = torch.empty(blocks * (-(-c // 64) * 36 * 128 + 32), **f32)
    grads = (torch.empty(32, c, **f32), torch.empty(32, **f32),
             torch.empty(c, 32, **f32), torch.empty(c, **f32))
    p = dispatch.ptr
    assert build.library(BLOCK_BWD).k3_adapter_bwd_sm90(
        1, p(x), p(gy), p(w1), p(b1), p(w2), p(b2), p(part), p(dx),
        *(p(g) for g in grads), m, c, 32, 1, blocks,
        torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    assert (dx[m:] == 7.0).all()
    with dispatch.force_plain():
        want = adapter_bwd(x, gy, w1, b1, w2, b2)[0]
    err = (dx[:m].float() - want.float()).abs().max()
    assert err <= REL_TOL[torch.bfloat16] * want.float().abs().max()


def _k7_case(gen, nw, s, c):
    x, gy = _rnd(gen, torch.bfloat16, nw, s, c), _rnd(gen, torch.bfloat16, nw, s, c)
    lw = _rnd(gen, torch.bfloat16, c, scale=0.1, shift=1.0)
    lb = _rnd(gen, torch.bfloat16, c, scale=0.1)
    wq, bq = _lin(gen, torch.bfloat16, 3 * c, c)
    wp, bp = _lin(gen, torch.bfloat16, c, c)
    return x, gy, (wq, bq, lw, lb, wp, bp)


@pytest.mark.cuda
@pytest.mark.parametrize("nw,s,c,nh", K7_SHAPES)
def test_k7_sm90_matches_plain_at_main_path_shapes(gen, monkeypatch, nw, s, c, nh):
    """K7's dx-only unmasked mode on csrc/block_bwd_sm90.cu, with and without
    the residual, and twice with the same bits."""
    x, gy, wt = _k7_case(gen, nw, s, c)
    for residual in (True, False):
        call = lambda: window_block_bwd(x, gy, *wt, num_heads=nh, residual=residual)
        assert _on_sm90(call, monkeypatch) == [BLOCK_BWD]
        _compare(call, torch.bfloat16)
        assert torch.equal(call(), call())


@pytest.mark.cuda
@pytest.mark.parametrize("nw,s,c,nh", [(4, 196, 384, 4), (2, 484, 576, 8)])
def test_k7_sm90_under_autograd(gen, nw, s, c, nh):
    """A frozen window block under autograd: K6 forward, then K7 on
    csrc/block_bwd_sm90.cu (two launches)."""
    x, gy, wt = _k7_case(gen, nw, s, c)

    def grad():
        xx = x.detach().requires_grad_()
        y = fused_window_block(xx, *wt, num_heads=nh)
        return torch.autograd.grad(y, xx, gy)[0]

    _compare(grad, torch.bfloat16, launches=2)


@pytest.mark.cuda
def test_k7_sm90_writes_no_row_past_m(gen):
    """The entry point called directly into a dx and scratch 77 rows longer
    than the windows' 2 x 196 rows, filled with a sentinel: no row past M
    changes."""
    from sam2unet_torch.ops import build

    nw, s, c, nh, pad = 2, 196, 384, 4, 77
    m = nw * s
    x, gy, (wq, bq, lw, lb, wp, bp) = _k7_case(gen, nw, s, c)
    rows = lambda w: torch.full((m + pad, w), 7.0, dtype=torch.bfloat16,  # noqa: E731
                                device="cuda")
    bufs = dict(xn=rows(c), qkv=rows(3 * c), dout=rows(c), dqkv=rows(3 * c),
                dxn=rows(c), dx=rows(c))
    lse = torch.full((nw * nh, s + pad), 7.0, device="cuda")
    d_rows = torch.full((nw * nh, s + pad), 7.0, device="cuda")
    p = dispatch.ptr
    assert build.library(BLOCK_BWD).k7_window_block_bwd_sm90(
        1, p(x), p(gy), p(wq), p(bq), p(lw), p(lb), p(wp), p(bufs["xn"]),
        p(bufs["qkv"]), p(lse), p(bufs["dout"]), p(d_rows), p(bufs["dqkv"]),
        p(bufs["dxn"]), p(bufs["dx"]), nw, s, c, nh, 1,
        torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    for n, t in bufs.items():
        assert (t[m:] == 7.0).all(), n
    # lse and D are (windows x heads, S): the rows past S of the last row
    assert (lse.reshape(-1)[nw * nh * s:] == 7.0).all()
    assert (d_rows.reshape(-1)[nw * nh * s:] == 7.0).all()
    with dispatch.force_plain():
        want = window_block_bwd(x, gy, wq, bq, lw, lb, wp, bp, num_heads=nh)
    err = (bufs["dx"][:m].float() - want.reshape(m, c).float()).abs().max()
    assert err <= REL_TOL[torch.bfloat16] * want.float().abs().max()


@pytest.mark.cuda
def test_k3_k7_old_sources_keep_fp32_and_other_widths(gen, monkeypatch):
    """fp32 K3 and K7, a K7 head dim past 128 and a ragged K3 width keep
    csrc/fused_mlp_bwd.cu and csrc/fused_attention_block_bwd.cu."""
    x, gy, w1, b1, w2, b2 = _k3_case(gen, 200, 384)
    f = lambda *t: tuple(a.float() for a in t)  # noqa: E731
    call = lambda: adapter_bwd(*f(x, gy, w1, b1, w2, b2))
    assert _on_sm90(call, monkeypatch) == ["fused_mlp_bwd"]
    x, gy, w1, b1, w2, b2 = _k3_case(gen, 200, 572)
    call = lambda: adapter_bwd(x, gy, w1, b1, w2, b2)
    assert _on_sm90(call, monkeypatch) == ["fused_mlp_bwd"]
    _compare(call, torch.bfloat16)
    x, gy, wt = _k7_case(gen, 2, 64, 576)
    call = lambda: window_block_bwd(x, gy, *wt, num_heads=4)   # head dim 144
    assert _on_sm90(call, monkeypatch) == ["fused_attention_block_bwd"]
    _compare(call, torch.bfloat16)
    call = lambda: window_block_bwd(*f(x, gy, *wt), num_heads=8)
    assert _on_sm90(call, monkeypatch) == ["fused_attention_block_bwd"]


@pytest.mark.cuda
def test_k7_sm90_after_the_mlp_gemm_of_another_library(gen):
    """csrc/mlp_sm90.cu and csrc/block_bwd_sm90.cu each build the GEMM of
    csrc/gemm_sm90.cuh: K2's kDz products in one library first must not
    leave K7's copies in the other without their shared-memory limit (a
    flag shared across libraries made K7's launch fail)."""
    x, gy, w1, b1, w2, b2, _ = _mlp_sm90_case(gen, 200, 576, 4 * 576, False)
    mlp_bwd_dx(x, gy, w1, b1, w2, b2, residual=True)
    x, gy, wt = _k7_case(gen, 2, 256, 576)
    _compare(lambda: window_block_bwd(x, gy, *wt, num_heads=8), torch.bfloat16)


# K5 and K9 in bf16 on csrc/block_bwd_sm90.cu (windows of 4 or 8, head dims
# multiples of 8 up to 128): the LN pass and the projections on the wgmma
# GEMM and one small-window attention pass over the (B, H, W, c) grid's
# windows. K5 at hiera_l@352's and hiera_s@960's window shapes at a small
# batch, and at an odd count of w4 windows along W (a strip's last tile
# holds one window of four); K9 at test_k9_kernel_matches_plain's three
# geometries, an odd count of w4 windows along W and head dim 96 at w4.
K5_SM90_SHAPES = [(2, 16, 16, 144, 2, 8), (2, 8, 8, 288, 4, 4), (2, 16, 16, 192, 2, 8),
                  (2, 8, 20, 288, 4, 4), (1, 16, 24, 96, 1, 8), (2, 12, 20, 192, 2, 4)]
K9_SM90_SHAPES = [(2, 16, 16, 72, 144, 2, 8), (2, 8, 8, 144, 288, 4, 4),
                  (2, 16, 16, 96, 192, 2, 8), (2, 8, 20, 144, 288, 4, 4),
                  (2, 12, 20, 192, 384, 4, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,hh,wd,c,nh,win", K5_SM90_SHAPES)
def test_k5_sm90_matches_plain_at_main_path_shapes(gen, monkeypatch, b, hh, wd, c, nh, win):
    """K5 on csrc/block_bwd_sm90.cu, with and without the residual, and
    twice with the same bits."""
    x, gy = _rnd(gen, torch.bfloat16, b, hh, wd, c), _rnd(gen, torch.bfloat16, b, hh, wd, c)
    w = _attn_weights(gen, torch.bfloat16, c, c)
    for residual in (True, False):
        call = lambda: window_block_strips_bwd(x, gy, *w, num_heads=nh, window=win,
                                               residual=residual)
        assert _on_sm90(call, monkeypatch) == [BLOCK_BWD]
        _compare(call, torch.bfloat16)
        assert torch.equal(call(), call())


@pytest.mark.cuda
@pytest.mark.parametrize("b,hh,wd,cin,cout,nh,win", K9_SM90_SHAPES)
def test_k9_sm90_matches_plain_at_main_path_shapes(gen, monkeypatch, b, hh, wd, cin, cout,
                                                   nh, win):
    """K9 on csrc/block_bwd_sm90.cu (K9_NEAR_TIE_SHARE's rule), and twice
    with the same bits; a grid of exactly tied cells routes every pooled
    gradient to the cell's first token, as the plain version does."""
    x = _rnd(gen, torch.bfloat16, b, hh, wd, cin)
    gy = _rnd(gen, torch.bfloat16, b, hh // 2, wd // 2, cout)
    w = _attn_weights(gen, torch.bfloat16, cin, cout)
    ws, bs = _lin(gen, torch.bfloat16, cout, cin)
    call = lambda: transition_bwd(x, gy, *w, ws, bs, num_heads=nh, window=win)
    assert _on_sm90(call, monkeypatch) == [BLOCK_BWD]
    _compare(call, torch.bfloat16, near_ties=True)
    assert torch.equal(call(), call())
    tied = x[:, ::2, ::2].repeat_interleave(2, 1).repeat_interleave(2, 2).contiguous()
    _compare(lambda: transition_bwd(tied, gy, *w, ws, bs, num_heads=nh, window=win),
             torch.bfloat16)


@pytest.mark.cuda
def test_k5_k9_old_sources_keep_fp32_and_other_head_dims(gen, monkeypatch):
    """fp32 K5 and K9 and a head dim past 128 keep
    csrc/fused_attention_block_bwd.cu and csrc/fused_transition_bwd.cu."""
    f = lambda *t: tuple(a.float() for a in t)  # noqa: E731
    x, gy = _rnd(gen, torch.bfloat16, 2, 8, 8, 288), _rnd(gen, torch.bfloat16, 2, 8, 8, 288)
    w = _attn_weights(gen, torch.bfloat16, 288, 288)
    call = lambda: window_block_strips_bwd(*f(x, gy, *w), num_heads=4, window=4)
    assert _on_sm90(call, monkeypatch) == ["fused_attention_block_bwd"]
    call = lambda: window_block_strips_bwd(x, gy, *w, num_heads=2, window=4)  # d 144
    assert _on_sm90(call, monkeypatch) == ["fused_attention_block_bwd"]
    _compare(call, torch.bfloat16)
    x = _rnd(gen, torch.bfloat16, 2, 8, 8, 144)
    gy = _rnd(gen, torch.bfloat16, 2, 4, 4, 288)
    w = _attn_weights(gen, torch.bfloat16, 144, 288)
    ws, bs = _lin(gen, torch.bfloat16, 288, 144)
    call = lambda: transition_bwd(*f(x, gy, *w, ws, bs), num_heads=4, window=4)
    assert _on_sm90(call, monkeypatch) == ["fused_transition_bwd"]
    call = lambda: transition_bwd(x, gy, *w, ws, bs, num_heads=2, window=4)  # d 144
    assert _on_sm90(call, monkeypatch) == ["fused_transition_bwd"]
