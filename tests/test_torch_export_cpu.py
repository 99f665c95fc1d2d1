"""The port's export and deploy path on the CPU against the JAX package's,
at the tiny geometry of tests/test_export.py (hiera_test, 64 px,
rfb_out=8), one torch thread, fp32. The weights are the JAX variables with
seeded noise on every zero- or one-initialised leaf, carried into the port
through `interop/from_jax.py`.

  (a) fold-BN: the port's folded forward against its unfolded forward and
      against the JAX `fold_batchnorm`'d forward.
  (b) the `.pt2` program: against the port's forward and against the JAX
      StableHLO artifact's outputs on the same input.
  (c) the port's ONNX graph through its numpy runner against the JAX
      forward under `force_xla`, with the input and output names; each
      op the port's graph adds to the JAX runner's set, op by op.
  (d) the golden ONNX corpus (tests/golden_onnx) through the port's runner.
  (e) `SamUnetSegmenter` masks of the `torch_export` and `onnx` backends
      against the JAX segmenter's `stablehlo` masks.
  (f) the export and deploy CLIs with --device cpu on a synthetic set.
  (g) the ONNX leg in a process where the JAX package's `onnx` shim was
      registered first (and the other way round), and `torch.export` with
      the port's shim registered, each in a fresh interpreter.
"""

from __future__ import annotations

import glob
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from sam2unet_torch.cli import deploy_cli, export_cli
from sam2unet_torch.configs import HIERA_TEST as PORT_HIERA_TEST
from sam2unet_torch.configs import SAM2UNetConfig as PortConfig
from sam2unet_torch.deploy.onnx_numpy import NumpyOnnxRunner
from sam2unet_torch.deploy.segmenter import SamUnetSegmenter
from sam2unet_torch.interop import export as port_export
from sam2unet_torch.interop import onnx_compat
from sam2unet_torch.interop.from_jax import jax_to_state_dict
from sam2unet_torch.models.sam2unet import SAM2UNet as PortSAM2UNet
from sam2unet_torch.nn.fold_bn import fold_batchnorm, fold_model
from sam2unet_torch.nn.layers import BN_EPS
from sam2unet_tpu.configs import HIERA_TEST, SAM2UNetConfig
from sam2unet_tpu.deploy.segmenter import SamUnetSegmenter as JaxSegmenter
from sam2unet_tpu.interop.export import export_stablehlo, load_exported
from sam2unet_tpu.models.sam2unet import SAM2UNet
from sam2unet_tpu.nn.fold_bn import fold_batchnorm as jax_fold_batchnorm
from sam2unet_tpu.ops.pallas import dispatch as jax_dispatch

ROOT = Path(__file__).resolve().parents[1]
SIZE, RFB = 64, 8
# fp32 on both sides. Port against JAX: the two frameworks sum in other
# orders through the trunk, the neck and the decoder (the whole-model test
# measured 2.6e-6 of max |output| at a larger config): 2e-5 of max
# |output|. Port against itself (folded, exported, the numpy runner): the
# same framework's arithmetic in another order, 1e-5 of max |output|.
JAX_REL = 2e-5
SELF_REL = 1e-5
# the head's bias set so that the test image's logits centre on logit(0.1)
# = -2.197 (the head's conv adds about -0.1 there), so that the segmenter's
# 0.1 threshold cuts the tiny model's probabilities into both values
HEAD_BIAS = -2.1
# masks of two frameworks: pixels whose probability lies within the fp32
# gap of the threshold may flip; at most 1 in 1000 of the pixels
MASK_SHARE = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the suite runs several test processes on the
    machine's cores, where torch's own pool would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _perturb(variables: dict, rng: np.random.Generator) -> dict:
    """Seeded noise on every zero- or one-initialised leaf (biases, LN/BN
    gains, pos-embeds, BN statistics), so that no BN fold is vacuous."""
    def walk(tree, path=()):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
                continue
            v = np.asarray(v, np.float32)
            if k == "var":
                v = v + rng.uniform(0.2, 0.8, v.shape).astype(np.float32)
            elif k in ("bias", "mean", "pos_embed", "pos_embed_window",
                       "scale"):
                v = v + 0.1 * rng.standard_normal(v.shape).astype(np.float32)
            if path[-1:] == ("head",) and k == "bias":
                v = np.full_like(v, HEAD_BIAS)
            out[k] = v
        return out
    return walk(variables)


@pytest.fixture(scope="module")
def pair():
    """(JAX model, its variables, the port model with the same weights)."""
    model = SAM2UNet(SAM2UNetConfig(trunk=HIERA_TEST, rfb_out=RFB))
    x0 = np.zeros((1, SIZE, SIZE, 3), np.float32)
    variables = jax.jit(model.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), x0, train=False)
    variables = _perturb(dict(jax.tree_util.tree_map(np.asarray, variables)),
                         np.random.default_rng(0))
    port = PortSAM2UNet(PortConfig(trunk=PORT_HIERA_TEST, rfb_out=RFB)).eval()
    port.load_state_dict(jax_to_state_dict(variables, port.state_dict().keys()),
                         strict=True)
    return model, variables, port


@pytest.fixture(scope="module")
def x():
    return np.random.default_rng(1).standard_normal(
        (1, SIZE, SIZE, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def artifacts(pair, tmp_path_factory):
    """The port's `.pt2` program and ONNX graph and the JAX package's
    StableHLO artifact of the same weights, exported once."""
    model, variables, port = pair
    d = tmp_path_factory.mktemp("artifacts")
    paths = {k: str(d / f"model.{k}") for k in ("pt2", "onnx", "stablehlo")}
    port_export.export_program(port, SIZE, paths["pt2"], "cpu")
    port_export.export_onnx(port, SIZE, paths["onnx"])
    export_stablehlo(model, variables, SIZE, paths["stablehlo"],
                     platforms=("cpu",))
    return paths


def _jax_forward(model, variables, x):
    with jax_dispatch.force_xla():
        out = jax.jit(lambda v, a: model.apply(v, a, train=False))(variables, x)
    return [np.asarray(o) for o in out]


def _port_forward(port, x):
    with torch.no_grad():
        return [o.numpy() for o in port(torch.from_numpy(x))]


def _close(got, want, rel):
    for g, w in zip(got, want):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= rel * np.abs(w).max(), (
            np.abs(g - w).max(), np.abs(w).max())


# ------------------------------------------------------------ (a) fold-BN


def test_fold_bn_keeps_the_forward_and_matches_the_jax_fold(pair, x):
    model, variables, port = pair
    state = port.state_dict()
    folded = fold_batchnorm(state)
    assert folded.keys() == state.keys()
    # the JAX package's fold of the same variables, converted, is the same
    # state dict (fp32 arithmetic in another order: 1e-6 of each tensor)
    want = jax_to_state_dict(jax_fold_batchnorm(variables), state.keys())
    for k in state:
        scale = max(want[k].abs().max().item(), 1.0)
        assert (folded[k] - want[k]).abs().max().item() <= 1e-6 * scale, k
    bns = [k[:-len(".running_mean")] for k in state
           if k.endswith(".running_mean")]
    assert len(bns) == 4 * 15 + 4 * 2   # the RFBs' ConvBNs, the Ups' pairs
    for bn in bns:
        assert torch.equal(folded[f"{bn}.weight"], torch.ones_like(
            folded[f"{bn}.weight"]))
        assert torch.equal(folded[f"{bn}.running_mean"], torch.zeros_like(
            folded[f"{bn}.running_mean"]))
        assert torch.allclose(folded[f"{bn}.running_var"], torch.full_like(
            folded[f"{bn}.running_var"], 1.0 - BN_EPS))
        assert not torch.equal(state[f"{bn}.running_var"],
                               folded[f"{bn}.running_var"])

    unfolded = _port_forward(port, x)
    folded_port = PortSAM2UNet(PortConfig(trunk=PORT_HIERA_TEST, rfb_out=RFB))
    folded_port.load_state_dict(state)
    got = _port_forward(fold_model(folded_port.eval()), x)
    _close(got, unfolded, SELF_REL)
    _close(got, _jax_forward(model, jax_fold_batchnorm(variables), x), JAX_REL)


# ------------------------------------------------------------ (b) .pt2


def test_program_round_trip_matches_port_and_stablehlo(pair, x, artifacts):
    _, _, port = pair
    path = artifacts["pt2"]
    assert os.path.getsize(path) > 1000
    run = port_export.load_exported(path, "cpu")
    got = run(x)
    assert list(got) == list(port_export.OUTPUT_NAMES)
    assert all(v.shape == (1, SIZE, SIZE, 1) for v in got.values())
    got = [got[n].numpy() for n in port_export.OUTPUT_NAMES]
    _close(got, _port_forward(port, x), SELF_REL)
    # the reference's gate is 1e-1; the CPU program is the same arithmetic
    assert port_export.verify_export(port, SIZE, path) <= 1e-5

    want = load_exported(artifacts["stablehlo"])(x)
    _close(got, [np.asarray(want[n]) for n in port_export.OUTPUT_NAMES],
           JAX_REL)


def test_program_refuses_another_device(pair, artifacts, tmp_path):
    _, _, port = pair
    with pytest.raises(ValueError, match="exported on"):
        port_export.load_exported(artifacts["pt2"], "meta")
    with pytest.raises(ValueError, match="lies on"):
        port_export.export_program(port, SIZE, str(tmp_path / "m.pt2"), "meta")


# ------------------------------------------------------------ (c) ONNX


def test_onnx_graph_matches_the_jax_forward(pair, x, artifacts):
    model, variables, port = pair
    path = artifacts["onnx"]
    proto = onnx_compat.load_model(path)
    assert [i.name for i in proto.graph.input] == ["images"]
    assert [o.name for o in proto.graph.output] == list(port_export.OUTPUT_NAMES)
    assert [d.dim_value for d in proto.graph.input[0].type.tensor_type.shape.dim
            ] == [1, SIZE, SIZE, 3]
    assert {op.version for op in proto.opset_import if not op.domain} == {17}
    runner = NumpyOnnxRunner(path)
    got = runner(x)
    assert list(got) == list(port_export.OUTPUT_NAMES)
    _close([got[n] for n in port_export.OUTPUT_NAMES],
           _jax_forward(model, variables, x), JAX_REL)
    assert port_export.verify_onnx(port, SIZE, path) <= 1e-5


def _graph(nodes, inputs, outputs):
    """A ModelProto of `nodes` (NodeProto kwargs) over named float inputs."""
    pb2 = onnx_compat._pb2()
    model = pb2.ModelProto(ir_version=8)
    model.opset_import.add(domain="", version=17)
    g = model.graph
    for n in nodes:
        attrs = n.pop("attrs", {})
        node = g.node.add(**n)
        for k, v in attrs.items():
            node.attribute.add(name=k, type=3, s=v.encode())
    for name in inputs:
        g.input.add(name=name).type.tensor_type.elem_type = 1
    for name in outputs:
        g.output.add(name=name)
    return model.SerializeToString()


@pytest.mark.parametrize("equation,shapes", [
    ("oh,bhwc->bowc", [(5, 7), (2, 7, 3, 4)]),       # the resize matrices
    ("pw,bowc->bopc", [(6, 3), (2, 5, 3, 4)]),
    ("bhqd,bhkd->bhqk", [(2, 3, 4, 8), (2, 3, 5, 8)]),
    ("...ij,...jk", [(2, 3, 4), (2, 4, 5)]),          # implicit output
])
def test_einsum_op(equation, shapes):
    """Einsum, the op the port's graph adds to the JAX runner's set,
    against torch.einsum (fp32: 1e-5 of max |output|)."""
    rng = np.random.default_rng(2)
    xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    names = [f"in{i}" for i in range(len(xs))]
    got = NumpyOnnxRunner(_graph(
        [dict(op_type="Einsum", input=names, output=["out"],
              attrs={"equation": equation})], names, ["out"]))(*xs)["out"]
    want = torch.einsum(equation, *map(torch.from_numpy, xs)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_port_graph_needs_no_op_beyond_the_runner(artifacts):
    """Every op type of the port's exported graph has a runner method."""
    ops = {n.op_type for n in
           onnx_compat.load_model(artifacts["onnx"]).graph.node}
    assert "Einsum" in ops
    assert not {op for op in ops if not hasattr(NumpyOnnxRunner, f"op_{op}")}


# ------------------------------------------------------------ (d) golden


CORPUS = ROOT / "tests" / "golden_onnx"
CASES = sorted(Path(p).stem for p in glob.glob(str(CORPUS / "*.onnx")))


def test_golden_corpus_present():
    assert len(CASES) >= 12, CASES


@pytest.mark.parametrize("name", CASES)
def test_golden_case(name):
    data = np.load(CORPUS / f"{name}.npz")
    ins = [data[k] for k in sorted(data.files) if k.startswith("in")]
    got = NumpyOnnxRunner(str(CORPUS / f"{name}.onnx"))(*ins)
    outs = sorted(k for k in data.files if k.startswith("out"))
    assert list(got.keys()) == outs
    for k in outs:
        np.testing.assert_allclose(got[k], data[k], rtol=1e-4, atol=1e-5,
                                   err_msg=f"{name}:{k}")


@pytest.mark.parametrize("name", CASES)
def test_golden_case_reserializes(name):
    """The port's bindings parse each golden graph and write bytes that
    parse back to the same message."""
    data = (CORPUS / f"{name}.onnx").read_bytes()
    model = onnx_compat.load_model_from_string(data)
    again = onnx_compat.load_model_from_string(model.SerializeToString())
    assert again == model and len(model.graph.node) > 0


# ------------------------------------------------------------ (e) segmenter


def test_segmenter_backends_match_the_jax_segmenter(artifacts):
    pt2, onnx_path = artifacts["pt2"], artifacts["onnx"]
    hlo = artifacts["stablehlo"]
    image = (np.random.default_rng(3).random((50, 70, 3)) * 255).astype(np.uint8)
    want = JaxSegmenter(hlo, input_size=SIZE, backend="stablehlo").segment(image)
    assert 0.05 < (want == 255).mean() < 0.95   # both values, many of each
    for backend, path in (("torch_export", pt2), ("onnx", onnx_path)):
        seg = SamUnetSegmenter(path, input_size=SIZE, backend=backend,
                               device="cpu")
        got = seg.segment(image)
        assert got.shape == (50, 70) and got.dtype == np.uint8
        assert set(np.unique(got)) <= {0, 255}
        assert seg.last_process_time > 0
        assert (got != want).mean() <= MASK_SHARE, backend
        # the pre and post process alone: equal masks from equal logits
        batch, padding, hw = seg.preprocess(image)
        jseg = JaxSegmenter(hlo, input_size=SIZE, backend="stablehlo")
        jbatch, jpadding, jhw = jseg.preprocess(image)
        np.testing.assert_allclose(batch, jbatch, rtol=0, atol=1e-6)
        assert (padding, hw) == (jpadding, jhw)
        assert (seg.onnx_runtime is None) == (backend == "torch_export")
    assert "numpy runner" in seg.onnx_runtime
    for backend in ("tf", "openvino"):
        with pytest.raises(NotImplementedError):
            SamUnetSegmenter(pt2, SIZE, backend, "cpu")


def test_segment_returns_zeros_on_failure(artifacts):
    seg = SamUnetSegmenter(artifacts["onnx"], input_size=SIZE, backend="onnx",
                           device="cpu")
    seg.model = lambda batch: 1 / 0
    mask = seg.segment(np.zeros((20, 30, 3), np.uint8))
    assert mask.shape == (20, 30) and not mask.any()
    assert seg.last_process_time == 0.0


# ------------------------------------------------------------ (f) CLIs


def _write_set(root: Path, n: int, rng) -> None:
    (root / "images").mkdir(parents=True)
    (root / "masks").mkdir(parents=True)
    for i in range(n):
        h, w = int(rng.integers(40, 90)), int(rng.integers(40, 90))
        Image.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8)).save(
            root / "images" / f"s{i}.jpg")
        yy, xx = np.mgrid[:h, :w]
        mask = ((yy - h / 2) ** 2 + (xx - w / 3) ** 2 < (min(h, w) / 4) ** 2)
        Image.fromarray(mask.astype(np.uint8) * 255).save(
            root / "masks" / f"s{i}.png")


def test_export_and_deploy_clis_on_the_cpu(tmp_path, capsys):
    torch.manual_seed(0)
    ckpt = tmp_path / "model.pth"
    from sam2unet_torch.cli.common import build_model

    torch.save(build_model("hiera_test", torch.device("cpu")).state_dict(),
               ckpt)
    data = tmp_path / "data"
    _write_set(data, 3, np.random.default_rng(4))
    masks = {}
    for fmt, suffix in (("torch_export", "pt2"), ("onnx", "onnx")):
        art = str(tmp_path / f"model.{suffix}")
        stats = export_cli.main(export_cli.build_parser().parse_args([
            "--checkpoint", str(ckpt), "--output", art, "--size", str(SIZE),
            "--model_cfg", "hiera_test", "--format", fmt, "--device", "cpu"]))
        assert stats["max_diff"] is not None and stats["max_diff"] <= 1e-5
        out = capsys.readouterr().out
        assert f"Exported to {art}" in out and "Export verified" in out
        save = tmp_path / f"preds_{fmt}"
        run = deploy_cli.main(deploy_cli.build_parser().parse_args([
            "--model_path", art, "--test_image_path", str(data / "images"),
            "--test_gt_path", str(data / "masks"), "--save_path", str(save),
            "--size", str(SIZE), "--backend", fmt, "--device", "cpu"]))
        out = capsys.readouterr().out
        assert run["images"] == 3 and all(t > 0 for t in run["process_times"])
        assert "average process_time:" in out
        assert ("onnx runtime: numpy runner" in out) == (fmt == "onnx")
        assert run["report"] is not None and "mIoU" in run["report"]
        assert (save / "log.txt").read_text().count("Segmentation Evaluation")
        for i in range(3):
            png = np.asarray(Image.open(save / f"s{i}.png"))
            gt = np.asarray(Image.open(data / "masks" / f"s{i}.png"))
            assert png.shape == gt.shape and png.dtype == np.uint8
            masks.setdefault(i, []).append(png)
    for pair_ in masks.values():   # the two artifacts of one checkpoint
        assert (pair_[0] != pair_[1]).mean() <= MASK_SHARE
    if not torch.cuda.is_available():   # the default device is cuda
        for cli, argv in ((export_cli, ["--checkpoint", str(ckpt), "--output",
                                        str(tmp_path / "x.pt2")]),
                          (deploy_cli, ["--model_path", art,
                                        "--test_image_path", str(data / "images"),
                                        "--save_path", str(tmp_path / "x")])):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                cli.main(cli.build_parser().parse_args(argv))


# ------------------------------------------------------------ (g) shims

_PROBE = textwrap.dedent("""
    import sys, numpy as np, torch
    torch.set_num_threads(1)
    from sam2unet_torch.configs import HIERA_TEST, SAM2UNetConfig
    from sam2unet_torch.deploy.onnx_numpy import NumpyOnnxRunner
    from sam2unet_torch.interop import export, onnx_compat
    from sam2unet_torch.models.sam2unet import SAM2UNet
    from sam2unet_tpu.interop import onnx_compat as jax_compat
    order, tmp = sys.argv[1], sys.argv[2]
    torch.manual_seed(0)
    port = SAM2UNet(SAM2UNetConfig(trunk=HIERA_TEST, rfb_out=8)).eval()
    x = np.random.default_rng(0).standard_normal((1, 64, 64, 3)).astype("f4")
    before = jax_compat.get_onnx() if order == "jax_first" else None
    assert sys.modules.get("onnx") is before
    if order == "jax_first":
        # torch.export, and its first import of torch._dynamo, with the
        # port's shim registered in place of the JAX package's (no spec)
        assert "torch._dynamo" not in sys.modules
        with onnx_compat.onnx_for_export() as shim:
            assert sys.modules["onnx"] is shim and shim.__spec__ is not None
            export.export_program(port, 64, tmp + "/m.pt2", "cpu")
        assert sys.modules.get("onnx") is before
    # the ONNX leg through the port's own shim and bindings
    export.export_onnx(port, 64, tmp + "/m.onnx")
    assert sys.modules.get("onnx") is before
    got = NumpyOnnxRunner(tmp + "/m.onnx")(x)["output"]
    with torch.no_grad():
        want = port(torch.from_numpy(x))[0].numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    if order == "port_first":
        jax_compat.get_onnx()
    m = jax_compat.load_model(tmp + "/m.onnx")   # the JAX bindings parse it
    assert [o.name for o in m.graph.output] == list(export.OUTPUT_NAMES)
    print("PROBE_OK", order)
""")


@pytest.mark.parametrize("order", ["jax_first", "port_first"])
def test_onnx_leg_beside_the_jax_shim(order, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _PROBE, order, str(tmp_path)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert f"PROBE_OK {order}" in out.stdout


def test_fp32_route_at_960_holds_chip_smoke_counts():
    """The deployed fp32 forward at hiera_s@960, batch 1, full widths
    (stubbed kernels): K12's gate refuses 60x60 w14 at 4-byte items, so
    stage 3's ten blocks after the transition run on the persistent window
    groups (7 windowed: K6 x 4 groups; 3 global: the long form, K10), block
    15 (30x30 w7) takes K12; `fused_mlp` 46 tails and 46 adapters, of which
    the two tails at width 768 (blocks 14 and 15: 18.9 MB of fp32 weights)
    take the plain form past the fp32 weight gate, as the JAX package's
    `_f32_weights_overflow` sends them to XLA: K1 launches 44 + 46.
    chip_smoke.py's s960deploy path holds the card's launches to these
    counts."""
    from test_torch_model_960_cpu import _route_of_each_block

    from sam2unet_torch.configs import HIERA_S

    x = torch.zeros(1, 960, 960, 3)
    routes, mlp, outs = _route_of_each_block(HIERA_S, x, stub=True)
    assert routes == (["K4", "K8", "K4", "K8"] + ["grouped"] * 10
                      + ["plain", "K12"])
    assert mlp == {True: 46, False: 46}
    assert [o.shape[1] for o in outs] == [240, 120, 60, 30]
    _, k1, _ = _route_of_each_block(HIERA_S, x, stub=True, launched=True)
    assert k1 == {True: 44, False: 46}
