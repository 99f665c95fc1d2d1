"""The port stands alone: no file of sam2unet_torch/, and not chip_smoke.py,
imports jax, flax, orbax, tensorstore, zstandard or anything of
sam2unet_tpu."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

# Import torch's compiler stack while the suite is collected, before any
# test runs. `sam2unet_tpu.interop.onnx_compat.get_onnx()` registers an
# `onnx` shim without `__spec__`; torch imports `torch._dynamo` lazily (the
# first optimizer, for one) and that import fails on such a module, so a
# process that ran an ONNX test first would fail unrelated torch tests.
import torch._dynamo  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "sam2unet_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tensorstore",
             "zstandard", "sam2unet_tpu")


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_port_package_has_the_expected_modules():
    names = {str(p.relative_to(ROOT)) for p in FILES}
    for mod in ("configs.py", "ops/dispatch.py", "ops/fused_mlp.py",
                "ops/fused_attention_block.py", "ops/fused_transition.py",
                "ops/flash_attention.py", "ops/pooling.py",
                "ops/build.py", "models/hiera.py", "models/sam2unet.py",
                "interop/from_jax.py", "data/dataset.py", "data/transforms.py",
                "train/loss.py", "train/optim.py", "train/engine.py",
                "train/checkpoints.py", "eval/metrics.py",
                "eval/metrics_device.py", "cli/test_cli.py",
                "cli/train_cli.py", "ops/attention.py",
                "models/position_encoding.py", "models/fpn.py",
                "models/prompt_encoder.py", "models/transformer.py",
                "models/mask_decoder.py", "models/sam2_base.py",
                "build_sam.py", "predictors/transforms.py",
                "predictors/image_predictor.py", "models/memory.py",
                "ops/connected_components.py", "utils/video.py",
                "predictors/video_predictor.py",
                "predictors/video_device.py", "configs_yaml/hydra_compat.py",
                "utils/amg.py", "predictors/amg.py", "ops/grouped.py",
                "cli/eval_cli.py", "data/native_loader.py",
                "nn/fold_bn.py", "interop/export.py",
                "interop/onnx_compat/__init__.py", "deploy/onnx_numpy.py",
                "deploy/segmenter.py", "cli/export_cli.py",
                "cli/deploy_cli.py", "interop/ocdbt.py", "interop/orbax.py",
                "utils/flops_audit.py", "utils/profile_model.py",
                "utils/dump_augmentations.py", "parallel/__init__.py",
                "parallel/mesh.py", "parallel/sharding.py",
                "parallel/dryrun.py", "ops/sp_attention.py"):
        assert f"sam2unet_torch/{mod}" in names
    for src in ("fused_mlp.cu", "fused_attention_block.cu",
                "fused_transition.cu", "flash_attention.cu",
                "attention_bwd.cuh", "attention_bwd_tiles.cuh",
                "flash_attention_bwd.cu", "full_attention.cu",
                "flash_attention_d256.cu", "full_attention_d256.cu",
                "attention_any.cu", "attention_any_bwd.cu",
                "attention_any_bwd_pad.cu", "attention_any.cuh",
                "attention_any_fwd.cuh", "attention_any_bwd.cuh",
                "gemm_any.cu", "gemm_any.cuh", "hopper.cuh",
                "flash_attention_bwd_sm90.cu", "flash_attention_fwd_sm90.cu",
                "ccl.cc", "dataload.cc"):
        assert (ROOT / "sam2unet_torch" / "csrc" / src).is_file()
    # the port's own ONNX schema and its committed protoc bindings
    assert (ROOT / "sam2unet_torch" / "interop" / "onnx_compat"
            / "sam2unet_torch_onnx.proto").is_file()
    assert "sam2unet_torch/interop/onnx_compat/_gen/sam2unet_torch_onnx_pb2.py" \
        in names
    # the port's own copies of the reference's YAML configs
    for name in ("t", "s", "b+", "l"):
        assert (ROOT / "sam2unet_torch" / "configs_yaml"
                / f"sam2_hiera_{name}.yaml").is_file()
