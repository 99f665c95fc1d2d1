"""Model export and parity verification: the port's copy of
sam2unet_tpu/interop/export.py (reference convert_onnx.py:20-107).

Two artifacts, one name contract: input "images", a (1, S, S, 3) float32
NHWC batch (the port's public layout), outputs ``OUTPUT_NAMES`` = (out,
out1, out2), each (1, S, S, 1) logits.

- `export_program`: a `torch.export` program saved as `.pt2`, the port's
  counterpart of the JAX package's StableHLO artifact. `load_exported`
  runs it.
- `export_onnx`: ONNX (opset 17, the reference's) through the TorchScript
  exporter, with `interop.onnx_compat` standing in for the `onnx` package
  where that is not installed. `verify_onnx` runs it with onnxruntime's
  numpy stand-in, `deploy/onnx_numpy.py`.

Both artifacts are traced under `dispatch.force_plain()`, as the JAX
package traces its own under `force_xla()`: the hand-written kernels are
bound through ctypes (`ops/build.py`), which no traced program can hold,
so the artifacts run the kernels' plain PyTorch versions by construction.
`verify_export` holds the `.pt2` program against the native forward WITH
the kernels on the model's device; `verify_onnx` holds the ONNX graph
against the native forward under `force_plain()`, as the JAX package's
`verify_onnx` does under `force_xla()`.

`torch.export` runs non-strict (`strict=False`): the routing gates of the
trunk (`ops/fused_attention_block.py`, which window layout and which
attention form a shape takes) are host Python over static shapes, which
the strict tracer (TorchDynamo) refuses (it fails on `min` over a
generator of tuples in `_win_pad_dims`); non-strict export runs that Python
as it is and records the tensor operations it chose. The program holds
the export device in its tensor-metadata asserts, so it runs on the device
it was exported on: the CPU in the tests, `cuda` on the card.

The JAX package's TF SavedModel half and its `export_onnx_via_torch`
bridge are not ported (ROADMAP.md, "Not to port"; the port is the torch
module).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch import nn

from sam2unet_torch.ops import dispatch

INPUT_NAME = "images"
OUTPUT_NAMES = ("output", "output_1", "output_2")


class _Named(nn.Module):
    """The model's forward with its outputs named by ``OUTPUT_NAMES``."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, images: torch.Tensor) -> dict[str, torch.Tensor]:
        return dict(zip(OUTPUT_NAMES, self.model(images)))


def _model_device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def export_program(model: nn.Module, size: int, path: str,
                   device: str | torch.device = "cuda"):
    """Trace `model`'s eval forward at (1, size, size, 3) float32 on
    `device` under `force_plain()` and save the program to `path`
    (`.pt2`). Returns the ExportedProgram."""
    device = torch.device(device)
    held = _model_device(model)
    if held.type != device.type or device.index not in (None, held.index):
        raise ValueError(f"the model lies on {_model_device(model)}, the "
                         f"export was asked for {device}")
    x = torch.zeros(1, size, size, 3, device=device)
    with dispatch.force_plain(), torch.no_grad():
        program = torch.export.export(_Named(model.eval()), (x,), strict=False)
    torch.export.save(program, path)
    return program


def load_exported(path: str, device: str | torch.device = "cuda"):
    """Returns fn(x: (1, S, S, 3) float32, numpy or tensor) -> {name:
    tensor on `device`}. Raises if the program was exported on another
    device."""
    device = torch.device(device)
    program = torch.export.load(path)
    held = {t.device for t in program.state_dict.values()}
    if {d.type for d in held} != {device.type}:
        raise ValueError(f"{path} was exported on {sorted(map(str, held))}; "
                         f"export it again on {device} to run it there")
    module = program.module()

    def fn(x) -> dict[str, torch.Tensor]:
        with torch.no_grad():
            return module(torch.as_tensor(x, dtype=torch.float32,
                                          device=device))

    return fn


def _numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().float().cpu().numpy()
    return np.asarray(t, np.float32)


def _verify_against_native(model: nn.Module, size: int, run_exported,
                           rtol: float, atol: float,
                           plain: bool = False) -> float:
    """The parity core of every format (convert_onnx.py:69-107): a seeded
    input, the native forward on the model's device (with the kernels, or
    under `force_plain()` when `plain`), `assert_allclose` on each named
    output, the max abs diff. `run_exported(x_nhwc)` returns {name: array
    or tensor}; NCHW outputs are transposed to match."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, size, size, 3)).astype(np.float32)
    xt = torch.from_numpy(x).to(_model_device(model))
    with (dispatch.force_plain() if plain else contextlib.nullcontext()), \
            torch.no_grad():
        native = model.eval()(xt)
    got = run_exported(x)
    max_diff = 0.0
    for name, ref in zip(OUTPUT_NAMES, native):
        g, ref = _numpy(got[name]), _numpy(ref)
        if g.shape != ref.shape and g.ndim == 4:  # NCHW -> NHWC
            g = g.transpose(0, 2, 3, 1)
        np.testing.assert_allclose(g, ref, rtol=rtol, atol=atol,
                                   err_msg=name)
        max_diff = max(max_diff, float(np.abs(g - ref).max()))
    return max_diff


def verify_export(model: nn.Module, size: int, path: str,
                  rtol: float = 1e-1, atol: float = 1e-1) -> float:
    """The `.pt2` program against the native forward with the kernels, on
    the model's device (convert_onnx.py:69-107: allclose at 1e-1). Returns
    the max abs diff."""
    return _verify_against_native(
        model, size, load_exported(path, _model_device(model)), rtol, atol)


def export_onnx(model: nn.Module, size: int, path: str,
                opset: int = 17) -> None:
    """ONNX through the TorchScript exporter, traced on the model's device
    under `force_plain()`: input "images" (1, size, size, 3) NHWC, outputs
    ``OUTPUT_NAMES`` (convert_onnx.py:25-34, opset 17)."""
    from sam2unet_torch.interop.onnx_compat import onnx_for_export

    x = torch.zeros(1, size, size, 3, device=_model_device(model))
    with dispatch.force_plain(), onnx_for_export(), torch.no_grad():
        torch.onnx.export(model.eval(), (x,), path, opset_version=opset,
                          dynamo=False, input_names=[INPUT_NAME],
                          output_names=list(OUTPUT_NAMES))


def verify_onnx(model: nn.Module, size: int, path: str,
                rtol: float = 5e-4, atol: float = 5e-4) -> float:
    """The `.onnx` graph through the numpy runner against the native
    forward under `force_plain()` (the reference's onnxruntime parity
    check, convert_onnx.py:69-107). Returns the max abs diff."""
    from sam2unet_torch.deploy.onnx_numpy import NumpyOnnxRunner

    runner = NumpyOnnxRunner(path)
    in_shape = runner.get_inputs()[0].shape
    nchw = len(in_shape) == 4 and in_shape[1] == 3
    return _verify_against_native(
        model, size,
        lambda x: runner(x.transpose(0, 3, 1, 2) if nchw else x),
        rtol, atol, plain=True)
