"""ONNX protobuf support without the `onnx` package: the port's own copy of
sam2unet_tpu/interop/onnx_compat.

`sam2unet_torch_onnx.proto` is a wire-compatible subset of the public
onnx.proto (field numbers per the ONNX IR spec). Its bindings,
`_gen/sam2unet_torch_onnx_pb2.py`, are generated by protoc 3.21 and
committed, so nothing is compiled at run time; they need only
`google.protobuf`. The file has its own name and package
(`sam2unet_torch_onnx`), so it registers in protobuf's default descriptor
pool beside any other copy of the schema, whichever loaded first.

- ``load_model`` / ``load_model_from_string``: parse a ``.onnx`` file into
  this package's ModelProto (always these bindings, never a shim that
  another package put in ``sys.modules``).
- ``onnx_for_export()``: a context in which ``import onnx`` resolves to the
  real package when it is installed, else to this package's shim. The
  TorchScript exporter (``torch.onnx.export(..., dynamo=False)``) imports
  ``onnx`` for its onnxscript post-pass and calls only
  ``load_model_from_string``, all the shim offers. A shim registered by
  another package is set aside for the export and put back after it.
- ``tensor_to_array``, ``attr_map``: TensorProto and NodeProto attributes
  to numpy and Python values.
"""

from __future__ import annotations

import contextlib
import importlib.machinery
import sys
import types
from pathlib import Path

import numpy as np

_SHIM_FLAG = "__sam2unet_torch_shim__"


def _pb2():
    from sam2unet_torch.interop.onnx_compat._gen import (
        sam2unet_torch_onnx_pb2,
    )

    return sam2unet_torch_onnx_pb2


def load_model_from_string(data: bytes):
    return _pb2().ModelProto.FromString(data)


def load_model(path: str):
    return load_model_from_string(Path(path).read_bytes())


def _real_onnx():
    """The installed `onnx` package, or None. A module that another package
    registered under that name as a stand-in does not count."""
    mod = sys.modules.get("onnx")
    if mod is None:
        try:
            import onnx as mod
        except ImportError:
            return None
    if getattr(mod, _SHIM_FLAG, False) or getattr(mod, "__sam2unet_shim__",
                                                  False):
        return None
    return mod


def _make_shim() -> types.ModuleType:
    """A module named `onnx` with what the TorchScript exporter calls,
    `load_model_from_string` (torch/onnx/_internal/torchscript_exporter/
    onnx_proto_utils.py). It carries a ModuleSpec: `import torch._dynamo`
    (which `torch.export` imports) fails on a module in `sys.modules` whose
    `__spec__` is None."""
    shim = types.ModuleType("onnx")
    shim.__spec__ = importlib.machinery.ModuleSpec("onnx", None)
    setattr(shim, _SHIM_FLAG, True)
    shim.load_model_from_string = load_model_from_string
    return shim


@contextlib.contextmanager
def onnx_for_export():
    """`import onnx` inside the block gives the real package, else this
    package's shim; whatever `sys.modules["onnx"]` held before is restored
    after."""
    real = _real_onnx()
    if real is not None:
        yield real
        return
    missing = object()
    before = sys.modules.get("onnx", missing)
    shim = _make_shim()
    sys.modules["onnx"] = shim
    try:
        yield shim
    finally:
        if before is missing:
            sys.modules.pop("onnx", None)
        else:
            sys.modules["onnx"] = before


# TensorProto.DataType -> numpy dtype (bfloat16 handled separately: ONNX
# stores bf16 raw payloads as uint16 words)
DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}


def tensor_to_array(t) -> np.ndarray:
    """TensorProto -> numpy array (the numpy_helper.to_array contract)."""
    dims = tuple(t.dims)
    dt = int(t.data_type)
    if dt == 16:  # bfloat16: widen via bit-shift into float32
        raw = np.frombuffer(t.raw_data, np.uint16) if t.raw_data else np.asarray(
            list(t.int32_data), np.uint16)
        return (raw.astype(np.uint32) << 16).view(np.float32).reshape(dims)
    if dt not in DTYPES:
        raise NotImplementedError(f"TensorProto data_type {dt}")
    np_dt = DTYPES[dt]
    if t.raw_data:
        return np.frombuffer(t.raw_data, np_dt).reshape(dims).copy()
    if dt == 1:
        data = np.asarray(list(t.float_data), np.float32)
    elif dt == 7:
        data = np.asarray(list(t.int64_data), np.int64)
    elif dt == 11:
        data = np.asarray(list(t.double_data), np.float64)
    elif dt in (12, 13):
        data = np.asarray(list(t.uint64_data), np.uint64)
    else:  # int32 carries every narrow integral/bool/fp16 payload
        data = np.asarray(list(t.int32_data), np.int32)
        if dt == 10:
            # fp16 typed storage holds uint16 bit patterns, not values:
            # bit-cast, never value-cast (15360 -> 1.0, not 15360.0)
            return data.astype(np.uint16).view(np.float16).reshape(dims)
    return data.astype(np_dt).reshape(dims)


def attr_map(node) -> dict:
    """NodeProto attributes -> {name: python value}."""
    out = {}
    for a in node.attribute:
        ty = int(a.type)
        if ty == 1:
            out[a.name] = float(a.f)
        elif ty == 2:
            out[a.name] = int(a.i)
        elif ty == 3:
            out[a.name] = a.s.decode("utf-8")
        elif ty == 4:
            out[a.name] = tensor_to_array(a.t)
        elif ty == 5:
            out[a.name] = a.g
        elif ty == 6:
            out[a.name] = [float(v) for v in a.floats]
        elif ty == 7:
            out[a.name] = [int(v) for v in a.ints]
        elif ty == 8:
            out[a.name] = [s.decode("utf-8") for s in a.strings]
        else:
            raise NotImplementedError(f"attribute type {ty} ({a.name})")
    return out
