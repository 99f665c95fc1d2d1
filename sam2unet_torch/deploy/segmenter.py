"""Deployment inference harness: the port's copy of
sam2unet_tpu/deploy/segmenter.py (reference test_onnx.py:33-237).

Backend-abstracted model loading and a segmenter with the reference's numpy
pre and post process: letterbox to the model size, normalize, run, crop the
padding, sigmoid, resize to the input resolution, threshold 0.1 -> a uint8
{0, 255} mask.

Backends:
  - "torch_export": the `.pt2` program of `interop.export.export_program`
    on `device` (default cuda), the port's counterpart of the JAX
    package's "stablehlo".
  - "onnx": an onnxruntime session where onnxruntime is installed, else the
    numpy runner (deploy/onnx_numpy.py), as the JAX package chooses;
    `onnx_runtime` names the one that runs. NCHW graphs (the reference's)
    and NHWC graphs (this package's) both load.
  - "openvino": raises, as test_onnx.py:104-120 does.
  - "tf": raises; the TF SavedModel format is not ported (ROADMAP.md,
    "Not to port").
"""

from __future__ import annotations

import abc
import time

import numpy as np
import torch

from sam2unet_torch.data.transforms import letterbox, normalize
from sam2unet_torch.ops.resize_np import resize_np

SCORE_THRESHOLD = 0.1
BACKENDS = ("torch_export", "onnx", "openvino", "tf")


class ModelMixin:
    """Load/run abstraction (test_onnx.py:33-120)."""

    backend: str = "torch_export"
    model = None
    onnx_runtime: str | None = None

    def load(self, model_path: str, backend: str | None = None,
             device: str | torch.device = "cuda") -> None:
        backend = backend or self.backend
        if backend == "torch_export":
            from sam2unet_torch.interop.export import load_exported

            program = load_exported(model_path, device)
            self.model = lambda x: {k: v.float().cpu().numpy()
                                    for k, v in program(x).items()}
        elif backend == "onnx":
            try:
                import onnxruntime as ort

                self._session = ort.InferenceSession(model_path)
                self.onnx_runtime = f"onnxruntime {ort.__version__}"
            except ImportError:
                from sam2unet_torch.deploy.onnx_numpy import NumpyOnnxRunner

                self._session = NumpyOnnxRunner(model_path)
                self.onnx_runtime = ("numpy runner (deploy/onnx_numpy.py; "
                                     "onnxruntime is not installed)")
            info = self._session.get_inputs()[0]
            self._onnx_input = info.name
            # the reference's graphs are NCHW, this package's NHWC
            self._onnx_nchw = len(info.shape) == 4 and info.shape[1] == 3
            self.model = self._run_onnx
        elif backend == "openvino":
            raise NotImplementedError("OpenVINO backend is not supported")
        elif backend == "tf":
            raise NotImplementedError(
                "the TF SavedModel backend is not ported (ROADMAP.md, "
                "\"Not to port\"); export with --format torch_export or onnx")
        else:
            raise ValueError(f"unknown backend {backend} (have {BACKENDS})")
        self.backend = backend

    def _run_onnx(self, x):
        x = np.asarray(x, np.float32)
        if self._onnx_nchw and x.ndim == 4 and x.shape[-1] == 3:
            x = x.transpose(0, 3, 1, 2)
        outs = self._session.run(None, {self._onnx_input: x})
        names = ["output"] + [f"output_{i}" for i in range(1, len(outs))]
        return dict(zip(names, outs))

    def run(self, x: np.ndarray) -> dict:
        if self.model is None:
            raise RuntimeError("call load() first")
        return self.model(x)


class BaseSegmenter(abc.ABC, ModelMixin):
    """(test_onnx.py:123-142)."""

    def __init__(self, model_path: str, input_size: int = 960,
                 backend: str = "torch_export",
                 device: str | torch.device = "cuda"):
        self.input_size = input_size
        self.last_process_time = 0.0  # defined before the first segment()
        self.load(model_path, backend, device)

    @abc.abstractmethod
    def segment(self, image: np.ndarray) -> np.ndarray: ...


class SamUnetSegmenter(BaseSegmenter):
    """(test_onnx.py:145-237): the numpy pre and post process around the
    exported model."""

    def preprocess(self, image: np.ndarray):
        """image: HWC uint8 RGB. Returns (batch (1, S, S, 3), padding
        (left, top, right, bottom), (h, w))."""
        h, w = image.shape[:2]
        chw = np.asarray(image, np.float32).transpose(2, 0, 1) / 255.0
        canvas, padding = letterbox(chw, self.input_size)
        return normalize(canvas).transpose(1, 2, 0)[None], padding, (h, w)

    def postprocess(self, out: np.ndarray, padding, hw) -> np.ndarray:
        """Logits (1, S, S, 1) NHWC or (1, 1, S, S) NCHW -> the uint8 mask
        at the input resolution `hw`."""
        out = np.asarray(out, np.float32)
        logits = out[0, ..., 0] if out.ndim == 4 and out.shape[-1] == 1 \
            else out[0, 0]
        left, top, right, bottom = padding
        s = self.input_size
        logits = logits[top: s - bottom, left: s - right]
        prob = 1.0 / (1.0 + np.exp(-logits))
        prob = resize_np(prob[None, None], tuple(hw), "bilinear")[0, 0]
        return ((prob > SCORE_THRESHOLD) * 255).astype(np.uint8)

    def segment(self, image: np.ndarray) -> np.ndarray:
        """A uint8 {0, 255} mask at the input resolution; zeros, and
        `last_process_time` 0, on an inference failure (test_onnx.py:166-171
        behaviour)."""
        try:
            batch, padding, hw = self.preprocess(image)
            t0 = time.perf_counter()
            out = self.run(batch)["output"]
            self.last_process_time = time.perf_counter() - t0
            return self.postprocess(out, padding, hw)
        except Exception:
            self.last_process_time = 0.0
            return np.zeros(image.shape[:2], np.uint8)
