"""Export entry point, flag-compatible with the JAX package's convert_onnx.py
(reference convert_onnx.py), plus --device.

--format torch_export (the default) writes the `torch.export` program
(`.pt2`) traced on --device; --format onnx writes an opset-17 ONNX graph
through the TorchScript exporter. Both run the kernels' plain versions by
construction (interop/export.py). Unless --skip_verify, the artifact is
held against the native forward as the reference does (convert_onnx.py:
69-107, allclose at 1e-1): the `.pt2` against the forward with the kernels
on --device, the ONNX graph (numpy runner) against the forward's plain
versions.

    python -m sam2unet_torch.cli.export_cli --checkpoint model.pth \
        --output model.pt2 [--format onnx --output model.onnx] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import torch

from sam2unet_torch.cli.common import build_model, load_weights, resolve_device
from sam2unet_torch.interop.export import (
    export_onnx,
    export_program,
    verify_export,
    verify_onnx,
)

FORMATS = ("torch_export", "onnx")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", type=str, required=True)
    p.add_argument("--onnx_path", type=str, default="",
                   help="output path (kept for reference flag parity)")
    p.add_argument("--output", type=str, default="", help="output path")
    p.add_argument("--size", type=int, default=960)
    p.add_argument("--model_cfg", type=str, default="sam2_hiera_s")
    p.add_argument("--format", choices=FORMATS, default="torch_export")
    p.add_argument("--skip_verify", action="store_true")
    p.add_argument("--device", default="cuda", type=str)
    return p


def main(args) -> dict:
    out_path = args.output or args.onnx_path
    if not out_path:
        raise SystemExit("provide --output (or --onnx_path)")
    device = resolve_device(args.device)
    model = build_model(args.model_cfg, torch.device("cpu"))
    load_weights(model, checkpoint=args.checkpoint)
    model = model.to(device)
    t0 = time.perf_counter()
    if args.format == "onnx":
        export_onnx(model, args.size, out_path)
    else:
        export_program(model, args.size, out_path, device)
    seconds = time.perf_counter() - t0
    print(f"Exported to {out_path} ({args.format}, {seconds:.2f} s on "
          f"{device})")
    diff = None
    if not args.skip_verify:
        if args.format == "onnx":
            diff = verify_onnx(model, args.size, out_path, rtol=1e-1, atol=1e-1)
        else:
            diff = verify_export(model, args.size, out_path)
        print(f"Export verified: max abs diff {diff:.3e} (tolerance 1e-1)")
    return {"path": out_path, "export_seconds": seconds, "max_diff": diff}


def run() -> None:
    main(build_parser().parse_args())


if __name__ == "__main__":
    run()
