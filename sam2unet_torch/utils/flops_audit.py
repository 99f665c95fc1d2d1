"""FLOP count of the SAM2-UNet forward and train step per image: the port's
counterpart of sam2unet_tpu/utils/flops_audit.py, for the MFU of a
benchmark.

The count is `torch.utils.flop_counter.FlopCounterMode` over one image at
`size`, with every hand-written kernel sent to its plain PyTorch version
(`ops.dispatch.force_plain()`): a kernel bound through ctypes is invisible
to the counter, as the Pallas custom calls were to XLA's cost analysis (the
JAX package forces its `_xla_*` forms for the same reason). "infer" is one
forward in eval mode; "train" is one step of the port's train engine
(`train.engine.train_step`): the forward in train mode, the three heads'
structure loss, the backward (the frozen trunk's dx only) and the AdamW
update.

FlopCounterMode counts the operations of matrix products, convolutions
(and their backward) and attention, 2 per multiply-add. XLA's `flops`
counts elementwise work besides (activations, normalisation, softmax, the
loss, the optimizer update), so the JAX audit reads higher and the two are
not expected to be equal (tests/test_torch_flops_cpu.py holds the ratio in
a measured band). The count does not depend on the dtype: the model runs
in fp32. It runs on a device (the plain route takes CPU and CUDA tensors,
not meta ones): `cuda` by default, `--device cpu` in the tests.

    python -m sam2unet_torch.utils.flops_audit --model_cfg sam2_hiera_s \
        --size 960 --mode both [--device cpu]

prints one JSON line, {"infer": <flops/img>, "train": <flops/img>}.
"""

from __future__ import annotations

import argparse
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from sam2unet_torch.cli.common import build_model, resolve_device
from sam2unet_torch.ops import dispatch
from sam2unet_torch.train.engine import train_step
from sam2unet_torch.train.optim import make_optimizer


def count_flops(fn, *args) -> float:
    """The FLOPs of `fn(*args)` as FlopCounterMode counts them, every
    kernel wrapper on its plain version."""
    counter = FlopCounterMode(display=False)
    with dispatch.force_plain(), counter:
        fn(*args)
    return float(counter.get_total_flops())


def audit(model_cfg: str, size: int, mode: str,
          device: str | torch.device = "cuda") -> dict:
    """{"infer": ..., "train": ...} (the modes asked for), FLOPs per image."""
    dev = resolve_device(device)
    model = build_model(model_cfg, dev)
    x = torch.zeros((1, size, size, 3), device=dev)
    out = {}
    if mode in ("infer", "both"):
        with torch.no_grad():
            out["infer"] = count_flops(model.eval(), x)
    if mode in ("train", "both"):
        y = torch.zeros((1, size, size, 1), device=dev)
        out["train"] = count_flops(train_step, model, make_optimizer(model),
                                   x, y)
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--model_cfg", default="sam2_hiera_l")
    p.add_argument("--size", type=int, default=352)
    p.add_argument("--mode", choices=["infer", "train", "both"],
                   default="both")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    out = audit(args.model_cfg, args.size, args.mode, args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
