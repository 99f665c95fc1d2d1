"""JAX package variables -> this package's state dict.

Input: the JAX SAM2-UNet's variables as a nested dict of numpy arrays
({"params": ..., "batch_stats": ...}). Output: a state dict for the port's
module keys, ready for `load_state_dict(strict=True)`.

The key rules are a self-contained copy of the JAX package's
`_to_flax_path` / `_wrap_block_path` / `flax_to_torch_state_dict`
(sam2unet_tpu/interop/torch_convert.py:31-240):
  blocks.N / layers.N / double_conv.N -> blocks_N / layers_N / layers_N
  branchK.N, mask_downscaling.N,
  output_upscaling.N (Sequentials)   -> <name>_layers_N
  point_embeddings.N,
  output_hypernetworks_mlps.N        -> <name>_N
  mask_downsampler.encoder.N         -> mask_downsampler/encoder_layers_N
  convs.N.conv (the FPN laterals)    -> convs_N_conv
  prompt_learn.N (Sequential)        -> prompt_learn/layers_N
  patch_embed.proj                   -> patch_embed_proj
  pe_layer.positional_encoding_gaussian_matrix -> one joined name
and the layouts: Dense (I, O) -> (O, I); Conv (kh, kw, I, O) and the
ConvTranspose kernel (kh, kw, O, I) -> (O, I, kh, kw) and (I, O, kh, kw),
one transpose for both (the depthwise (kh, kw, 1, C) too); pos embeds
(1, H, W, C) -> (1, C, H, W); BN mean/var -> running_*;
num_batches_tracked is 0; embeddings and other raw parameters (the memory
encoder's layer scales `gamma`, `maskmem_tpos_enc`) as they are. With
`wrap_blocks` (SAM2-UNet's trunk) the adapter wrapper's `block` scope is
inserted after `blocks_N` for keys that carry neither `block` nor
`prompt_learn`; SAM2's own trunk has no such scope.

Strict both ways: a port key with no JAX leaf raises, and so does a JAX
leaf that no port key consumed.
"""

from __future__ import annotations

import numpy as np
import torch

_SUFFIXES = (".weight", ".bias", ".running_mean", ".running_var",
             ".num_batches_tracked")


_LIST_FLAT = ("point_embeddings", "output_hypernetworks_mlps")
_SEQ_FLAT = ("mask_downscaling", "output_upscaling")


def _jax_path(name: str, wrap_blocks: bool = True) -> tuple[str, ...]:
    parts = name.split(".")
    out: list[str] = []
    i = 0
    while i < len(parts):
        p = parts[i]
        nxt = parts[i + 1] if i + 1 < len(parts) else None
        if p == "patch_embed" and nxt == "proj":
            out.append("patch_embed_proj")
            i += 2
        elif p == "pe_layer" and nxt == "positional_encoding_gaussian_matrix":
            out.append("pe_layer_positional_encoding_gaussian_matrix")
            i += 2
        elif nxt is not None and nxt.isdigit():
            if p in ("blocks", "layers", "double_conv"):
                out.append(f"{'layers' if p == 'double_conv' else p}_{nxt}")
            elif p in _LIST_FLAT:
                out.append(f"{p}_{nxt}")
            elif p in _SEQ_FLAT or (p.startswith("branch") and p[6:].isdigit()):
                out.append(f"{p}_layers_{nxt}")
            elif p == "encoder" and "mask_downsampler" in parts[:i]:
                out.append(f"encoder_layers_{nxt}")
            elif p == "convs" and i + 2 < len(parts):
                out.append(f"convs_{nxt}_{parts[i + 2]}")
                i += 1
            else:  # generic Sequential (prompt_learn)
                out += [p, f"layers_{nxt}"]
            i += 2
        else:
            out.append(p)
            i += 1
    if not wrap_blocks:
        return tuple(out)
    wrapped: list[str] = []
    for j, x in enumerate(out):
        wrapped.append(x)
        if x.startswith("blocks_") and out[j + 1: j + 2] not in (
                ["block"], ["prompt_learn"]):
            wrapped.append("block")
    return tuple(wrapped)


def _flatten(tree: dict, prefix: tuple = ()) -> dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def jax_to_state_dict(variables: dict, keys,
                      wrap_blocks: bool = True) -> dict[str, torch.Tensor]:
    """Convert JAX variables to a state dict covering `keys` (the port
    module's `state_dict().keys()`)."""
    leaves = {}
    for coll in ("params", "batch_stats"):
        leaves.update({(coll,) + p: v
                       for p, v in _flatten(variables.get(coll, {})).items()})
    used: set[tuple] = set()

    def take(path: tuple) -> np.ndarray | None:
        if path in leaves:
            used.add(path)
            return leaves[path]
        return None

    out: dict[str, torch.Tensor] = {}
    for key in keys:
        name, suffix = key, ""
        for s in _SUFFIXES:
            if key.endswith(s):
                name, suffix = key[: -len(s)], s
                break
        path = _jax_path(name, wrap_blocks)
        if suffix == ".num_batches_tracked":
            out[key] = torch.tensor(0, dtype=torch.int64)
            continue
        if suffix == ".running_mean":
            value = take(("batch_stats",) + path + ("mean",))
        elif suffix == ".running_var":
            value = take(("batch_stats",) + path + ("var",))
        elif suffix == ".weight":
            value = take(("params",) + path + ("kernel",))
            if value is not None:
                value = (value.transpose(3, 2, 0, 1) if value.ndim == 4
                         else value.T)
            else:
                value = take(("params",) + path + ("scale",))
            if value is None:   # an embedding's raw table
                value = take(("params",) + path)
        elif suffix == ".bias":
            value = take(("params",) + path + ("bias",))
        else:
            value = take(("params",) + path)
            if value is not None and name.endswith(("pos_embed",
                                                    "pos_embed_window")):
                value = value.transpose(0, 3, 1, 2)
        if value is None:
            raise KeyError(f"no JAX variable for port key {key} "
                           f"(looked under {'/'.join(path)})")
        out[key] = torch.from_numpy(np.array(value, np.float32))
    unused = sorted("/".join(p) for p in set(leaves) - used)
    if unused:
        raise KeyError(f"JAX variables with no port key: {unused[:8]}"
                       f"{'...' if len(unused) > 8 else ''}")
    return out
