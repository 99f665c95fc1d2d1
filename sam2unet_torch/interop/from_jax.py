"""JAX package variables <-> this package's state dict.

`jax_to_state_dict`: the JAX SAM2-UNet's variables as a nested dict of
numpy arrays ({"params": ..., "batch_stats": ...}) -> a state dict for the
port's module keys, ready for `load_state_dict(strict=True)`.
`state_dict_to_jax`: the inverse, a port state dict -> the JAX package's
variables (its `convert_state_dict`, interop/torch_convert.py:130-160, on
the port's keys), so that `save_variables` writes what the JAX package
restores.

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
leaf that no port key consumed; two port keys that land on one JAX leaf
raise. BatchNorm's running variance is carried as it is, both ways: the
JAX package stores the biased batch variance, torch the unbiased one, but
that only changes how a training step updates the statistic; an eval-mode
BatchNorm on either side normalises with the stored value.
"""

from __future__ import annotations

import numpy as np
import torch

_SUFFIXES = (".weight", ".bias", ".running_mean", ".running_var",
             ".num_batches_tracked")


_LIST_FLAT = ("point_embeddings", "output_hypernetworks_mlps")
# raw parameters and nn.Embedding tables stored as they are (no transpose,
# no kernel / scale leaf); the JAX package's `_EMBED_BASES`
_RAW = ("not_a_point_embed", "no_mask_embed", "iou_token", "mask_tokens",
        "obj_score_token", "no_mem_embed", "no_mem_pos_enc",
        "maskmem_tpos_enc", "no_obj_ptr", "no_obj_embed_spatial",
        "positional_encoding_gaussian_matrix", "gamma")
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


def _split_suffix(key: str) -> tuple[str, str]:
    for s in _SUFFIXES:
        if key.endswith(s):
            return key[: -len(s)], s
    return key, ""


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
        name, suffix = _split_suffix(key)
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


def jax_leaf(key: str, ndim: int, wrap_blocks: bool = True
             ) -> tuple[str, tuple[str, ...], tuple[int, ...]] | None:
    """Where a port state-dict entry of `ndim` dimensions lives in the JAX
    package's variables: (collection, path, axes), with the JAX array the
    port tensor permuted by `axes` (`tensor.permute(axes)`): Linear (O, I) ->
    Dense (I, O); Conv and ConvTranspose (O, I, kh, kw) / (I, O, kh, kw) ->
    (kh, kw, I, O) / (kh, kw, O, I); a 1-D weight (BatchNorm, LayerNorm) ->
    `scale`; running_mean / var -> `batch_stats` mean / var; pos embeds
    (1, C, H, W) -> (1, H, W, C); raw parameters and embedding tables as
    they are. None for num_batches_tracked, which the JAX package lacks."""
    name, suffix = _split_suffix(key)
    if suffix == ".num_batches_tracked":
        return None
    path = _jax_path(name, wrap_blocks)
    coll, leaf, axes = "params", None, tuple(range(ndim))
    parts = name.split(".")
    raw = parts[-1] in _RAW or (len(parts) > 1 and parts[-2]
                                == "point_embeddings" and parts[-1].isdigit())
    if suffix in (".running_mean", ".running_var"):
        coll, leaf = "batch_stats", suffix[len(".running_"):]
    elif suffix == ".weight" and not raw:
        if ndim == 4:
            leaf, axes = "kernel", (2, 3, 1, 0)
        elif ndim == 2:
            leaf, axes = "kernel", (1, 0)
        else:
            leaf = "scale"
    elif suffix == ".bias":
        leaf = "bias"
    elif name.endswith(("pos_embed", "pos_embed_window")):
        axes = (0, 2, 3, 1)
    return coll, path + (leaf,) if leaf else path, axes


def state_dict_to_jax(state_dict: dict, wrap_blocks: bool = True) -> dict:
    """A port state dict -> the JAX package's variables, nested dicts of
    numpy arrays, by `jax_leaf`'s places and layouts (num_batches_tracked
    dropped: `jax_to_state_dict` gives 0 back). Raises where two keys land
    on one JAX leaf."""
    tree: dict = {"params": {}, "batch_stats": {}}
    for key, value in state_dict.items():
        arr = (value.detach().cpu().numpy() if isinstance(value, torch.Tensor)
               else np.asarray(value))
        place = jax_leaf(key, arr.ndim, wrap_blocks)
        if place is None:
            continue
        coll, path, axes = place
        arr = arr.transpose(axes)
        node = tree[coll]
        for p in path[:-1]:
            node = node.setdefault(p, {})
            if not isinstance(node, dict):
                raise KeyError(f"port key {key} lands under the JAX leaf "
                               f"{'/'.join(path)}")
        if path[-1] in node:
            raise KeyError(f"port key {key} lands on the JAX leaf "
                           f"{coll}/{'/'.join(path)} a second time")
        node[path[-1]] = np.ascontiguousarray(arr)
    if not tree["batch_stats"]:
        tree.pop("batch_stats")
    return tree
