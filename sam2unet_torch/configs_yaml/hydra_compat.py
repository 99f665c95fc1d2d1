"""Hydra compatibility: `_target_` instantiation and dotlist overrides, the
port's copy of the JAX package's `configs/hydra_compat.py`.

The reference builds its model tree with `hydra.compose(config, overrides)`
and `hydra.utils.instantiate` (sam2/build_sam.py:24-44), and callers
customise it with `++key.path=value` override strings. The port's own
configuration is the dataclass registry (`configs.py`, `SAM2Config`); this
module takes a reference-shaped YAML tree and an override list to those
dataclasses without a hydra dependency (PyYAML only):

- `parse_dotlist(["++a.b=3", "c=[1,2]"])` -> nested dict (values YAML-parsed)
- `merge_overrides(cfg, overrides)` -> cfg deep-merged with a dotlist
- `instantiate(node)` -> recursively import and call `_target_` nodes
  (`_partial_: true` returns a functools.partial, as in hydra)
- `compose(yaml_path, overrides)` -> dict from file + dotlist merge
- `configs_from_tree(cfg)` -> (HieraConfig, SAM2Config) from a FULL
  reference config tree (sam2_configs/*.yaml shape). `_target_` nodes
  inside the model tree are ignored: the module architecture is fixed in
  code, and only the hyperparameters are read.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
from typing import Any

import yaml


def _locate(path: str) -> Any:
    """Import `pkg.mod.Attr` like hydra: try the longest module prefix
    first (including the full path — the target may itself be a submodule
    not re-exported by its parent), resolving the rest via getattr."""
    parts = path.split(".")
    for split in range(len(parts), 0, -1):
        mod_name = ".".join(parts[:split])
        try:
            obj = importlib.import_module(mod_name)
        except ModuleNotFoundError:
            continue
        try:
            for attr in parts[split:]:
                obj = getattr(obj, attr)
        except AttributeError:
            continue  # a shorter prefix may still import the missing attr
        return obj
    raise ImportError(f"cannot locate _target_ '{path}'")


def instantiate(node: Any, _recursive_: bool = True, **kwargs: Any) -> Any:
    """Hydra-style recursive instantiation of a plain dict/list tree."""
    if isinstance(node, (list, tuple)):
        out = [instantiate(v, _recursive_) for v in node]
        return type(node)(out) if isinstance(node, tuple) else out
    if not isinstance(node, dict):
        return node
    # a node-level `_recursive_` key overrides the inherited flag (hydra
    # semantics: `_recursive_: false` in the config stops eager child
    # instantiation for this subtree — children pass through as raw dicts)
    rec = bool(node.get("_recursive_", _recursive_))
    children = {
        k: (instantiate(v, rec) if rec else v)
        for k, v in node.items()
        if not k.startswith("_")
    }
    children.update(kwargs)
    target = node.get("_target_")
    if target is None:
        return children
    fn = _locate(target)
    if node.get("_partial_"):
        return functools.partial(fn, **children)
    return fn(**children)


def _parse_value(text: str) -> Any:
    try:
        return yaml.safe_load(text)
    except yaml.YAMLError:
        return text


def parse_dotlist(overrides: list[str]) -> dict:
    """`["++a.b=1", "+c=x", "d.e=[1,2]"]` -> nested dict. The +/++ prefixes
    (hydra's add / force-add) carry no extra meaning here: a dotlist merge
    always creates missing nodes and overwrites existing ones."""
    tree: dict = {}
    for item in overrides:
        key, sep, value = item.partition("=")
        if not sep:
            raise ValueError(f"override '{item}' is not KEY=VALUE")
        key = key.lstrip("+").strip()
        node = tree
        *parents, leaf = key.split(".")
        for p in parents:
            node = node.setdefault(p, {})
            if not isinstance(node, dict):
                raise ValueError(f"override '{item}' descends into non-dict")
        node[leaf] = _parse_value(value.strip())
    return tree


def merge_overrides(cfg: dict, overrides: list[str] | dict) -> dict:
    """Deep-merge a dotlist (or an already-nested dict) into cfg, returning
    a new tree (inputs are not mutated)."""
    patch = parse_dotlist(overrides) if isinstance(overrides, list) else overrides

    def deep(a: dict, b: dict) -> dict:
        out = dict(a)
        for k, v in b.items():
            if isinstance(v, dict) and isinstance(out.get(k), dict):
                out[k] = deep(out[k], v)
            else:
                out[k] = v
        return out

    return deep(cfg, patch)


def compose(yaml_path: str, overrides: list[str] | None = None) -> dict:
    """Load a YAML file and apply a hydra-style dotlist on top."""
    with open(yaml_path) as f:
        cfg = yaml.safe_load(f) or {}
    return merge_overrides(cfg, overrides or [])


def configs_from_tree(cfg: dict):
    """Extract (HieraConfig, SAM2Config) from a reference-shaped config tree
    (`model:` with nested `image_encoder.trunk` plus flat model-level keys —
    sam2_configs/sam2_hiera_s.yaml). Keys whose names match the dataclass
    fields are adopted; `_target_` nodes and unknown keys are ignored."""
    from sam2unet_torch.configs import HieraConfig
    from sam2unet_torch.models.sam2_base import SAM2Config

    model = cfg.get("model", cfg)

    def pick(node: dict, cls) -> dict:
        fields = {f.name for f in dataclasses.fields(cls)}
        out = {}
        for k, v in node.items():
            if k in fields and not isinstance(v, dict):
                out[k] = tuple(v) if isinstance(v, list) else v
        return out

    trunk_node = model.get("image_encoder", {}).get("trunk", {})
    trunk = HieraConfig(**pick(trunk_node, HieraConfig))
    sam_kwargs = pick(model, SAM2Config)
    sam_kwargs.update(pick(model.get("sam_mask_decoder_extra_args") or {},
                           SAM2Config))
    return trunk, SAM2Config(**sam_kwargs)
