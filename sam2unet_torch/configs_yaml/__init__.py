"""The reference's YAML configs and their Hydra-style composition, the
port's copies of the JAX package's `configs/yaml/*.yaml` and
`configs/hydra_compat.py`: `YAML_DIR` holds sam2_hiera_{t,s,b+,l}.yaml."""

from pathlib import Path

YAML_DIR = Path(__file__).resolve().parent
