"""Config loading with reference-schema parity.

Copy of ``lightning_generative_models_tpu/config.py`` (the port imports nothing from
the JAX package). Accepts ``{"model": {"name", "args"}, "dataset": {...}}`` and checks
that ``img_size`` / ``img_channels`` agree between the model args and the dataset.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict


class ConfigError(ValueError):
    """Raised when a config file fails validation."""


def load_config(config_path: str | Path) -> Dict[str, Any]:
    """Parse a JSON experiment config and validate cross-section consistency:
    when both the model args and the dataset section declare ``img_size`` /
    ``img_channels``, the two must agree.
    """
    path = Path(config_path)
    if not path.exists():
        raise ConfigError(f"Config file not found: {path}")
    with open(path) as f:
        try:
            config = json.load(f)
        except json.JSONDecodeError as e:
            raise ConfigError(f"Invalid JSON in {path}: {e}") from e

    for key in ("model", "dataset"):
        if key not in config:
            raise ConfigError(f"Config {path} missing required key '{key}'")
    model = config["model"]
    if "name" not in model:
        raise ConfigError(f"Config {path}: model section missing 'name'")
    model.setdefault("args", {})

    margs = model["args"]
    dset = config["dataset"]
    for field in ("img_size", "img_channels"):
        if field in margs and field in dset and margs[field] != dset[field]:
            raise ConfigError(
                f"Config {path}: model args {field}={margs[field]} does not "
                f"match dataset {field}={dset[field]}"
            )
    return config
