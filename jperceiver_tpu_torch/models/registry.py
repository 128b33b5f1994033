"""Name -> model-class registry (counterpart of
`jperceiver_tpu/models/registry.py`): a config's `model.name` selects the
class, which builds itself from the whole model config."""

from __future__ import annotations

MODELS: dict[str, type] = {}


def register(cls=None, *, name: str | None = None):
    def wrap(c):
        key = name or c.__name__
        if key in MODELS:
            raise KeyError(f"{key} already registered")
        MODELS[key] = c
        return c

    return wrap(cls) if cls is not None else wrap


def build_model(cfg):
    """The registered model named by `cfg.name`, from `from_config(cfg)`."""
    name = cfg.name if hasattr(cfg, "name") else cfg["name"]
    if name not in MODELS:
        raise KeyError(f"unknown model '{name}'; have {sorted(MODELS)}")
    return MODELS[name].from_config(cfg)
