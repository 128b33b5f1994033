"""Configs: `Config` / `ConfigDict`, the preset families and the preset
files under `presets/` (the port's own copies)."""

from .config import Config, ConfigDict
from .families import build_family, family_axes, list_families

__all__ = ["Config", "ConfigDict", "build_family", "family_axes", "list_families"]
