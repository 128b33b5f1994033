"""Python-file configs (the port's own copy of
`jperceiver_tpu/config/config.py`, an mmcv-`Config` workalike): a config
file is a plain Python module; its globals become attributes; nested dicts
get recursive attribute access.
"""

from __future__ import annotations

import copy
import importlib.util
import json
import os
from typing import Any, Iterator, Mapping


class ConfigDict(dict):
    """dict with attribute access, recursively."""

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def get(self, key, default=None):
        return super().get(key, default)

    @classmethod
    def convert(cls, obj: Any) -> Any:
        if isinstance(obj, Mapping):
            return cls({k: cls.convert(v) for k, v in obj.items()})
        if isinstance(obj, (list, tuple)):
            return type(obj)(cls.convert(v) for v in obj)
        return obj


class Config:
    """Top-level config namespace."""

    def __init__(self, data: Mapping[str, Any], filename: str | None = None):
        object.__setattr__(self, "_data", ConfigDict.convert(dict(data)))
        object.__setattr__(self, "filename", filename)

    # -- loading ---------------------------------------------------------
    @staticmethod
    def fromfile(path: str) -> "Config":
        path = os.path.abspath(path)
        spec = importlib.util.spec_from_file_location("_jp_cfg", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        data = {
            k: v
            for k, v in vars(mod).items()
            if not k.startswith("__") and not callable(v) and not isinstance(v, type(os))
        }
        return Config(data, filename=path)

    @staticmethod
    def fromdict(data: Mapping[str, Any]) -> "Config":
        return Config(data)

    # -- access ----------------------------------------------------------
    def __getattr__(self, key: str) -> Any:
        try:
            return self._data[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key: str, value: Any) -> None:
        self._data[key] = ConfigDict.convert(value)

    def __getitem__(self, key: str) -> Any:
        return self._data[key]

    def __setitem__(self, key: str, value: Any) -> None:
        self._data[key] = ConfigDict.convert(value)

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def get(self, key, default=None):
        return self._data.get(key, default)

    def keys(self):
        return self._data.keys()

    def to_dict(self) -> dict:
        return copy.deepcopy(dict(self._data))

    def dump(self) -> str:
        return json.dumps(self._data, indent=2, default=repr)

    def merge_from_dict(self, overrides: Mapping[str, Any]) -> None:
        """Dotted-key overrides, e.g. {'model.height': 512}."""
        for dotted, value in overrides.items():
            parts = dotted.split(".")
            node = self._data
            for p in parts[:-1]:
                node = node.setdefault(p, ConfigDict())
            node[parts[-1]] = ConfigDict.convert(value)
