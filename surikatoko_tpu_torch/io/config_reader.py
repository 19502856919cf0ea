"""JSON config reader with typed access, unused-parameter tracking, and
dev-override files.

A copy of ``surikatoko_tpu/io/config_reader.py`` (json and os only).

Equivalent of reference config-reader.{h,cpp}: typed ``get_value`` with
int->float/bool coercion, sequence access, keys starting with ``//`` treated
as comments, ``<name>-DEV.json`` override merged on top
(demo-davison-mono-slam.cpp:1161), and ``unused_params()`` listing keys never
read (reference ``GetUnusedParams``, used for config-typo warnings).
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional, Sequence


class ConfigReader:
    def __init__(self, path: str | os.PathLike | None = None,
                 data: dict | None = None, enable_dev_override: bool = True):
        self._data: dict[str, Any] = {}
        self._read_counts: dict[str, int] = {}
        self.err: Optional[str] = None
        if path is not None:
            self._load_file(path)
            if enable_dev_override:
                base, ext = os.path.splitext(str(path))
                dev = base + "-DEV" + ext
                if os.path.exists(dev):
                    self._load_file(dev)
        if data:
            self._data.update(data)
        self._read_counts = {k: 0 for k in self._data}

    def _load_file(self, path) -> None:
        with open(path) as f:
            loaded = json.load(f)
        for k, v in loaded.items():
            if k.startswith("//"):      # comment key
                continue
            self._data[k] = v

    def has_key(self, name: str) -> bool:
        return name in self._data

    def get_value(self, name: str, typ: type, default=None):
        """Typed access with int->float/bool coercion (reference :42-81)."""
        if name not in self._data:
            return default
        self._read_counts[name] += 1
        v = self._data[name]
        if typ is float and isinstance(v, (int, float)):
            return float(v)
        if typ is bool:
            if isinstance(v, bool):
                return v
            if isinstance(v, int) and v in (0, 1):
                return bool(v)
            raise TypeError(f"config key {name}: can't coerce {v!r} to bool")
        if typ is int:
            if isinstance(v, bool):
                raise TypeError(f"config key {name}: bool is not int")
            if isinstance(v, int):
                return v
            if isinstance(v, float) and v.is_integer():
                return int(v)
            raise TypeError(f"config key {name}: can't coerce {v!r} to int")
        if not isinstance(v, typ):
            raise TypeError(f"config key {name}: expected {typ}, got {type(v)}")
        return v

    def get_seq(self, name: str, typ: type = float, default=None) -> Optional[Sequence]:
        if name not in self._data:
            return default
        self._read_counts[name] += 1
        v = self._data[name]
        if not isinstance(v, list):
            raise TypeError(f"config key {name}: expected list, got {type(v)}")
        return [typ(x) for x in v]

    def unused_params(self) -> list[str]:
        return [k for k, c in self._read_counts.items() if c == 0]
