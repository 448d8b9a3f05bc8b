"""CLI flag parsing (the port's own copy of stratum_tpu/utils/flags.py).

Analog of the reference's Instance option multimap
(src/Core/Instance.cpp:57-70 parses ``--key=value`` / ``-key:value`` / bare
flags into an ``unordered_multimap``, queried via ``find_argument(s)``,
Core/Instance.hpp:43-51). Same grammar, same multi-value semantics, plus the
renderer's named feature flags with ``~``/``!`` negation
(Node/BDPT.cpp:97-127).
"""

from __future__ import annotations

from typing import Iterable, Optional


class Options:
    """Parsed argument multimap."""

    def __init__(self, args: Iterable[str]):
        self._items: list[tuple[str, str]] = []
        self.positional: list[str] = []
        for a in args:
            if a.startswith("--") or a.startswith("-"):
                body = a.lstrip("-")
                for sep in ("=", ":"):
                    if sep in body:
                        k, v = body.split(sep, 1)
                        self._items.append((k, v))
                        break
                else:
                    self._items.append((body, ""))
            else:
                self.positional.append(a)

    def find(self, key: str, default: Optional[str] = None) -> Optional[str]:
        """Last value for key (Instance::find_argument)."""
        vals = self.find_all(key)
        return vals[-1] if vals else default

    def find_all(self, key: str) -> list[str]:
        """All values for key (Instance::find_arguments)."""
        return [v for k, v in self._items if k == key]

    def has(self, key: str) -> bool:
        return any(k == key for k, _ in self._items)

    def get_float(self, key: str, default: float) -> float:
        v = self.find(key)
        return float(v) if v not in (None, "") else default

    def get_int(self, key: str, default: int) -> int:
        v = self.find(key)
        return int(v) if v not in (None, "") else default

    def get_str(self, key: str, default: str = "") -> str:
        v = self.find(key)
        return v if v not in (None, "") else default

    def get_bool(self, key: str, default: bool = False) -> bool:
        if not self.has(key):
            return default
        v = self.find(key)
        return v.lower() not in ("0", "false", "no", "off") if v else True

    def feature_flags(self, key: str, defaults: dict) -> dict:
        """Named feature flags with negation: ``--flag=Name`` enables,
        ``--flag=~Name`` or ``--flag=!Name`` disables (BDPT.cpp:97-127)."""
        out = dict(defaults)
        for v in self.find_all(key):
            neg = v.startswith("~") or v.startswith("!")
            name = v.lstrip("~!")
            if name not in out:
                raise KeyError(
                    f"unknown {key} flag {name!r}; known: {sorted(out)}"
                )
            out[name] = not neg
        return out
