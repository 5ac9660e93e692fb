"""Declarative dataclass configs with JSON, flat-dict and sha256 codecs,
and iteration-keyed schedules.

A copy of the ``Config`` base and ``Schedule`` of the JAX package's
``utils/config.py`` (reference: nqs/nqs/infrastructure/nested_data.py:9-172):
a schedule is sorted ``(start_iter, value)`` tuples resolved by binary search.
"""

from __future__ import annotations

import bisect
import dataclasses
import hashlib
import json
from typing import Any, Sequence, Tuple


def _to_jsonable(value):
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return {
            f.name: _to_jsonable(getattr(value, f.name))
            for f in dataclasses.fields(value)
            if not f.metadata.get("non_jsonable", False)
        }
    if isinstance(value, dict):
        return {str(k): _to_jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_to_jsonable(v) for v in value]
    if hasattr(value, "item") and getattr(value, "ndim", None) == 0:
        return value.item()
    if hasattr(value, "tolist"):
        return value.tolist()
    return value


def flatten_dict(d: dict, prefix: str = "") -> dict:
    """Flatten a nested dict into dot-separated keys."""
    out = {}
    for k, v in d.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_dict(v, key))
        else:
            out[key] = v
    return out


@dataclasses.dataclass
class Config:
    """Base class for declarative configs (subclass as a @dataclass)."""

    def to_dict(self) -> dict:
        return _to_jsonable(self)

    def to_flat_dict(self) -> dict:
        return flatten_dict(self.to_dict())

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True,
                          default=str)

    def to_sha256_str(self) -> str:
        payload = json.dumps(self.to_dict(), sort_keys=True, default=str)
        return hashlib.sha256(payload.encode()).hexdigest()

    def to_path_suffix(self) -> str:
        """'key=value' of each flat key, sorted, joined by '/'."""
        return "/".join(f"{key}={value}" for key, value in
                        sorted(self.to_flat_dict().items()))

    def replace(self, **kwargs):
        return dataclasses.replace(self, **kwargs)


class Schedule:
    """Sorted ``(start_iter, value)`` tuples resolved by binary search
    (reference: nqs/nqs/infrastructure/nested_data.py:133-172;
    nqs/nqs/applications/quantum_chemistry/experiments/__init__.py:1-11)."""

    def __init__(self, entries: Sequence[Tuple[int, Any]]):
        entries = sorted(entries, key=lambda e: e[0])
        if not entries or entries[0][0] != 0:
            raise ValueError("Schedule must start at iteration 0")
        self.starts = [e[0] for e in entries]
        self.values = [e[1] for e in entries]

    def __len__(self):
        return len(self.starts)

    def __iter__(self):
        return iter(zip(self.starts, self.values))

    def at(self, iter_idx: int):
        pos = bisect.bisect_right(self.starts, iter_idx) - 1
        return self.values[pos]

    def to_dict(self):
        return {
            str(s): _to_jsonable(v) for s, v in zip(self.starts, self.values)
        }


def schedule_lookup(schedule, iter_idx: int):
    """Resolve a Schedule (or a bare value) at ``iter_idx``."""
    if isinstance(schedule, Schedule):
        return schedule.at(iter_idx)
    return schedule
