"""Declarative dataclass configs with a JSON codec.

A copy of the ``Config`` base of the JAX package's ``utils/config.py``
(reference: nqs/nqs/infrastructure/nested_data.py:9-172).
"""

from __future__ import annotations

import dataclasses
import json


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


@dataclasses.dataclass
class Config:
    """Base class for declarative configs (subclass as a @dataclass)."""

    def to_dict(self) -> dict:
        return _to_jsonable(self)

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True,
                          default=str)

    def replace(self, **kwargs):
        return dataclasses.replace(self, **kwargs)
