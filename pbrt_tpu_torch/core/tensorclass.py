"""Frozen tensor dataclasses: the port's stand-in for core/pytree.py.

A `tensorclass` is a frozen dataclass whose fields hold tensors (or nested
tensorclasses, or None). `.replace(**updates)` returns a copy with fields
swapped; `.to(device)` moves every tensor field, recursing into nested
tensorclasses. Fields declared with `static_field()` are plain Python
values (counts, flags, shapes) that `.to` leaves alone — the role JAX's
pytree aux data plays in the reference. Fields declared with `init=False`
are derived in `__post_init__` from the others, so `.replace` and `.to`
rebuild them and never set them. A `.to` that moves nothing returns the
same object.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


def static_field(**kwargs: Any) -> Any:
    """A dataclass field holding a plain Python value (not moved by .to)."""
    metadata = dict(kwargs.pop("metadata", {}) or {})
    metadata["static"] = True
    return dataclasses.field(metadata=metadata, **kwargs)


def _move(value, device):
    if isinstance(value, torch.Tensor):
        return value.to(device)
    if dataclasses.is_dataclass(value) and hasattr(value, "to"):
        return value.to(device)
    return value


def tensorclass(cls: type) -> type:
    """Decorator: frozen dataclass with `.replace` and `.to(device)`."""
    cls = dataclasses.dataclass(frozen=True)(cls)

    def replace(self, **updates: Any):
        return dataclasses.replace(self, **updates)

    def to(self, device):
        updates = {
            f.name: _move(getattr(self, f.name), device)
            for f in dataclasses.fields(self)
            if f.init and not f.metadata.get("static", False)
        }
        if all(v is getattr(self, k) for k, v in updates.items()):
            return self
        return dataclasses.replace(self, **updates)

    cls.replace = replace
    cls.to = to
    return cls
