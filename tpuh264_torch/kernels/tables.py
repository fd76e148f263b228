"""Constant tables as device tensors, built once per (table, device).

The tables themselves come from the port's copies of the reference's
constants as numpy (`golden/`, `entropy/cavlc_tables.py`); this module only
uploads them.  Indexing a cached tensor with a Python int is a view, so
per-QP rows cost no host-device transfer.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict

import numpy as np
import torch

_MAKERS: Dict[str, Callable[[], np.ndarray]] = {}


def register(name: str, make: Callable[[], np.ndarray]) -> None:
    _MAKERS[name] = make


@functools.lru_cache(maxsize=None)
def _cached(name: str, device: str) -> torch.Tensor:
    arr = np.ascontiguousarray(_MAKERS[name]())
    return torch.from_numpy(arr).to(device)


def get(name: str, device) -> torch.Tensor:
    """The registered table `name` on `device` (int tables stay int)."""
    return _cached(name, str(torch.device(device)))
