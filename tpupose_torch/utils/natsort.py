"""Natural-order sorting (natsort replacement for file lists).

Counterpart of `tpupose/utils/natsort.py`. The reference sorts per-camera
frame filenames with `natsort.natsorted` (`src/dataset.py:28`); this
provides the same digit-aware ordering.
"""
from __future__ import annotations

import re

_CHUNK = re.compile(r"(\d+)")


def natural_key(s: str):
    return [int(p) if p.isdigit() else p for p in _CHUNK.split(str(s))]


def natsorted(items):
    return sorted(items, key=natural_key)
