"""Name -> factory registries.

Counterpart of `tpupose/utils/registry.py`: explicit registries in place of
the reference's `eval('...' + cfg_string)` dispatch
(`src/testmodel.py:107`, `src/evalmodel.py:385`,
`src/tracking/IterativeTracker.py:175`). Names are case-insensitive;
`tpupose_torch.pipeline.registry_defs` fills them.
"""
from __future__ import annotations


class Registry:
    def __init__(self, kind: str):
        self.kind = kind
        self._items = {}

    def register(self, name: str):
        def deco(fn):
            key = name.lower()
            if key in self._items:
                raise KeyError(f"{self.kind} '{name}' already registered")
            self._items[key] = fn
            return fn

        return deco

    def get(self, name: str):
        key = str(name).lower()
        if key not in self._items:
            raise KeyError(
                f"unknown {self.kind} '{name}'; available: {sorted(self._items)}"
            )
        return self._items[key]

    def names(self):
        return sorted(self._items)


DETECTORS = Registry("detector")
POSE_MODELS = Registry("pose model")
MATCHERS = Registry("person matcher")
TEST_FUNCTIONS = Registry("test function")
INIT_METHODS = Registry("init method")
BUILD_3D_KERNELS = Registry("build-3d kernel")
