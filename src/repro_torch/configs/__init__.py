"""Architecture configs of the port.

``get_config(name)`` accepts the same ids as ``repro.configs``; the port
holds the architectures its model stack runs so far (the dense
attention family).
"""
from __future__ import annotations

import importlib

_MODULES = {
    "qwen3-8b": "qwen3_8b",          # the paper's serving model
}


def get_config(name: str):
    mod = _MODULES.get(name)
    if mod is None:
        raise KeyError(f"unknown arch {name!r}; the port has "
                       f"{sorted(_MODULES)} (other families: ROADMAP "
                       "queue A, 'other model families')")
    return importlib.import_module(f"repro_torch.configs.{mod}").CONFIG
