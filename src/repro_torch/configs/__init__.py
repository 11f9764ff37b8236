"""Architecture configs of the port.

``get_config(name)`` accepts the same ids as ``repro.configs``: the 10
assigned architectures and the paper's own serving model.
"""
from __future__ import annotations

import importlib

_MODULES = {
    "gemma2-9b": "gemma2_9b",
    "deepseek-7b": "deepseek_7b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "gemma2-2b": "gemma2_2b",
    "xlstm-350m": "xlstm_350m",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "internvl2-2b": "internvl2_2b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "whisper-small": "whisper_small",
    "qwen3-8b": "qwen3_8b",          # the paper's serving model
}


def get_config(name: str):
    mod = _MODULES.get(name)
    if mod is None:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{mod}").CONFIG


#: the 10 assigned architectures (not the paper's serving model)
ASSIGNED = tuple(n for n in _MODULES if n != "qwen3-8b")
