"""Architecture registry: ``get_config(arch_id)`` / ``all_arch_ids()``.

The ten assigned architectures plus the paper's own workload (rig_gm).
"""

from __future__ import annotations

import importlib
from typing import Dict, List

_MODULES: Dict[str, str] = {
    # LM family
    "yi-34b": ".yi_34b",
    "qwen1.5-4b": ".qwen1_5_4b",
    "qwen2-7b": ".qwen2_7b",
    "grok-1-314b": ".grok_1_314b",
    "deepseek-moe-16b": ".deepseek_moe_16b",
    # GNN family
    "gin-tu": ".gin_tu",
    "graphcast": ".graphcast",
    "schnet": ".schnet",
    "graphsage-reddit": ".graphsage_reddit",
    # recsys
    "din": ".din",
    # the paper's workload
    "rig_gm": ".pattern",
}


def all_arch_ids(include_pattern: bool = True) -> List[str]:
    ids = list(_MODULES)
    if not include_pattern:
        ids.remove("rig_gm")
    return ids


ASSIGNED = all_arch_ids(include_pattern=False)


def get_config(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {list(_MODULES)}")
    mod = importlib.import_module(_MODULES[arch_id], __package__)
    if arch_id == "rig_gm":
        return mod.PatternArch()
    return mod.CONFIG
