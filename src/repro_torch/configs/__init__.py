"""Architecture registry: ``get_config(arch_id)`` / ``all_arch_ids()``.

The ten assigned architectures: five LMs, four GNNs and DIN.  The paper's
own workload (``rig_gm``) is not ported yet: asking for it raises a
``KeyError`` that names the slice of the port still to come.
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
}

_NOT_PORTED: Dict[str, str] = {"rig_gm": "the dry-run slice"}


def all_arch_ids() -> List[str]:
    return list(_MODULES)


def get_config(arch_id: str):
    if arch_id in _NOT_PORTED:
        raise KeyError(f"arch {arch_id!r} is not ported yet: it comes with "
                       f"{_NOT_PORTED[arch_id]} of the port; ported: "
                       f"{list(_MODULES)}")
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {list(_MODULES)}")
    return importlib.import_module(_MODULES[arch_id], __package__).CONFIG
