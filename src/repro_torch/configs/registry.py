"""Architecture registry: exact assigned configs + reduced smoke variants
(port of the JAX package's ``repro.configs.registry``).

Every entry is selectable via ``--arch <id>`` in the launchers.  Shapes
(per-arch cells) live in ``repro_torch.launch.shapes``.  The ids are the
reference's, all of them, and each has its module in the port: the ten
language-model configs (``repro_torch.configs.base.ModelConfig``) and
the max-flow workload.  A config is data; which of its families the
port's model can run is the model's business
(``repro_torch.models.transformer``).
"""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "qwen2-72b", "qwen1.5-4b", "qwen2.5-14b", "qwen3-4b", "whisper-tiny",
    "mixtral-8x7b", "grok-1-314b", "llama-3.2-vision-90b",
    "jamba-1.5-large-398b", "rwkv6-1.6b", "wbpr-maxflow",
]

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}

#: the ids whose config module the port has: every one
PORTED = tuple(ARCH_IDS)


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; expected one of {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str):
    return _module(arch).CONFIG


def get_smoke_config(arch: str):
    return _module(arch).SMOKE


def all_arch_ids(include_graph: bool = False):
    ids = [a for a in ARCH_IDS if a != "wbpr-maxflow"]
    return ARCH_IDS if include_graph else ids
