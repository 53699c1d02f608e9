"""Architecture registry: exact assigned configs + reduced smoke variants
(port of the JAX package's ``repro.configs.registry``).

Every entry is selectable via ``--arch <id>`` in the launchers.  Shapes
(per-arch cells) live in ``repro_torch.launch.shapes``.  The ids are the
reference's, all of them; only ``wbpr-maxflow`` has a module in the port
so far.  The language-model configs come with the LM core (ROADMAP.md,
Queue 1 item 2): until then :func:`get_config` and
:func:`get_smoke_config` raise ``NotImplementedError`` for their ids,
and never hand back a stand-in.
"""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "qwen2-72b", "qwen1.5-4b", "qwen2.5-14b", "qwen3-4b", "whisper-tiny",
    "mixtral-8x7b", "grok-1-314b", "llama-3.2-vision-90b",
    "jamba-1.5-large-398b", "rwkv6-1.6b", "wbpr-maxflow",
]

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}

#: the ids whose config module the port has
PORTED = ("wbpr-maxflow",)


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; expected one of {ARCH_IDS}")
    if arch not in PORTED:
        raise NotImplementedError(
            f"the {arch!r} config is not ported to repro_torch yet: the "
            "language-model configs and models come with the LM core "
            "(ROADMAP.md, Queue 1 item 2)")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str):
    return _module(arch).CONFIG


def get_smoke_config(arch: str):
    return _module(arch).SMOKE


def all_arch_ids(include_graph: bool = False):
    ids = [a for a in ARCH_IDS if a != "wbpr-maxflow"]
    return ARCH_IDS if include_graph else ids
