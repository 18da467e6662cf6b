"""Architecture registry: ``get_config("<arch-id>")`` / ``--arch <id>``.

Only the architectures whose layer kinds the port covers are listed.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig

_MODULES = {
    "gemma2-27b": "gemma2_27b",
}


def get_config(arch: str) -> ArchConfig:
    arch = arch.replace("_", "-")
    if arch.endswith("-smoke"):
        return get_config(arch[: -len("-smoke")]).smoke()
    if arch not in _MODULES:
        raise KeyError(f"unknown or unported arch {arch!r}; "
                       f"known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG
