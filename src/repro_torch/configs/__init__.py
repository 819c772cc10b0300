"""Assigned-architecture registry: ``--arch <id>`` -> ModelConfig (port of
``repro/configs``: the same shapes, copied by value).

Each module defines ``CONFIG`` (the exact published configuration) and
``smoke_config()`` (a reduced same-family config for CPU smoke tests).
"""
from __future__ import annotations

import importlib

ARCHS = [
    "qwen2-7b",
    "qwen1.5-32b",
    "olmo-1b",
    "qwen2.5-3b",
    "qwen3-moe-235b-a22b",
    "qwen3-moe-30b-a3b",
    "recurrentgemma-9b",
    "pixtral-12b",
    "rwkv6-1.6b",
    "whisper-medium",
]


def _mod(arch: str):
    return importlib.import_module(f"repro_torch.configs.{arch.replace('-', '_').replace('.', '_')}")


def get_config(arch: str):
    return _mod(arch).CONFIG


def get_smoke_config(arch: str):
    return _mod(arch).smoke_config()
