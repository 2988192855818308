"""Architecture configs ported so far: ``FULL`` (published) and ``SMOKE``
(reduced, for CPU tests) per arch."""
import importlib

from ..models.config import ModelConfig

ALIASES = {"qwen2-0.5b": "qwen2_0_5b"}


def get(arch: str, smoke: bool = False) -> ModelConfig:
    mod = importlib.import_module(
        f"{__name__}.{ALIASES.get(arch, arch).replace('-', '_')}")
    return mod.SMOKE if smoke else mod.FULL
