"""Per-architecture configs the port serves (one module per arch)."""
import importlib

_ARCH_MODULES = ["qwen1_5_0_5b", "rwkv6_3b"]


def load_all():
    for m in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")


from repro_torch.configs.base import (  # noqa: E402,F401
    DENSE, SSM, ModelConfig, SSMConfig, get_config, smoke_config)
