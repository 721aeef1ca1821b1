"""Per-architecture configs the port builds (one module per arch)."""
import importlib

_ARCH_MODULES = ["qwen1_5_0_5b", "rwkv6_3b", "deepseek_v2_lite_16b",
                 "jamba_v0_1_52b", "internvl2_1b", "gemma_7b", "minicpm_2b",
                 "dbrx_132b", "aqua_paper", "gemma3_12b", "whisper_tiny"]


def load_all():
    for m in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")


from repro_torch.configs.base import (  # noqa: E402,F401
    ALL_SHAPES, DECODE_32K, DENSE, ENCDEC, HYBRID, LONG_500K,
    LONG_CONTEXT_OK, MOE, PREFILL_32K, SHAPES_BY_NAME, SSM, TRAIN_4K, VLM,
    EncDecConfig, HybridConfig, MLAConfig, ModelConfig, MoEConfig,
    ShapeConfig, SSMConfig, get_config, list_archs, shape_applicable,
    smoke_config)
