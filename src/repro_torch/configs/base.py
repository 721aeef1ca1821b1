"""Architecture configuration for the PyTorch port.

The fields of ``repro/configs/base.py``'s :class:`ModelConfig` that the
dense and RWKV-6 families read (the sub-configs of the MoE, MLA, hybrid and
encoder-decoder families come with their slices), with
:meth:`ModelConfig.dtype` returning a torch dtype. Only the architectures
the port serves register here.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

DENSE = "dense"          # decoder-only transformer (GQA/MQA)
SSM = "ssm"              # RWKV-6 (attention-free)


@dataclass(frozen=True)
class SSMConfig:
    """RWKV-6 knobs (the reference's Mamba fields come with the hybrid
    slice)."""
    rwkv_head_dim: int = 64
    rwkv_lora_decay: int = 64         # rank of the data-dependent decay LoRA
    rwkv_lora_mix: int = 32           # rank of the token-shift interpolation LoRA


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 = d_model // n_heads
    activation: str = "swiglu"        # swiglu | geglu | gelu | relu_sq
    qkv_bias: bool = False
    tie_embeddings: bool = False
    use_qk_norm: bool = False
    rope_theta: float = 10000.0
    rmsnorm_eps: float = 1e-6
    embed_scale: bool = False
    logit_softcap: float = 0.0
    attn_logit_softcap: float = 0.0
    sliding_window: int = 0
    global_layer_every: int = 0
    ssm: Optional[SSMConfig] = None
    n_prefix_embeds: int = 0
    max_seq_len: int = 8192
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def param_count(self) -> int:
        """Analytic parameter count of a dense or RWKV-6 stack (the
        reference's formula)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        nh, nkv, L = self.n_heads, self.n_kv_heads, self.n_layers
        if self.family == SSM:
            s = self.ssm or SSMConfig()
            # time-mix: r,k,v,g,w projections + output + decay/mix LoRAs;
            # channel mix
            per_layer = (5 * d * d + d * d + 2 * d * s.rwkv_lora_decay
                         + 5 * 2 * d * s.rwkv_lora_mix
                         + 2 * d * f + f * d)
        else:
            glu = 3 if self.activation in ("swiglu", "geglu") else 2
            per_layer = (d * (nh * hd) + 2 * d * (nkv * hd) + (nh * hd) * d
                         + glu * d * f + 2 * d)
        return v * d * (1 if self.tie_embeddings else 2) + L * per_layer

    def dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def torch_compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
_REGISTRY = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        from repro_torch import configs as _c  # noqa
        _c.load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU tests — the reference's
    ``smoke_config`` for the families the port serves."""
    if cfg.family not in (DENSE, SSM):
        raise NotImplementedError(f"{cfg.name}: only dense and RWKV-6 "
                                  "smoke configs are ported")
    kw = dict(
        n_layers=min(cfg.n_layers, 4), d_model=128, n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads
        else 4,
        head_dim=32, d_ff=256, vocab_size=512, max_seq_len=128,
        param_dtype="float32", compute_dtype="float32")
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(cfg.ssm, rwkv_head_dim=32,
                                        rwkv_lora_decay=16, rwkv_lora_mix=8)
    return cfg.replace(**kw)
