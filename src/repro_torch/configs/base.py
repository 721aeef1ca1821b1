"""Architecture configuration for the PyTorch port.

The fields of ``repro/configs/base.py``'s :class:`ModelConfig` that the
dense, MoE (with DeepSeek's MLA), VLM (a dense backbone behind a stub
patch-embedding frontend), RWKV-6 and hybrid (Jamba: Mamba and attention)
families read, and the encoder-decoder family's (whisper: an encoder
stack over stub frame embeddings, a decoder with cross-attention), with
:meth:`ModelConfig.dtype` returning a torch dtype. Only the architectures
the port builds register here.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

DENSE = "dense"          # decoder-only transformer (GQA/MQA)
MOE = "moe"              # decoder-only transformer with MoE FFN
SSM = "ssm"              # RWKV-6 (attention-free)
HYBRID = "hybrid"        # Jamba: Mamba + attention interleave, MoE
VLM = "vlm"              # LM backbone + stub patch-embedding frontend
ENCDEC = "encdec"        # encoder-decoder (whisper), stub audio frontend


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8                # routed experts
    top_k: int = 2
    n_shared_experts: int = 0         # always-on shared experts (DeepSeek style)
    d_ff_expert: int = 0              # per-expert FFN width (0 = use d_ff)
    capacity_factor: float = 1.25     # dispatch capacity factor
    router_jitter: float = 0.0
    moe_every: int = 1                # apply MoE every k-th layer (Jamba: 2)
    aux_loss_coef: float = 0.01


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 multi-head latent attention."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 0              # 0 = direct q projection (V2-Lite)
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """RWKV-6 / Mamba specific knobs."""
    # RWKV-6
    rwkv_head_dim: int = 64
    rwkv_lora_decay: int = 64         # rank of the data-dependent decay LoRA
    rwkv_lora_mix: int = 32           # rank of the token-shift interpolation LoRA
    # Mamba (Jamba)
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_dt_rank: int = 0            # 0 = d_model // 16


@dataclass(frozen=True)
class HybridConfig:
    """Jamba interleave: every `period` layers, `attn_index` is attention."""
    period: int = 8
    attn_index: int = 4


@dataclass(frozen=True)
class EncDecConfig:
    n_encoder_layers: int = 4
    encoder_seq_len: int = 1500      # whisper: 30 s of audio -> 1500 frames
    max_decoder_len: int = 448       # whisper's decoder context


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
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    encdec: Optional[EncDecConfig] = None
    n_prefix_embeds: int = 0
    max_seq_len: int = 8192
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def is_attention_layer(self, layer_idx: int) -> bool:
        if self.family == SSM:
            return False
        if self.family == HYBRID:
            return layer_idx % self.hybrid.period == self.hybrid.attn_index
        return True

    def is_global_attn_layer(self, layer_idx: int) -> bool:
        """gemma3-style 5 local : 1 global interleave."""
        if self.global_layer_every <= 0:
            return self.sliding_window == 0
        return (layer_idx + 1) % self.global_layer_every == 0

    def is_moe_layer(self, layer_idx: int) -> bool:
        if self.moe is None:
            return False
        return (layer_idx % self.moe.moe_every) == (self.moe.moe_every - 1)

    def param_count(self) -> int:
        """Analytic parameter count of a dense, MoE/MLA, RWKV-6, hybrid or
        encoder-decoder stack (the reference's formula)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        nh, nkv, L = self.n_heads, self.n_kv_heads, self.n_layers
        glu = 3 if self.activation in ("swiglu", "geglu") else 2
        total = v * d * (1 if self.tie_embeddings else 2)
        for i in range(L):
            if self.family == SSM:
                s = self.ssm or SSMConfig()
                # time-mix: r,k,v,g,w projections + output + decay/mix
                # LoRAs; channel mix
                total += (5 * d * d + d * d + 2 * d * s.rwkv_lora_decay
                          + 5 * 2 * d * s.rwkv_lora_mix
                          + 2 * d * f + f * d)
                continue
            if self.family == HYBRID and not self.is_attention_layer(i):
                total += self._mamba_layer_params()
            elif self.mla is not None:
                total += self._mla_layer_params()
            else:
                total += d * (nh * hd) + 2 * d * (nkv * hd) + (nh * hd) * d
            if self.is_moe_layer(i):
                m = self.moe
                fe = m.d_ff_expert or f
                total += d * m.n_experts                       # router
                total += (m.n_experts + m.n_shared_experts) * glu * d * fe
            else:
                total += glu * d * f
            total += 2 * d                                     # norms
        if self.family == ENCDEC and self.encdec is not None:
            # the encoder stack (the formula counts three d x d_ff
            # matrices an MLP, gelu or not) and each decoder layer's
            # cross-attention and its norm
            total += self.encdec.n_encoder_layers * (
                4 * d * (nh * hd) + 3 * d * f + 2 * d)
            total += L * (4 * d * (nh * hd) + d)
        return total

    def _mamba_layer_params(self) -> int:
        # in_proj, conv_w, x_proj, dt_proj, A_log, D, out_proj (the
        # formula leaves out conv_b and dt_bias)
        d, s = self.d_model, self.ssm or SSMConfig()
        di = s.mamba_expand * d
        dtr = s.mamba_dt_rank or d // 16
        return (d * 2 * di + di * s.mamba_d_conv
                + di * (dtr + 2 * s.mamba_d_state) + dtr * di
                + di * s.mamba_d_state + di + di * d)

    def _mla_layer_params(self) -> int:
        d, m, nh = self.d_model, self.mla, self.n_heads
        qd = m.qk_nope_head_dim + m.qk_rope_head_dim
        q = (d * nh * qd if m.q_lora_rank == 0
             else d * m.q_lora_rank + m.q_lora_rank * nh * qd)
        kv = d * (m.kv_lora_rank + m.qk_rope_head_dim)
        kv += m.kv_lora_rank * nh * (m.qk_nope_head_dim + m.v_head_dim)
        return q + kv + nh * m.v_head_dim * d

    def dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def torch_compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Input shapes (assigned) — the reference's production cells
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

ALL_SHAPES: Tuple[ShapeConfig, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K,
                                       LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}

# archs that may run long_500k (sub-quadratic decode; see DESIGN.md skip list)
LONG_CONTEXT_OK = ("rwkv6-3b", "jamba-v0.1-52b", "gemma3-12b")


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether a given (arch, shape) cell is runnable; else reason."""
    if shape.name == "long_500k" and cfg.name not in LONG_CONTEXT_OK:
        return False, "pure full-attention arch: 500k KV decode is quadratic-cost/OOM (DESIGN.md skip list)"
    return True, ""


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


def list_archs():
    from repro_torch import configs as _c
    _c.load_all()
    return sorted(_REGISTRY)


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU tests — the reference's
    ``smoke_config``."""
    kw = dict(
        n_layers=min(cfg.n_layers, 4), d_model=128, n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads
        else 4,
        head_dim=32, d_ff=256, vocab_size=512, max_seq_len=128,
        param_dtype="float32", compute_dtype="float32")
    if cfg.family == HYBRID:
        kw["n_layers"] = 8   # one full interleave period
    if cfg.global_layer_every:
        kw["n_layers"] = min(cfg.n_layers, 6)
        kw["sliding_window"] = 16
    if cfg.sliding_window and not cfg.global_layer_every:
        kw["sliding_window"] = 16
    if cfg.moe is not None:
        # capacity_factor = n_experts makes capacity routing dropless
        kw["moe"] = dataclasses.replace(
            cfg.moe, n_experts=4, top_k=2,
            n_shared_experts=min(cfg.moe.n_shared_experts, 1),
            d_ff_expert=128 if cfg.moe.d_ff_expert else 0,
            capacity_factor=4.0)
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(kv_lora_rank=64, q_lora_rank=0,
                              qk_nope_head_dim=32, qk_rope_head_dim=16,
                              v_head_dim=32)
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(
            cfg.ssm, rwkv_head_dim=32, rwkv_lora_decay=16, rwkv_lora_mix=8,
            mamba_d_state=8, mamba_dt_rank=8)
    if cfg.encdec is not None:
        kw["encdec"] = EncDecConfig(n_encoder_layers=2, encoder_seq_len=32,
                                    max_decoder_len=64)
    if cfg.n_prefix_embeds:
        kw["n_prefix_embeds"] = 8
    return cfg.replace(**kw)
