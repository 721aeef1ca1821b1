"""deepseek-v2-lite-16b [moe] — MLA kv_lora=512, 64 routed top-6 + 2 shared.

27L d_model=2048 16H d_ff(expert)=1408 vocab=102400  [arXiv:2405.04434; hf]
The published V2-Lite: 64 routed experts + 2 shared, top-6, MLA with a
rank-512 latent and a 64-dim shared RoPE key — 576 elements per token and
layer on the ``mla`` page plane.
"""
from repro_torch.configs.base import (MOE, MLAConfig, ModelConfig, MoEConfig,
                                      register)

CONFIG = register(ModelConfig(
    name="deepseek-v2-lite-16b",
    family=MOE,
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    activation="swiglu",
    moe=MoEConfig(n_experts=64, top_k=6, n_shared_experts=2,
                  d_ff_expert=1408, capacity_factor=1.25),
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    max_seq_len=32768,
))
