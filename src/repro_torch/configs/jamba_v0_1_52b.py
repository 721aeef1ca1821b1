"""jamba-v0.1-52b [hybrid] — Mamba+attn 1:7 interleave, MoE 16e top-2 every 2nd layer.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536  [arXiv:2403.19887; hf]
Jamba v0.1. Period-8 blocks: layer index 4 within each period is attention,
the others Mamba (d_state 16, d_conv 4, expand 2, dt_rank d_model/16 = 256);
the MoE is the feed-forward of every second layer.
"""
from repro_torch.configs.base import (HYBRID, HybridConfig, ModelConfig,
                                      MoEConfig, SSMConfig, register)

CONFIG = register(ModelConfig(
    name="jamba-v0.1-52b",
    family=HYBRID,
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    activation="swiglu",
    hybrid=HybridConfig(period=8, attn_index=4),
    moe=MoEConfig(n_experts=16, top_k=2, n_shared_experts=0,
                  d_ff_expert=14336, moe_every=2, capacity_factor=1.25),
    ssm=SSMConfig(mamba_d_state=16, mamba_d_conv=4, mamba_expand=2),
    max_seq_len=524288,
))
