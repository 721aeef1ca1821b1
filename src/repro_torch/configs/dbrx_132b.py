"""dbrx-132b [moe] — 16 experts top-4, fine-grained, no shared expert.
[hf:databricks/dbrx-base]

40L d_model=6144 48H (GQA kv=8) of 128 d_ff=10752 vocab=100352. The
reference's router (softmax, top-4, gates renormalised) and no
``clip_qkv``.
"""
from repro_torch.configs.base import MOE, ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="dbrx-132b",
    family=MOE,
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    activation="swiglu",
    moe=MoEConfig(n_experts=16, top_k=4, n_shared_experts=0,
                  d_ff_expert=10752, capacity_factor=1.25),
    rope_theta=5e5,
    max_seq_len=32768,
))
