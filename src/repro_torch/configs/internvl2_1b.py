"""internvl2-1b [vlm] — InternViT frontend (stub) + a dense backbone.
[arXiv:2404.16821; hf]

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655. The ViT frontend
is a stub: a request carries precomputed patch embeddings, n_prefix_embeds
positions of d_model, that take the place of the token embedding at the
prompt's first positions.
"""
from repro_torch.configs.base import VLM, ModelConfig, register

CONFIG = register(ModelConfig(
    name="internvl2-1b",
    family=VLM,
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151655,
    activation="swiglu",
    rope_theta=1e6,
    tie_embeddings=True,
    n_prefix_embeds=256,          # 16x16 ViT patch tokens from the stub frontend
    max_seq_len=32768,
))
