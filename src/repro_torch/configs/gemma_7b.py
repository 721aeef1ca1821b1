"""gemma-7b [dense] — GeGLU, head_dim=256, embeddings scaled by sqrt(d).
[arXiv:2403.08295; hf]

28L d_model=3072 16H (kv=16) of 256 d_ff=24576 vocab=256000. Its 16 heads
of 256 span 4,096, wider than d_model.
"""
from repro_torch.configs.base import DENSE, ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma-7b",
    family=DENSE,
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    activation="geglu",
    tie_embeddings=True,
    embed_scale=True,
    max_seq_len=32768,
))
