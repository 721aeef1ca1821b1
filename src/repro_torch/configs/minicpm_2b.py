"""minicpm-2b [dense] — llama-like.  [arXiv:2404.06395; hf]

40L d_model=2304 36H (kv=36) d_ff=5760 vocab=122753.
"""
from repro_torch.configs.base import DENSE, ModelConfig, register

CONFIG = register(ModelConfig(
    name="minicpm-2b",
    family=DENSE,
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    head_dim=64,
    d_ff=5760,
    vocab_size=122753,
    activation="swiglu",
    tie_embeddings=True,
    max_seq_len=32768,
))
