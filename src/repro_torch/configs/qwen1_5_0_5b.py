"""qwen1.5-0.5b [dense] — QKV bias.  [hf:Qwen/Qwen1.5-0.5B; hf]

24L d_model=1024 16H (GQA kv=16) d_ff=2816 vocab=151936
"""
from repro_torch.configs.base import DENSE, ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen1.5-0.5b",
    family=DENSE,
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=2816,
    vocab_size=151936,
    activation="swiglu",
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1e6,
    max_seq_len=32768,
))
