"""rwkv6-3b [ssm] — RWKV-6 "Finch", attention-free, data-dependent decay.

32L d_model=2560 d_ff=8960 vocab=65536  [arXiv:2404.05892; hf]
rwkv head_dim=64 -> 40 heads. Dynamic context = recurrent state, O(1) per
request.
"""
from repro_torch.configs.base import SSM, ModelConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    name="rwkv6-3b",
    family=SSM,
    n_layers=32,
    d_model=2560,
    n_heads=40,                   # rwkv heads = d_model / rwkv_head_dim
    n_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab_size=65536,
    activation="relu_sq",         # rwkv channel-mix uses squared relu
    ssm=SSMConfig(rwkv_head_dim=64, rwkv_lora_decay=64, rwkv_lora_mix=32),
    max_seq_len=1 << 20,          # unbounded context (recurrent)
))
