"""The paper's own evaluated models (Tables 1-3), as the reference's
``repro/configs/aqua_paper.py`` states them: llama-family dense decoders.

aqua-opt-30b keeps the reference's RoPE, RMSNorm and tanh-gelu MLP (no
gate), not OPT's learned positions, LayerNorm and ReLU. aqua-mistral-7b's
4,096-token sliding window has no page plane: both packages refuse to
serve it.
"""
from repro_torch.configs.base import DENSE, ModelConfig, register

OPT_30B = register(ModelConfig(
    name="aqua-opt-30b", family=DENSE, n_layers=48, d_model=7168, n_heads=56,
    n_kv_heads=56, head_dim=128, d_ff=28672, vocab_size=50272,
    activation="gelu", max_seq_len=32768))

MISTRAL_7B = register(ModelConfig(
    name="aqua-mistral-7b", family=DENSE, n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, head_dim=128, d_ff=14336, vocab_size=32000,
    activation="swiglu", sliding_window=4096, max_seq_len=32768))

LLAMA2_13B = register(ModelConfig(
    name="aqua-llama2-13b", family=DENSE, n_layers=40, d_model=5120,
    n_heads=40, n_kv_heads=40, head_dim=128, d_ff=13824, vocab_size=32000,
    activation="swiglu", max_seq_len=4096))

CODELLAMA_34B = register(ModelConfig(
    name="aqua-codellama-34b", family=DENSE, n_layers=48, d_model=8192,
    n_heads=64, n_kv_heads=8, head_dim=128, d_ff=22016, vocab_size=32016,
    activation="swiglu", rope_theta=1e6, max_seq_len=16384))
