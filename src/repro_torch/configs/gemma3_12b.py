"""gemma3-12b [dense] — 5:1 local:global attention, 128k ctx.  [hf; unverified tier]

48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144, head_dim=256,
sliding window 1024 on local layers, every 6th layer global, qk-norm.
The local layers' KV caches are rings of ``min(1024, seq)`` slots; there is
no page plane for them, so only the dense KV-cache path (``prefill`` /
``decode_step``) serves it. One ``rope_theta`` (1e6) on every layer, as the
reference has it.
"""
from repro_torch.configs.base import DENSE, ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma3-12b",
    family=DENSE,
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    activation="geglu",
    tie_embeddings=True,
    embed_scale=True,
    use_qk_norm=True,
    sliding_window=1024,
    global_layer_every=6,
    rope_theta=1e6,
    max_seq_len=524288,
))
