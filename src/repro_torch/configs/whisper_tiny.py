"""whisper-tiny [audio] — encoder-decoder, conv frontend a stub.  [arXiv:2212.04356]

4 decoder and 4 encoder layers, d_model=384, 6 heads (kv=6) of 64,
d_ff=1536, gelu, vocab=51865. The conv1d audio frontend is a stub: callers
pass frame embeddings ``enc_embeds`` (B, 1500, d_model). RMSNorm and RoPE
stand in for LayerNorm and learned positions, as in the reference's
config. The engines refuse the family (the cross K/V has no page plane);
the dense KV-cache path (``prefill`` / ``decode_step``) serves it.
"""
from repro_torch.configs.base import (ENCDEC, EncDecConfig, ModelConfig,
                                      register)

CONFIG = register(ModelConfig(
    name="whisper-tiny",
    family=ENCDEC,
    n_layers=4,                    # decoder layers
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    activation="gelu",
    encdec=EncDecConfig(n_encoder_layers=4, encoder_seq_len=1500,
                        max_decoder_len=448),
    max_seq_len=32768,
))
