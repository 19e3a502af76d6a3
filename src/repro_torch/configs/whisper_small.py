"""whisper-small [audio] — enc-dec transformer, conv frontend stubbed.

12L (12 enc + 12 dec), d_model=768, 12H MHA (kv=12), d_ff=3072, vocab=51865.
[arXiv:2212.04356]. The audio frontend (log-mel + 2x conv) is a STUB:
``input_specs()`` provides precomputed frame embeddings (1500 frames = 30 s).
Whisper uses learned positions + pre-LayerNorm + GELU FFNs.
"""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51_865,
    activation="gelu",
    qkv_bias=True,
    pos_embedding="learned",
    norm="layernorm",
    encoder_layers=12,
    encoder_len=1_500,
    fsdp=False,  # 244M params: replicate-and-DP is cheaper than FSDP gathers
    notes="Assigned seq_len is the DECODER length; encoder fixed at 1500 frames.",
)
