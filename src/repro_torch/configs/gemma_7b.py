"""gemma-7b [dense] — GeGLU, head_dim=256 (q_dim 4096 > d_model 3072), MHA.

28L, d_model=3072, 16H (kv=16), d_ff=24576, vocab=256000. [arXiv:2403.08295].
Ties input/output embeddings (per the Gemma release).
"""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24_576,
    vocab_size=256_000,
    activation="geglu",
    rope_theta=10_000.0,
    tie_embeddings=True,
)
