"""phi3-mini-3.8b [dense] — RoPE, SwiGLU, GQA kv=32 (= MHA).

32L, d_model=3072, 32H (kv=32), d_ff=8192, vocab=32064. [arXiv:2404.14219].
"""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="phi3-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32_064,
    activation="swiglu",
    rope_theta=10_000.0,
    fsdp=False,  # 3.8B fits replicated on v5e with bf16 moments
    moment_dtype="bfloat16",
)
