"""phi3.5-moe-42b-a6.6b [moe] — 16 experts, top-2, every layer MoE.

32L, d_model=4096, 32H (GQA kv=8), d_ff=6400/expert, vocab=32064.
[hf:microsoft/Phi-3.5-MoE-instruct]. Expert count (16) divides the 16-way
model axis exactly -> pure expert parallelism (the hash-partition join path).
"""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    vocab_size=32_064,
    activation="swiglu",
    n_experts=16,
    top_k=2,
    moe_period=1,
    rope_theta=10_000.0,
)
