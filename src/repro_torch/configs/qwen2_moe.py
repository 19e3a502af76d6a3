"""qwen2-moe-a2.7b [moe] — 60 routed experts top-4 + 4 shared experts.

24L, d_model=2048, 16H (kv=16, MHA), d_ff=1408/expert, vocab=151936.
[hf:Qwen/Qwen1.5-MoE-A2.7B]. 60 experts do NOT divide the 16-way model axis:
the planner therefore TP-shards each expert's FFN (d_ff=1408=16*88) instead of
EP-sharding experts — the "join-algorithm choice" analogue (DESIGN.md §4).
"""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=151_936,
    activation="swiglu",
    qkv_bias=True,
    n_experts=60,
    n_shared_experts=4,
    top_k=4,
    moe_period=1,
    rope_theta=1_000_000.0,
)
