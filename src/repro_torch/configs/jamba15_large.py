"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2.

72L, d_model=8192, 64H (GQA kv=8), d_ff=24576, vocab=65536.
[arXiv:2403.19887]. Every 8th layer is attention (9 attention layers total);
every 2nd layer's channel mixer is MoE (16 experts, top-2). Sub-quadratic in
the Mamba layers -> long_500k runs with paged KV only on the 9 attention
layers, sequence-sharded (flash-decode) across the mesh.
"""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24_576,
    vocab_size=65_536,
    activation="swiglu",
    n_experts=16,
    top_k=2,
    moe_period=2,
    attn_period=8,
    d_state=16,
    d_conv=4,
    ssm_expand=2,
    pos_embedding="none",  # Jamba uses no positional encoding (Mamba provides order)
    moment_dtype="bfloat16",
)
