"""internvl2-26b [vlm] — InternViT frontend (STUB) + InternLM2-20B backbone.

48L, d_model=6144, 48H (GQA kv=8), d_ff=16384, vocab=92553.
[arXiv:2404.16821]. The ViT is a stub: ``input_specs()`` provides 256
precomputed patch embeddings that replace the first 256 token positions.
Vocab 92553 is padded to 92672 for 16-way TP (DESIGN.md §5).
"""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16_384,
    vocab_size=92_553,
    activation="swiglu",
    rope_theta=1_000_000.0,
    n_patches=256,
)
