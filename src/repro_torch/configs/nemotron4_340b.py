"""nemotron-4-340b [dense] — GQA, squared-ReLU (non-gated) FFN.

96L, d_model=18432, 96H (GQA kv=8), d_ff=73728, vocab=256000.
[arXiv:2402.16819]. Biggest dense arch in the pool; bf16 AdamW first moment
to fit 16 GB/chip HBM on a single 256-chip pod (DESIGN.md §6).
"""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18_432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73_728,
    vocab_size=256_000,
    activation="relu2",
    rope_theta=10_000.0,
    moment_dtype="bfloat16",
)
