"""xlstm-125m [ssm] — sLSTM + mLSTM blocks, no separate FFN (d_ff=0).

12L, d_model=768, 4H (kv=4), vocab=50304. [arXiv:2405.04517].
Every 4th block is sLSTM (scalar memory, sequential recurrence); the rest are
mLSTM (matrix memory, chunkwise-parallel). O(1) decode state, so long_500k
runs; the paged-KV object model is inapplicable (DESIGN.md §5) but the
page-based data pipeline + aggregation substrate still apply.
"""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50_304,
    pos_embedding="none",
    slstm_period=4,
    fsdp=False,
    notes="125M-scale; also the end-to-end CPU training example arch.",
)
