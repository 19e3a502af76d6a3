"""Seeded synthetic data (port of ``repro.data``: so far the generators of
``synthetic``; the token pipeline and tokenizer are not ported yet)."""
from repro_torch.data.synthetic import (denormalized_tpch, lda_triples,
                                        lm_tokens, points, tpch_q1_lineitems)

__all__ = ["denormalized_tpch", "lda_triples", "lm_tokens", "points",
           "tpch_q1_lineitems"]
