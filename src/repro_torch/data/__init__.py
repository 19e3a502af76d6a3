"""Token pipeline, tokenizer and seeded synthetic data (port of
``repro.data``)."""
from repro_torch.data.pipeline import (TokenLoader, TokenPageWriter,
                                       make_lm_batches)
from repro_torch.data.synthetic import (denormalized_tpch, lda_triples,
                                        lm_tokens, points, tpch_q1_lineitems)
from repro_torch.data.tokenizer import ByteTokenizer

__all__ = ["TokenLoader", "TokenPageWriter", "make_lm_batches",
           "denormalized_tpch", "lda_triples", "lm_tokens", "points",
           "tpch_q1_lineitems", "ByteTokenizer"]
