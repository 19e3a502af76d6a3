"""Library-style tools built on the platform (port of ``repro.apps``: so
far the TPC-H object analytics; lilLinAlg and the ML kit are not ported
yet)."""
from repro_torch.apps.tpch import (customers_per_supplier, load_tpch,
                                   q1_pricing_summary, topk_jaccard)

__all__ = ["customers_per_supplier", "load_tpch", "q1_pricing_summary",
           "topk_jaccard"]
