"""Library-style tools built ON the platform (port of ``repro.apps``; the
paper's raison d'être): lilLinAlg (distributed linear algebra + DSL), the
ML kit (k-means, GMM, LDA), and the TPC-H object analytics."""
from repro_torch.apps.linalg import BlockMatrix, LinAlgSession
from repro_torch.apps.ml import GMM, KMeans, LDAGibbs
from repro_torch.apps.tpch import (customers_per_supplier, load_tpch,
                                   q1_pricing_summary, topk_jaccard)

__all__ = ["BlockMatrix", "LinAlgSession", "GMM", "KMeans", "LDAGibbs",
           "customers_per_supplier", "load_tpch", "q1_pricing_summary",
           "topk_jaccard"]
