"""The paper's ML tools (§8.5) on the PyTorch port: k-means, GMM-EM and
LDA Gibbs on the declarative engine, their aggregations through the
segment-reduce kernel (K2) on the card; byte-identical to the numpy
backend.

Run:  PYTHONPATH=src python examples/torch_ml_tools.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.apps import GMM, KMeans, LDAGibbs
from repro_torch.data.synthetic import lda_triples, points


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    x, _ = points(8000, 16, n_clusters=5, seed=0)
    tri = lda_triples(300, vocab=400, avg_words=60, seed=1)
    runs = {}
    for name, kw in (("numpy", {"expr_backend": "numpy"}),
                     ("torch", {"device": args.device})):
        cents = KMeans(5, iters=5, **kw).fit(x)
        mu, var, pi = GMM(5, iters=3, **kw).fit(x[:4000])
        theta, phi = LDAGibbs(10, 400, iters=2, **kw).fit(tri, 300)
        runs[name] = [a.tobytes() for a in (cents, mu, var, pi, theta,
                                            phi)]
    assert runs["numpy"] == runs["torch"]
    print(f"k-means spread {np.linalg.norm(cents.std(0)):.2f}; GMM weights "
          f"{np.round(np.sort(pi), 3).tolist()}; LDA topic-0 top words "
          f"{np.argsort(-phi, axis=1)[0, :5].tolist()}; torch bytes == "
          "numpy bytes")


if __name__ == "__main__":
    main()
