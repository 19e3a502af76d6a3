"""lilLinAlg (paper §8.3) on the PyTorch port: least squares, the Gram
matrix and a nearest neighbour through the Matlab-like DSL, each multiply
a join on the inner block index feeding a sum of block products, the sum
through the segment-reduce kernel (K2) on the card; byte-identical to the
numpy backend.

Run:  PYTHONPATH=src python examples/torch_linalg_dsl.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.apps import LinAlgSession


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    rng = np.random.default_rng(7)
    n, d = 2000, 24
    X = rng.normal(size=(n, d))
    beta_true = rng.normal(size=(d, 1))
    y = X @ beta_true + 0.05 * rng.normal(size=(n, 1))
    out = {}
    for name, kw in (("numpy", {"expr_backend": "numpy"}),
                     ("torch", {"device": args.device})):
        s = LinAlgSession(block_size=128, num_partitions=4, **kw)
        s.load("X", X)
        s.load("y", y)
        s.run("beta = ( X '* X )^-1 %*% ( X '* y )\nG = X '* X")
        idx, dist = s.nearest_neighbor(s.vars["X"],
                                       np.diag(rng.uniform(0.5, 2.0, d)),
                                       X[123] + 0.01, k=3)
        out[name] = (s.fetch(s.vars["beta"]), s.fetch(s.vars["G"]), idx)
        assert idx[0] == 123
    (b0, g0, _), (b1, g1, _) = out["numpy"], out["torch"]
    assert b0.tobytes() == b1.tobytes() and g0.tobytes() == g1.tobytes()
    print(f"least squares: max |beta - beta*| = "
          f"{np.abs(b1 - beta_true).max():.4f}; gram max err vs numpy "
          f"{np.abs(g1 - X.T @ X).max():.2e}; torch bytes == numpy bytes")


if __name__ == "__main__":
    main()
