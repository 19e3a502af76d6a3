"""lilLinAlg — the paper's distributed linear-algebra tool (§8.3), built on
the Computation API exactly as described: a distributed matrix is a set of
MatrixBlock records on pages; multiply is a JoinComp (join on the inner
block index) feeding an AggregateComp (sum of block products); a tiny
Matlab-like DSL ( X'*X , %*% , ^-1 , + , - ) compiles to a Computation
graph. Small results (e.g. Gram matrices of the feature dimension) are
inverted on the driver, as lilLinAlg does.

Port of ``repro.apps.linalg``: the session runs on ``expr_backend``, by
default ``"torch"`` on ``device`` (CUDA unless the caller names another
device), where the sum of the block products goes through the segment
reduction; the block product itself stays ``np.matmul`` on the host on
every backend, as in the reference, so the bytes are the same.
"""
from __future__ import annotations

import dataclasses
import functools
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import (Executor, Session, make_lambda,
                              make_lambda_from_member)
from repro_torch.objectmodel import PagedStore
from repro_torch.objectmodel.schema import f64, i64, record, vector

__all__ = ["BlockMatrix", "LinAlgSession", "matrix_block_schema"]


def matrix_block_schema(bs: int) -> type:
    """The MatrixBlock record schema for one block size (paper §8.3)."""
    return record(f"MatrixBlock{bs}", r=i64, c=i64,
                  data=vector(f64, (bs, bs)))


def _block_dtype(bs: int) -> np.dtype:
    return matrix_block_schema(bs).dtype


def _flatten_data(rows):
    return rows["data"].reshape(len(rows), -1)


def _flat_blocks(arg):
    # module-level so repeated multiplies share the native-lambda identity
    # (keeps the session plan cache effective across same-shape queries).
    return make_lambda(arg, _flatten_data, "flat")


@functools.lru_cache(maxsize=None)
def _block_mul_fn(ta: bool, out_att: str, bs: int):
    # memoized so every (ta, bs)-shaped multiply reuses one function
    # object — the plan cache keys native lambdas by identity, so a fresh
    # closure per call would miss (and pin a new entry) every time.
    pair_dt = np.dtype([("key", np.int64),
                        ("data", np.float64, (bs, bs))])

    def mul(ar, br):
        out = np.zeros(len(ar), pair_dt)
        lhs = ar["data"]
        if ta:
            lhs = lhs.transpose(0, 2, 1)
        out["data"] = np.matmul(lhs, br["data"])
        out["key"] = ar[out_att] * (1 << 20) + br["c"]
        return out

    return mul


@dataclasses.dataclass
class BlockMatrix:
    """A matrix chunked into bs x bs MatrixBlock records stored on pages."""
    set_name: str
    rows: int
    cols: int
    bs: int

    @property
    def block_grid(self) -> Tuple[int, int]:
        return (-(-self.rows // self.bs), -(-self.cols // self.bs))


class LinAlgSession:
    """Built on the fluent Session front-end: multiply is a ``join`` on the
    inner block index feeding an ``aggregate`` (sum of block products);
    nearest-neighbor is a ``top_k``. Set naming is session-scoped."""

    def __init__(self, store: Optional[PagedStore] = None,
                 num_partitions: int = 4, block_size: int = 128,
                 do_optimize: bool = True, executor_cls=Executor,
                 expr_backend: str = "torch", device=None):
        self.sess = Session(store=store, num_partitions=num_partitions,
                            do_optimize=do_optimize,
                            executor_cls=executor_cls,
                            expr_backend=expr_backend, device=device)
        self.store = self.sess.store
        self.bs = block_size
        self.vars: Dict[str, BlockMatrix] = {}

    # ------------------------------------------------------------- I/O
    def load(self, name: str, a: np.ndarray) -> BlockMatrix:
        bs = self.bs
        n, m = a.shape
        gr, gc = -(-n // bs), -(-m // bs)
        recs = np.zeros(gr * gc, _block_dtype(bs))
        idx = 0
        for i in range(gr):
            for j in range(gc):
                blk = np.zeros((bs, bs))
                chunk = a[i * bs:(i + 1) * bs, j * bs:(j + 1) * bs]
                blk[: chunk.shape[0], : chunk.shape[1]] = chunk
                recs[idx] = (i, j, blk)
                idx += 1
        sname = self.sess.fresh_set_name(name)
        self.store.send_data(sname, recs)
        mat = BlockMatrix(sname, n, m, bs)
        self.vars[name] = mat
        return mat

    def fetch(self, m: BlockMatrix) -> np.ndarray:
        recs = self.store.get_set(m.set_name).all_records()
        bs = m.bs
        gr, gc = m.block_grid
        out = np.zeros((gr * bs, gc * bs))
        for rec in recs:
            out[rec["r"] * bs:(rec["r"] + 1) * bs,
                rec["c"] * bs:(rec["c"] + 1) * bs] = rec["data"]
        return out[: m.rows, : m.cols]

    # ------------------------------------------------ engine operations
    def _matmul(self, A: BlockMatrix, B: BlockMatrix,
                ta: bool = False) -> BlockMatrix:
        """A @ B (or A.T @ B when ta): JoinComp + AggregateComp, the
        paper's LAMultiplyJoin / LAMultiplyAggregate pair."""
        bs = A.bs
        # join key: A's inner index vs B's row index
        inner_att = "r" if ta else "c"
        out_att = "c" if ta else "r"
        mul = _block_mul_fn(ta, out_att, bs)

        schema = matrix_block_schema(bs)
        a_ds = self.sess.read(A.set_name, schema)
        b_ds = self.sess.read(B.set_name, schema)
        r = (a_ds.join(
                b_ds,
                on=lambda a, b: (make_lambda_from_member(a, inner_att)
                                 == make_lambda_from_member(b, "r")),
                project=lambda a, b: make_lambda([a, b], mul,
                                                 "blockMultiply"))
             .aggregate(key="key", value=_flat_blocks)
             .collect())
        keys = np.asarray(r["key"])
        vals = np.asarray(r["value"])
        recs = np.zeros(len(keys), _block_dtype(bs))
        recs["r"] = keys >> 20
        recs["c"] = keys & ((1 << 20) - 1)
        recs["data"] = vals.reshape(-1, bs, bs)
        out_name = self.sess.fresh_set_name("mm")
        self.store.send_data(out_name, recs)
        rows = A.cols if ta else A.rows
        return BlockMatrix(out_name, rows, B.cols, bs)

    def matmul(self, A, B):
        return self._matmul(A, B, ta=False)

    def transpose_multiply(self, A, B):
        return self._matmul(A, B, ta=True)

    def inverse(self, A: BlockMatrix) -> BlockMatrix:
        dense = self.fetch(A)  # small driver-side result (paper's pattern)
        inv = np.linalg.inv(dense)
        return self.load(f"inv_{A.set_name}", inv)

    def add(self, A: BlockMatrix, B: BlockMatrix, sign: float = 1.0
            ) -> BlockMatrix:
        a, b = self.fetch(A), self.fetch(B)
        return self.load(f"add_{A.set_name}", a + sign * b)

    def nearest_neighbor(self, X: BlockMatrix, Am: np.ndarray,
                         xq: np.ndarray, k: int = 1):
        """argmin_i (x_i - x')^T A (x_i - x') via top_k (paper §8.3)."""
        dim = X.cols
        row_schema = record(f"NNRow{dim}", idx=i64, x=vector(f64, dim))
        dense = self.fetch(X)
        recs = row_schema.pack(idx=np.arange(len(dense)), x=dense)

        def score(rows):
            d = rows["x"] - xq
            return -np.einsum("nd,df,nf->n", d, Am, d)

        r = (self.sess.load("rows", recs, row_schema)
                 .top_k(k, score=lambda a: make_lambda(a, score,
                                                       "negMahalanobis"),
                        payload="idx")
                 .collect())
        return np.asarray(r["payload"]), -np.asarray(r["score"])

    # --------------------------------------------------------------- DSL
    def run(self, script: str) -> Dict[str, BlockMatrix]:
        """Matlab-like DSL: ``beta = (X '* X)^-1 %*% (X '* y)``."""
        for line in script.strip().splitlines():
            line = line.strip().rstrip(";")
            if not line or line.startswith("#"):
                continue
            name, expr = (s.strip() for s in line.split("=", 1))
            self.vars[name] = self._eval(_tokenize(expr))
        return self.vars

    def _eval(self, tokens: List[str]) -> BlockMatrix:
        out, pos = self._parse(tokens, 0)
        if pos != len(tokens):
            raise SyntaxError(f"trailing tokens: {tokens[pos:]}")
        return out

    def _parse(self, t: List[str], i: int) -> Tuple[BlockMatrix, int]:
        lhs, i = self._parse_atom(t, i)
        while i < len(t) and t[i] in ("'*", "%*%", "+", "-"):
            op = t[i]
            rhs, i = self._parse_atom(t, i + 1)
            if op == "'*":
                lhs = self.transpose_multiply(lhs, rhs)
            elif op == "%*%":
                lhs = self.matmul(lhs, rhs)
            elif op == "+":
                lhs = self.add(lhs, rhs, 1.0)
            else:
                lhs = self.add(lhs, rhs, -1.0)
        return lhs, i

    def _parse_atom(self, t: List[str], i: int) -> Tuple[BlockMatrix, int]:
        if t[i] == "(":
            inner, i = self._parse(t, i + 1)
            assert t[i] == ")", t[i:]
            i += 1
        else:
            inner = self.vars[t[i]]
            i += 1
        while i < len(t) and t[i] == "^-1":
            inner = self.inverse(inner)
            i += 1
        return inner, i


def _tokenize(expr: str) -> List[str]:
    return re.findall(r"'\*|%\*%|\^-1|[()+\-]|[A-Za-z_]\w*", expr)
