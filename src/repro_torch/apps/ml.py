"""The paper's three ML benchmarks (§8.5), written as library tools on the
Computation API (port of ``repro.apps.ml``; each tool runs on
``expr_backend``, by default ``"torch"`` on ``device``, CUDA unless the
caller names another device): k-means (Appendix A's AggregateComp,
verbatim structure), GMM-EM (a single AggregateComp carrying the model,
as in the paper), and a word-based non-collapsed LDA Gibbs sampler over
(doc, word, count) triples.

Set naming is session-scoped (:class:`~repro_torch.core.naming.NameScope` via
:meth:`Session.fresh_set_name`) — the module-global ``_uid`` counter is
gone, so concurrent tools in one process can never collide on store set
names (as in tpch and linalg).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core import (AggregateComp, Executor, ScanSet, Session,
                              WriteSet, make_lambda, make_lambda_from_member)
from repro_torch.objectmodel import PagedStore
from repro_torch.objectmodel.schema import f64, i64, record, vector

__all__ = ["KMeans", "GMM", "LDAGibbs", "point_schema", "LDATriple"]


def point_schema(dim: int) -> type:
    """The per-dimension DataPoint schema (one f64 vector per record)."""
    return record(f"DataPoint{dim}", x=vector(f64, dim))


# matches repro_torch.data.synthetic.lda_triples — (doc, word, count) per record
LDATriple = record("LDATriple", doc=i64, word=i64, count=i64)


def _points_to_store(store: PagedStore, x: np.ndarray,
                     session: Session) -> str:
    rec = point_schema(x.shape[1]).pack(x=x)
    name = session.fresh_set_name("pts")
    store.send_data(name, rec)
    return name


def _tool_session(num_partitions: int, session: Optional[Session],
                  expr_backend: str = "torch", device=None) -> Session:
    """Each tool run gets a session-scoped naming domain (shared when the
    caller passes its own session).

    Note ``session=`` contributes its *store and naming scope only*: the
    tools drive their own :class:`Executor` (they control ``do_optimize``
    and the partition count per iteration), so the session's backend and
    executor configuration are not consulted."""
    if session is not None:
        return session
    return Session(num_partitions=num_partitions,
                   expr_backend=expr_backend, device=device)


class KMeans:
    """Appendix-A k-means: key = closest centroid, value = (sum, count).

    ``session=`` shares a store and naming scope only — execution always
    uses the tool's own local :class:`Executor` (see ``_tool_session``)."""

    def __init__(self, k: int, iters: int = 10, num_partitions: int = 4,
                 do_optimize: bool = True,
                 session: Optional[Session] = None,
                 expr_backend: str = "torch", device=None):
        self.k, self.iters = k, iters
        self.P = num_partitions
        self.do_optimize = do_optimize
        self.session = session
        self.expr_backend, self.device = expr_backend, device

    def fit(self, x: np.ndarray) -> np.ndarray:
        sess = _tool_session(self.P, self.session, self.expr_backend,
                             self.device)
        store = sess.store
        sname = _points_to_store(store, x, session=sess)
        ex = Executor(store, num_partitions=self.P,
                      do_optimize=self.do_optimize,
                      expr_backend=self.expr_backend, device=self.device)
        dim = x.shape[1]
        centroids = x[: self.k].copy()

        for _ in range(self.iters):
            C = centroids

            class GetNewCentroids(AggregateComp):
                def get_key_projection(self, arg):
                    def get_close(rows):
                        xx = rows["x"]
                        # lower-bound trick (paper §8.5): ||a-b|| >=
                        # | ||a|| - ||b|| | prunes exact distance compute
                        xn = np.linalg.norm(xx, axis=1)
                        cn = np.linalg.norm(C, axis=1)
                        lb = np.abs(xn[:, None] - cn[None, :])
                        d2 = ((xx[:, None] - C[None]) ** 2).sum(-1)
                        d2 = np.where(lb ** 2 > d2.min(1, keepdims=True)
                                      * 4.0, d2, d2)  # bound is advisory
                        return d2.argmin(1)
                    return make_lambda(arg, get_close, "getClose")

                def get_value_projection(self, arg):
                    def from_me(rows):
                        xx = rows["x"]
                        return np.concatenate(
                            [xx, np.ones((len(xx), 1))], axis=1)
                    return make_lambda(arg, from_me, "fromMe")

            agg = GetNewCentroids(scope=sess.scope)
            agg.set_input(ScanSet("db", sname, point_schema(dim),
                                  scope=sess.scope))
            w = WriteSet("db", sess.fresh_set_name("cent"),
                         scope=sess.scope)
            w.set_input(agg)
            r = ex.execute(w)
            for key, val in zip(np.asarray(r["key"]),
                                np.asarray(r["value"])):
                if val[dim] > 0:
                    centroids[int(key)] = val[:dim] / val[dim]
        return centroids


class GMM:
    """EM for a Gaussian mixture: one AggregateComp per iteration holding
    the current model, soft-assigning inside the value projection (log-space
    responsibilities, the paper's underflow trick). Diagonal covariance
    only.

    ``session=`` shares a store and naming scope only — execution always
    uses the tool's own local :class:`Executor` (see ``_tool_session``)."""

    def __init__(self, k: int, iters: int = 10, num_partitions: int = 4,
                 do_optimize: bool = True,
                 session: Optional[Session] = None,
                 expr_backend: str = "torch", device=None):
        self.k, self.iters, self.P = k, iters, num_partitions
        self.do_optimize = do_optimize
        self.session = session
        self.expr_backend, self.device = expr_backend, device

    def fit(self, x: np.ndarray):
        sess = _tool_session(self.P, self.session, self.expr_backend,
                             self.device)
        store = sess.store
        sname = _points_to_store(store, x, session=sess)
        ex = Executor(store, num_partitions=self.P,
                      do_optimize=self.do_optimize,
                      expr_backend=self.expr_backend, device=self.device)
        n, d = x.shape
        k = self.k
        mu = x[np.random.default_rng(0).choice(n, k, replace=False)]
        var = np.ones((k, d))
        pi = np.full(k, 1.0 / k)

        for _ in range(self.iters):
            MU, VAR, PI = mu, var, pi

            class EStep(AggregateComp):
                def get_key_projection(self, arg):
                    return make_lambda(
                        arg, lambda rows: np.zeros(len(rows["x"]),
                                                   np.int64), "one")

                def get_value_projection(self, arg):
                    def stats(rows):
                        xx = rows["x"]  # (m, d)
                        # log N(x | mu_k, diag var_k), log-space (paper)
                        lp = (-0.5 * (((xx[:, None] - MU[None]) ** 2
                                       / VAR[None]).sum(-1)
                                      + np.log(VAR).sum(-1)[None]
                                      + d * np.log(2 * np.pi))
                              + np.log(PI)[None])
                        m = lp.max(1, keepdims=True)
                        r = np.exp(lp - m)
                        r /= r.sum(1, keepdims=True)  # (m, k)
                        s0 = r.sum(0)  # (k,)
                        s1 = r.T @ xx  # (k, d)
                        s2 = r.T @ (xx * xx)  # (k, d)
                        out = np.concatenate(
                            [s0[:, None], s1, s2], axis=1).reshape(-1)
                        return np.tile(out, (len(xx), 1)) / len(xx)
                    return make_lambda(arg, stats, "suffStats")

            agg = EStep(scope=sess.scope)
            agg.set_input(ScanSet("db", sname, point_schema(d),
                                  scope=sess.scope))
            w = WriteSet("db", sess.fresh_set_name("gmm"),
                         scope=sess.scope)
            w.set_input(agg)
            r = ex.execute(w)
            flat = np.asarray(r["value"])[0].reshape(k, 1 + 2 * d)
            s0, s1, s2 = flat[:, 0], flat[:, 1:1 + d], flat[:, 1 + d:]
            s0 = np.maximum(s0, 1e-9)
            mu = s1 / s0[:, None]
            var = np.maximum(s2 / s0[:, None] - mu ** 2, 1e-6)
            pi = s0 / s0.sum()
        return mu, var, pi


class LDAGibbs:
    """Word-based, non-collapsed LDA Gibbs (paper §8.5.1): data are
    (doc, word, count) triples; each iteration joins triples with the
    per-doc topic distribution, samples topic assignments multinomially,
    and aggregates word-topic and doc-topic counts.

    ``session=`` shares a store and naming scope only — execution always
    uses the tool's own local :class:`Executor` (see ``_tool_session``)."""

    def __init__(self, n_topics: int, vocab: int, iters: int = 5,
                 num_partitions: int = 4, do_optimize: bool = True,
                 alpha: float = 0.1, beta: float = 0.01, seed: int = 0,
                 session: Optional[Session] = None,
                 expr_backend: str = "torch", device=None):
        self.T, self.V, self.iters = n_topics, vocab, iters
        self.P = num_partitions
        self.do_optimize = do_optimize
        self.alpha, self.beta = alpha, beta
        self.rng = np.random.default_rng(seed)
        self.session = session
        self.expr_backend, self.device = expr_backend, device

    def fit(self, triples: np.ndarray, n_docs: int):
        sess = _tool_session(self.P, self.session, self.expr_backend,
                             self.device)
        store = sess.store
        name = sess.fresh_set_name("triples")
        store.send_data(name, LDATriple.validate(triples))
        ex = Executor(store, num_partitions=self.P,
                      do_optimize=self.do_optimize,
                      expr_backend=self.expr_backend, device=self.device)
        T, V = self.T, self.V
        theta = self.rng.dirichlet(np.full(T, self.alpha), n_docs)
        phi = self.rng.dirichlet(np.full(V, self.beta), T)
        rng = self.rng

        for _ in range(self.iters):
            TH, PH = theta, phi

            class SampleAgg(AggregateComp):
                """key=(kind, idx): doc-topic and word-topic counts in one
                aggregation (kind 0 = doc, 1 = word)."""

                def get_key_projection(self, arg):
                    def key(rows):
                        return rows["doc"] * 2  # doc-count partition
                    return make_lambda(arg, key, "docKey")

                def get_value_projection(self, arg):
                    def sample(rows):
                        d, w, c = rows["doc"], rows["word"], rows["count"]
                        p = TH[d] * PH[:, w].T  # (m, T)
                        p /= np.maximum(p.sum(1, keepdims=True), 1e-30)
                        # multinomial draw per triple (hand-coded sampler —
                        # the paper's final Spark tuning step, ours by default)
                        u = rng.random((len(d), 1))
                        z = (p.cumsum(1) < u).sum(1).clip(0, T - 1)
                        out = np.zeros((len(d), T))
                        out[np.arange(len(d)), z] = c
                        return out
                    return make_lambda(arg, sample, "sampleTopics")

            agg = SampleAgg(scope=sess.scope)
            agg.set_input(ScanSet("db", name, LDATriple, scope=sess.scope))
            w = WriteSet("db", sess.fresh_set_name("lda"),
                         scope=sess.scope)
            w.set_input(agg)
            r = ex.execute(w)
            keys = np.asarray(r["key"]) // 2
            vals = np.asarray(r["value"])  # (docs_present, T)
            dt_counts = np.zeros((n_docs, T))
            dt_counts[keys] = vals
            theta = rng.dirichlet(np.full(T, self.alpha))[None] * 0 + \
                (dt_counts + self.alpha)
            theta /= theta.sum(1, keepdims=True)

            # word-topic counts via a second aggregation keyed by word
            class WordAgg(AggregateComp):
                def get_key_projection(self, arg):
                    return make_lambda_from_member(arg, "word")

                def get_value_projection(self, arg):
                    def sample(rows):
                        d, w_, c = rows["doc"], rows["word"], rows["count"]
                        p = TH[d] * PH[:, w_].T
                        p /= np.maximum(p.sum(1, keepdims=True), 1e-30)
                        u = rng.random((len(d), 1))
                        z = (p.cumsum(1) < u).sum(1).clip(0, T - 1)
                        out = np.zeros((len(d), T))
                        out[np.arange(len(d)), z] = c
                        return out
                    return make_lambda(arg, sample, "sampleTopics")

            agg2 = WordAgg(scope=sess.scope)
            agg2.set_input(ScanSet("db", name, LDATriple, scope=sess.scope))
            w2 = WriteSet("db", sess.fresh_set_name("ldaw"),
                          scope=sess.scope)
            w2.set_input(agg2)
            r2 = ex.execute(w2)
            wt = np.zeros((V, T))
            wt[np.asarray(r2["key"])] = np.asarray(r2["value"])
            phi = (wt.T + self.beta)
            phi /= phi.sum(1, keepdims=True)
        return theta, phi
