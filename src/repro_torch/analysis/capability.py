"""Pass 3a — capability rules: build-time configuration validation.

Historically these checks lived as ad-hoc ``ValueError``s scattered
through ``Session.__init__`` and ``DistributedExecutor.__init__``. They
are now analyzer rules evaluated in one place, in a *fixed order*, with
the exact exception types and messages preserved — ``Session`` and the
driver call :func:`check_session_config` / :func:`check_worker_config`
instead of duplicating the checks.

Plan-level capability checking (:func:`capability_diagnostics`) runs per
compiled program: a native Python lambda in a plan bound for
``socket_launch='connect'`` workers cannot cross the wire (**PL301**,
error severity — the Session refuses to execute the plan, long before the
rendezvous would fail).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from repro_torch.analysis.diagnostics import Diagnostic, op_path
from repro_torch.core.exprc import EXPR_BACKENDS
from repro_torch.core.tcap import TCAPProgram

__all__ = ["BuildConfig", "SOCKET_LAUNCHES", "capability_diagnostics",
           "check_session_config", "check_worker_config",
           "session_config_violation", "worker_config_violation"]

SOCKET_LAUNCHES = ("fork", "thread", "connect")


@dataclasses.dataclass(frozen=True)
class BuildConfig:
    """The session/executor knobs the capability rules reason about."""

    backend: str = "local"
    num_partitions: Optional[int] = None
    num_workers: Optional[int] = None
    worker_kind: Optional[str] = None
    socket_launch: Optional[str] = None
    socket_addr: Optional[Tuple[str, int]] = None
    expr_backend: str = "torch"
    plan_cache_size: int = 64
    custom_executor: bool = False  # executor_cls other than the default
    has_service: bool = False      # a QueryService was passed (service=)


# ------------------------------------------------------ session-level
def session_config_violation(cfg: BuildConfig) -> Optional[str]:
    """The first violated session rule's message, or None. Rule order is
    part of the contract: a config violating several rules must raise the
    same message it always did."""
    if cfg.expr_backend not in EXPR_BACKENDS:
        return (f"unknown expr_backend {cfg.expr_backend!r} "
                f"(expected one of {EXPR_BACKENDS})")
    if cfg.backend == "workers":
        if cfg.custom_executor:
            return ("backend='workers' chooses its own executor — drop the "
                    "executor_cls argument")
        if (cfg.num_partitions is not None and cfg.num_workers is not None
                and cfg.num_partitions != cfg.num_workers):
            return (f"num_partitions={cfg.num_partitions} and "
                    f"num_workers={cfg.num_workers} disagree — the workers "
                    "backend takes one worker per partition; pass just "
                    "num_workers")
        if (cfg.worker_kind == "socket" and cfg.socket_launch == "connect"
                and cfg.num_workers is None and cfg.num_partitions is None):
            return ("worker_kind='socket' with socket_launch='connect' "
                    "needs an explicit num_workers — the driver must know "
                    "how many external workers to await at the rendezvous")
    elif cfg.backend == "service":
        if not cfg.has_service:
            return ("backend='service' attaches to a running QueryService "
                    "— pass service=<QueryService> (or use "
                    "Session.connect(service))")
        if cfg.custom_executor:
            return ("backend='service' chooses its own executor — drop "
                    "the executor_cls argument")
        if cfg.num_workers is not None or cfg.num_partitions is not None:
            return ("the worker pool size is fixed by the QueryService — "
                    "drop num_workers/num_partitions for "
                    "backend='service'")
        if cfg.worker_kind is not None:
            return ("worker_kind is fixed by the QueryService's launch "
                    "mode — drop it for backend='service'")
        if cfg.socket_launch is not None or cfg.socket_addr is not None:
            return ("socket_launch/socket_addr are fixed by the "
                    "QueryService — drop them for backend='service'")
    elif cfg.backend == "local":
        if cfg.num_workers is not None:
            return ("num_workers only applies to backend='workers' "
                    "(use num_partitions for the local simulation)")
        if cfg.worker_kind is not None:
            return ("worker_kind only applies to backend='workers' "
                    "(the local backend simulates partitions in-process)")
        if cfg.socket_launch is not None or cfg.socket_addr is not None:
            return ("socket_launch/socket_addr only apply to "
                    "backend='workers' with worker_kind='socket'")
    else:
        return (f"unknown backend {cfg.backend!r} "
                "(expected 'local', 'workers', or 'service')")
    if cfg.backend != "service" and cfg.has_service:
        return ("service= only applies to backend='service' — a "
                "QueryService was passed but this session would not "
                "use it")
    if cfg.plan_cache_size < 1:
        return "plan_cache_size must be >= 1"
    return None


def check_session_config(cfg: BuildConfig) -> None:
    msg = session_config_violation(cfg)
    if msg is not None:
        raise ValueError(msg)


# ------------------------------------------------------- worker-level
def worker_config_violation(num_workers: int, expr_backend: str,
                            worker_kind: str,
                            socket_launch: Optional[str],
                            socket_addr: Optional[Tuple[str, int]]
                            ) -> Optional[str]:
    """DistributedExecutor's constructor rules (the raw-driver API — the
    Session rules above subsume most of them but standalone callers hit
    these directly). ``socket_launch`` is the *pre-normalization* value:
    the driver defaults it to 'fork' only after these rules pass."""
    if num_workers < 1:
        return "num_workers must be >= 1"
    if expr_backend not in EXPR_BACKENDS:
        return (f"unknown expr_backend {expr_backend!r} "
                f"(expected one of {EXPR_BACKENDS})")
    if worker_kind not in ("thread", "fork", "socket"):
        return (f"unknown worker_kind {worker_kind!r} "
                "(expected 'thread', 'fork', or 'socket')")
    if worker_kind == "fork" and expr_backend == "torch":
        return ("worker_kind='fork' cannot run expr_backend='torch': CUDA's "
                "context does not survive a fork taken after torch "
                "initialized CUDA in the parent (forked children would fail "
                "at their first kernel) — use worker_kind='thread'")
    if worker_kind != "socket":
        if socket_launch is not None or socket_addr is not None:
            return ("socket_launch/socket_addr only apply to "
                    "worker_kind='socket'")
        return None
    launch = socket_launch or "fork"
    if launch not in SOCKET_LAUNCHES:
        return (f"unknown socket_launch {launch!r} (expected "
                f"one of {SOCKET_LAUNCHES})")
    if launch == "fork" and expr_backend == "torch":
        return ("worker_kind='socket' with socket_launch='fork' cannot "
                "run expr_backend='torch': CUDA's context does not "
                "survive the fork that spawns the connecting workers — "
                "use socket_launch='thread' (in-process workers over "
                "real TCP) or socket_launch='connect' (external worker "
                "processes with their own torch)")
    if launch == "connect" and (socket_addr is None or socket_addr[1] == 0):
        return ("socket_launch='connect' needs an explicit "
                "socket_addr=(host, port) with a nonzero port — "
                "external workers must be told where to dial before "
                "the query runs")
    return None


def check_worker_config(num_workers: int, expr_backend: str,
                        worker_kind: str, socket_launch: Optional[str],
                        socket_addr: Optional[Tuple[str, int]]) -> None:
    msg = worker_config_violation(num_workers, expr_backend, worker_kind,
                                  socket_launch, socket_addr)
    if msg is not None:
        raise ValueError(msg)


# --------------------------------------------------------- plan-level
def capability_diagnostics(prog: TCAPProgram,
                           cfg: Optional[BuildConfig]) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    if cfg is None:
        return diags
    # PL301: the program must cross the wire pickled. True for external
    # socket workers, and for EVERY service pool launch — the resident
    # pool exists before any query does (no fork image to ride), so
    # QUERY frames always pickle the program.
    if cfg.worker_kind == "socket" and cfg.socket_launch == "connect":
        reason = ("socket_launch='connect' ships the TCAP program to "
                  "external workers by pickling")
        remedy = ("express the query in the lambda DSL, or run "
                  "socket_launch='fork' workers on the driver host")
    elif cfg.backend == "service":
        reason = ("backend='service' ships the TCAP program to resident "
                  "pool workers by pickling (the pool outlives any one "
                  "query, so no launch mode can carry native lambdas in "
                  "a fork image)")
        remedy = "express the query in the lambda DSL"
    else:
        return diags
    for i, op in enumerate(prog.ops):
        if op.op == "APPLY" and op.info.get("type") == "native":
            diags.append(Diagnostic(
                "PL301", "error",
                f"{reason}, and native Python lambdas (make_lambda) "
                f"only exist in-process — stage {op.stage!r} cannot "
                f"cross the wire; {remedy}",
                op_path(i, op)))
    return diags
