"""Rendering for execution stats and traces.

Single source for the human-facing views of a run:

* :func:`last_run_lines` — the ``== last run ... ==`` block ``explain()``
  appends (totals + the per-worker shuffle_bytes / exchanges_elided line
  with the transport named);
* :func:`service_lines` — the ``== service ... ==`` footer a
  ``backend='service'`` session appends: admission counters, catalog
  occupancy/hits, and the shard bytes the last query shipped (0 on a
  catalog-warm repeat);
* :func:`render_analyze` — the ``explain(analyze=True)`` per-op table:
  wall ms / rows / bytes / % of query wall per TCAP op (workers backends
  fold the per-rank op spans: wall is the max across ranks — the critical
  path — rows and bytes are summed), plus the plan phases and the
  driver-side overheads, with a coverage footer stating how much of the
  measured query wall the table accounts for.
"""
from __future__ import annotations

from typing import List, Optional

from repro_torch.obs.trace import QueryTrace, Span

__all__ = ["last_run_lines", "render_analyze", "service_lines"]


def last_run_lines(stats, worker_stats=None,
                   worker_kind: Optional[str] = None) -> List[str]:
    """The last-run stats block: totals, then (for the workers backend)
    one per-rank ``w<rank>=<shuffle_bytes>/<exchanges_elided>`` line with
    the transport named."""
    if stats is None:
        return []
    lines = [f"== last run: rows_scanned={stats.rows_scanned}, "
             f"rows_output={stats.rows_output}, "
             f"shuffle_bytes={stats.shuffle_bytes}, "
             f"exchanges_elided={stats.exchanges_elided} =="]
    if worker_stats:
        per = ", ".join(f"w{i}={ws.shuffle_bytes}/{ws.exchanges_elided}"
                        for i, ws in enumerate(worker_stats))
        label = ("page-serialized" if worker_kind is None
                 else f"page-serialized, transport={worker_kind}")
        lines.append("  per-worker shuffle_bytes/exchanges_elided "
                     f"({label}): {per}")
    return lines


def service_lines(service, last_setup_bytes: int = 0) -> List[str]:
    """The service footer for a ``backend='service'`` session: admission
    accounting from the process metrics, catalog occupancy, and the shard
    bytes the last query actually shipped (the warm-path proof: 0 when
    every scan resolved to a held shard)."""
    if service is None:
        return []
    from repro_torch.obs.metrics import METRICS

    def ctr(name: str):
        return METRICS.counter(name)

    cat = service.catalog.snapshot()
    lines = [
        "== service: "
        f"admitted={ctr('service.queries.admitted.total')}, "
        f"rejected={ctr('service.queries.rejected.total')}, "
        f"queued={ctr('service.queries.queued.total')}, "
        f"timeouts={ctr('service.queries.timeout.total')} ==",
        f"  catalog: shards={cat['holdings']}, "
        f"hits={cat['hits']}, "
        f"materialized={len(cat['materialized'])}",
        f"  pool: workers={service.P}, launch={service.launch}, "
        f"setup_bytes(last)={last_setup_bytes}",
    ]
    return lines


# ------------------------------------------------------------ analyze table
# categories that account query wall time on the driver lane; kernel and
# exchange sub-spans are nested inside op spans and would double-count
_ACCOUNTED = ("plan", "driver", "wait", "op")


def _driver_leaves(trace: QueryTrace) -> List[Span]:
    """Driver-lane spans of the accounted categories with no accounted
    child — these tile the query wall, so their sum is the coverage."""
    driver = [sp for sp in trace.spans if sp.rank is None]
    has_child = {sp.parent for sp in driver if sp.cat in _ACCOUNTED}
    return [sp for sp in driver
            if sp.cat in _ACCOUNTED and sp.id not in has_child]


def _fold_worker_ops(trace: QueryTrace):
    """Per-rank op spans folded per op: (idx, name, wall=max, rows, bytes)."""
    by_name = {}
    for sp in trace.spans:
        if sp.rank is None or sp.cat != "op":
            continue
        idx, rows, nbytes = (sp.attrs.get("idx", 0), sp.attrs.get("rows"),
                             sp.attrs.get("bytes"))
        ent = by_name.setdefault(sp.name, [idx, 0, None, None])
        ent[1] = max(ent[1], sp.dur_ns)
        if rows is not None:
            ent[2] = (ent[2] or 0) + int(rows)
        if nbytes is not None:
            ent[3] = (ent[3] or 0) + int(nbytes)
    return sorted(((name, *ent) for name, ent in by_name.items()),
                  key=lambda r: r[1])


def render_analyze(trace: QueryTrace) -> str:
    root = trace.root()
    if root is None:
        return "== analyze: no trace recorded =="
    wall = max(root.dur_ns, 1)
    ranks = trace.ranks()
    head = "== analyze: per-op wall/rows/bytes"
    if ranks:
        head += (f" ({len(ranks)} ranks, "
                 f"transport={trace.meta.get('transport', '?')})")
    lines = [head + " ==",
             f"  {'phase/op':<34}{'wall ms':>10}{'%':>7}  detail"]

    def row(name: str, dur_ns: int, detail: str = "") -> None:
        if len(name) > 34:  # long fused-run labels: clip for alignment
            name = name[:33] + "…"
        lines.append(f"  {name:<34}{dur_ns / 1e6:>10.3f}"
                     f"{100.0 * dur_ns / wall:>7.1f}"
                     + (f"  {detail}" if detail else ""))

    worker_ops = _fold_worker_ops(trace)
    covered = 0
    for sp in _driver_leaves(trace):
        if sp is root:
            continue
        covered += sp.dur_ns
        if sp.cat == "wait" and worker_ops:
            # the driver's collect wait is where the workers actually run:
            # expand it into the folded per-rank op rows (wall = max across
            # ranks, the critical path; rows/bytes summed)
            row(f"{sp.name} (workers run here)", sp.dur_ns)
            for name, _idx, w, rows, nbytes in worker_ops:
                det = " ".join(
                    ([f"rows={rows}"] if rows is not None else [])
                    + ([f"bytes={nbytes}"] if nbytes is not None else []))
                row(f"  {name}", w, det)
            continue
        det = " ".join(f"{k}={v}" for k, v in sp.attrs.items()
                       if k in ("rows", "bytes", "ops", "algo"))
        row(sp.name, sp.dur_ns, det)
    pct = min(100.0, 100.0 * covered / wall)
    lines.append(f"  -- query wall {wall / 1e6:.3f} ms; "
                 f"table covers {pct:.1f}% of wall --")
    return "\n".join(lines)
