"""Lambda-stage compiler: whole term trees lowered to ONE fused kernel
(port of ``repro.core.exprc``).

The seed executed TCAP one op at a time — every APPLY allocated a fresh
vector list, every FILTER row-compacted every live column. This module
lowers a maximal run of pipelined ops (APPLY of pure stages, FILTER, HASH)
into a single compiled callable per batch, with two backends:

* ``numpy`` — generated Python source over numpy columns. Filters are
  *deferred*: predicate columns are computed over the full batch, masks are
  AND-combined, and one boolean gather at the end materializes only the
  stage's output columns. No per-op vector lists, no per-filter compaction
  of every live column.
* ``torch`` — the same run split into a host prologue (structured-field
  access, registered methods, byte-string compares, key hashing) and one
  numeric core for the cmp/bool/arith DAG, run on the stage's device by
  the hand-written expression kernel (``kernels/expr_core.py``, K1; its
  plain torch version on the CPU), which computes every op in numpy's
  loop dtype so int64/float64 semantics match numpy bit-for-bit. The
  core's inputs go to the device in one copy and its results come back in
  one; the host gathers the filtered rows.

``interp`` (the seed's per-op path) remains available for comparison; all
three produce byte-identical results — enforced by
``tests/test_torch_exprc.py`` against the reference's backends.

Fusion barriers: ``native`` lambdas (opaque — they may inspect the whole
column, so they must see exactly the filtered rows), FLATTEN, and every
exchange op (JOIN/AGG/TOPK/OUTPUT). Registered methods are fused — they
are elementwise by contract (:func:`~repro_torch.core.lambdas.register_method`).

Compiled kernels live in a process-wide LRU keyed by the run's structural
signature + input dtypes (:func:`kernel_cache_info` exposes hit/miss
counters), so repeated queries reuse one compiled kernel per query shape.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.lambdas import METHOD_REGISTRY, _APPLY_BINOP as _NP_BINOP
from repro_torch.core.relops import hash_col
from repro_torch.core.tcap import TCAPOp, TCAPProgram
from repro_torch.kernels import expr_core, ops
from repro_torch.kernels.transfer import staging, to_device
from repro_torch.obs.metrics import METRICS
from repro_torch.obs.trace import NULL, current
from repro_torch.objectmodel.vectorlist import VectorList

__all__ = ["FusedStage", "build_steps", "expr_device", "kernel_cache_info",
           "reset_kernel_cache", "schedule_torch_run", "EXPR_BACKENDS"]

EXPR_BACKENDS = ("interp", "numpy", "torch")

# APPLY stage types the fuser understands (native is a deliberate barrier)
_FUSABLE_TYPES = frozenset(
    {"attAccess", "methodCall", "cmp", "bool", "arith", "const", "rename"})


def _fusable(op: TCAPOp) -> bool:
    if op.op in ("FILTER", "HASH"):
        return True
    if op.op == "APPLY":
        return (not op.new_cols
                or op.info.get("type") in _FUSABLE_TYPES)
    return False


def expr_device(backend: str, device=None) -> Optional[torch.device]:
    """Where ``backend`` runs its kernels: for ``"torch"`` ``device`` with
    its index, the CUDA card unless the caller names another device (with
    no card it raises, never falling back to the CPU); None for the host
    backends."""
    if backend != "torch":
        return None
    from repro_torch.kernels.transfer import card
    from repro_torch.models.model_zoo import resolve_device
    return card(resolve_device(device))


def build_steps(prog: TCAPProgram, backend: str, device=None):
    """The execution plan: prog.ops with maximal fusable runs replaced by
    :class:`FusedStage` entries (``interp`` keeps every op as-is);
    ``device`` is where a ``torch`` stage runs its core.

    A run extends while the next op is fusable, consumes the current tail
    list, and that tail has no other consumer — intermediate vector lists
    then never materialize.
    """
    if backend == "interp":
        return list(prog.ops)
    if backend not in EXPR_BACKENDS:
        raise ValueError(f"unknown expr backend {backend!r} "
                         f"(expected one of {EXPR_BACKENDS})")
    consumers: Dict[str, int] = {}
    for op in prog.ops:
        for src in (op.in_list, op.in_list2):
            if src:
                consumers[src] = consumers.get(src, 0) + 1
    steps: List[Any] = []
    ops = prog.ops
    i = 0
    while i < len(ops):
        op = ops[i]
        if not _fusable(op):
            steps.append(op)
            i += 1
            continue
        run = [op]
        j = i + 1
        while (j < len(ops) and _fusable(ops[j])
               and ops[j].in_list == run[-1].out
               and consumers.get(run[-1].out, 0) == 1):
            run.append(ops[j])
            j += 1
        if len(run) == 1:
            steps.append(op)
            i += 1
        else:
            steps.append(FusedStage(run, backend, device))
            i = j
    return steps


# --------------------------------------------------------------- instr IR
@dataclasses.dataclass
class _Instr:
    kind: str               # attAccess|methodCall|const|hash|cmp|bool|arith
    out: int                # value slot written
    ins: Tuple[int, ...]    # value slots read
    payload: Any            # attName | (onType, method) | value | op string


@dataclasses.dataclass
class _RunIR:
    in_cols: Tuple[str, ...]      # input columns read from the batch
    n_inputs: int
    instrs: List[_Instr]
    masks: List[int]              # FILTER mask slots, in program order
    out_slots: Tuple[int, ...]    # slots of the run's output columns
    out_cols: Tuple[str, ...]


def _lower_run(run: Sequence[TCAPOp]) -> _RunIR:
    slot_of: Dict[str, int] = {}
    in_cols: List[str] = []
    instrs: List[_Instr] = []
    masks: List[int] = []
    next_slot = 0

    def slot(col: str) -> int:
        nonlocal next_slot
        if col not in slot_of:
            # first reference to a column not produced in-run: a batch input
            slot_of[col] = next_slot
            in_cols.append(col)
            next_slot += 1
        return slot_of[col]

    def fresh(col: str) -> int:
        nonlocal next_slot
        slot_of[col] = next_slot
        next_slot += 1
        return slot_of[col]

    # reserve input slots for everything the run reads before it writes
    produced = set()
    for op in run:
        for c in (*op.apply_cols, *op.copy_cols):
            if c not in produced:
                slot(c)
        produced.update(op.new_cols)
    n_inputs = next_slot

    for op in run:
        if op.op == "FILTER":
            masks.append(slot_of[op.apply_cols[0]])
            continue
        if op.op == "HASH":
            instrs.append(_Instr("hash", fresh(op.new_cols[0]),
                                 (slot_of[op.apply_cols[0]],), None))
            continue
        # APPLY
        if not op.new_cols:
            continue  # pure projection — outputs select slots below
        t = op.info["type"]
        new = op.new_cols[0]
        if t == "rename":
            slot_of[new] = slot_of[op.apply_cols[0]]  # alias, no compute
        elif t == "attAccess":
            instrs.append(_Instr("attAccess", fresh(new),
                                 (slot_of[op.apply_cols[0]],),
                                 op.info["attName"]))
        elif t == "methodCall":
            instrs.append(_Instr("methodCall", fresh(new),
                                 (slot_of[op.apply_cols[0]],),
                                 (op.info["onType"], op.info["methodName"])))
        elif t == "const":
            instrs.append(_Instr("const", fresh(new), (), op.info["value"]))
        elif t in ("cmp", "bool", "arith"):
            ins = tuple(slot_of[c] for c in op.apply_cols)
            instrs.append(_Instr(t, fresh(new), ins, op.info["op"]))
        else:  # pragma: no cover - guarded by _fusable
            raise AssertionError(t)

    out = run[-1]
    return _RunIR(tuple(in_cols), n_inputs, instrs, masks,
                  tuple(slot_of[c] for c in out.out_cols), out.out_cols)


def _run_signature(run: Sequence[TCAPOp]) -> Optional[Tuple]:
    """Name-canonicalized structural key of a fusable run (None when a
    constant is unhashable — such runs compile uncached)."""
    ordinal: Dict[str, int] = {}

    def o(col: str) -> int:
        if col not in ordinal:
            ordinal[col] = len(ordinal)
        return ordinal[col]

    sig = []
    for op in run:
        t = op.info.get("type")
        if t == "const":
            v = op.info["value"]
            try:
                # the value's inferred dtype is part of the kernel's
                # semantics (np.full bakes it in): 2, 2.0 and True hash and
                # compare equal but must not share a compiled kernel
                payload: Any = (str(np.asarray(v).dtype), v)
                hash(payload)
            except TypeError:
                return None
        elif t == "attAccess":
            payload = op.info["attName"]
        elif t == "methodCall":
            payload = (op.info["onType"], op.info["methodName"])
        elif t in ("cmp", "bool", "arith"):
            payload = op.info["op"]
        else:
            payload = None
        sig.append((op.op, t, payload,
                    tuple(o(c) for c in op.apply_cols),
                    tuple(o(c) for c in op.copy_cols),
                    tuple(o(c) for c in op.out_cols)))
    return tuple(sig)


# ------------------------------------------------------------ kernel cache
_CACHE_CAP = 512
_KCACHE: "OrderedDict[Tuple, Callable]" = OrderedDict()
_KLOCK = threading.Lock()
_KSTATS = {"hits": 0, "misses": 0, "evictions": 0}


def kernel_cache_info() -> Dict[str, int]:
    with _KLOCK:
        return {**_KSTATS, "entries": len(_KCACHE), "capacity": _CACHE_CAP}


def reset_kernel_cache() -> None:
    with _KLOCK:
        _KCACHE.clear()
        _KSTATS.update(hits=0, misses=0, evictions=0)


class FusedStage:
    """One compiled pipeline stage: a maximal APPLY/FILTER/HASH run fused
    into a single per-batch callable (specialized lazily per input dtype
    signature; specializations are shared process-wide through the kernel
    LRU). A ``torch`` stage runs its numeric core on ``device``; its
    compiled kernels take the device per call, so the LRU shares them
    across devices."""

    def __init__(self, run: Sequence[TCAPOp], backend: str, device=None):
        self.ops = list(run)
        self.backend = backend
        self.device = device
        self.in_list = run[0].in_list
        self.out = run[-1].out
        self.out_cols = run[-1].out_cols
        self.ir = _lower_run(run)
        self.sig = _run_signature(run)
        self._kern: Dict[Tuple, Callable] = {}

    def __repr__(self):
        kinds = "+".join(op.op for op in self.ops)
        return f"FusedStage[{self.backend}:{kinds}]"

    def __call__(self, vl: VectorList) -> VectorList:
        ir = self.ir
        arrays = tuple(vl[c] for c in ir.in_cols)
        dsig = tuple(np.asarray(a[:0]).dtype for a in arrays)
        kern = self._kern.get(dsig)
        if kern is None:
            kern = self._specialize(dsig, arrays)
            self._kern[dsig] = kern
        outs = (kern(arrays, self.device) if self.backend == "torch"
                else kern(arrays))
        out = VectorList()
        for name, arr in zip(ir.out_cols, outs):
            out.append(name, arr)
        return out

    def _specialize(self, dsig: Tuple, arrays: Tuple) -> Callable:
        # runs once per (stage, dtype signature) — the per-batch hot path
        # memoizes in self._kern — so the metrics/tracing work here is off
        # the per-row/per-batch cost model. METRICS calls sit outside
        # _KLOCK (the registry has its own lock).
        key = None if self.sig is None else (self.backend, self.sig, dsig)
        if key is not None:
            with _KLOCK:
                kern = _KCACHE.get(key)
                if kern is not None:
                    _KSTATS["hits"] += 1
                    _KCACHE.move_to_end(key)
                else:
                    _KSTATS["misses"] += 1
            if kern is not None:
                METRICS.inc("kernel_cache.hits")
                return kern
            METRICS.inc("kernel_cache.misses")
        with current().span("kernel:compile", cat="kernel",
                            backend=self.backend,
                            stage="+".join(op.op for op in self.ops)):
            if self.backend == "torch":
                kern = _compile_torch(self.ir, arrays)
            else:
                kern = _compile_numpy(self.ir)
        if key is not None:
            evicted = 0
            with _KLOCK:
                _KCACHE[key] = kern
                while len(_KCACHE) > _CACHE_CAP:
                    _KCACHE.popitem(last=False)
                    _KSTATS["evictions"] += 1
                    evicted += 1
            if evicted:
                METRICS.inc("kernel_cache.evictions", evicted)
        return kern


# --------------------------------------------------------- numpy codegen
def _compile_numpy(ir: _RunIR) -> Callable:
    """Generate one Python function over numpy columns for the whole run."""
    P: List[Any] = []  # payload pool (field names, consts, method keys)

    def pool(x) -> str:
        P.append(x)
        return f"_P[{len(P) - 1}]"

    lines = ["def _kernel(_A, _P, _np, _hash, _REG):"]
    for i in range(ir.n_inputs):
        lines.append(f"    v{i} = _A[{i}]")
    lines.append(f"    _n0 = _A[0].shape[0]" if ir.n_inputs
                 else "    _n0 = 0")
    for ins in ir.instrs:
        o, a = ins.out, [f"v{i}" for i in ins.ins]
        if ins.kind == "attAccess":
            lines.append(f"    v{o} = {a[0]}[{pool(ins.payload)}]")
        elif ins.kind == "methodCall":
            lines.append(f"    v{o} = _REG[{pool(ins.payload)}]({a[0]})")
        elif ins.kind == "const":
            lines.append(f"    v{o} = _np.full(_n0, {pool(ins.payload)})")
        elif ins.kind == "hash":
            lines.append(f"    v{o} = _hash(_np.asarray({a[0]}))")
        elif ins.kind == "bool":
            if ins.payload == "!":
                lines.append(f"    v{o} = _np.logical_not({a[0]})")
            elif ins.payload == "&&":
                lines.append(f"    v{o} = _np.logical_and({a[0]}, {a[1]})")
            else:
                lines.append(f"    v{o} = _np.logical_or({a[0]}, {a[1]})")
        else:  # cmp | arith — plain vectorized operators
            lines.append(f"    v{o} = {a[0]} {ins.payload} {a[1]}")
    outs = [f"v{s}" for s in ir.out_slots]
    if ir.masks:
        m = " & ".join(f"_np.asarray(v{s}, bool)" for s in ir.masks)
        lines.append(f"    _m = {m}")
        body = ", ".join(f"{v}[_m]" for v in outs)
    else:
        body = ", ".join(outs)
    lines.append(f"    return ({body}{',' if len(outs) == 1 else ''})")
    ns: Dict[str, Any] = {}
    exec(compile("\n".join(lines), "<exprc>", "exec"), ns)  # noqa: S102
    fn = ns["_kernel"]
    pool_t = tuple(P)

    def kernel(A: Tuple) -> Tuple:
        # deferred masking evaluates expressions over rows a filter later
        # drops — numeric warnings for those rows would be spurious
        with np.errstate(all="ignore"):
            return fn(A, pool_t, np, hash_col, METHOD_REGISTRY)

    return kernel


# ---------------------------------------------------------- torch backend
def _eval_host(ins: _Instr, env: Dict[int, np.ndarray], n0: int):
    if ins.kind == "attAccess":
        return env[ins.ins[0]][ins.payload]
    if ins.kind == "methodCall":
        return METHOD_REGISTRY[ins.payload](env[ins.ins[0]])
    if ins.kind == "const":
        return np.full(n0, ins.payload)
    if ins.kind == "hash":
        return hash_col(np.asarray(env[ins.ins[0]]))
    if ins.kind == "bool":
        if ins.payload == "!":
            return np.logical_not(env[ins.ins[0]])
        a, b = (env[i] for i in ins.ins)
        return (np.logical_and if ins.payload == "&&"
                else np.logical_or)(a, b)
    a, b = (env[i] for i in ins.ins)
    return _NP_BINOP[ins.payload](a, b)


def _core_dtype(dt: Optional[np.dtype]) -> bool:
    """A dtype the numeric core takes (the reference's ``_jaxable``)."""
    return dt is not None and dt.names is None and dt.kind in "biuf"


def schedule_torch_run(ir: _RunIR, arrays: Sequence, hoist_host: bool = True
                       ) -> Tuple[Dict[int, str],
                                  Dict[int, Optional[np.dtype]]]:
    """The torch backend's static schedule for one fused run (the
    reference's ``schedule_jax_run``, status for status): zero-row dtype
    propagation, then each instruction assigned ``"pre"`` (host
    prologue), ``"jit"`` (the single numeric core, on the device) or
    ``"post"`` (host epilogue — a host↔device round-trip after the core).
    Returns ``(status per slot, dtype per slot)``. Pure numpy — shared
    between :func:`_compile_torch` (which builds the kernel from it) and
    the static analyzer's fusion pass (which diagnoses the round-trips,
    PL402), so the diagnosis can never drift from what the kernel actually
    does.

    ``hoist_host=True`` (the optimizer acting on PL402) then runs a
    demotion fixpoint: any host-only instruction stranded in the epilogue
    pins its core-computed inputs to the host prologue (``_eval_host``
    evaluates the same numeric ops in numpy, byte-identical to the core),
    re-ordering the commuting host-only stages ahead of the core until the
    epilogue is empty — a single host→device crossing instead of a
    round-trip. ``hoist_host=False`` yields the raw schedule the analyzer
    reports the round-trip from."""
    probe: Dict[int, Any] = {i: np.asarray(a)[:0]
                             for i, a in enumerate(arrays)}
    dtypes: Dict[int, Optional[np.dtype]] = {
        i: v.dtype for i, v in probe.items()}
    for ins in ir.instrs:
        try:
            with np.errstate(all="ignore"):
                v = _eval_host(ins, probe, 0)
            probe[ins.out] = np.asarray(v)
            dtypes[ins.out] = probe[ins.out].dtype
        except Exception:
            probe[ins.out] = None
            dtypes[ins.out] = None

    JIT_KINDS = ("cmp", "bool", "arith")
    pinned: set = set()  # slots demoted to the host prologue

    def assign() -> Dict[int, str]:
        status: Dict[int, str] = {i: "pre" for i in range(ir.n_inputs)}
        for ins in ir.instrs:
            dep_status = [status[i] for i in ins.ins]
            jit_ok = (ins.kind in JIT_KINDS
                      and ins.out not in pinned
                      and _core_dtype(dtypes[ins.out])
                      and all(_core_dtype(dtypes[i]) for i in ins.ins)
                      and all(s in ("pre", "jit") for s in dep_status))
            if jit_ok:
                status[ins.out] = "jit"
            elif any(s in ("jit", "post") for s in dep_status):
                status[ins.out] = "post"
            else:
                status[ins.out] = "pre"
        return status

    status = assign()
    while hoist_host:
        # a "post" instruction is stranded on the host behind jit-computed
        # inputs; demote those inputs (each iteration pins at least one
        # jit slot, so this terminates — and ends with an empty epilogue)
        demote = set()
        for ins in ir.instrs:
            if status[ins.out] == "post":
                demote |= {s for s in ins.ins if status[s] == "jit"}
        if not demote:
            break
        pinned |= demote
        status = assign()
    return status, dtypes


def _compile_torch(ir: _RunIR, arrays: Tuple) -> Callable:
    """Split the run into host prologue / one numeric core on the device /
    host epilogue, scheduled statically from zero-row dtype propagation;
    the core is one ``expr_core`` program. The compiled kernel takes the
    batch's columns and the device."""
    status, dtypes = schedule_torch_run(ir, arrays)

    pre = [i for i in ir.instrs if status[i.out] == "pre"]
    core = [i for i in ir.instrs if status[i.out] == "jit"]
    post = [i for i in ir.instrs if status[i.out] == "post"]

    # slots the core reads from the host side, and slots it must return
    ext = sorted({s for ins in core for s in ins.ins
                  if status[s] != "jit"})
    needed_after = set(ir.out_slots) | set(ir.masks)
    for ins in post:
        needed_after.update(ins.ins)
    ret = sorted({ins.out for ins in core} & needed_after)
    program = (expr_core.encode([(i.payload, i.out, i.ins) for i in core],
                                dtypes, ext, ret) if core else None)
    # a constant goes to the device as one value, read at every row
    consts = {ins.out for ins in pre if ins.kind == "const"}

    def kernel(A: Tuple, device) -> Tuple:
        # "stage" spans split a fused op's time per batch (the analyze
        # table leaves them out: it tiles the wall with op spans)
        rec = current()
        env: Dict[int, Any] = dict(enumerate(A))
        n0 = A[0].shape[0] if A else 0
        with np.errstate(all="ignore"):
            with rec.span("stage:pre", cat="stage"):
                for ins in pre:
                    env[ins.out] = _eval_host(ins, env, n0)
            if program is not None:
                outs = _run_core(program, [env[s] for s in ext],
                                 [s in consts for s in ext], n0, device,
                                 rec)
                for s, o in zip(ret, outs):
                    env[s] = o
            with rec.span("stage:post", cat="stage"):
                for ins in post:
                    env[ins.out] = _eval_host(ins, env, n0)
                if ir.masks:  # the host's mask gather
                    m = np.asarray(env[ir.masks[0]], bool)
                    for s in ir.masks[1:]:
                        m = m & np.asarray(env[s], bool)
                    return tuple(np.asarray(env[s])[m]
                                 for s in ir.out_slots)
                return tuple(env[s] for s in ir.out_slots)

    return kernel


def _run_core(program, arrays: List[np.ndarray], const: List[bool],
              n0: int, device, rec=NULL) -> List[np.ndarray]:
    """One batch through the core on ``device``. Columns of one batch share
    their trailing shape (a vector field): the core runs over their
    elements. On a card the inputs (a constant as one value) are packed
    into the device's pinned "k1 in" staging buffer, the kernel reads them
    and writes its outputs into the pinned "k1 out" buffer through the
    card's mapping, and the host waits for it (on the calling thread's
    current stream, not the whole device, which other ranks may share) and
    copies the outputs out: one pack, one launch, one wait. The process's
    one buffer pair serves every batch of every thread: a thread holds
    both buffers' locks from the pack to the copy out.
    Under a recorder ``rec`` the pack, the launch with its wait and the
    copy out are spans."""
    arrays = [np.asarray(a) for a in arrays]
    shapes = {a.shape[1:] for a in arrays}
    if len(shapes) > 1:
        raise TypeError(f"the numeric core takes columns of one shape; got "
                        f"{sorted(a.shape for a in arrays)}")
    trail = shapes.pop()
    n = n0 * int(np.prod(trail, dtype=np.int64))
    cols = [a[:1] if c else a for a, c in zip(arrays, const)]
    if device.type == "cpu":
        with rec.span("stage:k1", cat="stage"):
            outs = [t.numpy().view(dt) for t, dt in zip(
                ops.expr_core(program, to_device(cols, device), n),
                program.out_dtypes)]
    else:
        in_stage = staging(device, "k1 in")
        out_stage = staging(device, "k1 out")
        with in_stage.lock, out_stage.lock:
            with rec.span("stage:pinned_in", cat="stage"):
                inputs, _ = in_stage.pack([[c] for c in cols])
            with rec.span("stage:k1", cat="stage"):
                views = out_stage.views([(n, dt)
                                         for dt in program.out_dtypes])
                ops.expr_core(program, inputs, n, outs=views, device=device)
                torch.cuda.current_stream(device).synchronize()
            with rec.span("stage:pinned_out", cat="stage"):
                outs = [v.numpy().view(dt).copy()
                        for v, dt in zip(views, program.out_dtypes)]
    return [o.reshape((n0,) + trail) for o in outs]
