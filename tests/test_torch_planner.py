"""The port's planning half against the reference, on the CPU, exhaustively:
every architecture x every input shape x five meshes x ``allow_dp_only``.

For each cell the port's ``make_plan`` equals the reference's field by
field (the decision strings too), and so do the spec trees: parameters,
AdamW state, inputs and the decode state (float and int8 caches), the
reference's ``PartitionSpec`` read as a tuple. The analytic bytes a device
(parameters, plus the moments for train, plus the decode state for
decode) are the reference dry-run's formula (``repro/launch/dryrun.py``,
``analytic_bytes_per_device``), computed here from the reference's own
abstract trees and specs: importing that module rewrites ``XLA_FLAGS``,
so this process does not. The stand-ins' shapes and dtypes agree leaf for
leaf as well. Everything is exact."""
import functools

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCH_IDS, SHAPES, cell_is_runnable
from repro.configs import get_arch as jget_arch
from repro.core.planner import make_plan as jmake_plan
from repro.engine.specs import abstract_decode_state as jabstract_state
from repro.engine.specs import input_shardings as jinput_shardings
from repro.engine.specs import input_specs as jinput_specs
from repro.models import build_model as jbuild
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import abstract_opt_state as jabstract_opt
from repro.optim import opt_state_specs as jopt_specs

MESHES = {
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
    "2x4": {"data": 2, "model": 4},
    "1x4": {"data": 1, "model": 4},
    "1x1": {"data": 1, "model": 1},
}
PLAN_FIELDS = ("mesh_axes", "shape_kind", "moe_strategy", "kv_strategy",
               "fsdp", "remat", "decisions", "shard_batch", "tp_disabled",
               "batch_extra_axes")


@pytest.fixture(scope="module", autouse=True)
def torch():
    torch = pytest.importorskip("torch")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield torch
    torch.set_num_threads(threads)


def _key(p) -> str:
    return str(getattr(p, "name", getattr(p, "key", getattr(p, "idx", p))))


def _jflat(tree):
    """[(path, leaf)] of a reference tree, specs read as tuples."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return [("/".join(_key(p) for p in path),
             tuple(x) if isinstance(x, JP) else x) for path, x in flat]


def _tflat(tree):
    from repro_torch import tree as tr
    return [("/".join(str(p) for p in path),
             tuple(x) if isinstance(x, tuple) else x)
            for path, x in tr.leaves_with_path(tree)]


def _shard_factor(spec, axes) -> int:
    f = 1
    for entry in spec:
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None:
                f *= axes.get(a, 1)
    return f


def _jbytes(abstract, specs, axes) -> int:
    """The reference dry-run's ``analytic_bytes_per_device``."""
    total = 0
    for a, s in zip(jax.tree.leaves(abstract),
                    jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, JP))):
        nbytes = int(np.prod(a.shape)) * a.dtype.itemsize if a.shape else \
            a.dtype.itemsize
        total += nbytes // max(1, _shard_factor(s, axes))
    return total


def _shapes(flat_ref, flat_port):
    """Shapes and dtype names of two stand-in trees, path by path."""
    ref = [(p, tuple(a.shape), np.dtype(a.dtype).name) for p, a in flat_ref]
    port = [(p, tuple(t.shape), str(t.dtype).split(".")[-1])
            for p, t in flat_port]
    return ref, port


@functools.lru_cache(maxsize=None)
def _models(arch):
    from repro_torch.models import build_model
    return jbuild(jget_arch(arch)), build_model(arch)


@pytest.mark.parametrize("dp_only", [False, True], ids=["tp", "dp_only"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_plan_specs_and_bytes_match_reference(arch, shape, mesh, dp_only):
    from repro_torch.configs import get_shape
    from repro_torch.core.planner import make_plan
    from repro_torch.engine.specs import (abstract_decode_state,
                                          input_shardings, input_specs)
    from repro_torch.launch.dryrun import analytic_bytes_per_device
    from repro_torch.optim import (AdamWConfig, abstract_opt_state,
                                   opt_state_specs)
    axes = MESHES[mesh]
    jm, model = _models(arch)
    jshape = SHAPES[shape]
    want = jmake_plan(jm.cfg, axes, jshape, allow_dp_only=dp_only)
    plan = make_plan(model.cfg, axes, get_shape(shape),
                     allow_dp_only=dp_only)
    for field in PLAN_FIELDS:
        assert getattr(plan, field) == getattr(want, field), field
    assert (plan.dp_axes, plan.tp_axis, plan.tp_size, plan.dp_size) == (
        want.dp_axes, want.tp_axis, want.tp_size, want.dp_size)

    p_spec, jp_spec = model.param_specs(plan), jm.param_specs(want)
    assert _tflat(p_spec) == _jflat(jp_spec)
    assert _tflat(opt_state_specs(p_spec)) == _jflat(jopt_specs(jp_spec))
    assert _tflat(input_shardings(model, get_shape(shape), plan)) == _jflat(
        jinput_shardings(jm, jshape, want))
    for kv_dtype in (None, "int8"):
        assert _tflat(model.decode_state_specs(plan, kv_dtype)) == _jflat(
            jm.decode_state_specs(want, kv_dtype)), kv_dtype

    ok, _ = cell_is_runnable(jm.cfg, jshape)
    if not ok:
        return
    p_abs, jp_abs = model.abstract_params(), jm.abstract_params()
    ref, port = _shapes(_jflat(jp_abs), _tflat(p_abs))
    assert port == ref
    ref, port = _shapes(_jflat(jinput_specs(jm, jshape)),
                        _tflat(input_specs(model, get_shape(shape))))
    assert port == ref
    got = analytic_bytes_per_device(p_abs, p_spec, axes)
    assert got == _jbytes(jp_abs, jp_spec, axes)
    if jshape.kind == "train":
        ocfg = AdamWConfig(moment_dtype=model.cfg.moment_dtype)
        o_abs = abstract_opt_state(p_abs, ocfg)
        jo_abs = jabstract_opt(jp_abs, JAdamWConfig(
            moment_dtype=jm.cfg.moment_dtype))
        ref, port = _shapes(_jflat(jo_abs), _tflat(o_abs))
        assert port == ref
        got += analytic_bytes_per_device(o_abs, opt_state_specs(p_spec), axes)
        want_bytes = _jbytes(jp_abs, jp_spec, axes) + _jbytes(
            jo_abs, jopt_specs(jp_spec), axes)
        assert got == want_bytes
    elif jshape.kind == "decode":
        st = abstract_decode_state(model, get_shape(shape))
        jst = jabstract_state(jm, jshape)
        ref, port = _shapes(_jflat(jst), _tflat(st))
        assert port == ref
        assert analytic_bytes_per_device(
            st, model.decode_state_specs(plan), axes) == _jbytes(
                jst, jm.decode_state_specs(want), axes)


def test_dryrun_cli_writes_every_cell(tmp_path):
    """The command line over every arch x shape on both production
    meshes: one record a runnable cell, with the plan and the bytes a
    device; a skipped cell gives the reference's reason."""
    import json
    from repro_torch.launch import dryrun
    assert dryrun.main(["--out", str(tmp_path)]) == 0
    recs = [json.loads(f.read_text()) for f in sorted(tmp_path.iterdir())]
    n_ok = sum(cell_is_runnable(jget_arch(a), SHAPES[s])[0]
               for a in ARCH_IDS for s in SHAPES)
    assert 0 < n_ok < len(ARCH_IDS) * len(SHAPES)
    assert len(recs) == 2 * n_ok  # a skipped cell writes no record
    ok = [r for r in recs if r["status"] == "ok"]
    assert len(ok) == len(recs)
    moe = next(r for r in ok if (r["arch"], r["shape"], r["mesh"]) == (
        "qwen2_moe", "decode_32k", "multi"))
    # 60 experts do not divide the model axis of 16: TP within experts
    assert moe["devices"] == 512 and moe["plan"]["moe"] == "tp"
    assert moe["params"] == 14_316_259_328
    assert next(r for r in ok if r["arch"] == "phi35_moe")["plan"][
        "moe"] == "ep"  # 16 experts
    rec = dryrun.run_cell("gemma_7b", "long_500k", "single")
    assert rec["status"] == "skipped" and "sub-quadratic" in rec["reason"]
