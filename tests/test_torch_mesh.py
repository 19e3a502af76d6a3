"""The port's parallelism layer over four ranks, on the CPU: each rank a
process of its own (``tests/torch_mesh_ranks.py``) joined through a
FileStore under the test's tmp_path with gloo, every run under its own wall
limit. One run of the ranks serves the tests of a group.

* The collectives on the inputs of tests/test_multidevice.py, against
  numpy: ``two_stage_aggregate``, ``broadcast_join``,
  ``hash_partition_join`` (each rank's received partition),
  ``grad_reduce_two_stage``; ``pipeline_forward`` at 4 stages against the
  sequential loop at 2e-5, the reference's bound; ``Checkpointer.restore``
  onto a (2, 2) mesh, each rank's shard exactly the slice that JAX's
  ``NamedSharding`` places at the same mesh position (read from a
  four-device JAX process).
* Explicit expert parallelism (``Ctx(plan=, mesh=, ep_shard_map=True)``)
  on the placement of ``param_specs`` (the dense layers split over the
  model axis too: tests/test_torch_tensor_parallel.py) on (2, 2) and
  (1, 4) meshes in float32 with capacity_factor 4.0 (the
  reference's own test case): logits within 2e-3 of the reference's
  single-device ``log_softmax`` (tests/test_multidevice.py's bound), aux
  to 1e-5 of the reference's on the rank's own data shard (the EP aux is
  each shard's, unreduced); a capacity-bound layer (capacity_factor 1.0
  and 0.5) against a plain numpy recomputation of the reference's EP
  arithmetic (global capacity, per-shard routing) at 1e-5 of the largest
  output; ``serve_model`` under the EP context at (1, 4): every rank's
  tokens the single-process engine's.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

from repro.configs import get_arch, reduced_config
from repro.models import Ctx as JCtx
from repro.models import moe as jmoe
from torch_mesh_ranks import WALL_S, Grid, _rank_seeded, run_ranks
from torch_parity import carry

EP_TOL = 2e-3


@pytest.fixture(scope="module", autouse=True)
def torch():
    torch = pytest.importorskip("torch")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield torch
    torch.set_num_threads(threads)


# ------------------------------------------------------------ collectives
def _ckpt_case(torch, where):
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.core.planner import P
    state = {"w": torch.arange(64.0).reshape(8, 8),
             "v": torch.arange(32.0).reshape(8, 4),
             "s": torch.arange(16.0).reshape(4, 4).to(torch.bfloat16),
             "x": torch.arange(3, dtype=torch.int32)}
    Checkpointer(str(where)).save(1, state, extra={"epoch": 2})
    specs = {"w": P("data", "model"), "v": P(("data", "model"), None),
             "s": P(None, "model"), "x": P()}
    return state, specs


@pytest.fixture(scope="module")
def collectives(torch, tmp_path_factory):
    where = tmp_path_factory.mktemp("collectives")
    rng = np.random.default_rng(0)
    Ws = (rng.standard_normal((4, 16, 16)) / 4.0).astype(np.float32)
    x = rng.standard_normal((8, 16)).astype(np.float32)
    state, specs = _ckpt_case(torch, where / "ckpt")
    template = {k: torch.zeros_like(t) for k, t in state.items()}
    ranks = run_ranks(where / "run", {
        "checks": ["collectives"], "Ws": Ws, "x": x,
        "ckpt_dir": str(where / "ckpt"), "ckpt_template": template,
        "ckpt_specs": specs})
    return {"ranks": [r["collectives"] for r in ranks], "Ws": Ws, "x": x,
            "state": state, "specs": specs,
            "backends": {r["backend"] for r in ranks}}


def test_ranks_run_gloo_on_the_cpu(collectives):
    assert collectives["backends"] == {"gloo"}


def test_two_stage_aggregate(collectives):
    keys, vals = np.arange(64) % 16, np.arange(64, dtype=np.float32)
    want = np.zeros(16, np.float32)
    np.add.at(want, keys, vals)
    got = np.concatenate([r["two_stage"].numpy()
                          for r in collectives["ranks"]])
    np.testing.assert_array_equal(got, want)


def test_broadcast_join(collectives):
    for probe, matched, vals in (r["broadcast_join"]
                                 for r in collectives["ranks"]):
        assert matched.all()  # every probe key 0-9 is on the build side
        np.testing.assert_array_equal(vals[:, 0].numpy(),
                                      probe.numpy() * 10.0)


def test_hash_partition_join(collectives):
    seen = []
    for rank, (rk, rv) in enumerate(r["hash_join"]
                                    for r in collectives["ranks"]):
        assert rk.shape == (4, 8) and rv.shape == (4, 8, 2)
        full = rk >= 0
        assert (rk[full] == rank).all(), (rank, rk)  # key k lands on rank k
        # row j of what rank receives comes from source rank j's rows
        for src in range(4):
            rows = rv[src][full[src], 0].numpy()
            assert ((rows >= 16 * src) & (rows < 16 * src + 16)).all()
        np.testing.assert_array_equal(rv[full][:, 1].numpy(), rank)
        assert (rv[~full] == 0).all()
        seen += rv[full][:, 0].tolist()
    assert sorted(seen) == list(range(64))  # no row lost at T // n * 2


def test_grad_reduce_two_stage(collectives):
    grads = [_rank_seeded(r) for r in range(4)]
    total = {k: sum(g[k] for g in grads) for k in grads[0]}
    for rank, r in enumerate(collectives["ranks"]):
        got = r["grad_reduce"]
        # a (8, 3): reduce-scattered, 2 rows a rank; b (3,), c (5, 2): 4
        # does not divide their first dims, so all-reduced whole
        np.testing.assert_allclose(got["a"], total["a"][2 * rank:2 * rank + 2],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got["b"], total["b"], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got["c"], total["c"], rtol=1e-6, atol=1e-6)
        assert r["grad_inputs_kept"]


def test_pipeline_forward_matches_sequential(collectives):
    want = collectives["x"]
    for W in collectives["Ws"]:
        want = np.tanh(want @ W)
    for r in collectives["ranks"]:
        np.testing.assert_allclose(r["pipeline"], want, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(r["pipeline_loss"],
                                   np.mean(r["pipeline"].numpy() ** 2),
                                   rtol=1e-6)


_JAX_PLACEMENT = """
import json
import jax
from jax.sharding import NamedSharding, PartitionSpec as P
mesh = jax.make_mesh((2, 2), ("data", "model"))
out = {}
for name, shape, spec in json.loads(%r):
    spec = [tuple(e) if isinstance(e, list) else e for e in spec]
    idx = NamedSharding(mesh, P(*spec)).devices_indices_map(tuple(shape))
    out[name] = [[[list(s.indices(n)[:2]) for s, n in
                   zip(idx[mesh.devices[i, j]], shape)]
                  for j in range(2)] for i in range(2)]
print(json.dumps(out))
"""


def test_restore_onto_a_2x2_mesh_places_jax_slices(collectives):
    state, specs = collectives["state"], collectives["specs"]
    cases = [(k, list(t.shape), [list(e) if isinstance(e, tuple) else e
                                 for e in specs[k]]) for k, t in state.items()]
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(
        _JAX_PLACEMENT % json.dumps(cases))], capture_output=True, text=True,
        env=env, timeout=WALL_S)
    assert out.returncode == 0, out.stderr
    placement = json.loads(out.stdout)
    for rank, r in enumerate(collectives["ranks"]):
        got, coords, devices, extra = r["restore"]
        i, j = coords["data"], coords["model"]
        assert (i, j) == divmod(rank, 2) and extra == {"epoch": 2}
        for k, whole in state.items():
            want = whole[tuple(slice(a, b) for a, b in placement[k][i][j])]
            assert got[k].dtype == whole.dtype and devices[k] == "cpu"
            assert got[k].shape == want.shape and (got[k] == want).all(), k


def test_production_mesh_refuses_another_world(collectives):
    for r in collectives["ranks"]:
        assert "needs 256 ranks; the world has 4" in r["production_mesh"]


def test_gloo_probe_carries_every_collective_on_the_cpu(tmp_path):
    """``launch.gloo_probe`` on CPU tensors: every collective that the
    port's code runs over a gloo group comes back ``ok``, each in two
    processes of its own, with values checked by the probe."""
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "src")
    env = dict(os.environ, TMPDIR=str(tmp_path), PYTHONPATH=src)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.gloo_probe", "--device",
         "cpu", "--wall-s", str(WALL_S)], capture_output=True, text=True,
        env=env, timeout=WALL_S + 30)
    assert out.returncode == 0, out.stdout + out.stderr
    from repro_torch.launch.gloo_probe import PROBES
    assert json.loads(out.stdout.splitlines()[-1]) == {
        name: "ok" for name in PROBES}, out.stdout


# ------------------------------------------------------ expert parallelism
def _cfg(arch, capacity_factor):
    return dataclasses.replace(reduced_config(get_arch(arch)),
                               capacity_factor=capacity_factor)


def _layer0(jp):
    import torch
    return {k: torch.from_numpy(np.array(v[0], np.float32))
            for k, v in jp["blocks"]["moe"].items() if k != "shared"}


def _np_ep_layer(cfg, p, x, dp):
    """The reference's EP arithmetic in float64 numpy, shard by shard:
    capacity from the global token count, each data shard routing its own
    tokens, the model rank of each expert keeping its first C slots (in
    token order), the ranks' outputs summed (so every expert's, whichever
    rank holds it). Returns (y, aux of every data shard, slots dropped)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    C = jmoe.expert_capacity(cfg, B * S)
    p = {key: np.asarray(v, np.float64) for key, v in p.items()}
    silu = lambda z: z / (1 + np.exp(-z))  # noqa: E731
    ys, auxs, dropped = [], [], 0
    for di in range(dp):
        xs = x[di * B // dp:(di + 1) * B // dp].reshape(-1, d).astype(
            np.float64)
        logits = xs @ p["router"]
        probs = np.exp(logits - logits.max(-1, keepdims=True))
        probs /= probs.sum(-1, keepdims=True)
        ids = np.argsort(-probs, axis=-1, kind="stable")[:, :k]
        w = np.take_along_axis(probs, ids, -1)
        w /= w.sum(-1, keepdims=True)
        counts = np.bincount(ids.ravel(), minlength=E)
        auxs.append(E * np.sum(counts / (len(xs) * k) * probs.mean(0)))
        y = np.zeros_like(xs)
        for e in range(E):
            toks, slot = np.nonzero(ids == e)  # token order
            dropped += max(0, len(toks) - C)
            toks, slot = toks[:C], slot[:C]
            h = silu(xs[toks] @ p["w_gate"][e]) * (xs[toks] @ p["w_up"][e])
            y[toks] += w[toks, slot][:, None] * (h @ p["w_down"][e])
        ys.append(y.reshape(-1, S, d))
    return np.concatenate(ys), auxs, dropped


@pytest.fixture(scope="module")
def ep(torch, tmp_path_factory):
    import jax.numpy as jnp
    from repro_torch.launch.serve import serve_model
    phi, qwen = _cfg("phi35_moe", 4.0), _cfg("qwen2_moe", 4.0)
    jphi, jphi_p, phi_model = carry(phi, "float32")
    jqwen, jqwen_p, qwen_model = carry(qwen, "float32")
    tokens = np.random.default_rng(1).integers(0, phi.vocab_size, (4, 16),
                                               dtype=np.int32)
    x = np.random.default_rng(2).standard_normal((4, 16, phi.d_model)
                                                 ).astype(np.float32)
    serve = {"n_requests": 4, "max_new": 6, "batch_size": 2}
    fields = lambda c: dataclasses.asdict(c)  # noqa: E731
    cases = [
        {"name": "phi_2x2", "cfg": fields(phi), "mesh": (2, 2),
         "shape": "train_4k", "state": phi_model.state_dict(),
         "tokens": tokens},
        {"name": "phi_1x4", "cfg": fields(phi), "mesh": (1, 4),
         "shape": "train_4k", "state": phi_model.state_dict(),
         "tokens": tokens},
        {"name": "qwen_1x4", "cfg": fields(qwen), "mesh": (1, 4),
         "shape": "decode_32k", "state": qwen_model.state_dict(),
         "tokens": tokens, "serve": serve, "init_shards": True}]
    for cf in (1.0, 0.5):
        cases.append({"name": f"layer_cf{cf}", "cfg": fields(_cfg(
            "phi35_moe", cf)), "mesh": (2, 2), "shape": "train_4k",
            "layer": _layer0(jphi_p), "x": x})
    ranks = run_ranks(tmp_path_factory.mktemp("ep"),
                      {"checks": ["ep"], "ep": cases})
    ref = {}
    for name, jm, jp in (("phi", jphi, jphi_p), ("qwen", jqwen, jqwen_p)):
        f = jax.jit(lambda p, t, jm=jm: jm.forward(p, {"tokens": t}, JCtx()))
        ref[name] = [f(jp, jnp.asarray(t)) for t in (tokens, tokens[:2],
                                                     tokens[2:])]
    with torch.no_grad():
        single = serve_model(qwen_model, **serve)["outputs"]
    return {"ranks": [r["ep"] for r in ranks], "ref": ref, "x": x,
            "layer": _layer0(jphi_p), "jlayer": {
                k: v[0] for k, v in jphi_p["blocks"]["moe"].items()},
            "served": single}


def _log_softmax(a):
    a = np.asarray(a, np.float64)
    m = a.max(-1, keepdims=True)
    return a - m - np.log(np.exp(a - m).sum(-1, keepdims=True))


@pytest.mark.parametrize("case,dp", [("phi_2x2", 2), ("phi_1x4", 1),
                                     ("qwen_1x4", 1)])
def test_ep_forward_matches_single_device(ep, case, dp):
    arch = case.split("_")[0]
    (full, aux), *halves = ep["ref"][arch]
    want_lp = _log_softmax(full)
    for r in ep["ranks"]:
        res = r[case]
        di = res["coords"]["data"]
        n, tp = 4 // dp, 4 // dp
        assert res["expert_shape"][1] == 4 // tp  # the rank's E / tp experts
        got = _log_softmax(res["logits"].numpy())
        err = np.abs(got - want_lp[di * n:(di + 1) * n]).max()
        assert err < EP_TOL, (case, res["coords"], err)
        shard_aux = aux if dp == 1 else halves[di][1]
        np.testing.assert_allclose(res["aux"], float(shard_aux), rtol=1e-5)
    # the model ranks of one data shard hold the same bits after the
    # all-reduce
    by_shard = {}
    for r in ep["ranks"]:
        by_shard.setdefault(r[case]["coords"]["data"], []).append(
            r[case]["logits"])
    for same in by_shard.values():
        assert all(np.array_equal(same[0], t) for t in same[1:])


@pytest.mark.parametrize("cf", [1.0, 0.5])
def test_ep_capacity_bound_layer_matches_numpy(ep, cf):
    cfg = _cfg("phi35_moe", cf)
    want, auxs, dropped = _np_ep_layer(cfg, ep["layer"], ep["x"], dp=2)
    scale = np.abs(want).max()
    for r in ep["ranks"]:
        res = r[f"layer_cf{cf}"]
        di = res["coords"]["data"]
        got = res["y"].numpy()
        assert np.abs(got - want[2 * di:2 * di + 2]).max() < 1e-5 * scale
        np.testing.assert_allclose(res["aux"], auxs[di], rtol=1e-5)
        # it trains: the gradients of <y, w> + aux (x, the router, the
        # rank's experts) are finite and not zero
        for key, g in res["grads"].items():
            assert np.isfinite(g.numpy()).all() and g.abs().max() > 0, key
    # x's and the router's gradients are complete on every rank: the two
    # model ranks of a data shard hold the same bits
    for key in ("x", "router"):
        by_shard = {}
        for r in ep["ranks"]:
            res = r[f"layer_cf{cf}"]
            by_shard.setdefault(res["coords"]["data"], []).append(
                res["grads"][key])
        for same in by_shard.values():
            assert all(np.array_equal(same[0], t) for t in same[1:]), key
    # the trap the test pins: capacity comes from the global 64 tokens
    # while a shard routes 32, so the drops are not the single-device
    # path's (cf 1.0: that path drops and EP cannot; cf 0.5: both drop)
    single, _ = jmoe.moe_apply(cfg, ep["jlayer"], ep["x"], JCtx())
    assert np.abs(np.asarray(single) - want).max() > 1e-3 * scale
    assert (dropped > 0) == (cf == 0.5)


def test_ep_serve_batch_equals_single_process(ep):
    assert len(ep["served"]) == 4
    for r in ep["ranks"]:
        assert r["qwen_1x4"]["served"] == ep["served"]


def test_init_shards_draws_the_single_process_weights(ep):
    """``Model.init_shards`` (the ranks drawing in turns) keeps the very
    slices of what ``init_params`` draws in one process."""
    assert all(r["qwen_1x4"]["init_shards_equal"] for r in ep["ranks"])


def test_what_waits_for_later_items_refuses(torch, ep):
    """A rank's slices under ``param_specs`` (the dense layers split over
    the model axis, the experts too) load, and the ranks of ``ep`` ran one
    forward on them; a train step over the mesh builds on them (it trains
    in tests/test_torch_mesh_train.py), and so does one at a plan with
    FSDP over a data axis (it trains in tests/test_torch_fsdp.py)."""
    from repro_torch.configs import get_arch as tget
    from repro_torch.configs import get_shape
    from repro_torch.configs import reduced_config as treduced
    from repro_torch.core.planner import make_plan
    from repro_torch.distributed.elastic import reshard_state
    from repro_torch.engine import make_train_step
    from repro_torch.models import Ctx, build_model
    from repro_torch.models.params import flatten
    cfg = treduced(tget("qwen2_moe"))
    model = build_model(cfg).init_params(torch.Generator().manual_seed(0),
                                         torch.float32)
    plan = make_plan(cfg, {"data": 1, "model": 4}, get_shape("prefill_32k"))
    grid = Grid({"data": 1, "model": 4}, data=0, model=1)
    whole = model.state_dict()
    tp = reshard_state(whole, flatten(model.param_specs(plan)), grid)
    assert tp["blocks.moe.w_up"].shape[1] == 1  # 4 experts over 4
    q_dim = whole["blocks.attn.wq"].shape[-1]
    assert tp["blocks.attn.wq"].shape[-1] == q_dim // 4
    loaded = build_model(cfg).load_shards(tp)
    assert loaded.blocks.attn.wq.shape == tp["blocks.attn.wq"].shape
    for r in ep["ranks"]:
        res = r["qwen_1x4"]
        assert res["wq_shape"][-1] == q_dim // 4
        assert np.isfinite(res["logits"].numpy()).all()
    assert callable(make_train_step(model, Ctx(plan=plan, mesh=grid)))
    fsdp = dataclasses.replace(cfg, fsdp=True)
    axes = {"data": 2, "model": 2}
    plan = make_plan(fsdp, axes, get_shape("prefill_32k"))
    assert plan.fsdp and "data" in plan.spec("embed", "ff")
    assert callable(make_train_step(build_model(fsdp), Ctx(
        plan=plan, mesh=Grid(axes, data=0, model=0))))
