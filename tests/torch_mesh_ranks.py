"""The rank side of the port's multi-rank tests (tests/test_torch_mesh.py,
tests/test_torch_tensor_parallel.py, tests/test_torch_mesh_train.py,
tests/test_torch_fsdp.py, tests/test_torch_hybrid_split.py,
tests/test_torch_kv_sequence.py, tests/test_torch_qdim_split.py and the
expert-parallel gradient of tests/test_torch_moe.py on the CPU, the
expert-parallel, tensor-parallel and mesh-training cases of
tests/test_torch_cuda.py on a card).

    python tests/torch_mesh_ranks.py JOB RANK WORLD DEVICE

JOB is a ``torch.save``d dict written by the test (``run_ranks``): the
checks to run (``collectives``, ``ep``, ``tp``, ``train``, ``loop``,
``remat``, ``hybrid``, ``kvseq``) and their inputs. Each rank joins a
gloo or NCCL group (``launch.mesh.init_ranks``, whose rule picks the
transport) through a FileStore beside JOB, runs every check, and saves
what it got to ``rank<RANK>.pt`` beside JOB, for the test to hold against
its reference. Nothing here imports JAX."""
import dataclasses
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
WALL_S = 120  # each run of the ranks


def run_ranks(where, job, world=4, device="cpu", wall_s=WALL_S):
    """Start ``world`` rank processes of this file on ``job`` (written to
    ``where``) and wait at most ``wall_s`` for all, killing any still
    running then; returns each rank's saved results."""
    where.mkdir(parents=True, exist_ok=True)
    torch.save(dict(job, timeout_s=wall_s), where / "job.pt")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    logs = [open(where / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(where / "job.pt"),
         str(r), str(world), device], stdout=logs[r],
        stderr=subprocess.STDOUT, cwd=ROOT, env=env) for r in range(world)]
    deadline = time.monotonic() + wall_s
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    text = "\n".join(f"--- rank {r}\n" + (where / f"rank{r}.log").read_text()
                     for r in range(world))
    assert all(p.returncode == 0 for p in procs), (
        f"rank exit codes {[p.returncode for p in procs]} (a rank past "
        f"{wall_s} s is killed):\n{text[-6000:]}")
    return [torch.load(where / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


class Grid:
    """A mesh's coordinates without its process groups: enough for
    ``reshard_state``, which places and never communicates."""

    def __init__(self, shape, **coords):
        self.shape, self.coords, self.device = shape, coords, "cpu"

    def index(self, axis):
        return self.coords[axis]


def _rank_seeded(rank: int):
    g = torch.Generator().manual_seed(100 + rank)
    return {"a": torch.randn(8, 3, generator=g),
            "b": torch.randn(3, generator=g),
            "c": torch.randn(5, 2, generator=g)}


def check_collectives(job, dev, device):
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.engine.aggregation import (broadcast_join,
                                                grad_reduce_two_stage,
                                                hash_partition_join,
                                                two_stage_aggregate)
    from repro_torch.engine.pipeline_parallel import (pipeline_forward,
                                                      pipeline_loss)
    from repro_torch.launch.mesh import make_mesh, make_production_mesh
    out = {}
    mesh = make_mesh((4,), ("data",), device)
    g, r = mesh.group("data"), mesh.index("data")
    on = lambda t: t.to(dev)  # noqa: E731
    # the inputs of tests/test_multidevice.py, each rank its block
    keys, vals = torch.arange(64) % 16, torch.arange(64, dtype=torch.float32)
    out["two_stage"] = two_stage_aggregate(
        on(keys[16 * r:16 * r + 16]), on(vals[16 * r:16 * r + 16]), 16,
        g).cpu()
    probe = torch.arange(32) % 10
    bk = torch.nn.functional.pad(torch.arange(10), (0, 2))
    bv = torch.nn.functional.pad((torch.arange(10) * 10.0)[:, None],
                                 (0, 0, 0, 2))
    m, v = broadcast_join(on(probe[8 * r:8 * r + 8]),
                          on(bk[3 * r:3 * r + 3]), on(bv[3 * r:3 * r + 3]), g)
    out["broadcast_join"] = (probe[8 * r:8 * r + 8], m.cpu(), v.cpu())
    hk = torch.arange(64) % 4
    hv = torch.stack([torch.arange(64.0), hk.float()], dim=1)  # (row, key)
    rk, rv = hash_partition_join(on(hk[16 * r:16 * r + 16]),
                                 on(hv[16 * r:16 * r + 16]), 4, g)
    out["hash_join"] = (rk.cpu(), rv.cpu())
    grads = {k: on(t) for k, t in _rank_seeded(r).items()}
    out["grad_reduce"] = {k: t.cpu() for k, t in
                          grad_reduce_two_stage(grads, g).items()}
    out["grad_inputs_kept"] = all(
        torch.equal(grads[k].cpu(), t) for k, t in _rank_seeded(r).items())

    pipe = make_mesh((4,), ("pipe",), device)
    Ws, x = on(torch.from_numpy(job["Ws"])), on(torch.from_numpy(job["x"]))
    stage = lambda W, h: torch.tanh(h @ W)  # noqa: E731
    out["pipeline"] = pipeline_forward(stage, Ws, x, 4, pipe).cpu()
    out["pipeline_loss"] = float(pipeline_loss(
        stage, Ws, x, torch.zeros_like(x), 4, pipe))

    grid = make_mesh((2, 2), ("data", "model"), device)
    got, extra = Checkpointer(job["ckpt_dir"]).restore(
        job["ckpt_template"], specs=job["ckpt_specs"], mesh=grid)
    out["restore"] = ({k: t.cpu() for k, t in got.items()}, grid.coords,
                      {k: str(t.device) for k, t in got.items()}, extra)
    try:
        make_production_mesh(device=device)
        out["production_mesh"] = "built"
    except ValueError as e:
        out["production_mesh"] = str(e)
    return out


def check_ep(job, dev, device):
    from repro_torch import tree as tr
    from repro_torch.configs import ArchConfig, get_shape
    from repro_torch.core.planner import P, make_plan
    from repro_torch.distributed.elastic import reshard_state
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import serve_model
    from repro_torch.models import Ctx, build_model
    from repro_torch.models.moe import moe_apply
    from repro_torch.models.params import flatten
    out = {}
    for case in job["ep"]:
        cfg = ArchConfig(**case["cfg"])
        mesh = make_mesh(case["mesh"], ("data", "model"), device)
        plan = make_plan(cfg, mesh.shape, get_shape(case["shape"]))
        assert plan.moe_strategy == "ep", plan.decisions
        ctx = Ctx(plan=plan, mesh=mesh, ep_shard_map=True,
                  use_flash=case.get("use_flash", False))
        dp, di = mesh.shape["data"], mesh.index("data")
        res = {"coords": mesh.coords}
        if "layer" in case:  # one MoE layer: the rank's experts, router whole
            p = reshard_state(case["layer"], case.get("layer_specs") or {
                k: P("model") if k.startswith("w_") else P()
                for k in case["layer"]}, mesh)
            x = torch.from_numpy(case["x"])
            n = x.shape[0] // dp
            xs = x[di * n:(di + 1) * n].to(dev)
            with torch.no_grad():
                y, aux = moe_apply(cfg, p, xs, ctx)
            res.update(y=y.cpu(), aux=float(aux))
            # the gradient of <y, w> + aux with respect to x and every leaf
            wants = tr.tree_map(lambda t: t.clone().requires_grad_(True), p)
            xs.requires_grad_(True)
            y, aux = moe_apply(cfg, wants, xs, ctx)
            w = torch.from_numpy(case["x"][di * n:(di + 1) * n]).to(dev)
            got = torch.autograd.grad((y * w).sum() + aux,
                                      [xs, *tr.leaves(wants)])
            res["grads"] = {"x": got[0].cpu(), **{
                ".".join(path): g.cpu() for (path, _), g in zip(
                    tr.leaves_with_path(wants), got[1:])}}
        else:
            model = build_model(cfg)
            specs = flatten(model.param_specs(plan))
            model.load_shards(reshard_state(case["state"], specs, mesh))
            res["expert_shape"] = tuple(model.blocks.moe.w_up.shape)
            res["wq_shape"] = tuple(model.blocks.attn.wq.shape)
            if case.get("init_shards"):  # drawn in turns = sliced after
                drawn = build_model(cfg).init_shards(
                    torch.Generator(dev).manual_seed(0), plan, mesh,
                    torch.float32).state_dict()
                whole = build_model(cfg).init_params(
                    torch.Generator(dev).manual_seed(0), torch.float32)
                want = reshard_state(whole.state_dict(), specs, mesh)
                res["init_shards_equal"] = sorted(drawn) == sorted(want) and all(
                    torch.equal(drawn[k], want[k]) for k in want)
            tokens = torch.from_numpy(case["tokens"])
            n = tokens.shape[0] // dp
            ops.reset_launch_counts()
            with torch.no_grad():
                logits, aux = model.forward(
                    {"tokens": tokens[di * n:(di + 1) * n].to(dev)}, ctx)
            res.update(logits=logits.cpu(), aux=float(aux),
                       launches=dict(ops.launch_counts()))
            if "serve" in case:
                with torch.no_grad():
                    res["served"] = serve_model(model, ctx=ctx,
                                                **case["serve"])["outputs"]
        out[case["name"]] = res
    return out


def _decode_run(model, tokens, ctx, max_seq=None, **state_kw):
    """Each step's logits of ``tokens`` (B, n) fed one a step from an
    empty decode state of ``max_seq`` positions (default n + 4; on a rank
    laid out as ``ctx`` places it), and the state after the last step."""
    state = model.init_decode_state(
        tokens.shape[0], max_seq or tokens.shape[1] + 4, model.dtype,
        ctx=ctx, **state_kw)
    out = []
    for t in range(tokens.shape[1]):
        step, state = model.decode_step(tokens[:, t:t + 1], state, ctx)
        out.append(step.cpu())
    return out, state


def _teacher_forced(model, tokens, ctx, **state_kw):
    """Each step's logits of ``tokens`` (B, n) fed one a step from an
    empty decode state."""
    return _decode_run(model, tokens, ctx, **state_kw)[0]


def check_tp(job, dev, device):
    """The tensor-parallel split of every case's model: each rank holds
    its slices under ``param_specs`` (loaded from the whole state, drawn
    by ``init_shards``, or restored from a checkpoint), runs the forward
    on its data shard of the batch, teacher-forced dense and paged decode
    and ``serve_model`` (dense and paged) under the mesh context."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import ArchConfig, get_shape
    from repro_torch.core.planner import make_plan
    from repro_torch.distributed.elastic import reshard_state
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import serve_model
    from repro_torch.models import Ctx, build_model
    from repro_torch.models.params import flatten
    out = {}
    for case in job["tp"]:
        cfg = ArchConfig(**case["cfg"])
        mesh = make_mesh(case["mesh"], ("data", "model"), device)
        plan = make_plan(cfg, mesh.shape, get_shape(case["shape"]))
        ctx = Ctx(plan=plan, mesh=mesh, ep_shard_map=cfg.is_moe,
                  use_flash=case.get("use_flash", False))
        dp, di = mesh.shape["data"], mesh.index("data")
        res = {"coords": mesh.coords, "kv_strategy": plan.kv_strategy}
        model = build_model(cfg)
        specs = flatten(model.param_specs(plan))
        model.load_shards(reshard_state(case["state"], specs, mesh))
        res["shapes"] = {k: tuple(t.shape)
                         for k, t in model.state_dict().items()}
        res["specs"] = specs
        if case.get("init_shards"):  # drawn in turns = sliced after
            drawn = build_model(cfg).init_shards(
                torch.Generator(dev).manual_seed(0), plan, mesh,
                torch.float32).state_dict()
            whole = build_model(cfg).init_params(
                torch.Generator(dev).manual_seed(0), torch.float32)
            want = reshard_state(whole.state_dict(), specs, mesh)
            res["init_shards_equal"] = sorted(drawn) == sorted(want) and all(
                torch.equal(drawn[k], want[k]) for k in want)
        n = case["tokens"].shape[0] // dp
        rows = slice(di * n, (di + 1) * n)
        batch = {"tokens": torch.from_numpy(case["tokens"][rows]).to(dev)}
        if case.get("patches") is not None:
            batch["patches"] = torch.from_numpy(case["patches"][rows]).to(dev)
        with torch.no_grad():
            ops.reset_launch_counts()
            logits, aux = model.forward(batch, ctx)
            res.update(logits=logits.cpu(), aux=float(aux),
                       launches=dict(ops.launch_counts()))
            if case.get("keep_state"):
                res["state"] = {k: t.cpu()
                                for k, t in model.state_dict().items()}
            if "ckpt_dir" in case:
                restored, _ = Checkpointer(case["ckpt_dir"]).restore(
                    build_model(cfg).state_dict(), specs=specs, mesh=mesh)
                again = build_model(cfg).load_shards(restored)
                res["restored_logits"] = again.forward(batch, ctx)[0].cpu()
            if "decode" in case:
                tokens = torch.from_numpy(case["decode"][rows]).to(dev)
                res["decode"] = {
                    "dense": _teacher_forced(model, tokens, ctx),
                    "paged": _teacher_forced(model, tokens, ctx,
                                             kv_layout="paged", page_size=4)}
                res["cache_shape"] = tuple(model.init_decode_state(
                    1, 4, model.dtype, ctx=ctx).k_cache.shape[2:])
            if "serve" in case:
                res["served"] = {layout: serve_model(
                    model, ctx=ctx, kv_layout=layout, page_size=4,
                    **case["serve"])["outputs"]
                    for layout in ("dense", "paged")}
        out[case["name"]] = res
    return out


def _cpu_tree(tree):
    from repro_torch.models.params import flatten
    return {k: t.detach().cpu().clone() for k, t in flatten(tree).items()}


def check_train(job, dev, device):
    """Training over the mesh: each case's rank loads its slices of the
    whole state under ``param_specs``, takes its data shard of each global
    batch (``shard_batch``) and runs ``make_train_step`` under
    ``Ctx(plan=, mesh=)``; the first batch's gradient (``make_grad_fn``,
    after the data axes' sum) and the final parameters come back as the
    rank's slices. A case may save the state after ``save_at`` steps over
    the mesh (``Checkpointer.save(specs=, mesh=)``), or restore one and
    step on (``restore``), and may plan for a ``shape`` (ShapeConfig's
    fields) other than train_4k."""
    from repro_torch import tree as tr
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import ArchConfig, ShapeConfig, get_shape
    from repro_torch.core.planner import make_plan
    from repro_torch.distributed.elastic import reshard_state
    from repro_torch.engine import (CompressionConfig, TrainConfig,
                                    init_error_state, make_grad_fn,
                                    make_train_step, shard_batch)
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Ctx, build_model
    from repro_torch.models.params import flatten
    from repro_torch.optim import (AdamWConfig, init_opt_state,
                                   opt_state_specs, warmup_cosine)
    out = {}
    for case in job["train"]:
        cfg = ArchConfig(**case["cfg"])
        mesh = make_mesh(case["mesh"], ("data", "model"), device)
        plan = make_plan(cfg, mesh.shape, ShapeConfig(*case["shape"])
                         if "shape" in case else get_shape("train_4k"))
        ctx = Ctx(plan=plan, mesh=mesh, ep_shard_map=True)
        model = build_model(cfg)
        specs = model.param_specs(plan)
        model.load_shards(reshard_state(case["state"], flatten(specs), mesh))
        params = tr.tree_map(lambda p: p.detach().clone(), model.params())
        scheme = case.get("scheme", "none")
        tcfg = TrainConfig(microbatches=case.get("micro", 1),
                           opt=AdamWConfig(),
                           compression=CompressionConfig(scheme, 0.05))
        step = make_train_step(model, ctx, tcfg, warmup_cosine(*job["lr"]))
        opt = init_opt_state(params, tcfg.opt)
        err = init_error_state(params) if scheme != "none" else None
        state_specs = (specs, opt_state_specs(specs))
        res = {"coords": mesh.coords, "specs": flatten(specs),
               "losses": [], "norms": [], "plan": plan.moe_strategy,
               "fsdp": ctx.fsdp, "dp": ctx.dp}
        if "restore" in case:
            (params, opt), extra = Checkpointer(case["restore"]).restore(
                (params, opt), specs=state_specs, mesh=mesh)
            res["restored_step"] = int(opt.step)
        batches = [{k: t.to(dev) for k, t in shard_batch(
            {k: torch.from_numpy(v) for k, v in b.items()}, ctx,
            tcfg.microbatches).items()} for b in case["batches"]]
        if "restore" not in case:
            _, met, g = make_grad_fn(model, ctx, tcfg)(params, batches[0])
            res["grads"] = _cpu_tree(g)
            res["metrics"] = {k: float(v) for k, v in met.items()}
        ops.reset_launch_counts()
        for i, local in enumerate(batches):
            params, opt, err, met = step(params, opt, err, local)
            res["losses"].append(float(met["total_loss"]))
            res["norms"].append(float(met["grad_norm"]))
            if case.get("save_at") == i + 1:
                Checkpointer(case["save"]).save(
                    i + 1, (params, opt), {"step": i + 1}, specs=state_specs,
                    mesh=mesh)
        res["launches"] = dict(ops.launch_counts())
        res["params"] = _cpu_tree(params)
        out[case["name"]] = res
    return out


def check_loop(job, dev, device):
    """``train_loop(mesh=)`` under the supervisor: each case trains from
    the whole state's slices (``weights``) on its mesh to ``steps``,
    saving every ``save_every`` steps to ``ckpt``, or resuming there from
    the latest save (a job restarted on another mesh)."""
    from repro_torch.configs import ArchConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import train_loop
    out = {}
    for case in job["loop"]:
        mesh = make_mesh(case["mesh"], ("data", "model"), device)
        got = train_loop(ArchConfig(**case["cfg"]), reduced=False,
                         steps=case["steps"], batch=case["batch"],
                         seq=case["seq"], weights=case["state"], mesh=mesh,
                         ckpt_dir=case["ckpt"], save_every=case["save_every"],
                         log_every=case["steps"] + 1)
        out[case["name"]] = {
            "coords": mesh.coords, "losses": got["losses"],
            "norms": [h["grad_norm"] for h in got["history"]],
            "restored_from": got["report"].restored_from}
    return out


def _gathered(tree, dims, out):
    """The leaves of ``tree`` (a layer's leaves as ``_take`` gives them)
    that were gathered over the data axis: those whose ``dims`` entry is
    not None."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _gathered(v, dims[k], out)
        elif dims[k] is not None:
            out.append(v)
    return out


def check_remat(job, dev, device):
    """FSDP under each remat policy: the forward's loss (the logits'
    weighted sum and the aux) with grad on, every leaf a layer's
    ``_take`` gathered over the data axis tracked by a weak reference;
    after the forward, how many are alive (held for the backward), then
    the gradient of every leaf of the rank's blocks."""
    import gc
    import weakref

    from repro_torch import tree as tr
    from repro_torch.configs import ArchConfig, get_shape
    from repro_torch.core.planner import make_plan
    from repro_torch.distributed.elastic import reshard_state
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Ctx, build_model
    from repro_torch.models import transformer as tf
    from repro_torch.models.params import flatten
    real = tf._take
    out = {}
    for case in job["remat"]:
        cfg = ArchConfig(**case["cfg"])
        mesh = make_mesh(case["mesh"], ("data", "model"), device)
        plan = make_plan(cfg, mesh.shape, get_shape("train_4k"))
        ctx = Ctx(plan=plan, mesh=mesh, ep_shard_map=True)
        model = build_model(cfg)
        model.load_shards(reshard_state(
            case["state"], flatten(model.param_specs(plan)), mesh))
        n = case["tokens"].shape[0] // mesh.shape["data"]
        rows = slice(mesh.index("data") * n, (mesh.index("data") + 1) * n)
        batch = {"tokens": torch.from_numpy(case["tokens"][rows]).to(dev)}
        res = {"coords": mesh.coords}
        for remat in ("none", "full", "dots"):
            tracked = []

            def spy(tree, idx, dims=None, ctx=None):
                got = real(tree, idx, dims, ctx)
                if idx is not None and dims is not None:
                    tracked.extend(weakref.ref(t)
                                   for t in _gathered(got, dims, []))
                return got

            params = tr.tree_map(lambda p: p.detach().requires_grad_(True),
                                 model.params())
            tf._take = spy
            try:
                logits, aux = tf.forward(dataclasses.replace(
                    cfg, remat=remat), params, batch, ctx,
                    gather_logits=False)
            finally:
                tf._take = real
            w = torch.linspace(-1, 1, logits.shape[-1], device=dev)
            loss = (logits * w).sum() + aux
            gc.collect()
            alive = sum(r() is not None for r in tracked)
            grads = torch.autograd.grad(loss, tr.leaves(params))
            res[remat] = {"tracked": len(tracked), "alive": alive,
                          "grads": [g.cpu() for g in grads]}
            del logits, aux, loss, params
        out[case["name"]] = res
    return out


def check_hybrid(job, dev, device):
    """Mamba's ``inner`` over the model axis, piece by piece: the rank's
    block of a known ``in_proj`` product (``xz``, its columns over
    ``model``) through ``collectives.inner_halves`` and its gradient for
    the rank's channels of a cotangent ``g`` of ``[xb | z]``; one Mamba
    layer (``layer``, whole leaves) on the rank's slices, its output and
    the gradient of ``<y, gy>`` for ``x`` and each slice; then the model's
    slices of ``state`` teacher-forced over the dense cache from an empty
    state (``decode``, the rank's rows), returning the Mamba states and
    the specs that ``decode_state_specs`` gives them."""
    from repro_torch.configs import ArchConfig, get_shape
    from repro_torch.core.planner import P, make_plan
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed.elastic import local_slice, reshard_state
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Ctx, build_model
    from repro_torch.models.params import flatten
    from repro_torch.models.ssm import mamba_apply
    out = {}
    for case in job["hybrid"]:
        cfg = ArchConfig(**case["cfg"])
        mesh = make_mesh(case["mesh"], ("data", "model"), device)
        plan = make_plan(cfg, mesh.shape, get_shape("decode_32k"))
        ctx = Ctx(plan=plan, mesh=mesh, ep_shard_map=True)
        res = {"coords": mesh.coords}
        xz = torch.from_numpy(case["xz"])
        block = local_slice(xz, P(None, None, "model"), mesh).to(dev)
        block.requires_grad_(True)
        halves = coll.inner_halves(block, ctx.tp_group)
        di, w, r = xz.shape[-1] // 2, block.shape[-1] // 2, ctx.tp_index
        g = torch.from_numpy(case["g"])
        mine = torch.cat([g[..., r * w:(r + 1) * w],
                          g[..., di + r * w:di + (r + 1) * w]], dim=-1)
        res["halves"] = halves.detach().cpu()
        res["halves_grad"] = torch.autograd.grad(halves, block,
                                                 mine.to(dev))[0].cpu()
        model = build_model(cfg)
        specs = flatten(model.param_specs(plan))
        res["layer_specs"] = {k: P(*tuple(specs[f"groups.mamba.{k}"])[1:])
                              for k in case["layer"]}
        layer = {k: local_slice(torch.from_numpy(v), res["layer_specs"][k],
                                mesh).to(dev).requires_grad_(True)
                 for k, v in case["layer"].items()}
        x = torch.from_numpy(case["x"]).to(dev).requires_grad_(True)
        y = mamba_apply(cfg, layer, x, ctx)
        grads = torch.autograd.grad(y, [x, *layer.values()],
                                    torch.from_numpy(case["gy"]).to(dev))
        res["y"] = y.detach().cpu()
        res["grads"] = {"x": grads[0].cpu(), **{
            k: t.cpu() for k, t in zip(layer, grads[1:])}}
        model.load_shards(reshard_state(case["state"], specs, mesh))
        n = case["decode"].shape[0] // mesh.shape["data"]
        rows = slice(mesh.index("data") * n, (mesh.index("data") + 1) * n)
        tokens = torch.from_numpy(case["decode"][rows]).to(dev)
        state = model.init_decode_state(tokens.shape[0], tokens.shape[1] + 4,
                                        model.dtype, ctx=ctx)
        with torch.no_grad():
            for t in range(tokens.shape[1]):
                _, state = model.decode_step(tokens[:, t:t + 1], state, ctx)
        res["h"], res["conv"] = state.mamba.h.cpu(), state.mamba.conv.cpu()
        res["state_specs"] = build_model(cfg).decode_state_specs(plan).mamba
        out[case["name"]] = res
    return out


def _caches(state):
    """A decode state's caches on the host: the dense ones (with int8
    scales) or the paged pool with its table row and page map."""
    if hasattr(state, "kv"):
        return {"k_pages": state.kv.k_pages.cpu(),
                "v_pages": state.kv.v_pages.cpu(),
                "tables": state.kv.block_tables.cpu(),
                "seq_pages": None if state.seq_pages is None
                else state.seq_pages.cpu()}
    return {k: getattr(state, k).cpu() for k in
            ("k_cache", "v_cache", "k_scale", "v_scale")
            if getattr(state, k) is not None}


def check_kvseq(job, dev, device):
    """Decode over the sequence-sharded cache: each case's rank holds its
    slices under ``param_specs`` and decodes its rows (all of them where
    the plan keeps the batch whole) teacher-forced from an empty state over
    the dense cache, the int8 cache and the paged pool (pages of
    ``page``), each laid out as ``decode_state_specs`` places it
    (``init_decode_state(ctx=)``); returns each step's logits, the caches
    after the last step, the launches of the paged run and, where asked,
    ``serve_model`` over both layouts."""
    from repro_torch.configs import ArchConfig, get_shape
    from repro_torch.core.planner import make_plan
    from repro_torch.distributed.elastic import reshard_state
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import serve_model
    from repro_torch.models import Ctx, build_model
    from repro_torch.models.params import flatten
    out = {}
    for case in job["kvseq"]:
        cfg = ArchConfig(**case["cfg"])
        mesh = make_mesh(case["mesh"], ("data", "model"), device)
        plan = make_plan(cfg, mesh.shape, get_shape(case["shape"]))
        ctx = Ctx(plan=plan, mesh=mesh, ep_shard_map=cfg.is_moe)
        model = build_model(cfg)
        specs = flatten(model.param_specs(plan))
        model.load_shards(reshard_state(case["state"], specs, mesh))
        res = {"coords": mesh.coords, "kv_strategy": plan.kv_strategy,
               "shard_batch": plan.shard_batch, "span": ctx.seq_span,
               "spec": tuple(build_model(cfg).decode_state_specs(
                   plan).k_cache)}
        n = case["decode"].shape[0] // ctx.dp
        rows = slice(ctx.dp_index * n, (ctx.dp_index + 1) * n)
        tokens = torch.from_numpy(case["decode"][rows]).to(dev)
        with torch.no_grad():
            for layout, kw in (("dense", {}), ("int8", {"kv_dtype": "int8"}),
                               ("paged", {"kv_layout": "paged",
                                          "page_size": case["page"]})):
                ops.reset_launch_counts()
                steps, state = _decode_run(model, tokens, ctx,
                                           case["max_seq"], **kw)
                res[layout] = {"steps": steps, "launches": dict(
                    ops.launch_counts()), "caches": _caches(state)}
            if "serve" in case:
                res["served"] = {layout: serve_model(
                    model, ctx=ctx, kv_layout=layout, page_size=case["page"],
                    **case["serve"])["outputs"]
                    for layout in ("dense", "paged")}
        out[case["name"]] = res
    return out


CHECKS = {"collectives": check_collectives, "ep": check_ep, "tp": check_tp,
          "train": check_train, "loop": check_loop, "remat": check_remat,
          "hybrid": check_hybrid, "kvseq": check_kvseq}


def main(job_path: str, rank: int, world: int, device: str) -> None:
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_ranks
    torch.set_num_threads(1)
    job = torch.load(job_path, weights_only=False)
    here = os.path.dirname(job_path)
    dev = init_ranks(rank, world, device=device, timeout_s=job["timeout_s"],
                     store=dist.FileStore(os.path.join(here, "store"), world))
    out = {"backend": dist.get_backend(), "device": str(dev)}
    for name in job["checks"]:
        out[name] = CHECKS[name](job, dev, device)
    torch.save(out, os.path.join(here, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
