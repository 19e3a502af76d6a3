"""The hybrid (jamba) family split over the model axis, piece by piece,
on the CPU: each rank a process of its own (``tests/torch_mesh_ranks.py``'s
``check_hybrid`` and ``check_train``, gloo, a FileStore under the test's
tmp_path) holding its slices of Mamba's ``inner`` under
``Model.param_specs``, reduced jamba, float32.

* ``collectives.inner_halves``: a rank's contiguous block of the 2·di
  columns of ``in_proj``'s product becomes exactly its di/tp channels of
  ``xb`` and of ``z``, and the gradient comes back as exactly the rank's
  block of the whole gradient (a permutation of the values: bit for bit),
  on (1, 2) and (1, 4); the exchange plan delivers every block for any
  axis from 2 to 8 ranks, odd ones too (where a rank sends its two blocks
  swapped).
* One Mamba layer on (1, 2), (1, 4) and (2, 2): the output within 1e-5 of
  its largest value of the port's single process (and within 1e-4 of the
  reference's ``mamba_apply``, tests/test_torch_hybrid.py's bound), the
  gradient of x and of every leaf's slice within 1e-4 of the leaf's
  largest |g| (tests/test_torch_mesh_train.py's bound): the partial
  ``x_proj`` sums and the ``to_model`` gradients hold.
* Decode over the dense cache, several steps teacher-forced from an
  empty state: a rank's ``h`` is its di/tp channels of the single
  process's, the conv window whole, the same bits on every model rank
  and the single process's within 1e-5 of its largest value; both laid
  out as ``decode_state_specs`` says (``h`` over ``model``, the window
  whole: its dim 2 is d_conv - 1).
* Checkpoints: training at the published plan (``fsdp=True``,
  ``remat="full"``; ``capacity_factor`` 4.0 as the mesh-training tests
  set it under expert parallelism) saved over (1, 4) after 2 steps writes
  the single process's manifest, file names and values (within 1e-4 of
  each leaf's largest, tests/test_torch_mesh_train.py's bound on the
  parameters after AdamW steps: ``conv_b`` and ``dt_bias`` start at zero,
  so their largest value is a few learning rates); restored on (2, 2), ``in_proj`` then split over
  ``data`` and ``model``, and on one process, the third step's loss is
  the uninterrupted run's.
* Refusals: ``held_split`` refuses a held width that is neither whole nor
  1/tp; a Mamba layer whose ``in_proj`` block is not twice its channels,
  and an odd block handed to ``inner_halves``, raise ValueError.
"""
import concurrent.futures
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_arch, reduced_config
from repro.models import Ctx as JCtx
from repro.models import ssm as jssm
from test_torch_mesh_train import LR, PORT_TOL, REF_TOL, _batches, _single
from torch_mesh_ranks import Grid, run_ranks

ARCH = "jamba15_large"
MESHES = [(1, 2), (1, 4), (2, 2)]
B, L, STEPS = 2, 16, 5
OUT_TOL, GRAD_TOL, LAYER_REF_TOL = 1e-5, 1e-4, 1e-4


@pytest.fixture(scope="module", autouse=True)
def torch():
    torch = pytest.importorskip("torch")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield torch
    torch.set_num_threads(threads)


def _port_cfg(**edit):
    from repro_torch.configs import get_arch as tget
    from repro_torch.configs import reduced_config as treduced
    return dataclasses.replace(treduced(tget(ARCH)), **edit)


def _single_layer(torch, cfg, layer, x, gy):
    """The port's single process: one Mamba layer's output and the
    gradient of <y, gy> for x and each leaf."""
    from repro_torch.models import Ctx
    from repro_torch.models.ssm import mamba_apply
    p = {k: torch.from_numpy(v).requires_grad_(True)
         for k, v in layer.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y = mamba_apply(cfg, p, xt, Ctx())
    grads = torch.autograd.grad(y, [xt, *p.values()], torch.from_numpy(gy))
    return y.detach().numpy(), {"x": grads[0].numpy(), **{
        k: g.numpy() for k, g in zip(p, grads[1:])}}


def _single_decode(torch, model, tokens):
    state = model.init_decode_state(tokens.shape[0], tokens.shape[1] + 4,
                                    model.dtype)
    with torch.no_grad():
        for t in range(tokens.shape[1]):
            _, state = model.decode_step(torch.from_numpy(
                tokens[:, t:t + 1]), state)
    return state.mamba.h.numpy(), state.mamba.conv.numpy()


@pytest.fixture(scope="module")
def split(torch, tmp_path_factory):
    """The ranks' answers beside the single process's: ``check_hybrid``
    on the three meshes (the world-2 and world-4 runs at once), then
    training saved over (1, 4) and restored over (2, 2)."""
    from repro_torch.models import build_model
    where = tmp_path_factory.mktemp("hybrid_split")
    cfg = _port_cfg()
    rng = np.random.default_rng(0)
    model = build_model(cfg).init_params(torch.Generator().manual_seed(0),
                                         torch.float32)
    di = cfg.ssm_expand * cfg.d_model
    layer = {k: v[0].numpy().copy()
             for k, v in model.params()["groups"]["mamba"].items()}
    x = rng.standard_normal((B, L, cfg.d_model)).astype(np.float32)
    gy = rng.standard_normal((B, L, cfg.d_model)).astype(np.float32)
    xz = rng.standard_normal((B, L, 2 * di)).astype(np.float32)
    g = rng.standard_normal((B, L, 2 * di)).astype(np.float32)
    dec = rng.integers(0, cfg.vocab_size, (4, STEPS), dtype=np.int32)
    jobs = {}
    for mesh in MESHES:
        jobs.setdefault(mesh[0] * mesh[1], []).append({
            "name": f"{mesh[0]}x{mesh[1]}", "cfg": dataclasses.asdict(cfg),
            "mesh": mesh, "xz": xz, "g": g, "layer": layer, "x": x,
            "gy": gy, "state": model.state_dict(), "decode": dec})
    tcfg = _port_cfg(fsdp=True, remat="full", capacity_factor=4.0)
    tmodel = build_model(tcfg).init_params(torch.Generator().manual_seed(1),
                                           torch.float32)
    batches = _batches(tcfg, seed=5)
    train_case = {"name": "save", "cfg": dataclasses.asdict(tcfg),
                  "mesh": (1, 4), "state": tmodel.state_dict(),
                  "batches": batches, "save_at": 2,
                  "save": str(where / "ckpt")}
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        runs = {world: pool.submit(run_ranks, where / f"world{world}", {
            "checks": ["hybrid"], "hybrid": cases}, world=world)
            for world, cases in jobs.items()}
        saved = pool.submit(run_ranks, where / "save", {
            "checks": ["train"], "train": [train_case], "lr": LR}, world=4)
        single = {"y_grads": _single_layer(torch, cfg, layer, x, gy),
                  "decode": _single_decode(torch, model, dec),
                  "train": _single(torch, tmodel, batches, 1, "none",
                                   save=str(where / "single"))}
        ranks = {world: [r["hybrid"] for r in run.result()]
                 for world, run in runs.items()}
        saved = [r["train"]["save"] for r in saved.result()]
    restored = run_ranks(where / "restore", {"checks": ["train"], "lr": LR,
                                             "train": [dict(
        train_case, name="restore", mesh=(2, 2), batches=batches[2:],
        restore=train_case["save"])]}, world=4)
    by_mesh = {}
    for mesh in MESHES:
        name = f"{mesh[0]}x{mesh[1]}"
        by_mesh[mesh] = [r[name] for r in ranks[mesh[0] * mesh[1]]]
    return {"cfg": cfg, "tcfg": tcfg, "tmodel": tmodel, "batches": batches,
            "xz": xz, "g": g, "layer": layer, "x": x, "gy": gy,
            "dec": dec, "single": single, "ranks": by_mesh, "saved": saved,
            "restored": [r["train"]["restore"] for r in restored],
            "ckpt": train_case["save"], "single_ckpt": str(where / "single")}


def _tp(mesh, res):
    return mesh[1], res["coords"]["model"]


@pytest.mark.parametrize("mesh", [(1, 2), (1, 4)])
def test_inner_halves_gives_each_rank_its_channels(split, mesh):
    """Forward: the rank's w channels of xb, then of z, exactly; backward:
    the rank's contiguous block of the whole gradient, exactly."""
    xz, g = split["xz"], split["g"]
    di = xz.shape[-1] // 2
    for res in split["ranks"][mesh]:
        tp, r = _tp(mesh, res)
        w = di // tp
        want = np.concatenate([xz[..., r * w:(r + 1) * w],
                               xz[..., di + r * w:di + (r + 1) * w]], -1)
        assert np.array_equal(res["halves"].numpy(), want), (mesh, r)
        assert np.array_equal(res["halves_grad"].numpy(),
                              g[..., 2 * r * w:2 * (r + 1) * w]), (mesh, r)


@pytest.mark.parametrize("n", range(2, 9))
def test_the_exchange_plan_delivers_every_block(n):
    """Simulated all_to_all of ``_halves_plan`` over n ranks: each rank's
    two w-blocks, sent in rank order of their destinations, arrive as
    [xb_r | z_r], for odd n (swapped sends) too."""
    from repro_torch.distributed.collectives import _halves_plan
    w = 3
    blocks = np.arange(2 * n * w).reshape(2 * n, w)  # global block b
    plans = [_halves_plan(n, r, w) for r in range(n)]
    for r in range(n):
        send, swapped, recv = plans[r]
        assert sum(send) == sum(recv) == 2 * w
        assert swapped == ((2 * r) % n > (2 * r + 1) % n)
    sent = []  # rank s's rows, cut by its send sizes
    for s, (send, swapped, _) in enumerate(plans):
        rows = blocks[2 * s:2 * s + 2].reshape(-1)
        if swapped:
            rows = np.concatenate([rows[w:], rows[:w]])
        cuts = np.cumsum([0] + send)
        sent.append([rows[cuts[j]:cuts[j + 1]] for j in range(n)])
    for r, (_, _, recv) in enumerate(plans):
        got = np.concatenate([sent[s][r] for s in range(n)])
        assert [len(sent[s][r]) for s in range(n)] == recv
        assert np.array_equal(got, np.concatenate(
            [blocks[r], blocks[n + r]])), (n, r)


@pytest.mark.parametrize("mesh", MESHES)
def test_one_mamba_layer_on_the_ranks_matches_single_process(split, mesh):
    from repro_torch.distributed.elastic import local_index
    y1, g1 = split["single"]["y_grads"]
    scale = np.abs(y1).max()
    for res in split["ranks"][mesh]:
        y = res["y"].numpy()
        assert np.abs(y - y1).max() <= OUT_TOL * scale, mesh
        axes = {"data": mesh[0], "model": mesh[1]}
        grid = Grid(axes, **res["coords"])
        for key, got in res["grads"].items():
            want = g1[key]
            if key != "x":  # the rank's slice of the leaf
                want = want[local_index(want.shape,
                                        res["layer_specs"][key], grid)]
            err = np.abs(got.numpy() - want).max()
            assert err <= GRAD_TOL * np.abs(g1[key]).max(), (mesh, key, err)


def test_one_mamba_layer_matches_the_reference(split):
    """The layer on the ranks of (1, 4) against the reference's
    ``mamba_apply`` on the same leaves and input."""
    from repro.configs import ArchConfig as JArch
    cfg = JArch(**dataclasses.asdict(split["cfg"]))
    want = np.asarray(jssm.mamba_apply(
        cfg, {k: jnp.asarray(v) for k, v in split["layer"].items()},
        jnp.asarray(split["x"]), JCtx()))
    for res in split["ranks"][(1, 4)]:
        err = np.abs(res["y"].numpy() - want).max()
        assert err <= LAYER_REF_TOL * np.abs(want).max(), err


@pytest.mark.parametrize("mesh", MESHES)
def test_decode_state_is_laid_out_as_its_specs(split, mesh):
    """After the steps: a rank's h is its di/tp channels of the single
    process's (its rows of the batch), the conv window whole, the same
    bits on every model rank of a data shard and the single process's;
    both as ``decode_state_specs`` places them."""
    from repro_torch.models.params import local_shape
    h1, conv1 = split["single"]["decode"]
    di = conv1.shape[-1]
    by_shard = {}
    for res in split["ranks"][mesh]:
        tp, r = _tp(mesh, res)
        w = di // tp
        n = h1.shape[1] // mesh[0]
        rows = slice(res["coords"]["data"] * n,
                     (res["coords"]["data"] + 1) * n)
        h, conv = res["h"].numpy(), res["conv"].numpy()
        assert h.shape == (h1.shape[0], n, w, h1.shape[-1])
        assert np.abs(h - h1[:, rows, r * w:(r + 1) * w]).max() <= \
            OUT_TOL * np.abs(h1).max(), (mesh, r)
        assert conv.shape == conv1[:, rows].shape
        assert np.abs(conv - conv1[:, rows]).max() <= \
            OUT_TOL * np.abs(conv1).max(), (mesh, r)
        axes = {"data": 1, "model": mesh[1]}  # the state of a shard's rows
        specs = res["state_specs"]
        assert tuple(specs.h)[2] == "model" and tuple(specs.conv)[2:] == (
            None, None)
        assert local_shape(h1[:, rows].shape, specs.h, axes) == h.shape
        assert local_shape(conv1[:, rows].shape, specs.conv, axes) == \
            conv.shape
        by_shard.setdefault(res["coords"]["data"], []).append(conv)
    for same in by_shard.values():
        assert all(np.array_equal(same[0], c) for c in same[1:]), mesh


def test_checkpoint_saved_over_1x4_restores_on_2x2_and_one_process(
        split, torch):
    from repro_torch import tree as tr
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.engine import TrainConfig, make_train_step
    from repro_torch.models import Ctx
    from repro_torch.optim import AdamWConfig, init_opt_state, warmup_cosine
    step_dir = os.path.join(split["ckpt"], "step_2")
    with open(os.path.join(step_dir, "MANIFEST.json")) as f:
        manifest = json.load(f)
    with open(os.path.join(split["single_ckpt"], "step_2",
                           "MANIFEST.json")) as f:
        assert manifest == json.load(f)
    assert sorted(os.listdir(step_dir)) == sorted(
        os.listdir(os.path.join(split["single_ckpt"], "step_2")))
    single = split["single"]["train"]
    names = [leaf["file"] for leaf in manifest["leaves"]]
    for key, fname in zip(single["saved"], names):
        got = np.load(os.path.join(step_dir, fname))
        want = single["saved"][key]
        assert np.abs(got - want).max() <= REF_TOL * np.abs(want).max(), key
    for res in split["saved"]:
        np.testing.assert_allclose(res["losses"], single["losses"],
                                   rtol=PORT_TOL)
    specs = split["restored"][0]["specs"]
    assert {"data", "model"} <= set(specs["groups.mamba.in_proj"])
    for res in split["restored"]:
        assert res["restored_step"] == 2
        np.testing.assert_allclose(res["losses"], single["losses"][2:],
                                   rtol=PORT_TOL)
    model = split["tmodel"]
    params = tr.tree_map(lambda p: p.detach().clone(), model.params())
    tcfg = TrainConfig(opt=AdamWConfig())
    (params, opt), extra = Checkpointer(split["ckpt"]).restore(
        (params, init_opt_state(params, tcfg.opt)))
    assert int(opt.step) == 2 and extra == {"step": 2}
    step = make_train_step(model, Ctx(), tcfg, warmup_cosine(*LR))
    _, _, _, met = step(params, opt, None, {
        k: torch.from_numpy(v) for k, v in split["batches"][2].items()})
    np.testing.assert_allclose(float(met["total_loss"]),
                               single["losses"][2], rtol=PORT_TOL)


def test_held_split_refuses_a_width_not_one_tp_th(torch):
    from repro_torch.configs import get_shape
    from repro_torch.core.planner import make_plan
    from repro_torch.distributed import collectives as coll
    from repro_torch.models import Ctx
    from repro_torch.models.layers import held_split
    from repro_torch.models.ssm import mamba_apply
    cfg = _port_cfg()
    axes = {"data": 1, "model": 4}
    ctx = Ctx(plan=make_plan(cfg, axes, get_shape("decode_32k")),
              mesh=Grid(axes, data=0, model=0))
    di = cfg.ssm_expand * cfg.d_model
    assert held_split(di // 4, di, ctx) and not held_split(di, di, ctx)
    for held in (di // 2, di // 8, di - 1):
        with pytest.raises(ValueError, match="1/tp"):
            held_split(held, di, ctx)
    with pytest.raises(ValueError, match="1/tp"):
        held_split(di // 4, di, Ctx())
    from repro_torch.models.params import initialize
    from repro_torch.models.ssm import mamba_defs
    p = initialize(mamba_defs(cfg), torch.Generator().manual_seed(0),
                   torch.float32, "cpu")
    p["D"] = p["D"][:di // 4]
    x = torch.zeros((1, 4, cfg.d_model))
    with pytest.raises(ValueError, match="in_proj"):
        mamba_apply(cfg, p, x, ctx)
    with pytest.raises(ValueError, match="divide"):
        coll.inner_halves(torch.zeros((1, 4, 5)), None)
