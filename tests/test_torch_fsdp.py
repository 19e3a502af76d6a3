"""FSDP over the data axis and the reference's per-layer remat, on the CPU.

FSDP: each rank a process of its own (``tests/torch_mesh_ranks.py``,
gloo, a FileStore under the test's tmp_path) holds its block of every
leaf under ``Model.param_specs`` at a plan with ``fsdp`` on: a dim of the
larger leaves over ``data`` (``embed``, ``ff``, ``inner`` or ``vocab``, as
the reference's planner places them) besides the heads, ff, vocab and experts
over ``model``. The model all-gathers each leaf where a layer takes it,
inside the layer's remat region, and the gather's backward
reduce-scatters its gradient (``collectives.gather_data``); the train
step sums such a leaf over no other data axis, and compression, AdamW and
the global norm work on the rank's blocks with the whole leaf's
semantics.

Training cases (reduced configs with ``fsdp=True`` and ``remat="full"``,
the reference's too; float32, 3 steps of 4 x 16 tokens at
warmup-cosine(1e-3, 1, 3), tests/test_torch_mesh_train.py's batches):
gemma-7b (tied table over ``(model, data)``) and internvl2-26b (vlm) on
(2, 2) and (2, 1); qwen2-moe's plain path on (4, 1) and, with 2
microbatches, on (2, 1), at the published capacity; phi3.5-moe under
expert parallelism on (2, 2) (``capacity_factor`` 4.0, as
tests/test_torch_mesh_train.py sets it there); jamba, xlstm and whisper
on (2, 1); jamba on (2, 2) (``in_proj`` over ``data`` and ``model``, the
rest of Mamba's ``inner`` over ``model``, its MoE under expert
parallelism, ``capacity_factor`` 4.0); phi3-mini with int8 and top-k compression on (2, 2); and
gemma-7b on (2, 1) at a plan whose global batch (1) does not split over
the data axis, so every rank steps the whole batch and a gathered leaf's
gradient comes back as the rank's block without a sum. Held with
tests/test_torch_mesh_train.py's tolerances and exemption rule,
unchanged: the losses at rtol 1e-5 of the reference's jitted step and the
port's single process, the first gradient (whole leaves rebuilt from the
ranks' blocks) at 1e-4 / 1e-5 of each leaf's largest |g| plus 1e-6, the
parameters after 3 steps at 1e-4 of each leaf's largest value. Every
rank holding a block holds the same bits as the others holding it.

Checkpoints: the (2, 2) gemma run saved after 2 steps writes the single
process's manifest, file names and values; restored on (4, 1) and on one
process, the third step's loss is the uninterrupted run's.
``train_loop(mesh=)`` under the supervisor runs 2 steps over (2, 2), saves,
and a job restarted over (4, 1) resumes for the third, the single
process's ``train_loop`` losses.

Serving at a serve plan (``prefill_32k``, FSDP on) over (2, 2): the
forward (gemma-7b and internvl2-26b) within 2e-3 of the reference's
log_softmax and 1e-5 of the single process's largest logit,
teacher-forced dense and paged decode within 1e-5, and gemma's
``serve_model`` over both layouts token for token the single process's.

Remat: on one process "full" and "dots" give the same bits as "none" in
the loss and every gradient leaf, for six families; "dots" against the
reference's ``jax.value_and_grad`` under its
``checkpoint_dots_with_no_batch_dims`` within 1e-4 of each leaf's
largest |g| plus 1e-6 (every training case above holds "full" on both
sides). Under "full" a layer keeps nothing but its
input for the backward: the tensors autograd saves do not grow with the
depth. On a (2, 1) FSDP mesh no gathered leaf of a layer is alive after
the forward under "full" or "dots" (under "none" they are), and the
gradients are the same bits under all three.
"""
import concurrent.futures
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_arch, reduced_config
from repro.engine import TrainConfig as JTrainConfig
from repro.engine import make_loss_fn as jmake_loss_fn
from repro.models import Ctx as JCtx
from repro.models import build_model as jbuild
from test_torch_mesh_train import (ADAMW_STEPS, LOSS_RTOL, LR, PORT_TOL,
                                   REF_TOL, ULP, _batches, _close, _jflat,
                                   _reference, _single)
from torch_mesh_ranks import Grid, _teacher_forced, run_ranks
from torch_parity import carry, port_cfg

EP_TOL = 2e-3  # tests/test_multidevice.py's bound on log_softmax
# (case, arch, (data, model), options)
CASES = [
    ("gemma_2x2", "gemma_7b", (2, 2), {"save_at": 2}),
    ("gemma_2x1", "gemma_7b", (2, 1), {}),
    ("gemma_2x1_whole_batch", "gemma_7b", (2, 1),
     {"shape": ("train", 16, 1, "train")}),
    ("internvl2_2x2", "internvl2_26b", (2, 2), {}),
    ("internvl2_2x1", "internvl2_26b", (2, 1), {}),
    ("qwen2_moe_4x1", "qwen2_moe", (4, 1), {}),
    ("qwen2_moe_2x1_micro2", "qwen2_moe", (2, 1), {"micro": 2}),
    ("phi35_moe_2x2", "phi35_moe", (2, 2), {}),
    ("jamba_2x1", "jamba15_large", (2, 1), {}),
    ("jamba_2x2", "jamba15_large", (2, 2), {}),
    ("xlstm_2x1", "xlstm_125m", (2, 1), {}),
    ("whisper_2x1", "whisper_small", (2, 1), {}),
    ("phi3_2x2_int8", "phi3_mini", (2, 2), {"scheme": "int8"}),
    ("phi3_2x2_topk", "phi3_mini", (2, 2), {"scheme": "topk"}),
]
NAMES = [c[0] for c in CASES]
SERVE_ARCHS = ["gemma_7b", "internvl2_26b"]
SERVE = {"n_requests": 2, "max_new": 4, "batch_size": 2}
DECODE_STEPS = 3
REMAT_FAMILIES = ["gemma_7b", "qwen2_moe", "jamba15_large", "xlstm_125m",
                  "whisper_small", "internvl2_26b"]
# "full" is every training case's, on both sides
REMAT_REFERENCE = [("jamba15_large", "dots")]


@pytest.fixture(scope="module", autouse=True)
def torch():
    torch = pytest.importorskip("torch")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield torch
    torch.set_num_threads(threads)


def _cfg(arch, mesh=(1, 1), **edit):
    """The reduced config at its published FSDP and remat (what every
    config but phi3-mini, whisper-small and xlstm-125m publishes); under
    expert parallelism at dp 2 with ``capacity_factor`` 4.0."""
    cfg = dataclasses.replace(reduced_config(get_arch(arch)),
                              **{"fsdp": True, "remat": "full", **edit})
    if cfg.is_moe and mesh[0] > 1 and mesh[1] > 1:
        cfg = dataclasses.replace(cfg, capacity_factor=4.0)
    return cfg


def _remat_reference(cfg, batch):
    """``jax.value_and_grad`` of the reference's loss at ``cfg.remat``
    (its ``jax.checkpoint`` of every layer): the loss and the gradient
    under the port's dotted paths. Runs in a process of its own."""
    jm = jbuild(cfg)
    jp = jm.init_params(jax.random.PRNGKey(0), "float32")
    (loss, _), g = jax.jit(jax.value_and_grad(
        jmake_loss_fn(jm, JCtx(), JTrainConfig()), has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), _jflat(g)


def _serve_references(torch, jm, jp, model, batch, dec, serve):
    """The reference's forward, and the port's single process's forward,
    dense and paged teacher-forced decode and (``serve``) serving."""
    from repro_torch.launch.serve import serve_model
    want, _ = jax.jit(lambda p, b: jm.forward(p, b, JCtx()))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tokens = torch.from_numpy(dec)
    with torch.no_grad():
        out = {"want": np.asarray(want),
               "single": model.forward({k: torch.from_numpy(v)
                                        for k, v in batch.items()})[0].numpy(),
               "decode": {"dense": _teacher_forced(model, tokens, None),
                          "paged": _teacher_forced(model, tokens, None,
                                                   kv_layout="paged",
                                                   page_size=4)}}
        if serve:
            out["served"] = {layout: serve_model(
                model, kv_layout=layout, page_size=4, **SERVE)["outputs"]
                for layout in ("dense", "paged")}
    return out


def _loop_single(torch, cfg, state, ckpt):
    from repro_torch.launch.train import train_loop
    return train_loop(port_cfg(cfg), reduced=False, steps=3, batch=4, seq=16,
                      weights=state, device="cpu", ckpt_dir=ckpt,
                      save_every=2, log_every=4)


@pytest.fixture(scope="module")
def fsdp(torch, tmp_path_factory):
    """Every training case's rank results beside the reference's and the
    port's single-process answers; the remat check's ranks; then a world
    of four restoring the (2, 2) checkpoint on (4, 1), resuming the
    supervised loop there and serving over (2, 2). The rank runs go
    while this process computes the answers (the reference's jitted
    steps in spawned processes)."""
    import multiprocessing
    where = tmp_path_factory.mktemp("fsdp")
    cfgs = {name: _cfg(arch, mesh) for name, arch, mesh, _ in CASES}
    batches = {name: _batches(cfgs[name], seed=len(arch))
               for name, arch, _, _ in CASES}
    work = {}
    for name, arch, _, opts in sorted(CASES, key=lambda c: c[1] not in (
            "jamba15_large", "xlstm_125m")):
        work.setdefault((arch, cfgs[name].capacity_factor,
                         opts.get("micro", 1), opts.get("scheme", "none")),
                        []).append(name)
    remat_batch = {arch: _batches(_cfg(arch), seed=7)[0]
                   for arch, _ in REMAT_REFERENCE}
    with concurrent.futures.ProcessPoolExecutor(
            6, mp_context=multiprocessing.get_context("spawn")) as pool:
        ref_runs = {key: pool.submit(
            _reference, cfgs[names[0]], batches[names[0]], key[2], key[3])
            for key, names in work.items()}
        remat_runs = {(arch, remat): pool.submit(
            _remat_reference, _cfg(arch, remat=remat), remat_batch[arch])
            for arch, remat in REMAT_REFERENCE}
        carried = {}
        for name, arch, _, _ in CASES:
            key = (arch, cfgs[name].capacity_factor)
            if key not in carried:
                carried[key] = carry(cfgs[name], "float32")
        jobs, cases = {2: [], 4: []}, {}
        for name, arch, mesh, opts in CASES:
            model = carried[(arch, cfgs[name].capacity_factor)][2]
            case = {"name": name, "cfg": dataclasses.asdict(cfgs[name]),
                    "mesh": mesh, "state": model.state_dict(),
                    "batches": batches[name], "micro": opts.get("micro", 1),
                    "scheme": opts.get("scheme", "none")}
            if "shape" in opts:
                case["shape"] = opts["shape"]
            if "save_at" in opts:
                case.update(save_at=opts["save_at"],
                            save=str(where / "ckpt"))
            jobs[mesh[0] * mesh[1]].append(case)
            cases[name] = dict(case, arch=arch, model=model)
        gemma = cases["gemma_2x2"]
        remat_job = [{"name": "gemma", "cfg": gemma["cfg"], "mesh": (2, 1),
                      "state": gemma["state"],
                      "tokens": gemma["batches"][0]["tokens"]}]
        loop_state = {k: v.clone() for k, v in gemma["state"].items()}
        loop_case = {"name": "loop", "cfg": gemma["cfg"], "batch": 4,
                     "seq": 16, "state": loop_state, "ckpt": str(
                         where / "loop"), "save_every": 2}
        with concurrent.futures.ThreadPoolExecutor(2) as ranks_pool:
            runs = {
                4: ranks_pool.submit(run_ranks, where / "world4", {
                    "checks": ["train", "loop"], "train": jobs[4],
                    "lr": LR, "loop": [dict(loop_case, mesh=(2, 2),
                                            steps=2)]}, world=4),
                2: ranks_pool.submit(run_ranks, where / "world2", {
                    "checks": ["train", "remat"], "train": jobs[2],
                    "lr": LR, "remat": remat_job}, world=2)}
            singles = {name: _single(
                torch, c["model"], c["batches"], c["micro"], c["scheme"],
                save=(str(where / "single") if "save" in c else None))
                for name, c in cases.items()}
            ranks = {world: run.result() for world, run in runs.items()}
        serve_cases, serve_refs = [], {}
        rng = np.random.default_rng(11)
        for arch in SERVE_ARCHS:
            cfg = _cfg(arch)
            jm, jp, model = carry(cfg, "float32")
            batch = {"tokens": rng.integers(0, cfg.vocab_size, (4, 16),
                                            dtype=np.int32)}
            if cfg.family == "vlm":
                batch["patches"] = rng.standard_normal(
                    (4, cfg.n_patches, cfg.d_model)).astype(np.float32)
            dec = rng.integers(0, cfg.vocab_size, (4, DECODE_STEPS),
                               dtype=np.int32)
            serve = arch == "gemma_7b"
            serve_refs[arch] = _serve_references(torch, jm, jp, model,
                                                 batch, dec, serve)
            case = {"name": arch, "cfg": dataclasses.asdict(cfg),
                    "mesh": (2, 2), "shape": "prefill_32k",
                    "state": model.state_dict(), "tokens": batch["tokens"],
                    "patches": batch.get("patches"), "decode": dec}
            if serve:
                case["serve"] = SERVE
            serve_cases.append(case)
        with concurrent.futures.ThreadPoolExecutor(1) as ranks_pool:
            after = ranks_pool.submit(run_ranks, where / "after", {
                "checks": ["train", "loop", "tp"], "lr": LR,
                "train": [{"name": "restore", "cfg": gemma["cfg"],
                           "mesh": (4, 1), "state": gemma["state"],
                           "batches": gemma["batches"][2:],
                           "restore": gemma["save"]}],
                "loop": [dict(loop_case, mesh=(4, 1), steps=3)],
                "tp": serve_cases}, world=4)
            loop_single = _loop_single(torch, cfgs["gemma_2x2"], loop_state,
                                       str(where / "loop_single"))
            after = after.result()
        refs = {name: run.result() for key, run in ref_runs.items()
                for name in work[key]}
        remat_refs = {key: run.result() for key, run in remat_runs.items()}
    out = {name: {"cfg": c["cfg"], "arch": c["arch"], "mesh": c["mesh"],
                  "scheme": c["scheme"], "ref": refs[name],
                  "single": singles[name], "model": c["model"],
                  "batches": c["batches"],
                  "ranks": [r["train"][name] for r in ranks[
                      c["mesh"][0] * c["mesh"][1]]]}
           for name, c in cases.items()}
    out["restore"] = {"ranks": [r["train"]["restore"] for r in after],
                      "ckpt": gemma["save"],
                      "single_ckpt": str(where / "single")}
    out["loop"] = {"first": [r["loop"]["loop"] for r in ranks[4]],
                   "resumed": [r["loop"]["loop"] for r in after],
                   "single": loop_single}
    out["remat"] = [r["remat"]["gemma"] for r in ranks[2]]
    out["remat_refs"], out["remat_batch"] = remat_refs, remat_batch
    out["serve"] = {arch: {"ref": serve_refs[arch],
                           "ranks": [r["tp"][arch] for r in after]}
                    for arch in SERVE_ARCHS}
    return out


def _whole(c, which):
    """Each leaf of ``which`` ("grads" or "params") rebuilt from every
    rank's block, each put where ``local_index`` places its coordinates'
    (blocks of a leaf split over the data and the model axis)."""
    from repro_torch.distributed.elastic import local_index
    axes = {"data": c["mesh"][0], "model": c["mesh"][1]}
    out = {}
    for key, spec in c["ranks"][0]["specs"].items():
        shape = c["ref"]["params"][key].shape
        whole = np.full(shape, np.nan, np.float32)
        for r in c["ranks"]:
            whole[local_index(shape, spec, Grid(axes, **r["coords"]))] = \
                r[which][key].numpy()
        out[key] = whole
    return out


@pytest.mark.parametrize("case", NAMES)
def test_fsdp_places_blocks_over_the_data_axis(fsdp, case):
    """FSDP is on: the embedding's table and at least a quarter of the
    leaves have a dim over ``data``, and every rank holds exactly
    ``local_shape`` of each leaf under its spec."""
    from repro_torch.models.params import local_shape
    c = fsdp[case]
    axes = {"data": c["mesh"][0], "model": c["mesh"][1]}
    specs = c["ranks"][0]["specs"]
    over_data = [k for k, spec in specs.items() if "data" in spec]
    assert "embed.tokens" in over_data, case
    assert len(over_data) >= len(specs) // 4, (case, over_data)
    for res in c["ranks"]:
        assert res["fsdp"] == axes["data"]
        assert res["dp"] == (1 if "whole_batch" in case else axes["data"])
        for key, spec in specs.items():
            want = local_shape(c["ref"]["params"][key].shape, spec, axes)
            assert tuple(res["params"][key].shape) == want, (case, key)


@pytest.mark.parametrize("case", NAMES)
def test_fsdp_losses_match_reference_and_single_process(fsdp, case):
    c = fsdp[case]
    for res in c["ranks"]:
        np.testing.assert_allclose(res["losses"], c["ref"]["losses"],
                                   rtol=LOSS_RTOL, err_msg=case)
        np.testing.assert_allclose(res["losses"], c["single"]["losses"],
                                   rtol=PORT_TOL, err_msg=case)
        np.testing.assert_allclose(res["norms"], c["single"]["norms"],
                                   rtol=PORT_TOL, err_msg=case)
        if c["ref"]["metrics"] is not None:
            for key, want in c["ref"]["metrics"].items():
                np.testing.assert_allclose(
                    res["metrics"][key], want, rtol=LOSS_RTOL, atol=1e-9,
                    err_msg=(case, key))
        assert res["launches"]["flash_attention"] == 0


@pytest.mark.parametrize("case", NAMES)
def test_fsdp_gradients_match_reference_and_single_process(fsdp, case):
    """The first batch's gradient, summed over the data shards (a leaf
    over ``data`` by its gather's reduce-scatter), rebuilt whole from the
    ranks' blocks."""
    c = fsdp[case]
    got = _whole(c, "grads")
    assert got.keys() == c["ref"]["grads"].keys()
    for key, want in c["ref"]["grads"].items():
        assert not np.isnan(got[key]).any(), (case, key)
        scale = np.abs(want).max()
        err = np.abs(got[key] - want).max()
        assert err <= REF_TOL * scale + 1e-6, (case, key, err, scale)
        single = c["single"]["grads"][key]
        err = np.abs(got[key] - single).max()
        assert err <= PORT_TOL * np.abs(single).max() + 1e-6, (case, key)


@pytest.mark.parametrize("case", NAMES)
def test_fsdp_params_after_three_steps_match(fsdp, case):
    """tests/test_torch_mesh_train.py's rule, unchanged."""
    c = fsdp[case]
    got = _whole(c, "params")
    for key, want in c["ref"]["params"].items():
        single = c["single"]["params"][key]
        g1 = np.abs(c["single"]["grads"][key])
        noise = (g1 > 0) & (g1 < ULP * g1.max())
        assert noise.sum() <= noise.size // 10, (case, key, noise.sum())
        if key.endswith(".bk"):
            noise[...] = True
        for other in (want, single):
            assert np.abs(got[key] - other)[noise].max(initial=0) <= \
                ADAMW_STEPS, (case, key)
        _close(got[key][~noise], want[~noise], REF_TOL * np.abs(want).max(),
               c["scheme"], (case, key))
        _close(got[key][~noise], single[~noise],
               REF_TOL * np.abs(single).max(), c["scheme"], (case, key))


@pytest.mark.parametrize("case", NAMES)
def test_fsdp_ranks_holding_a_block_hold_the_same_bits(fsdp, case):
    """The ranks that hold the same block of a leaf (its replicas over
    the axes that do not split it) have the same bits of its first
    gradient and of its value after 3 steps."""
    c = fsdp[case]
    first = c["ranks"][0]
    for res in c["ranks"][1:]:
        for key, spec in first["specs"].items():
            if all(res["coords"][a] == first["coords"][a]
                   for a in ("data", "model") if a in spec):
                for which in ("grads", "params"):
                    assert np.array_equal(res[which][key],
                                          first[which][key]), (case, key)


def test_fsdp_checkpoint_is_the_single_process_s_and_restores_elsewhere(
        fsdp, torch):
    """Saved over (2, 2) after 2 steps, every leaf but the norms split
    over both axes: the single process's manifest, file names and values;
    restored on (4, 1) (the moments following ``opt_state_specs``) and on
    one process, the third step's loss is the uninterrupted run's."""
    from repro_torch import tree as tr
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.engine import TrainConfig, make_train_step
    from repro_torch.models import Ctx
    from repro_torch.optim import AdamWConfig, init_opt_state, warmup_cosine
    r = fsdp["restore"]
    step_dir = os.path.join(r["ckpt"], "step_2")
    with open(os.path.join(step_dir, "MANIFEST.json")) as f:
        mesh_manifest = json.load(f)
    with open(os.path.join(r["single_ckpt"], "step_2",
                           "MANIFEST.json")) as f:
        assert mesh_manifest == json.load(f)
    assert sorted(os.listdir(step_dir)) == sorted(
        os.listdir(os.path.join(r["single_ckpt"], "step_2")))
    c = fsdp["gemma_2x2"]
    two_axes = [k for k, spec in c["ranks"][0]["specs"].items()
                if "data" in spec and "model" in spec]
    assert len(two_axes) >= 5, two_axes
    saved = c["single"]["saved"]
    names = [leaf["file"] for leaf in mesh_manifest["leaves"]]
    for key, fname in zip(saved, names):
        got = np.load(os.path.join(step_dir, fname))
        want = saved[key]
        assert np.abs(got - want).max() <= PORT_TOL * np.abs(want).max(), key
    uninterrupted = c["ranks"][0]["losses"][2]
    for res in r["ranks"]:
        assert res["restored_step"] == 2 and res["coords"]["model"] == 0
        np.testing.assert_allclose(res["losses"], [uninterrupted],
                                   rtol=PORT_TOL)
    model = c["model"]
    params = tr.tree_map(lambda p: p.detach().clone(), model.params())
    tcfg = TrainConfig(opt=AdamWConfig())
    (params, opt), extra = Checkpointer(r["ckpt"]).restore(
        (params, init_opt_state(params, tcfg.opt)))
    assert int(opt.step) == 2 and extra == {"step": 2}
    step = make_train_step(model, Ctx(), tcfg, warmup_cosine(*LR))
    _, _, _, met = step(params, opt, None, {
        k: torch.from_numpy(v) for k, v in c["batches"][2].items()})
    np.testing.assert_allclose(float(met["total_loss"]),
                               c["single"]["losses"][2], rtol=PORT_TOL)


def test_train_loop_under_the_supervisor_resumes_on_another_mesh(fsdp):
    """``train_loop(mesh=)`` at the FSDP plan: 2 steps over (2, 2) and a
    save, then a job over (4, 1) that resumes from it for the third step;
    the losses and gradient norms are the single process's loop's."""
    lp = fsdp["loop"]
    want = lp["single"]
    norms = [h["grad_norm"] for h in want["history"]]
    for res in lp["first"]:
        assert res["restored_from"] == []
        np.testing.assert_allclose(res["losses"], want["losses"][:2],
                                   rtol=PORT_TOL)
        np.testing.assert_allclose(res["norms"], norms[:2], rtol=PORT_TOL)
    for res in lp["resumed"]:
        assert res["restored_from"] == [2]
        np.testing.assert_allclose(res["losses"], want["losses"][2:],
                                   rtol=PORT_TOL)
        np.testing.assert_allclose(res["norms"], norms[2:], rtol=PORT_TOL)


def _log_softmax(a):
    a = np.asarray(a, np.float64)
    m = a.max(-1, keepdims=True)
    return a - m - np.log(np.exp(a - m).sum(-1, keepdims=True))


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_fsdp_serving_matches_reference_and_single_process(fsdp, arch):
    """At the serve plan over (2, 2), FSDP on: each rank's forward on its
    data shard, its teacher-forced dense and paged decode, and serving."""
    s = fsdp["serve"][arch]
    ref = s["ref"]
    scale = np.abs(ref["single"]).max()
    for res in s["ranks"]:
        assert "data" in res["specs"]["embed.tokens"], res["specs"]
        rows = slice(2 * res["coords"]["data"], 2 * res["coords"]["data"] + 2)
        got = res["logits"].numpy()
        assert np.abs(_log_softmax(got) - _log_softmax(
            ref["want"][rows])).max() <= EP_TOL, arch
        assert np.abs(got - ref["single"][rows]).max() <= PORT_TOL * scale
        for layout in ("dense", "paged"):
            for got_t, want_t in zip(res["decode"][layout],
                                     ref["decode"][layout]):
                want_t = want_t.numpy()[rows]
                assert np.abs(got_t.numpy() - want_t).max() <= \
                    PORT_TOL * np.abs(want_t).max(), (arch, layout)
        if "served" in ref:
            assert res["served"] == ref["served"], arch


# ------------------------------------------------------------------ remat
def _port_grads(torch, cfg, batch):
    """The port's single-process loss and gradient leaves at ``cfg`` from
    ``init_params`` seeded 0."""
    from repro_torch import tree as tr
    from repro_torch.engine import make_grad_fn
    from repro_torch.models import Ctx, build_model
    model = build_model(port_cfg(cfg)).init_params(
        torch.Generator().manual_seed(0), torch.float32)
    loss, _, g = make_grad_fn(model, Ctx())(
        model.params(), {k: torch.from_numpy(v) for k, v in batch.items()})
    return loss, tr.leaves(g)


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", REMAT_FAMILIES)
def test_remat_gives_the_same_bits(torch, arch, remat):
    """The loss and every gradient leaf under ``remat`` are those without
    it, bit for bit: the layers run again in the backward on the same
    inputs."""
    cfg = _cfg(arch, remat="none")
    batch = _batches(cfg, seed=5)[0]
    loss, grads = _port_grads(torch, cfg, batch)
    got_loss, got = _port_grads(
        torch, dataclasses.replace(cfg, remat=remat), batch)
    assert torch.equal(got_loss, loss)
    assert all(torch.equal(a, b) for a, b in zip(got, grads))


@pytest.mark.parametrize("arch,remat", REMAT_REFERENCE)
def test_remat_matches_the_reference_at_its_own_remat(fsdp, torch, arch,
                                                      remat):
    """Weights carried from the reference; its ``jax.checkpoint`` (with
    ``checkpoint_dots_with_no_batch_dims`` under "dots") against the
    port's at the same policy."""
    from repro_torch.engine import make_grad_fn
    from repro_torch.models import Ctx
    from repro_torch.models.params import flatten
    cfg = _cfg(arch, remat=remat)
    batch = fsdp["remat_batch"][arch]
    want_loss, want = fsdp["remat_refs"][(arch, remat)]
    model = carry(cfg, "float32")[2]
    loss, _, g = make_grad_fn(model, Ctx())(
        model.params(), {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    got = {k: v.numpy() for k, v in flatten(g).items()}
    assert got.keys() == want.keys()
    for key, w in want.items():
        err = np.abs(got[key] - w).max()
        assert err <= REF_TOL * np.abs(w).max() + 1e-6, (arch, key, err)


@pytest.mark.parametrize("arch", ["gemma_7b", "jamba15_large"])
def test_full_remat_keeps_only_each_layer_s_input(torch, arch):
    """What autograd saves for the backward, seen through
    ``saved_tensors_hooks``, for a stack of 3 x ``period`` layers against
    one of ``period``: under "full" each extra layer saves one tensor, its
    input (B, S, d), which the checkpoint keeps to recompute the rest;
    under "none" each saves many times that."""
    from repro_torch.models import Ctx, build_model
    from repro_torch.models import transformer as tf

    def saved(cfg):
        model = build_model(port_cfg(cfg)).init_params(
            torch.Generator().manual_seed(0), torch.float32,
            trainable=True)
        batch = _batches(cfg, seed=5)[0]
        packed = []

        def pack(t):
            packed.append(t.numel())
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            tf.forward(model.cfg, model.params(), {
                k: torch.from_numpy(v) for k, v in batch.items()}, Ctx())
        return len(packed), sum(packed)

    period = 2 if arch == "jamba15_large" else 1
    cfg = _cfg(arch)
    one_input = 4 * 16 * cfg.d_model  # _batches: 4 x 16 tokens
    extra = 2 * period
    shallow = saved(_cfg(arch, n_layers=period))
    deep = saved(_cfg(arch, n_layers=3 * period))
    assert (deep[0] - shallow[0], deep[1] - shallow[1]) == (
        extra, extra * one_input), (shallow, deep)
    shallow = saved(_cfg(arch, remat="none", n_layers=period))
    deep = saved(_cfg(arch, remat="none", n_layers=3 * period))
    assert deep[1] - shallow[1] > 4 * extra * one_input, (shallow, deep)


def test_no_gathered_leaf_outlives_its_layer(fsdp):
    """gemma-7b over (2, 1) under FSDP: after the forward, the layers'
    gathered leaves are alive for the backward under "none" and none of
    them under "full" or "dots" (each layer gathers again in its
    recompute); the gradients are the same bits under all three."""
    for res in fsdp["remat"]:
        assert res["none"]["tracked"] > 0
        assert res["none"]["alive"] > 0
        for remat in ("full", "dots"):
            assert res[remat]["tracked"] == res["none"]["tracked"]
            assert res[remat]["alive"] == 0, (remat, res[remat]["alive"])
            for a, b in zip(res[remat]["grads"], res["none"]["grads"]):
                assert np.array_equal(a.numpy(), b.numpy()), remat
