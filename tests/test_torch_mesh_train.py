"""Training over the (data, model) mesh on the split placement, on the
CPU: each rank a process of its own (``tests/torch_mesh_ranks.py``'s
``check_train``, gloo, a FileStore under the test's tmp_path) holds its
slices of every leaf under ``Model.param_specs`` (heads, ff and vocab over
``model``, the experts too under expert parallelism), takes its data
shard of each global batch (``engine.shard_batch``) and runs
``make_train_step`` under ``Ctx(plan=, mesh=)``: the split products'
backward (``layers.to_model`` / ``model_sum``), the loss over the split
vocab, the denominators and the MoE aux over the global batch, one
all-reduce a leaf over the data axis, compression and AdamW on the rank's
slices.

Cases, float32, 3 steps of 4 x 16 tokens at warmup-cosine(1e-3, 1, 3):
phi3-mini on (1, 2) and (2, 2) (also with 2 microbatches, and with int8
and top-k compression on (1, 2)), gemma-7b (tied table; 2 kv heads on 4
ranks: the "sequence" strategy, ``wk``/``wv`` whole and sliced),
internvl2-26b (vlm) on (2, 2), qwen2-moe (expert parallelism, qkv bias,
"sequence") on (1, 4), phi3.5-moe (expert parallelism, the aux at dp 2)
on (2, 2) with ``capacity_factor`` 4.0, as tests/test_multidevice.py sets
it (under expert parallelism a data shard ranks its own tokens, as the
reference's shard_map does), jamba on (1, 2) (Mamba's ``inner`` over
``model``: the ``in_proj`` redistribution, the partial ``x_proj`` sums
and P4's backward on the rank's channels; its MoE under expert
parallelism), qwen2-moe on (2, 1) with 2 microbatches and jamba, xlstm
and whisper on (2, 1): the plain MoE path at the published capacity,
whose slots are ranked over the global batch, drops included.
Labels are masked (-1) unevenly between the data shards.

Held, as tests/test_torch_train.py holds the single process: each step's
total loss within rtol 1e-5 of the reference's jitted
``repro.engine.make_train_step``; the first batch's gradient (after the
data axes' sum), gathered whole, within 1e-4 of each leaf's largest |g|
plus 1e-6 of ``jax.value_and_grad`` of the reference's ``make_loss_fn``
(with 2 microbatches, the mean of the two microbatches' gradients); the
parameters after 3 steps within 1e-4 of each leaf's largest value (with
compression ``_close``'s rule: up to 0.1% of a leaf's entries may differ
by up to three AdamW steps). Against the port's single process the losses
and gradient norms at rtol 1e-5, the gradients within 1e-5 of the largest
|g| plus 1e-6, the parameters as against the reference: AdamW divides
each entry's gradient by its own root mean square, so an entry whose
gradient is small within its leaf turns the rounding of sums taken in
another order (about 1e-6 of the leaf's largest |g|) into a relative
error of its update, and the biases, which start at zero, have a largest
value of a few learning rates. An entry whose gradient lies at rounding
level takes AdamW steps of that noise normalised to the learning rate's
size, which no tolerance on the values holds. Two kinds are held to
three AdamW steps instead, their gradients as every other's: an entry
whose first gradient in the single process is not zero but under one
float32 ulp of its leaf's largest |g| (2**-23 of it; at most a tenth of
a leaf: some of xlstm's sLSTM input-gate bias, which the normaliser state
cancels, some of jamba's ``x_proj``), and the attention key biases
(``bk``), whose gradient is a sum over the keys of the softmax's input
gradients, which add to zero for every query: zero in exact arithmetic
without RoPE (whisper's, under 1e-8 of the model's largest |g|), a sum
that cancels down to the rotations' residue with it (qwen2-moe's).
After 3 steps the
whole leaves hold the same bits on every rank and every leaf the same
bits on the data replicas. A checkpoint saved over (2, 2) after 2 steps
has the single process's manifest and file names and its values, and
restored on a (1, 2) mesh (a world of two) it steps on to the
uninterrupted run's third loss.
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
from repro.engine import make_train_step as jmake_train_step
from repro.engine.compression import CompressionConfig as JCompression
from repro.models import Ctx as JCtx
from repro.models import build_model as jbuild
from repro.optim import AdamWConfig as JAdamW
from repro.optim import init_opt_state as jinit_opt_state
from repro.optim import warmup_cosine as jwarmup_cosine
from torch_mesh_ranks import run_ranks
from torch_parity import carry

B, S, STEPS, LR = 4, 16, 3, (1e-3, 1, 3)
REF_TOL, PORT_TOL, LOSS_RTOL = 1e-4, 1e-5, 1e-5
# (case, arch, (data, model), options)
CASES = [
    ("phi3_1x2", "phi3_mini", (1, 2), {}),
    ("phi3_2x2", "phi3_mini", (2, 2), {"save_at": 2}),
    ("phi3_2x2_micro2", "phi3_mini", (2, 2), {"micro": 2}),
    ("phi3_1x2_int8", "phi3_mini", (1, 2), {"scheme": "int8"}),
    ("phi3_1x2_topk", "phi3_mini", (1, 2), {"scheme": "topk"}),
    ("gemma_1x4", "gemma_7b", (1, 4), {}),
    ("internvl2_2x2", "internvl2_26b", (2, 2), {}),
    ("qwen2_moe_1x4", "qwen2_moe", (1, 4), {}),
    ("phi35_moe_2x2", "phi35_moe", (2, 2), {}),
    ("qwen2_moe_2x1_micro2", "qwen2_moe", (2, 1), {"micro": 2}),
    ("jamba_2x1", "jamba15_large", (2, 1), {}),
    ("jamba_1x2", "jamba15_large", (1, 2), {}),
    ("xlstm_2x1", "xlstm_125m", (2, 1), {}),
    ("whisper_2x1", "whisper_small", (2, 1), {}),
]
NAMES = [c[0] for c in CASES]
ADAMW_STEPS = 3 * 2 * LR[0]  # three steps of at most twice the peak lr
ULP = 2.0 ** -23  # a first gradient under this much of its leaf's largest


@pytest.fixture(scope="module", autouse=True)
def torch():
    torch = pytest.importorskip("torch")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield torch
    torch.set_num_threads(threads)


def _cfg(arch, mesh):
    """The reduced config; under expert parallelism at dp 2 (a model axis
    of more than one rank) with ``capacity_factor`` 4.0."""
    cfg = reduced_config(get_arch(arch))
    if cfg.is_moe and mesh[0] > 1 and mesh[1] > 1:
        cfg = dataclasses.replace(cfg, capacity_factor=4.0)
    return cfg


def _batches(cfg, seed):
    """STEPS global batches; labels masked unevenly between the data
    shards (rows 0-1 lose 16 of 30 targets, rows 2-3 one)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        tokens = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
        labels = tokens.copy()
        labels[0, 5:] = -1
        labels[1, -5:] = -1
        labels[3, 2] = -1
        b = {"tokens": tokens, "labels": labels}
        if cfg.family == "audio":
            b["frames"] = rng.standard_normal(
                (B, cfg.encoder_len, cfg.d_model)).astype(np.float32)
        if cfg.family == "vlm":
            b["patches"] = rng.standard_normal(
                (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


def _flat(tree):
    """Copies of the leaves (the train step updates its state in place)."""
    from repro_torch.models.params import flatten
    return {k: np.array(v.detach() if hasattr(v, "detach") else v)
            for k, v in flatten(tree).items()}


def _reference(cfg, batches, micro, scheme):
    """The reference's jitted 3 steps (total losses, final parameters)
    and its first batch's loss, metrics and gradient (the microbatches'
    mean with 2 of them), from ``init_params(PRNGKey(0), "float32")``, the
    weights ``carry`` gives the port. Runs in a process of its own."""
    jm = jbuild(cfg)
    jp = jm.init_params(jax.random.PRNGKey(0), "float32")
    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    grad = jax.jit(jax.value_and_grad(
        jmake_loss_fn(jm, JCtx(), JTrainConfig()), has_aux=True))
    if micro == 1:
        (_, met), g = grad(jp, jb[0])
        metrics = {k: float(v) for k, v in met.items()}
    else:
        parts = [grad(jp, {k: v[i * B // micro:(i + 1) * B // micro]
                           for k, v in jb[0].items()})[1]
                 for i in range(micro)]
        g = jax.tree.map(lambda *a: sum(a) / micro, *parts)
        metrics = None
    tcfg = JTrainConfig(microbatches=micro, opt=JAdamW(),
                        compression=JCompression(scheme, topk_frac=0.05))
    step = jax.jit(jmake_train_step(jm, JCtx(), tcfg, jwarmup_cosine(*LR)))
    opt = jinit_opt_state(jp, tcfg.opt)
    err = (jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), jp)
           if scheme != "none" else None)
    losses = []
    for b in jb:
        jp, opt, err, met = step(jp, opt, err, b)
        losses.append(float(met["total_loss"]))
    return {"losses": losses, "metrics": metrics,
            "grads": _jflat(g), "params": _jflat(jp)}


def _jflat(tree):
    """A reference tree's leaves as numpy arrays under the port's dotted
    paths."""
    return {".".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _single(torch, model, batches, micro, scheme, save=None):
    """The port's single process: 3 steps (losses, gradient norms, final
    parameters), the first batch's gradient and metrics; with ``save``,
    its (params, opt) after 2 steps written there."""
    from repro_torch import tree as tr
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.engine import (CompressionConfig, TrainConfig,
                                    init_error_state, make_grad_fn,
                                    make_train_step)
    from repro_torch.models import Ctx
    from repro_torch.optim import AdamWConfig, init_opt_state, warmup_cosine
    tcfg = TrainConfig(microbatches=micro, opt=AdamWConfig(),
                       compression=CompressionConfig(scheme, 0.05))
    params = tr.tree_map(lambda p: p.detach().clone(), model.params())
    step = make_train_step(model, Ctx(), tcfg, warmup_cosine(*LR))
    opt = init_opt_state(params, tcfg.opt)
    err = init_error_state(params) if scheme != "none" else None
    out = {"losses": [], "norms": []}
    for i, b in enumerate(batches):
        tb = {k: torch.from_numpy(v) for k, v in b.items()}
        if i == 0:
            _, met, g = make_grad_fn(model, Ctx(), tcfg)(params, tb)
            out["grads"] = _flat(g)
            out["metrics"] = {k: float(v) for k, v in met.items()}
        params, opt, err, met = step(params, opt, err, tb)
        out["losses"].append(float(met["total_loss"]))
        out["norms"].append(float(met["grad_norm"]))
        if save and i + 1 == 2:
            Checkpointer(save).save(2, (params, opt), {"step": 2})
            out["saved"] = _flat(params)
    out["params"] = _flat(params)
    out["v"] = _flat(opt.v)
    return out


@pytest.fixture(scope="module")
def mesh_train(torch, tmp_path_factory):
    """Every case's rank results beside the reference's and the port's
    single-process answers on the same weights and batches. The world-2
    and world-4 ranks run at once while this process computes the
    answers (the reference's jitted steps on a few threads); then a world
    of two restores the (2, 2) checkpoint on (1, 2)."""
    import multiprocessing
    where = tmp_path_factory.mktemp("mesh_train")
    cfgs = {name: _cfg(arch, mesh) for name, arch, mesh, _ in CASES}
    batches = {name: _batches(cfgs[name], seed=len(arch))
               for name, arch, _, _ in CASES}
    # the reference's answers in processes of their own (its tracing and
    # compiling hold one interpreter), the longest first; one a config
    # and train config, shared by the meshes that train it
    work = {}
    for name, arch, _, opts in sorted(CASES, key=lambda c: c[1] not in (
            "jamba15_large", "xlstm_125m")):
        work.setdefault((arch, cfgs[name].capacity_factor,
                         opts.get("micro", 1), opts.get("scheme", "none")),
                        []).append(name)
    with concurrent.futures.ProcessPoolExecutor(
            6, mp_context=multiprocessing.get_context("spawn")) as refs_pool:
        ref_runs = {key: refs_pool.submit(
            _reference, cfgs[names[0]], batches[names[0]], key[2], key[3])
            for key, names in work.items()}
        carried = {}
        for name, arch, _, _ in CASES:
            key = (arch, cfgs[name].capacity_factor)
            if key not in carried:
                carried[key] = carry(cfgs[name], "float32")[2]
        jobs, cases = {2: [], 4: []}, {}
        for name, arch, mesh, opts in CASES:
            model = carried[(arch, cfgs[name].capacity_factor)]
            case = {"name": name, "cfg": dataclasses.asdict(cfgs[name]),
                    "mesh": mesh, "state": model.state_dict(),
                    "batches": batches[name], "micro": opts.get("micro", 1),
                    "scheme": opts.get("scheme", "none")}
            if "save_at" in opts:
                case.update(save_at=opts["save_at"],
                            save=str(where / "ckpt"))
            jobs[mesh[0] * mesh[1]].append(case)
            cases[name] = dict(case, arch=arch, model=model)
        with concurrent.futures.ThreadPoolExecutor(2) as ranks_pool:
            runs = {world: ranks_pool.submit(
                run_ranks, where / f"world{world}",
                {"checks": ["train"], "train": job, "lr": LR}, world=world)
                for world, job in jobs.items()}
            singles = {name: _single(
                torch, c["model"], c["batches"], c["micro"], c["scheme"],
                save=(str(where / "single") if "save" in c else None))
                for name, c in cases.items()}
            ranks = {world: [r["train"] for r in run.result()]
                     for world, run in runs.items()}
        refs = {name: run.result() for key, run in ref_runs.items()
                for name in work[key]}
    c = cases["phi3_2x2"]
    restore = run_ranks(where / "restore", {"checks": ["train"], "lr": LR,
                                            "train": [{
        "name": "restore", "cfg": c["cfg"], "mesh": (1, 2),
        "state": c["state"], "batches": c["batches"][2:],
        "restore": c["save"]}]}, world=2)
    out = {name: {"cfg": c["cfg"], "arch": c["arch"], "mesh": c["mesh"],
                  "scheme": c["scheme"], "ref": refs[name],
                  "single": singles[name],
                  "ranks": [r[name] for r in ranks[c["mesh"][0]
                                                    * c["mesh"][1]]]}
           for name, c in cases.items()}
    out["restore"] = {"ranks": [r["train"]["restore"] for r in restore],
                      "ckpt": c["save"], "single_ckpt": str(where / "single")}
    return out


def _whole(c, which):
    """Each leaf of ``which`` ("grads" or "params") rebuilt from the
    ranks of data shard 0, their blocks put back along the split dim."""
    ranks = [r for r in c["ranks"] if r["coords"]["data"] == 0]
    ranks.sort(key=lambda r: r["coords"]["model"])
    out = {}
    for key, spec in ranks[0]["specs"].items():
        blocks = [r[which][key].numpy() for r in ranks]
        dim = next((i for i, e in enumerate(spec) if e is not None), None)
        out[key] = blocks[0] if dim is None else np.concatenate(blocks, dim)
    return out


@pytest.mark.parametrize("case", NAMES)
def test_mesh_losses_match_reference_and_single_process(mesh_train, case):
    c = mesh_train[case]
    for res in c["ranks"]:
        np.testing.assert_allclose(res["losses"], c["ref"]["losses"],
                                   rtol=LOSS_RTOL, err_msg=case)
        np.testing.assert_allclose(res["losses"], c["single"]["losses"],
                                   rtol=PORT_TOL, err_msg=case)
        np.testing.assert_allclose(res["norms"], c["single"]["norms"],
                                   rtol=PORT_TOL, err_msg=case)
        if c["ref"]["metrics"] is not None:  # the global batch's metrics
            for key, want in c["ref"]["metrics"].items():
                np.testing.assert_allclose(
                    res["metrics"][key], want, rtol=LOSS_RTOL, atol=1e-9,
                    err_msg=(case, key))
        assert res["launches"]["flash_attention"] == 0


@pytest.mark.parametrize("case", NAMES)
def test_mesh_gradients_match_reference_and_single_process(mesh_train, case):
    """The first batch's gradient, after the data axes' sum, gathered
    whole; every data rank holds the same bits of it."""
    c = mesh_train[case]
    got = _whole(c, "grads")
    assert got.keys() == c["ref"]["grads"].keys()
    for key, want in c["ref"]["grads"].items():
        scale = np.abs(want).max()
        err = np.abs(got[key] - want).max()
        assert err <= REF_TOL * scale + 1e-6, (case, key, err, scale)
        single = c["single"]["grads"][key]
        err = np.abs(got[key] - single).max()
        assert err <= PORT_TOL * np.abs(single).max() + 1e-6, (case, key)
    by_model = {}
    for res in c["ranks"]:
        by_model.setdefault(res["coords"]["model"], []).append(res["grads"])
    for same in by_model.values():
        for g in same[1:]:
            assert all(np.array_equal(g[k], same[0][k]) for k in g), case


def _close(got, want, atol, scheme, name):
    """tests/test_torch_train.py's rule: within ``atol``; with compression
    up to 0.1% of the entries (at least one) may instead differ by up to
    three AdamW steps (an entry within rounding of a quantisation boundary
    goes either way)."""
    if scheme == "none":
        np.testing.assert_allclose(got, want, rtol=0, atol=atol,
                                   err_msg=name)
        return
    bad = np.abs(got - want) > atol
    assert bad.sum() <= max(1, bad.size // 1000), (name, bad.sum())
    assert np.abs(got - want).max() <= max(atol, ADAMW_STEPS), name


@pytest.mark.parametrize("case", NAMES)
def test_mesh_params_after_three_steps_match(mesh_train, case):
    c = mesh_train[case]
    got = _whole(c, "params")
    for key, want in c["ref"]["params"].items():
        single = c["single"]["params"][key]
        g1 = np.abs(c["single"]["grads"][key])
        noise = (g1 > 0) & (g1 < ULP * g1.max())  # the module's text
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
def test_mesh_replicas_hold_the_same_bits(mesh_train, case):
    """After 3 steps: a leaf held whole has the same bits on every rank,
    and every leaf the same bits on the data replicas of a model slice."""
    c = mesh_train[case]
    first = c["ranks"][0]
    for res in c["ranks"][1:]:
        for key, spec in first["specs"].items():
            same_slice = res["coords"]["model"] == first["coords"]["model"]
            if same_slice or all(e is None for e in spec):
                assert np.array_equal(res["params"][key],
                                      first["params"][key]), (case, key)


def test_mesh_checkpoint_is_the_single_process_s_and_restarts_elsewhere(
        mesh_train):
    """Saved over (2, 2) after 2 steps: the single process's manifest and
    file names, its values within 1e-5 of each leaf's largest (the
    parameters); restored on (1, 2), a world of two, at step 2 with the
    moments following ``opt_state_specs``, the third step's loss is the
    uninterrupted run's."""
    r = mesh_train["restore"]
    with open(os.path.join(r["ckpt"], "step_2", "MANIFEST.json")) as f:
        mesh_manifest = json.load(f)
    with open(os.path.join(r["single_ckpt"], "step_2",
                           "MANIFEST.json")) as f:
        single_manifest = json.load(f)
    assert mesh_manifest == single_manifest
    assert sorted(os.listdir(os.path.join(r["ckpt"], "step_2"))) == sorted(
        os.listdir(os.path.join(r["single_ckpt"], "step_2")))
    c = mesh_train["phi3_2x2"]
    saved = c["single"]["saved"]
    names = [leaf["file"] for leaf in mesh_manifest["leaves"]]
    for key, fname in zip(saved, names):  # the parameters lead, in order
        assert fname.split("_", 1)[1].startswith("0_" + key.replace(
            ".", "_")), (fname, key)
        got = np.load(os.path.join(r["ckpt"], "step_2", fname))
        want = saved[key]
        assert np.abs(got - want).max() <= PORT_TOL * np.abs(want).max(), key
    uninterrupted = c["ranks"][0]["losses"][2]
    for res in r["ranks"]:
        assert res["restored_step"] == 2 and res["coords"]["data"] == 0
        np.testing.assert_allclose(res["losses"], [uninterrupted],
                                   rtol=PORT_TOL)
        np.testing.assert_allclose(res["losses"],
                                   [c["single"]["losses"][2]], rtol=PORT_TOL)


def test_shard_batch_takes_its_rows_of_each_microbatch(torch):
    """Data shard r of 2 with 2 microbatches of a batch of 8 rows: rows
    [2r, 2r + 2) of microbatch 0 (rows 0-3) and of microbatch 1 (rows
    4-7), in that order; without microbatches the r-th block of 4."""
    from torch_mesh_ranks import Grid

    from repro_torch.configs import get_shape
    from repro_torch.core.planner import make_plan
    from repro_torch.engine import shard_batch
    from repro_torch.models import Ctx
    axes = {"data": 2, "model": 1}
    plan = make_plan(_port_cfg("phi3_mini"), axes, get_shape("train_4k"))
    batch = {"tokens": torch.arange(8)[:, None].repeat(1, 3)}
    for r in range(2):
        ctx = Ctx(plan=plan, mesh=Grid(axes, data=r, model=0))
        got = shard_batch(batch, ctx, 2)["tokens"][:, 0].tolist()
        assert got == [2 * r, 2 * r + 1, 4 + 2 * r, 5 + 2 * r]
        got = shard_batch(batch, ctx, 1)["tokens"][:, 0].tolist()
        assert got == [4 * r + i for i in range(4)]
    with pytest.raises(ValueError, match="microbatches"):
        shard_batch(batch, ctx, 3)


def _port_cfg(arch, **edit):
    from repro_torch.configs import get_arch as tget
    from repro_torch.configs import reduced_config as treduced
    return dataclasses.replace(treduced(tget(arch)), **edit)
