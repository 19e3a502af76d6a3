"""The tensor-parallel split of the dense layers over the model axis, on
the CPU: each rank a process of its own (``tests/torch_mesh_ranks.py``,
gloo, a FileStore under the test's tmp_path, one wall limit a run) holds
its slices of every leaf under ``Model.param_specs(plan)`` (heads, ff and
vocab over ``model``, the experts too under expert parallelism) and runs
the split forward, decode and serving with its all-reduces and the
logits' all-gather (``Ctx(plan=, mesh=)``).

* The forward of reduced qwen2.5-32b (GQA, qkv bias), gemma-7b (tied,
  MHA, hd 256), nemotron-4-340b (relu2, untied), phi3-mini, internvl2-26b
  (vlm, with patches), qwen2-moe, phi3.5-moe and jamba-1.5-large (hybrid:
  Mamba's ``inner`` over ``model``, its attention and MoE layers as the
  uniform stack's) on (1, 2), (1, 4) and (2, 2) meshes, float32, a data shard of the batch a data coordinate:
  log_softmax within 2e-3 of the reference's single-device forward
  (tests/test_multidevice.py's bound) on the weights carried across by
  ``models/convert.py``, and within 1e-5 of the largest logit of the
  port's single process; the model ranks of a data shard the same bits.
  The (1, 4) mesh runs the reduced configs' 2 kv heads under the
  "sequence" strategy (prefill: a rank computes the kv head its q head
  reads; decode: its span of a quarter of the positions over both kv
  heads, tests/test_torch_kv_sequence.py); one case at 4 kv heads splits
  the cache by heads.
* Teacher-forced decode over the dense cache and the paged pool, each
  laid out as ``decode_state_specs`` places it: each
  step within 1e-5 of the largest logit of the port's single process, and
  the dense steps within 2e-3 of the reference's decode on log_softmax;
  on (1, 4), ``serve_model`` over both layouts token for token the single
  process's (each collective of a CPU gloo group costs tens of ms, so
  the other meshes do not serve).
* Placement: every rank's leaves have the shapes ``params.local_shape``
  gives under ``param_specs``, and together they rebuild the whole state
  (``load_shards(reshard_state(whole, param_specs))`` round-trips);
  ``init_shards`` draws the very slices of ``init_params``;
  ``Checkpointer.restore(specs=, mesh=)`` onto (1, 2) gives the same
  forward.
* Refusals: the ssm and audio families and the MoE "tp" strategy raise
  on a model axis of tp > 1, each naming its ROADMAP item (FSDP over a
  data axis runs: tests/test_torch_fsdp.py). A q_dim block that cuts a
  head takes the head map ``attention.head_block``
  (tests/test_torch_qdim_split.py runs it over the ranks).
"""
import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_arch, reduced_config
from repro.models import Ctx as JCtx
from torch_mesh_ranks import Grid, _teacher_forced, run_ranks
from torch_parity import carry

EP_TOL = 2e-3  # tests/test_multidevice.py's bound on log_softmax
PORT_TOL = 1e-5  # of the largest logit, against the port's single process
ARCHS = ["qwen25_32b", "gemma_7b", "nemotron4_340b", "phi3_mini",
         "internvl2_26b", "qwen2_moe", "phi35_moe", "jamba15_large"]
MESHES = [(1, 2), (1, 4), (2, 2)]
B, S, STEPS = 4, 16, 4
SERVE = {"n_requests": 2, "max_new": 4, "batch_size": 2}  # on (1, 4)
# (case, arch, mesh)
CASES = [(f"{a}_{m[0]}x{m[1]}", a, m) for a in ARCHS for m in MESHES] + [
    ("nemotron_kv4_1x4", "nemotron4_340b", (1, 4))]


@pytest.fixture(scope="module", autouse=True)
def torch():
    torch = pytest.importorskip("torch")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield torch
    torch.set_num_threads(threads)


def _cfg(name, arch):
    cfg = reduced_config(get_arch(arch))
    if cfg.is_moe:  # no slot dropped: a data shard routes its own tokens
        cfg = dataclasses.replace(cfg, capacity_factor=4.0)
    if "kv4" in name:
        cfg = dataclasses.replace(cfg, n_kv_heads=4)
    return cfg


def _log_softmax(a):
    a = np.asarray(a, np.float64)
    m = a.max(-1, keepdims=True)
    return a - m - np.log(np.exp(a - m).sum(-1, keepdims=True))


def _inputs(cfg, rng):
    """A config's prefill batch (B, S) (with patches for a vlm) and its
    teacher-forced decode tokens (B, STEPS), numpy."""
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S),
                                    dtype=np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return batch, rng.integers(0, cfg.vocab_size, (B, STEPS), dtype=np.int32)


def _references(torch, jm, jp, model, batch, dec):
    """The reference's forward and dense decode, and the port's single
    process's forward, dense and paged decode and serving."""
    from repro_torch.launch.serve import serve_model
    want, _ = jax.jit(lambda p, b: jm.forward(p, b, JCtx()))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    step = jax.jit(lambda p, t, s: jm.decode_step(p, t, s, JCtx()))
    jstate, jdec = jm.init_decode_state(B, STEPS + 4, "float32"), []
    for t in range(STEPS):
        lg, jstate = step(jp, jnp.asarray(dec[:, t:t + 1]), jstate)
        jdec.append(np.asarray(lg))
    tokens = torch.from_numpy(dec)
    with torch.no_grad():
        return {
            "want": np.asarray(want), "jdec": jdec,
            "single": model.forward({k: torch.from_numpy(v)
                                     for k, v in batch.items()})[0].numpy(),
            "decode": {"dense": _teacher_forced(model, tokens, None),
                       "paged": _teacher_forced(model, tokens, None,
                                                kv_layout="paged",
                                                page_size=4)},
            "served": {layout: serve_model(model, kv_layout=layout,
                                           page_size=4, **SERVE)["outputs"]
                       for layout in ("dense", "paged")}}


@pytest.fixture(scope="module")
def tp(torch, tmp_path_factory):
    """Every case's rank results beside the reference's and the port's
    single-process answers on the same weights and inputs. The ranks of
    the (1, 2) mesh and those of the four-rank meshes run at once, while
    this process computes the single-device answers."""
    from repro_torch.checkpoint import Checkpointer
    where = tmp_path_factory.mktemp("tp")
    rng = np.random.default_rng(0)
    jobs, models = {2: [], 4: []}, {}
    for name, arch, mesh in CASES:
        cfg = _cfg(name, arch)
        key = (arch, cfg.n_kv_heads)
        if key not in models:
            models[key] = (*carry(cfg, "float32"), *_inputs(cfg, rng))
        _, _, model, batch, dec = models[key]
        case = {"name": name, "cfg": dataclasses.asdict(cfg), "mesh": mesh,
                "shape": "decode_32k", "state": model.state_dict(),
                "tokens": batch["tokens"], "patches": batch.get("patches"),
                "decode": dec}
        if mesh == (1, 4):
            case["serve"] = SERVE
        if name in ("nemotron4_340b_1x4", "jamba15_large_1x4"):
            case.update(init_shards=True, keep_state=True)
        if name == "qwen25_32b_1x2":
            ckpt = where / "ckpt"
            Checkpointer(str(ckpt)).save(1, model.state_dict())
            case["ckpt_dir"] = str(ckpt)
        jobs[mesh[0] * mesh[1]].append(case)
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        runs = {world: pool.submit(run_ranks, where / f"world{world}", {
            "checks": ["tp"], "tp": cases}, world=world)
            for world, cases in jobs.items()}
        ref = {key: dict(_references(torch, *m), model=m[2])
               for key, m in models.items()}
        ranks = {world: [r["tp"] for r in run.result()]
                 for world, run in runs.items()}
    by_case = {}
    for name, arch, mesh in CASES:
        cfg = _cfg(name, arch)
        by_case[name] = {"cfg": cfg, "mesh": mesh,
                         "ref": ref[(arch, cfg.n_kv_heads)],
                         "ranks": [r[name] for r in
                                   ranks[mesh[0] * mesh[1]]]}
    return by_case


def _rows(c, res):
    """The batch rows of a rank's data shard."""
    n = B // c["mesh"][0]
    di = res["coords"]["data"]
    return slice(di * n, (di + 1) * n)


def _port_err(got, want):
    """max |got - want| over the largest |want|."""
    got = np.asarray(got)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_split_forward_matches_single_device(tp, case):
    c = tp[case]
    want_lp = _log_softmax(c["ref"]["want"])
    for res in c["ranks"]:
        rows = _rows(c, res)
        got = res["logits"].numpy()
        err = np.abs(_log_softmax(got) - want_lp[rows]).max()
        assert err < EP_TOL, (case, res["coords"], err)
        assert _port_err(got, c["ref"]["single"][rows]) < PORT_TOL, (
            case, res["coords"])
    # the model ranks of a data shard hold the same bits after the
    # all-gather
    by_shard = {}
    for res in c["ranks"]:
        by_shard.setdefault(res["coords"]["data"], []).append(res["logits"])
    for same in by_shard.values():
        assert all(np.array_equal(same[0], t) for t in same[1:])


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_split_decode_matches_single_device(tp, case):
    """Teacher-forced steps over the dense cache and the paged pool, each
    laid out as ``decode_state_specs`` places it: a cache of 4 positions
    is (positions, kv heads, hd) on a rank, (4, K/tp, hd) under "heads"
    and (4/tp, K, hd), its span of the sequence, under "sequence"."""
    c = tp[case]
    cfg, ref = c["cfg"], c["ref"]
    hd, K = cfg.resolved_head_dim, cfg.n_kv_heads
    for res in c["ranks"]:
        rows = _rows(c, res)
        tp_size = c["mesh"][1]
        want = ((4, K // tp_size, hd) if res["kv_strategy"] == "heads"
                else (4 // tp_size, K, hd))
        assert res["cache_shape"] == want, (case, res["kv_strategy"])
        for layout in ("dense", "paged"):
            for t, (got, want) in enumerate(zip(res["decode"][layout],
                                                ref["decode"][layout])):
                assert _port_err(got.numpy(), want[rows].numpy()) < \
                    PORT_TOL, (case, layout, t)
        for got, want in zip(res["decode"]["dense"], ref["jdec"]):
            err = np.abs(_log_softmax(got.numpy())
                         - _log_softmax(want[rows])).max()
            assert err < EP_TOL, (case, err)


@pytest.mark.parametrize("case", [c[0] for c in CASES if c[2] == (1, 4)])
def test_split_serving_equals_single_process(tp, case):
    c = tp[case]
    for res in c["ranks"]:
        assert res["served"] == c["ref"]["served"], case


def test_kv_strategies_of_the_cases(tp):
    """(1, 4) at 2 kv heads is the "sequence" strategy: wk and wv whole,
    a rank's prefill computing the one kv head its q head reads; at 4 kv
    heads they split by heads."""
    for case, want in (("qwen25_32b_1x4", "sequence"),
                       ("qwen25_32b_1x2", "heads"),
                       ("nemotron_kv4_1x4", "heads")):
        assert {r["kv_strategy"] for r in tp[case]["ranks"]} == {want}
    seq = tp["qwen25_32b_1x4"]["ranks"][0]["shapes"]
    assert seq["blocks.attn.wk"] == (2, 64, 32)  # whole: 2 heads of 16
    assert seq["blocks.attn.wq"] == (2, 64, 16)  # one q head
    heads = tp["nemotron_kv4_1x4"]["ranks"][0]["shapes"]
    assert heads["blocks.attn.wk"] == (2, 64, 16)


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_every_rank_holds_its_param_specs_slices(tp, case):
    """Every leaf a rank holds has the shape ``local_shape`` gives under
    ``param_specs``; the dense layers' heads, ff and vocab are split, and
    Mamba's ``inner``."""
    from repro_torch.models import build_model
    from repro_torch.models.params import local_shape, tree_paths
    from repro_torch.configs import ArchConfig
    c = tp[case]
    cfg = ArchConfig(**dataclasses.asdict(c["cfg"]))
    defs = tree_paths(build_model(cfg).defs)
    axes = {"data": c["mesh"][0], "model": c["mesh"][1]}
    tp_size = c["mesh"][1]
    for res in c["ranks"]:
        assert set(res["shapes"]) == set(defs)
        for path, d in defs.items():
            assert res["shapes"][path] == local_shape(
                d.shape, res["specs"][path], axes), path
        shapes = res["shapes"]
        L, V = cfg.n_layers, cfg.padded_vocab
        stack = "groups" if cfg.family == "hybrid" else "blocks"
        assert shapes["embed.tokens"] == (V // tp_size, cfg.d_model)
        assert shapes[f"{stack}.attn.wo"][1] == (
            cfg.n_heads * cfg.resolved_head_dim // tp_size)
        if cfg.family == "hybrid":  # both the moe and the mlp subtrees
            n_moe, di = L // cfg.moe_period, cfg.ssm_expand * cfg.d_model
            n_mamba = L - L // cfg.attn_period
            assert shapes["groups.moe.w_up"][1] == cfg.n_experts // tp_size
            assert shapes["groups.moe.router"] == (n_moe, cfg.d_model,
                                                   cfg.n_experts)
            assert shapes["groups.mlp.w_down"][1] == cfg.d_ff // tp_size
            assert shapes["groups.mamba.in_proj"] == (
                n_mamba, cfg.d_model, 2 * di // tp_size)
            assert shapes["groups.mamba.D"] == (n_mamba, di // tp_size)
            assert shapes["groups.mamba.x_proj"][1] == di // tp_size
            assert shapes["groups.mamba_ln.scale"] == (n_mamba, cfg.d_model)
        elif cfg.is_moe:
            assert shapes["blocks.moe.w_up"][1] == cfg.n_experts // tp_size
            assert shapes["blocks.moe.router"] == (L, cfg.d_model,
                                                   cfg.n_experts)
            if cfg.n_shared_experts:
                assert shapes["blocks.moe.shared.w_down"][1] == (
                    cfg.n_shared_experts * cfg.d_ff // tp_size)
        else:
            assert shapes["blocks.mlp.w_down"][1] == cfg.d_ff // tp_size
        if stack == "blocks":
            assert shapes["blocks.ln1.scale"] == (L, cfg.d_model)


def test_load_shards_round_trips_the_whole_state(tp):
    """The four ranks' slices of ``load_shards(reshard_state(whole,
    param_specs))`` put back at their places rebuild every leaf."""
    c = tp["nemotron4_340b_1x4"]
    whole = c["ref"]["model"].state_dict()
    for key, t in whole.items():
        blocks = [r["state"][key] for r in c["ranks"]]
        spec = c["ranks"][0]["specs"][key]
        dim = next((i for i, e in enumerate(spec) if e == "model"), None)
        rebuilt = blocks[0] if dim is None else np.concatenate(blocks, dim)
        if dim is None:
            assert all(np.array_equal(b, blocks[0]) for b in blocks)
        assert np.array_equal(rebuilt, t), key


def test_init_shards_draws_the_single_process_weights(tp):
    assert all(r["init_shards_equal"]
               for r in tp["nemotron4_340b_1x4"]["ranks"])


def test_a_rank_holds_its_contiguous_block_of_in_proj(tp):
    """Rank r of (1, 4) holds columns [r, r + 1) x 2·di/4 of ``in_proj``
    (the spec's contiguous block: ranks 0-1 hold ``xb``'s columns, 2-3
    ``z``'s), its di/4 channels of the per-channel leaves and its rows of
    ``x_proj`` / ``out_proj``; ``init_shards`` draws the same slices."""
    c = tp["jamba15_large_1x4"]
    whole = c["ref"]["model"].state_dict()
    di = c["cfg"].ssm_expand * c["cfg"].d_model
    w = di // 4
    for res in c["ranks"]:
        r = res["coords"]["model"]
        got = res["state"]
        assert np.array_equal(got["groups.mamba.in_proj"],
                              whole["groups.mamba.in_proj"][
                                  ..., 2 * r * w:2 * (r + 1) * w])
        for key in ("D", "conv_b", "dt_bias"):
            assert np.array_equal(got[f"groups.mamba.{key}"], whole[
                f"groups.mamba.{key}"][..., r * w:(r + 1) * w]), key
        for key in ("conv_w", "dt_proj"):
            assert np.array_equal(got[f"groups.mamba.{key}"], whole[
                f"groups.mamba.{key}"][..., r * w:(r + 1) * w]), key
        for key in ("x_proj", "out_proj", "A_log"):
            assert np.array_equal(got[f"groups.mamba.{key}"], whole[
                f"groups.mamba.{key}"][:, r * w:(r + 1) * w]), key
        assert res["init_shards_equal"]


def test_sharded_restore_gives_the_same_forward(tp):
    """``Checkpointer.restore(specs=param_specs, mesh=)`` of the whole
    state onto (1, 2), loaded by ``load_shards``: the same forward."""
    for res in tp["qwen25_32b_1x2"]["ranks"]:
        assert np.array_equal(res["restored_logits"], res["logits"])


def _refusal_ctx(cfg, model_axis, data_axis=1):
    from repro_torch.configs import ArchConfig, get_shape
    from repro_torch.core.planner import make_plan
    from repro_torch.models import Ctx
    cfg = ArchConfig(**dataclasses.asdict(cfg))
    axes = {"data": data_axis, "model": model_axis}
    plan = make_plan(cfg, axes, get_shape("prefill_32k"))
    return cfg, Ctx(plan=plan, mesh=Grid(axes, data=0, model=0),
                    ep_shard_map=True)


@pytest.mark.parametrize("arch,edit,axes,item", [
    ("xlstm_125m", {}, (1, 2), "item 15"),
    ("whisper_small", {}, (1, 2), "item 16"),
    ("qwen2_moe", {}, (1, 3), "item 17")])
def test_what_the_split_does_not_take_refuses(torch, arch, edit, axes,
                                              item):
    """On a model axis of tp > 1: the ssm and audio families and the MoE
    "tp" strategy (4 experts over 3 ranks) raise before any collective,
    naming their ROADMAP items (the hybrid family runs there:
    tests/test_torch_hybrid_split.py and the jamba cases above)."""
    from repro_torch.models import build_model
    cfg = dataclasses.replace(reduced_config(get_arch(arch)), **edit)
    cfg, ctx = _refusal_ctx(cfg, axes[1], axes[0])
    if arch == "qwen2_moe":
        assert ctx.plan.moe_strategy == "tp"
    model = build_model(cfg).init_params(torch.Generator().manual_seed(0),
                                         torch.float32)
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.int32)}
    if cfg.family == "audio":
        batch["frames"] = torch.zeros((1, cfg.encoder_len, cfg.d_model))
    with pytest.raises(NotImplementedError, match=item):
        model.forward(batch, ctx)
    if cfg.family != "audio":
        state = model.init_decode_state(1, 4, torch.float32)
        with pytest.raises(NotImplementedError, match=item):
            model.decode_step(batch["tokens"][:, :1], state, ctx)


def test_a_q_dim_split_inside_a_head_refuses(torch):
    """The head map of a rank's q_dim block (``head_block``; the name is
    kept from when such a block raised): whole heads as before, and 8
    ranks over 4 heads of 16, whose block of 8 columns is half a head, and
    qwen2.5-32b's 40 heads of 128 over 16 ranks, 320 columns (2.5 heads)
    a rank: the heads each block overlaps, its first column's offset in
    the first of them and the kv heads they read."""
    from repro_torch.configs import ArchConfig, get_arch as port_arch
    from repro_torch.models.attention import attn_heads, head_block
    cfg = ArchConfig(**dataclasses.asdict(reduced_config(
        get_arch("qwen25_32b"))))
    assert attn_heads(cfg, 64, 32) == (4, 2)
    assert attn_heads(cfg, 16, 32) == (1, 1)  # G=2: one kv head read
    assert attn_heads(cfg, 32, 32) == (2, 1)
    for r in range(8):  # head r // 2, each half; kv head r // 4
        assert attn_heads(cfg, 8, 32, r) == (1, 1)
        assert head_block(cfg, 8, r) == (r // 2, 1, 8 * (r % 2), (r // 4,))
    full = port_arch("qwen25_32b")
    for r in range(16):  # 3 heads from 2.5 r, cut at 64 on odd ranks
        first = 5 * r // 2
        assert head_block(full, 320, r) == (first, 3, 64 * (r % 2),
                                            (r // 2,))
        assert attn_heads(full, 320, 1024, r) == (3, 1)
    # whole heads whose kv heads fall unevenly: heads 3-5 read 1, 2, 2
    uneven = dataclasses.replace(cfg, n_heads=12, n_kv_heads=6)
    assert head_block(uneven, 48, 1) == (3, 3, 0, (1, 2, 2))
    assert attn_heads(uneven, 48, 96, 1) == (3, 3)
