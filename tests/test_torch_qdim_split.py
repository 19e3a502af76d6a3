"""The q_dim split inside a head, on the CPU: where the model axis does not
divide the q heads (qwen2.5-32b's 40 over the reference's 16), a rank's
block of ``wq``'s q_dim columns (``Model.param_specs``) cuts a head at an
edge, and the rank computes every head its block overlaps
(``attention.head_block``). Each rank a process of its own
(``tests/torch_mesh_ranks.py``, gloo, one process a rank), reduced
qwen2.5-32b with two edits over (data 1, model 4) at ``decode_32k``'s
plan, whose "sequence" kv strategy such a split always takes (the axis
divides neither H nor K = H / G):

* ``n_heads`` 10, ``n_kv_heads`` 2: 2.5 heads a rank (40 of 160
  columns), G = 5, every rank reading one kv head (the full model over
  16: 320 columns, 3 heads, one kv head a rank);
* ``n_heads`` 6, ``n_kv_heads`` 3: 1.5 heads a rank (24 of 96 columns);
  rank 1's heads 1-2 read kv heads 0 and 1.

A third edit, ``n_heads`` 12 and ``n_kv_heads`` 6 (G = 2), gives each rank
3 whole heads whose kv heads fall unevenly (rank 1's heads 3-5 read kv
heads 1, 2, 2): its prefill reads the kv heads repeated to one a q head.

Held, float32: prefill (``check_tp``, through the plain path and through
``ops.flash_attention``'s entry, P1's plain version on CPU tensors)
within 1e-5 of the largest logit of the port's single process and
within 2e-3 of the reference's single-device forward on log_softmax
(tests/test_multidevice.py's bound; the reference's own multi-device run
does not run here, and partitioning changes no value); dense, int8 and
paged teacher-forced decode over the sequence-sharded cache
(``check_kvseq``) within 1e-5 of the single process at every step, and
``serve_model`` over both layouts token for token the single process's;
one training step over the mesh (``check_train``) on the first edit: its
loss within rtol 1e-5 of the single process's, each rank's gradient slice
of ``wq``, ``bq`` and ``wo`` within 1e-4 of its leaf's largest |g|.
"""
import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_arch, reduced_config
from repro.models import Ctx as JCtx
from torch_mesh_ranks import _decode_run, run_ranks
from torch_parity import carry

EP_TOL = 2e-3  # tests/test_multidevice.py's bound on log_softmax
PORT_TOL = 1e-5  # of the largest logit, against the port's single process
GRAD_TOL = 1e-4  # of a leaf's largest |g|
MESH = (1, 4)
B, S, STEPS, MAX_SEQ, PAGE = 4, 16, 6, 10, 2
SERVE = {"n_requests": 2, "max_new": 3, "batch_size": 2}
LR = (1e-3, 1, 3)
EDITS = {"h10_kv2": {"n_heads": 10, "n_kv_heads": 2},
         "h6_kv3": {"n_heads": 6, "n_kv_heads": 3},
         "h12_kv6": {"n_heads": 12, "n_kv_heads": 6}}
DECODED = ("h10_kv2", "h6_kv3")
TRAINED = "h10_kv2"


@pytest.fixture(scope="module", autouse=True)
def torch():
    torch = pytest.importorskip("torch")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield torch
    torch.set_num_threads(threads)


def _cfg(edit):
    return dataclasses.replace(reduced_config(get_arch("qwen25_32b")),
                               **EDITS[edit])


def _batch(cfg, rng):
    tokens = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    labels = tokens.copy()
    labels[0, 5:] = -1
    return {"tokens": tokens, "labels": labels}


def _single(torch, jm, jp, model, batch, dec, decoded, trained):
    """The reference's forward; the port's single process's forward,
    dense / int8 / paged decode and serving, and its first train step's
    loss and gradient."""
    from repro_torch import tree as tr
    from repro_torch.engine import TrainConfig, make_grad_fn, make_train_step
    from repro_torch.launch.serve import serve_model
    from repro_torch.models import Ctx
    from repro_torch.models.params import flatten
    from repro_torch.optim import AdamWConfig, init_opt_state, warmup_cosine
    want, _ = jax.jit(lambda p, b: jm.forward(p, b, JCtx()))(
        jp, {"tokens": jnp.asarray(batch["tokens"])})
    out = {"want": np.asarray(want)}
    tokens = torch.from_numpy(batch["tokens"])
    with torch.no_grad():
        out["single"] = model.forward({"tokens": tokens})[0].numpy()
        if decoded:
            dec = torch.from_numpy(dec)
            for layout, kw in (("dense", {}), ("int8", {"kv_dtype": "int8"}),
                               ("paged", {"kv_layout": "paged",
                                          "page_size": PAGE})):
                out[layout] = _decode_run(model, dec, None, MAX_SEQ, **kw)[0]
            out["served"] = {layout: serve_model(
                model, kv_layout=layout, page_size=PAGE, **SERVE)["outputs"]
                for layout in ("dense", "paged")}
    if trained:
        tcfg = TrainConfig(opt=AdamWConfig())
        params = tr.tree_map(lambda p: p.detach().clone(), model.params())
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        _, _, g = make_grad_fn(model, Ctx(), tcfg)(params, tb)
        out["grads"] = {k: v.detach().numpy() for k, v in flatten(g).items()}
        step = make_train_step(model, Ctx(), tcfg, warmup_cosine(*LR))
        _, _, _, met = step(params, init_opt_state(params, tcfg.opt), None,
                            tb)
        out["loss"] = float(met["total_loss"])
    return out


@pytest.fixture(scope="module")
def qdim(torch, tmp_path_factory):
    """Each edit's rank results beside the reference's and the port's
    single-process answers on the same weights and tokens; one world-4
    run an edit, the two started together while this process computes
    the single answers."""
    where = tmp_path_factory.mktemp("qdim")
    rng = np.random.default_rng(0)
    models, jobs = {}, []
    for edit in EDITS:
        cfg = _cfg(edit)
        jm, jp, model = carry(cfg, "float32")
        batch = _batch(cfg, rng)
        dec = rng.integers(0, cfg.vocab_size, (B, STEPS), dtype=np.int32)
        models[edit] = (jm, jp, model, batch, dec)
        base = {"cfg": dataclasses.asdict(cfg), "mesh": MESH,
                "shape": "decode_32k", "state": model.state_dict()}
        job = {"checks": ["tp"], "tp": [
            dict(base, name=f"{edit}_{path}", tokens=batch["tokens"],
                 use_flash=path == "flash") for path in ("plain", "flash")]}
        if edit in DECODED:
            job["checks"].append("kvseq")
            job["kvseq"] = [dict(base, name=edit, decode=dec,
                                 max_seq=MAX_SEQ, page=PAGE, serve=SERVE)]
        if edit == TRAINED:
            job["checks"].append("train")
            train = {k: v for k, v in base.items() if k != "shape"}
            job.update(lr=LR, train=[dict(train, name=edit,
                                          batches=[batch])])  # train_4k
        jobs.append(job)
    # the third edit's prefill beside the second's run
    jobs[1]["tp"] += jobs.pop()["tp"]
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        runs = [pool.submit(run_ranks, where / f"run{i}", job, world=4)
                for i, job in enumerate(jobs)]
        single = {edit: _single(torch, *m, edit in DECODED, edit == TRAINED)
                  for edit, m in models.items()}
        ranks = [r for run in runs for r in run.result()]
    return {"single": single, "ranks": ranks}


def _port_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _log_softmax(a):
    a = np.asarray(a, np.float64)
    m = a.max(-1, keepdims=True)
    return a - m - np.log(np.exp(a - m).sum(-1, keepdims=True))


def _results(qdim, check, name):
    """Each rank's results of ``check`` for case ``name``."""
    got = [r[check][name] for r in qdim["ranks"]
           if name in r.get(check, {})]
    assert len(got) == MESH[1], (check, name)
    return got


@pytest.mark.parametrize("edit", list(EDITS))
def test_every_rank_cuts_or_reads_as_the_head_map_says(qdim, edit):
    """"sequence" on every rank; a rank holds its W = H·hd/4 columns of
    ``wq``/``bq``, its W rows of ``wo`` and ``wk``/``wv`` whole."""
    cfg = _cfg(edit)
    hd = cfg.resolved_head_dim
    for res in _results(qdim, "tp", f"{edit}_plain"):
        assert res["kv_strategy"] == "sequence"
        W = cfg.n_heads * hd // MESH[1]
        assert res["shapes"]["blocks.attn.wq"] == (2, cfg.d_model, W)
        assert res["shapes"]["blocks.attn.bq"] == (2, W)
        assert res["shapes"]["blocks.attn.wo"] == (2, W, cfg.d_model)
        assert res["shapes"]["blocks.attn.wk"] == (
            2, cfg.d_model, cfg.n_kv_heads * hd)


@pytest.mark.parametrize("path", ["plain", "flash"])
@pytest.mark.parametrize("edit", list(EDITS))
def test_split_prefill_matches_single_device(qdim, edit, path):
    single = qdim["single"][edit]
    want_lp = _log_softmax(single["want"])
    for res in _results(qdim, "tp", f"{edit}_{path}"):
        got = res["logits"].numpy()
        assert _port_err(got, single["single"]) < PORT_TOL, (edit, path)
        err = np.abs(_log_softmax(got) - want_lp).max()
        assert err < EP_TOL, (edit, path, err)


@pytest.mark.parametrize("layout", ["dense", "int8", "paged"])
@pytest.mark.parametrize("edit", DECODED)
def test_split_decode_matches_single_process(qdim, edit, layout):
    want = qdim["single"][edit][layout]
    for res in _results(qdim, "kvseq", edit):
        assert res["span"] == (res["coords"]["model"], MESH[1])
        steps = res[layout]["steps"]
        assert len(steps) == STEPS
        for t, (got, w) in enumerate(zip(steps, want)):
            assert _port_err(got, w) < PORT_TOL, (edit, layout, t)


@pytest.mark.parametrize("edit", DECODED)
def test_split_serving_equals_single_process(qdim, edit):
    for res in _results(qdim, "kvseq", edit):
        assert res["served"] == qdim["single"][edit]["served"], edit


def test_split_train_step_loss_matches_single_process(qdim):
    want = qdim["single"][TRAINED]["loss"]
    for res in _results(qdim, "train", TRAINED):
        np.testing.assert_allclose(res["losses"][0], want, rtol=PORT_TOL)


@pytest.mark.parametrize("leaf", ["wq", "bq", "wo"])
def test_split_gradient_slices_match_single_process(qdim, leaf):
    """Each rank's block of the leaf's gradient (the exchange's backward
    brings it the gradient of its columns that a neighbour read) against
    the same block of the single process's."""
    key = f"blocks.attn.{leaf}"
    whole = qdim["single"][TRAINED]["grads"][key]
    for res in _results(qdim, "train", TRAINED):
        spec = res["specs"][key]
        dim = next(i for i, e in enumerate(spec) if e == "model")
        got = res["grads"][key].numpy()
        n = got.shape[dim]
        r = res["coords"]["model"]
        want = np.take(whole, np.arange(r * n, (r + 1) * n), axis=dim)
        err = np.abs(got - want).max() / np.abs(whole).max()
        assert err < GRAD_TOL, (leaf, r, err)


def test_the_heads_layout_refuses_a_block_that_cuts_a_head(torch):
    """Under the "heads" kv strategy the model axis divides K, so H: a
    block that cuts a head there raises ValueError, in the head count and
    in the decode over the cache split by heads (no plan makes one)."""
    from repro_torch.configs import ArchConfig
    from repro_torch.models import build_model
    from repro_torch.models import transformer as tf
    from repro_torch.models.attention import attn_heads
    cfg = ArchConfig(**dataclasses.asdict(_cfg("h10_kv2")))
    with pytest.raises(ValueError, match="splits a head"):
        attn_heads(cfg, 40, 16)  # kv heads split, a q block of 2.5 heads
    model = build_model(cfg).init_params(torch.Generator().manual_seed(0),
                                         torch.float32)
    p = {k: v[0] for k, v in model.params()["blocks"]["attn"].items()}
    p.update(wq=p["wq"][:, :40], bq=p["bq"][:40], wo=p["wo"][:40])
    state = model.init_decode_state(1, 4, torch.float32)
    with pytest.raises(ValueError, match="splits a head"):
        tf._attn_decode(cfg, p, torch.zeros(1, 1, cfg.d_model), state, 0)
