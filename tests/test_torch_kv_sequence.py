"""Decode over a KV cache split along the sequence (the "sequence" kv
strategy: the kv heads do not divide the model axis), on the CPU.

The plain pieces, against the reference's oracles at 2e-5 in float32:

* the paged kernel's partial mode (``ref.paged_attention_partial_ref``,
  what ``ops.paged_attention_partial`` runs on CPU tensors) over each
  shard of a pool split 1-5 ways by ``KVPageManager``, each shard's local
  table and valid positions (``kvcache.shard_lengths``), the shards'
  partials merged in shard order (``attention.merge_partials``), against
  ``repro.kernels.ref.paged_attention_ref`` over the whole pool: rows
  whose later shards are empty, a hole, a length-0 row (an idle slot: no
  shard holds a valid position, so the merge gives zeros where the oracle
  gives the mean of V) and a page stolen from a shard that ran dry (it
  sits on another shard, so the round-robin rule alone would misplace it);
* the dense span partials (``attention.decode_partial``) over a cache
  rounded up to a multiple of the spans, merged in span order, against the
  reference's ``decode_attention``.

On the ranks (``tests/torch_mesh_ranks.py``'s ``check_kvseq``, gloo, one
process a rank): reduced qwen2.5-32b, internvl2-26b, phi3.5-moe and
jamba-1.5-large on a (data 1, model 4) mesh at ``decode_32k``'s plan, and
jamba with one kv head on (2, 2) at ``long_500k``'s, where the batch is
replicated and the sequence spreads over both axes (four spans). Each
rank decodes teacher-forced from an empty state over the dense cache, the
int8 cache and the paged pool, laid out as ``decode_state_specs`` places
it (its span of 12 positions rounded up from 10, every kv head; or its
shard of a pool of 2-token pages). Held: every step within 1e-5 of the
largest logit of the port's single process (the mesh tests' bound), the
dense steps within 2e-3 of the reference's single-device decode on
log_softmax; the spans put together in spec order are the single
process's cache (dense and int8) and the shards' pages its pool's: where
a layer's input is the embedding alone (the first layer of the uniform
stacks: the embedding's all-reduce adds one non-zero row, exactly) bit
for bit, deeper (after the model axis's sums, whose order differs from
one product's) within 1e-5 of the largest value; the padded positions
and the pages past the tokens zero. On (1, 4) ``serve_model`` over both
layouts gives the single process's tokens.
"""
import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_arch, reduced_config
from repro.kernels import ref as jref
from repro.models import Ctx as JCtx
from repro.models.attention import decode_attention as jdecode_attention
from torch_mesh_ranks import _decode_run, run_ranks
from torch_parity import carry

TOL = 2e-5  # float32, tests/test_kernels.py's
EP_TOL = 2e-3  # tests/test_multidevice.py's bound on log_softmax
PORT_TOL = 1e-5  # of the largest value, against the port's single process
B, STEPS, MAX_SEQ, PAGE = 4, 6, 10, 2
SERVE = {"n_requests": 2, "max_new": 3, "batch_size": 2}
# (case, arch, mesh, shape, edit)
CASES = [(f"{a}_1x4", a, (1, 4), "decode_32k", {})
         for a in ("qwen25_32b", "internvl2_26b", "phi35_moe",
                   "jamba15_large")] + [
    ("jamba_kv1_2x2", "jamba15_large", (2, 2), "long_500k",
     {"n_kv_heads": 1})]
SERVED = ("qwen25_32b_1x4", "jamba15_large_1x4")


@pytest.fixture(scope="module", autouse=True)
def torch():
    torch = pytest.importorskip("torch")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield torch
    torch.set_num_threads(threads)


# ------------------------------------------------------- the plain pieces
def _pool(rng, P, ps, K, hd):
    return (rng.standard_normal((P, ps, K, hd), dtype=np.float32),
            rng.standard_normal((P, ps, K, hd), dtype=np.float32))


def _oracle(q, kp, vp, tables, lengths):
    return np.asarray(jref.paged_attention_ref(
        *(jnp.asarray(a) for a in (q, kp, vp, tables, lengths))))


def _merged_shards(torch, q, kp, vp, tables, seq_pages, lengths, ps):
    """Each shard's partial over its sub-pool, local table and valid
    positions, merged in shard order; and the partials."""
    from repro_torch.kernels import ops
    from repro_torch.models.attention import merge_partials
    from repro_torch.objectmodel.kvcache import shard_lengths
    n = tables.shape[0]
    pps = kp.shape[0] // n
    outs, mls = [], []
    for s in range(n):
        t = torch.from_numpy(tables[s])
        held = shard_lengths(t, torch.from_numpy(seq_pages[s]),
                             torch.from_numpy(lengths), ps)
        o, ml = ops.paged_attention_partial(
            torch.from_numpy(q), *(torch.from_numpy(x[s * pps:(s + 1) * pps])
                                   for x in (kp, vp)), t, held)
        outs.append(o)
        mls.append(ml)
    return merge_partials(torch.stack(outs), torch.stack(mls)), mls


@pytest.mark.parametrize("shards", [1, 2, 3, 4, 5])
def test_partial_mode_merged_over_shards_is_the_oracle(torch, shards):
    """Rows of 23, 5, 0, 30 and 42 tokens in 6-token pages (7 a row) over
    ``shards`` shards placed round-robin by ``KVPageManager``, a hole in
    row 0's third page; the length-0 row owns no page."""
    from repro_torch.objectmodel.kvcache import KVCacheConfig, KVPageManager
    rng = np.random.default_rng(shards)
    ps, K, G, hd = 6, 2, 3, 32
    lengths = np.array([23, 5, 0, 30, 42], np.int32)
    cfg = KVCacheConfig(n_layers=1, n_kv_heads=K, head_dim=hd,
                        max_seq_len=42, page_size=ps,
                        num_pages=shards * 2 * len(lengths) * 4,
                        num_shards=shards)
    books = KVPageManager(cfg)
    for seq, n in enumerate(lengths):
        books.allocate(seq, int(n))
    seqs = list(range(len(lengths)))
    tables, seq_pages = books.build_tables(seqs), books.build_page_map(seqs)
    assert all(k % shards == s for s in range(shards)
               for k in seq_pages[s].ravel() if k >= 0)  # round-robin
    # a hole: row 0's page 2, on its shard and in the whole table
    s, j = 2 % shards, 2 // shards
    assert seq_pages[s, 0, j] == 2
    tables[s, 0, j] = -1
    whole = np.full((len(lengths), 7), -1, np.int32)
    for seq in seqs:
        for k, (sh, local) in enumerate(books.owned[seq]):
            whole[seq, k] = sh * cfg.pages_per_shard + local
    whole[0, 2] = -1
    kp, vp = _pool(rng, cfg.num_pages, ps, K, hd)
    q = rng.standard_normal((len(lengths), K * G, hd), dtype=np.float32)
    got, mls = _merged_shards(torch, q, kp, vp, tables, seq_pages, lengths,
                              ps)
    want = _oracle(q, kp, vp, whole, lengths)
    live = lengths > 0
    np.testing.assert_allclose(got.numpy()[live], want[live], atol=TOL,
                               rtol=TOL)
    # the idle row: every shard's partial empty, the merge zeros
    assert all(float(ml[2, :, 1].abs().max()) == 0 for ml in mls)
    assert float(got[2].abs().max()) == 0
    if shards > 1:  # row 1's 5 tokens: one page, the later shards empty
        assert all(float(ml[1, :, 1].max()) == 0 for ml in mls[1:])


def test_a_stolen_page_is_read_where_it_sits(torch):
    """Two shards of 4 pages, sequences of 4 pages: three one-page
    sequences dry shard 0 out, so the third page of a 3-page sequence is
    stolen by shard 1 (entry 1 of shard 1, where round-robin would put it
    at entry 1 of shard 0). The shards' valid positions, the tail page
    that names the writing shard and the merged partials follow the pages
    where they are."""
    from repro_torch.objectmodel.kvcache import (KVCacheConfig, KVPageManager,
                                                 shard_tail)
    rng = np.random.default_rng(7)
    ps, K, hd = 4, 2, 16
    cfg = KVCacheConfig(n_layers=1, n_kv_heads=K, head_dim=hd,
                        max_seq_len=4 * ps, page_size=ps, num_pages=8,
                        num_shards=2)
    books = KVPageManager(cfg)
    for seq in (1, 2, 3):
        books.allocate(seq, 1)
    books.allocate(0, 2 * ps + 2)  # pages 0, 1 and the stolen 2
    assert books.owned[0] == [(0, 3), (1, 0), (1, 1)]
    tables, seq_pages = books.build_tables([0]), books.build_page_map([0])
    assert seq_pages[:, 0].tolist() == [[0, -1], [1, 2]]
    lengths = np.array([2 * ps + 1], np.int32)
    whole = np.array([[3, 4, 5, -1]], np.int32)
    kp, vp = _pool(rng, 8, ps, K, hd)
    q = rng.standard_normal((1, 2 * K, hd), dtype=np.float32)
    got, _ = _merged_shards(torch, q, kp, vp, tables, seq_pages, lengths,
                            ps)
    np.testing.assert_allclose(got.numpy(), _oracle(q, kp, vp, whole,
                                                     lengths),
                               atol=TOL, rtol=TOL)
    books.advance(0, int(lengths[0]))
    for s in range(2):  # position 9 is on page 2: only shard 1 writes
        tail = shard_tail(torch.from_numpy(tables[s]),
                          torch.from_numpy(seq_pages[s]),
                          torch.from_numpy(lengths), ps, s * 4)
        assert int(tail[0]) == ([-1, books.tail_physical_page(0)][s])


@pytest.mark.parametrize("spans", [1, 2, 3, 4, 5])
def test_dense_span_partials_merged_are_decode_attention(torch, spans):
    """A cache of 10 positions rounded up to a multiple of ``spans``, the
    padding masked; rows of 1, 4, 7 and 10 valid positions (later spans
    empty)."""
    from repro_torch.models.attention import decode_partial, merge_partials
    rng = np.random.default_rng(spans)
    S, K, G, hd = 10, 2, 2, 16
    length = np.array([1, 4, 7, 10], np.int32)
    q = rng.standard_normal((4, 1, K * G, hd), dtype=np.float32)
    k = rng.standard_normal((4, S, K, hd), dtype=np.float32)
    v = rng.standard_normal((4, S, K, hd), dtype=np.float32)
    jcfg = reduced_config(get_arch("qwen25_32b"))  # 4 heads over 2 of 16
    assert (jcfg.n_heads, jcfg.n_kv_heads, jcfg.resolved_head_dim) == (
        K * G, K, hd)
    want = np.asarray(jdecode_attention(jcfg, *(jnp.asarray(a) for a in
                                                 (q, k, v, length))))
    span = -(-S // spans)
    pad = ((0, 0), (0, span * spans - S), (0, 0), (0, 0))
    kt, vt = (torch.from_numpy(np.pad(a, pad)) for a in (k, v))
    outs, mls = [], []
    for s in range(spans):
        pos = s * span + torch.arange(span)
        valid = pos[None] < torch.minimum(torch.from_numpy(length),
                                          torch.tensor(S))[:, None]
        o, ml = decode_partial(torch.from_numpy(q[:, 0]),
                               kt[:, s * span:(s + 1) * span],
                               vt[:, s * span:(s + 1) * span], valid)
        outs.append(o)
        mls.append(ml)
    got = merge_partials(torch.stack(outs), torch.stack(mls))
    np.testing.assert_allclose(got.numpy(), want[:, 0], atol=TOL, rtol=TOL)


# ------------------------------------------------------------- the ranks
def _cfg(arch, edit):
    cfg = reduced_config(get_arch(arch))
    if cfg.is_moe:  # no slot dropped: a data shard routes its own tokens
        cfg = dataclasses.replace(cfg, capacity_factor=4.0)
    return dataclasses.replace(cfg, **edit)


def _single(torch, jm, jp, model, dec):
    """The reference's dense decode and the port's single process: its
    dense, int8 and paged steps and caches, and its serving."""
    from repro_torch.launch.serve import serve_model
    step = jax.jit(lambda p, t, s: jm.decode_step(p, t, s, JCtx()))
    jstate, jdec = jm.init_decode_state(B, MAX_SEQ, "float32"), []
    for t in range(STEPS):
        lg, jstate = step(jp, jnp.asarray(dec[:, t:t + 1]), jstate)
        jdec.append(np.asarray(lg))
    tokens = torch.from_numpy(dec)
    out = {"jdec": jdec}
    with torch.no_grad():
        for layout, kw in (("dense", {}), ("int8", {"kv_dtype": "int8"}),
                           ("paged", {"kv_layout": "paged",
                                      "page_size": PAGE})):
            steps, state = _decode_run(model, tokens, None, MAX_SEQ, **kw)
            out[layout] = {"steps": steps, "state": state}
        out["served"] = {layout: serve_model(
            model, kv_layout=layout, page_size=PAGE, **SERVE)["outputs"]
            for layout in ("dense", "paged")}
    return out


@pytest.fixture(scope="module")
def kvseq(torch, tmp_path_factory):
    """Every case's rank results beside the reference's and the port's
    single-process answers on the same weights and tokens; the world-4
    runs go at once while this process computes the single answers."""
    where = tmp_path_factory.mktemp("kvseq")
    rng = np.random.default_rng(0)
    cases, models = [], {}
    for name, arch, mesh, shape, edit in CASES:
        cfg = _cfg(arch, edit)
        jm, jp, model = carry(cfg, "float32")
        dec = rng.integers(0, cfg.vocab_size, (B, STEPS), dtype=np.int32)
        models[name] = (cfg, jm, jp, model, dec)
        case = {"name": name, "cfg": dataclasses.asdict(cfg), "mesh": mesh,
                "shape": shape, "state": model.state_dict(), "decode": dec,
                "max_seq": MAX_SEQ, "page": PAGE}
        if name in SERVED:
            case["serve"] = SERVE
        cases.append(case)
    half = len(cases) // 2
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        runs = [pool.submit(run_ranks, where / f"run{i}", {
            "checks": ["kvseq"], "kvseq": part}, world=4)
            for i, part in enumerate((cases[:half], cases[half:]))]
        single = {name: _single(torch, *m[1:]) for name, m in models.items()}
        ranks = [r["kvseq"] for run in runs for r in run.result()]
    return {name: {"cfg": models[name][0], "single": single[name],
                   "ranks": [r[name] for r in ranks if name in r]}
            for name, *_ in CASES}


def _port_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _log_softmax(a):
    a = np.asarray(a, np.float64)
    m = a.max(-1, keepdims=True)
    return a - m - np.log(np.exp(a - m).sum(-1, keepdims=True))


NAMES = [c[0] for c in CASES]


@pytest.mark.parametrize("case", NAMES)
def test_every_case_takes_the_sequence_layout(kvseq, case):
    """"sequence" on every rank; the span from the cache's spec: the
    model axis, or with the batch replicated (long_500k) the data then
    the model axis."""
    c = kvseq[case]
    two_axes = case.endswith("2x2")
    for res in c["ranks"]:
        assert res["kv_strategy"] == "sequence"
        assert res["shard_batch"] is not two_axes
        co = res["coords"]
        assert res["spec"][2] == (("data", "model") if two_axes
                                  else "model")
        assert res["span"] == ((co["data"] * 2 + co["model"], 4) if two_axes
                               else (co["model"], 4))
        dense = res["dense"]["caches"]["k_cache"]
        L = dense.shape[0]
        assert tuple(dense.shape) == (L, B, 3, c["cfg"].n_kv_heads,
                                      c["cfg"].resolved_head_dim)
        if c["cfg"].family != "hybrid":  # a hybrid ignores the int8 cache
            assert tuple(res["int8"]["caches"]["k_scale"].shape) == \
                tuple(dense.shape[:4])


@pytest.mark.parametrize("layout", ["dense", "int8", "paged"])
@pytest.mark.parametrize("case", NAMES)
def test_sequence_decode_matches_single_device(kvseq, case, layout):
    c = kvseq[case]
    want = c["single"][layout]["steps"]
    for res in c["ranks"]:
        for t, (got, w) in enumerate(zip(res[layout]["steps"], want)):
            assert _port_err(got, w) < PORT_TOL, (case, layout, t)
        if layout == "dense":
            for got, w in zip(res[layout]["steps"], c["single"]["jdec"]):
                err = np.abs(_log_softmax(got) - _log_softmax(w)).max()
                assert err < EP_TOL, (case, err)


def _exact_layers(cfg):
    """The attention layers whose input is the embedding alone: the first
    of a uniform stack (a hybrid stack's follows Mamba layers)."""
    return [0] if cfg.family != "hybrid" else []


def _held_close(got, want, exact, what):
    """``got`` against ``want`` (L, ...) layer by layer: bit for bit at
    the layers in ``exact``, within PORT_TOL of the largest value at the
    others."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    for layer in range(want.shape[0]):
        if layer in exact:
            assert np.array_equal(got[layer], want[layer]), (what, layer)
        assert np.abs(got[layer] - want[layer]).max() <= \
            PORT_TOL * np.abs(want[layer]).max(), (what, layer)


@pytest.mark.parametrize("layout", ["dense", "int8"])
@pytest.mark.parametrize("case", NAMES)
def test_spans_put_together_are_the_single_process_cache(kvseq, case,
                                                         layout):
    c = kvseq[case]
    state = c["single"][layout]["state"]
    spans = sorted(c["ranks"], key=lambda r: r["span"][0])
    if case.endswith("1x4"):
        assert [r["span"][0] for r in spans] == [0, 1, 2, 3]
    int8 = state.k_scale is not None
    for key in ("k_cache", "v_cache") + (("k_scale", "v_scale") if int8
                                          else ()):
        whole = np.concatenate([r[layout]["caches"][key].numpy()
                                for r in spans], axis=2)
        # the padding, never written: zeros, the scales' ones
        assert (whole[:, :, MAX_SEQ:] == key.endswith("scale")).all()
        want = getattr(state, key).numpy()
        if int8 and key.endswith("cache"):  # values x scales
            scale = np.concatenate([r[layout]["caches"][key[0] + "_scale"]
                                    .numpy() for r in spans], axis=2)
            want_scale = getattr(state, key[0] + "_scale").numpy()
            for layer in _exact_layers(c["cfg"]):
                assert np.array_equal(whole[layer, :, :MAX_SEQ],
                                      want[layer]), (key, layer)
            whole = whole * scale[..., None]
            want = want * want_scale[..., None]
            _held_close(whole[:, :, :MAX_SEQ], want, [], (case, key))
            continue
        _held_close(whole[:, :, :MAX_SEQ], want, _exact_layers(c["cfg"]),
                    (case, key))


@pytest.mark.parametrize("case", NAMES)
def test_shards_hold_the_single_process_pages(kvseq, case):
    """Shard s's entry j of row b holds the single pool's page j * 4 + s
    of that row (local id b * slots + j); the pages past the tokens are
    zero."""
    c = kvseq[case]
    kv = c["single"]["paged"]["state"].kv
    per_seq = -(-MAX_SEQ // PAGE)
    slots = -(-per_seq // 4)
    for res in c["ranks"]:
        got = res["paged"]["caches"]
        s = res["span"][0]
        pages = [j * 4 + s for j in range(slots)]
        assert got["seq_pages"].tolist() == [
            [k if k < per_seq else -1 for k in pages]] * B
        for key in ("k_pages", "v_pages"):
            mine = got[key].numpy()
            for j, k in enumerate(pages):
                local = np.arange(B) * slots + j
                if k >= per_seq:
                    continue
                want = getattr(kv, key)[:, np.arange(B) * per_seq + k]
                _held_close(mine[:, local], want.numpy(),
                            _exact_layers(c["cfg"]), (case, key, s, j))
                if k * PAGE >= STEPS:
                    assert not mine[:, local].any()


@pytest.mark.parametrize("case", SERVED)
def test_sequence_serving_equals_single_process(kvseq, case):
    c = kvseq[case]
    for res in c["ranks"]:
        assert res["served"] == c["single"]["served"], case
