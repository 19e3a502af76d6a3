"""The port's checkpointing, supervised restart, stragglers, elastic
rebalancing and data-loader recovery: the mirrors of
tests/test_fault_tolerance.py, on the CPU, plus the on-disk format
against the reference's: one float32 training state saved by both
packages gives the same manifest and file names (and the same bytes), the
port restores a checkpoint the reference wrote, and a bf16 state makes
the round trip bit for bit (written as its uint16 bits, ``"dtype":
"bfloat16"`` in the manifest)."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.checkpoint import Checkpointer as JCheckpointer
from repro.configs import get_arch, reduced_config
from repro.optim import AdamWConfig as JAdamW
from repro.optim import init_opt_state as jinit_opt_state
from torch_parity import carry


@pytest.fixture(scope="module", autouse=True)
def torch():
    torch = pytest.importorskip("torch")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield torch
    torch.set_num_threads(threads)


def test_checkpoint_roundtrip_and_gc(torch, tmp_path):
    from repro_torch.checkpoint import Checkpointer
    ck = Checkpointer(str(tmp_path), keep=2)
    state = {"a": torch.arange(10.0), "b": {"c": torch.ones((3, 3))}}
    for s in (1, 2, 3):
        ck.save(s, {"a": state["a"] * s, "b": {"c": state["b"]["c"] * s}},
                {"note": s})
    assert ck.steps() == [2, 3]  # gc kept last 2
    got, extra = ck.restore(state)
    assert torch.equal(got["a"], state["a"] * 3)
    assert torch.equal(got["b"]["c"], state["b"]["c"] * 3)
    assert extra["note"] == 3


def test_checkpoint_async_and_atomicity(torch, tmp_path):
    from repro_torch.checkpoint import Checkpointer
    ck = Checkpointer(str(tmp_path))
    ck.save_async(5, {"w": torch.ones((128, 128))})
    ck.wait()
    assert ck.latest_step() == 5
    # no tmp dirs left behind (atomic rename)
    assert not [d for d in os.listdir(tmp_path) if d.startswith("tmp.")]


def test_supervisor_restarts_from_checkpoint(torch, tmp_path):
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.distributed import Supervisor
    sup = Supervisor(Checkpointer(str(tmp_path)), save_every=5,
                     max_restarts=2)
    crashes = {"n": 0}

    def step_fn(state, step):
        if step == 12 and crashes["n"] == 0:
            crashes["n"] += 1
            raise RuntimeError("node failure")
        return {"x": state["x"] + 1}

    state, rep = sup.run({"x": torch.zeros(())}, step_fn, total_steps=20)
    assert rep.restarts == 1
    assert rep.restored_from == [10]  # last checkpoint before the crash
    assert float(state["x"]) == 20  # steps replayed, none lost


def test_supervisor_gives_up_after_budget(torch, tmp_path):
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.distributed import Supervisor
    sup = Supervisor(Checkpointer(str(tmp_path)), save_every=2,
                     max_restarts=1)

    def bad(state, step):
        if step >= 4:
            raise RuntimeError("persistent failure")
        return state

    with pytest.raises(RuntimeError):
        sup.run({"x": torch.zeros(())}, bad, total_steps=10)


def test_end_to_end_training_with_injected_failure(torch, tmp_path):
    """As the reference's test, and more: the port's loop goes back to the
    checkpoint's data cursor, so the replayed steps repeat the first
    pass's losses exactly (same state, same batches, one thread)."""
    from repro_torch.launch.train import train_loop
    kw = dict(steps=16, batch=4, seq=32, save_every=4, log_every=100,
              device="cpu")
    clean = train_loop("xlstm_125m", ckpt_dir=str(tmp_path / "a"), **kw)
    out = train_loop("xlstm_125m", ckpt_dir=str(tmp_path / "b"), fail_at=9,
                     **kw)
    rep, losses = out["report"], out["losses"]
    assert clean["report"].restarts == 0 and rep.restarts == 1
    assert rep.restored_from == [8] and len(losses) == 16 + 1
    assert losses[9:] == clean["losses"][8:]  # step 8 replayed, then on
    assert np.isfinite(losses[-1]) and losses[-1] < losses[0]


def test_straggler_detection_and_reassignment():
    from repro_torch.distributed import HeartbeatMonitor
    mon = HeartbeatMonitor(4, straggler_factor=2.0, timeout_s=100)
    for step in range(5):
        for w in range(4):
            dur = 10.0 if w == 2 else 1.0  # worker 2 is slow
            mon.beat(w, dur, now=step * 10.0)
    plan = mon.check(now=50.0)
    assert plan.stragglers == [2]
    assert plan.reassign[2] in (0, 1, 3)


def test_silent_worker_flagged():
    from repro_torch.distributed import HeartbeatMonitor
    mon = HeartbeatMonitor(3, timeout_s=5.0)
    for w in range(3):
        mon.beat(w, 1.0, now=0.0)
    mon.beat(0, 1.0, now=10.0)
    mon.beat(1, 1.0, now=10.0)
    plan = mon.check(now=10.0)  # worker 2 silent for 10s
    assert 2 in plan.stragglers


def test_elastic_rebalance_and_reshard_waits_for_the_mesh(torch):
    from repro.distributed import rebalance_shards as jrebalance
    from repro_torch.distributed import rebalance_shards, reshard_state
    asg = rebalance_shards(n_pages=10, old_workers=4, new_workers=3,
                           old_cursors={})
    assert sorted(p for ps in asg.values() for p in ps) == list(range(10))
    sizes = [len(v) for v in asg.values()]
    assert max(sizes) - min(sizes) <= 1
    assert asg == jrebalance(10, 4, 3, {})
    # reshard_state keeps the slice a rank's coordinates own (a tuple
    # entry: the first axis the major one); four ranks on one host run it
    # in tests/test_torch_mesh.py
    from torch_mesh_ranks import Grid

    from repro_torch.core.planner import P
    w = torch.arange(64.0).reshape(8, 8)
    for i in range(2):
        for j in range(2):
            got = reshard_state({"w": w, "v": w}, {
                "w": P("data", "model"), "v": P(("data", "model"))},
                Grid({"data": 2, "model": 2}, data=i, model=j))
            assert torch.equal(got["w"], w[4 * i:4 * i + 4, 4 * j:4 * j + 4])
            k = 2 * i + j
            assert torch.equal(got["v"], w[2 * k:2 * k + 2])


def test_restore_into_a_different_template_fails_loudly(torch, tmp_path):
    from repro_torch.checkpoint import Checkpointer
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"a": torch.ones(3)})
    with pytest.raises(ValueError, match="template has 2"):
        ck.restore({"a": torch.ones(3), "b": torch.ones(3)})
    from torch_mesh_ranks import Grid

    from repro_torch.core.planner import P
    with pytest.raises(ValueError, match="does not split into 2 blocks"):
        ck.restore({"a": torch.ones(3)}, specs={"a": P("data")},
                   mesh=Grid({"data": 2}, data=0))


def test_data_loader_cursor_recovery():
    from repro_torch.data import TokenLoader, TokenPageWriter
    from repro_torch.objectmodel import PagedStore
    store = PagedStore()
    w = TokenPageWriter(store, "s", seq_len=8)
    for i in range(40):
        w.add_document(list(range(i, i + 9)))
    loader = TokenLoader(w.set, batch_size=4, seed=1)
    it = iter(loader)
    [next(it)["tokens"] for _ in range(3)]
    st = loader.state()
    it.close()  # the producer thread stops with the iteration
    # "crash": new loader, restore cursor -> continues where it left off
    loader2 = TokenLoader(w.set, batch_size=4, seed=1)
    loader2.restore(st)
    nxt = next(iter(loader2))["tokens"]
    it_ref = iter(TokenLoader(w.set, batch_size=4, seed=1))
    for _ in range(3):
        next(it_ref)
    np.testing.assert_array_equal(nxt, next(it_ref)["tokens"])


def test_token_pipeline_matches_reference():
    """The same documents and seed give the reference's batches, in order,
    and the byte tokenizer the reference's ids."""
    from repro.data import ByteTokenizer as JByteTokenizer
    from repro.data import make_lm_batches as jmake_lm_batches
    from repro.objectmodel import PagedStore as JPagedStore
    from repro_torch.data import ByteTokenizer, make_lm_batches
    from repro_torch.objectmodel import PagedStore
    text = "PlinyCompute: a platform for distributed tools. " * 20
    assert ByteTokenizer().encode(text, add_eos=True) == \
        JByteTokenizer().encode(text, add_eos=True)
    got = list(make_lm_batches(PagedStore(), "t", text, 16, 3, repeat=2))
    want = list(jmake_lm_batches(JPagedStore(), "t", text, 16, 3, repeat=2))
    assert len(got) == len(want) > 3
    for g, w in zip(got, want):
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(g[k], w[k])


def _train_state(torch):
    """The reference's (params, opt) of a reduced qwen2-moe in float32, as
    its train loop checkpoints them, and the port's same state."""
    from repro_torch.models.convert import from_jax_opt_state
    from repro_torch.optim import AdamWConfig, init_opt_state
    cfg = reduced_config(get_arch("qwen2_moe"))
    jm, jp, model = carry(cfg, "float32")
    jopt = jinit_opt_state(jp, JAdamW())
    rng = np.random.default_rng(3)
    jopt = jopt._replace(  # moments that are not all zeros, step 7
        m=jax.tree.map(lambda a: jnp.asarray(
            rng.standard_normal(a.shape), jnp.float32), jopt.m),
        step=jnp.asarray(7, jnp.int32))
    params = model.params()
    opt = from_jax_opt_state(jax.tree.map(np.asarray, jopt), model)
    template = (params, init_opt_state(params, AdamWConfig()))
    return (jp, jopt), (params, opt), template


def test_float32_state_has_the_reference_manifest_and_files(torch, tmp_path):
    from repro_torch.checkpoint import Checkpointer
    jstate, state, _ = _train_state(torch)
    JCheckpointer(str(tmp_path / "jax")).save(3, jstate, {"data": {"c": 1}})
    Checkpointer(str(tmp_path / "port")).save(3, state, {"data": {"c": 1}})
    manifests = [json.loads((tmp_path / side / "step_3" / "MANIFEST.json")
                            .read_text()) for side in ("jax", "port")]
    assert manifests[0] == manifests[1]
    names = [m["file"] for m in manifests[0]["leaves"]]
    assert any("1_m_blocks_moe_router" in n for n in names)
    assert names[-1].endswith("_1_step.npy")
    for name in names:
        a = np.load(tmp_path / "jax" / "step_3" / name)
        b = np.load(tmp_path / "port" / "step_3" / name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name


def test_port_restores_a_checkpoint_the_reference_wrote(torch, tmp_path):
    from repro_torch import tree as tr
    from repro_torch.checkpoint import Checkpointer
    jstate, state, template = _train_state(torch)
    JCheckpointer(str(tmp_path)).save(5, jstate, {"data": {"cursor": 12}})
    (params, opt), extra = Checkpointer(str(tmp_path)).restore(template)
    assert extra == {"data": {"cursor": 12}}
    assert int(opt.step) == 7 and opt.step.dtype == torch.int32
    for got, want in zip(tr.leaves((params, opt)), tr.leaves(state)):
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_bfloat16_state_round_trips_bit_for_bit(torch, tmp_path):
    from repro_torch import tree as tr
    from repro_torch.checkpoint import Checkpointer
    gen = torch.Generator().manual_seed(0)
    state = {"w": torch.randn((5, 7), generator=gen).to(torch.bfloat16),
             "m": [torch.randn(3, generator=gen).to(torch.bfloat16),
                   torch.tensor(3, dtype=torch.int32)]}
    state["w"][0, :3] = torch.tensor([float("inf"), -0.0, float("nan")])
    ck = Checkpointer(str(tmp_path))
    ck.save(1, state)
    manifest = json.loads((tmp_path / "step_1" / "MANIFEST.json").read_text())
    assert [m["dtype"] for m in manifest["leaves"]] == [
        "bfloat16", "int32", "bfloat16"]  # m_0, m_1, w: sorted keys
    assert [m["file"] for m in manifest["leaves"]] == [
        "00000_m_0.npy", "00001_m_1.npy", "00002_w.npy"]
    got, _ = ck.restore(state)
    for a, b in zip(tr.leaves(got), tr.leaves(state)):
        assert a.dtype == b.dtype
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b)
