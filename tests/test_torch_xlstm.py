"""The ssm family (xlstm-125m: groups of 3 mLSTM blocks and 1 sLSTM block,
no attention, no FFN outside the blocks) in the port, against the
reference on the CPU, at ``reduced_config`` size (one group of 4 blocks,
d_model 64, 4 heads).

Weights are the reference's ``init_params(PRNGKey(0), ...)`` carried over
with ``from_jax_params`` (one block's leaves numpy-seeded where a block is
tested alone); inputs are numpy-seeded. The mLSTM's full-sequence pass is
chunkwise-parallel (chunks of 64, a log-space stabiliser), its decode the
one-step recurrence; the sLSTM is a loop over time in both packages.
Tolerances: 1e-5 of the largest |value| for one block and for the
whole-model logits in float32 against the reference (the same float32
steps in the reference's order, products summed in another); 1e-4 for a
block's full-sequence pass against its own decode steps (the chunkwise
and the recurrent forms sum in other orders); 2e-2 for the sLSTM block
with bf16 parameters, and for the whole bf16 model the reference's own
distance from its float32 answer (test_xlstm_bf16_forward_matches_reference
says why)."""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_arch, reduced_config
from repro.models import Ctx as JCtx
from repro.models import build_model as jbuild
from repro.models import xlstm as jxl
from torch_parity import carry, decode_both, port_cfg, rel_err, serve_both

ARCH = "xlstm_125m"


@pytest.fixture(scope="module", autouse=True)
def torch():
    torch = pytest.importorskip("torch")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield torch
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ssm():
    return reduced_config(get_arch(ARCH))


@functools.lru_cache(maxsize=None)
def _carried(dtype="float32"):
    return carry(reduced_config(get_arch(ARCH)), dtype)


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape,
                                                dtype=np.int32)


def _block_params(defs, seed):
    """One block's leaves: 1/sqrt(fan-in) for the matrices, 0.3 for the
    recurrent weights and the gates' inputs, 0.1 around the init for the
    vectors (so that every term, biases included, is exercised)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, d in defs.items():
        a = rng.standard_normal(d.shape)
        if name in ("r", "w_i", "w_f"):
            a *= 0.3
        elif len(d.shape) == 1:
            a = a * 0.1 + (1.0 if d.init == "ones" else 0.0)
        else:
            a /= np.sqrt(d.shape[-2])
        out[name] = a.astype(np.float32)
    return out


def _both(p, torch):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


def test_port_xlstm_config_is_the_reference_config(ssm):
    from repro_torch.configs import get_arch as tget
    from repro_torch.configs import reduced_config as treduced
    full = tget("xlstm-125m")
    assert dataclasses.asdict(full) == dataclasses.asdict(get_arch(ARCH))
    assert dataclasses.asdict(treduced(full)) == dataclasses.asdict(ssm)
    assert (ssm.n_layers, ssm.slstm_period, ssm.n_heads) == (4, 4, 4)


@pytest.mark.parametrize("reduced", [True, False])
def test_xlstm_param_tree_paths_match_reference(reduced):
    from repro.models import params as jparams
    from repro_torch.models import params
    from repro_torch.models.transformer import model_defs
    cfg = get_arch(ARCH)
    if reduced:
        cfg = reduced_config(cfg)
    mine = params.tree_paths(model_defs(port_cfg(cfg)))
    ref = jparams.tree_paths(jbuild(cfg).defs)
    assert {k.replace("/", "."): (d.shape, d.init, d.scale)
            for k, d in ref.items()} == {
        k: (d.shape, d.init, d.scale) for k, d in mine.items()}
    g = cfg.n_layers // 4
    assert mine["groups.mlstm.wq"].shape[0] == 3 * g
    assert mine["groups.slstm.r"].shape[0] == g


def test_xlstm_full_width_param_count_and_depth(torch):
    from repro_torch.models import build_model
    model = build_model(ARCH)  # meta parameters: nothing allocated
    assert model.groups.mlstm.wq.is_meta
    assert model.param_count() == jbuild(get_arch(ARCH)).param_count() \
        == 189_169_224
    with pytest.raises(ValueError, match="slstm_period"):
        build_model(ARCH, layers=6)
    assert build_model(ARCH, layers=8).cfg.n_layers == 8


@pytest.mark.parametrize("L", [20, 64, 150])  # one short chunk; whole; ragged
def test_mlstm_apply_matches_reference(torch, ssm, L):
    from repro_torch.models import Ctx
    from repro_torch.models import xlstm
    jp, tp = _both(_block_params(jxl.mlstm_defs(ssm), 4), torch)
    x = np.random.default_rng(5).standard_normal((2, L, ssm.d_model),
                                                 dtype=np.float32)
    want = jxl.mlstm_apply(ssm, jp, jnp.asarray(x), JCtx())
    got = xlstm.mlstm_apply(port_cfg(ssm), tp, torch.from_numpy(x), Ctx())
    assert got.shape == x.shape and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    assert rel_err(got, want) <= 1e-5


def test_slstm_apply_matches_reference(torch, ssm):
    from repro_torch.models import Ctx
    from repro_torch.models import xlstm
    jp, tp = _both(_block_params(jxl.slstm_defs(ssm), 6), torch)
    x = np.random.default_rng(7).standard_normal((2, 37, ssm.d_model),
                                                 dtype=np.float32)
    want = jxl.slstm_apply(ssm, jp, jnp.asarray(x), JCtx())
    got = xlstm.slstm_apply(port_cfg(ssm), tp, torch.from_numpy(x), Ctx())
    assert rel_err(got, want) <= 1e-5


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_decode_steps_match_reference_and_their_full_pass(torch, ssm, kind):
    """Nine steps of one block from a zero state: each step's output and
    state against the reference's step; the outputs against the block's
    own full-sequence pass."""
    from repro_torch.models import Ctx
    from repro_torch.models import xlstm
    tcfg = port_cfg(ssm)
    defs = getattr(jxl, f"{kind}_defs")(ssm)
    jp, tp = _both(_block_params(defs, 8), torch)
    xs = np.random.default_rng(9).standard_normal((2, 9, ssm.d_model),
                                                  dtype=np.float32)
    if kind == "mlstm":
        jstate = jxl.mlstm_init_state(ssm, 2, "float32")
        stacked = xlstm.mlstm_init_state(tcfg, 2, torch.float32, "cpu", 1)
        state = xlstm.MLSTMState(*(t[0] for t in stacked))
    else:
        jstate = jxl.slstm_init_state(ssm, 2, "float32")
        state = xlstm.slstm_init_state(tcfg, 2, "cpu")
    jstep = getattr(jxl, f"{kind}_decode_step")
    step = getattr(xlstm, f"{kind}_decode_step")
    outs = []
    for t in range(xs.shape[1]):
        want, jstate = jstep(ssm, jp, jnp.asarray(xs[:, t:t + 1]), jstate)
        got, state = step(tcfg, tp, torch.from_numpy(xs[:, t:t + 1]), state)
        assert rel_err(got, want) <= 1e-5, t
        for mine, ref in zip(state, jstate):
            assert rel_err(mine, ref) <= 1e-5, t
        outs.append(got)
    full = getattr(xlstm, f"{kind}_apply")(tcfg, tp, torch.from_numpy(xs),
                                           Ctx())
    assert rel_err(torch.cat(outs, 1), full.numpy()) <= 1e-4


def test_xlstm_forward_matches_reference(torch, ssm):
    from repro_torch.kernels import ops
    from repro_torch.models import Ctx
    jm, jp, model = _carried()
    tokens = _tokens(ssm, (2, 70))  # two mLSTM chunks, the second ragged
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(tokens)}, JCtx())
    ops.reset_launch_counts()
    got, aux = model.forward({"tokens": torch.from_numpy(tokens)},
                             Ctx(use_flash=True))
    assert sum(ops.launch_counts().values()) == 0
    assert got.dtype == torch.float32 and float(aux) == 0.0
    assert rel_err(got, want) <= 1e-5


def test_xlstm_bf16_forward_matches_reference(torch, ssm):
    """bf16 parameters. The mLSTM's output divides by max(|den|, exp(-m)),
    which is small at some positions of random-weight inputs: there a
    1-ulp change of a bf16 input moves the reference's own float32 output
    by up to 16% of its largest value (one reduced-config block, five
    random perturbations), and XLA's bf16 silu is one ulp off torch's in
    ~40% of elements (ROADMAP.md queue 3).
    So the two packages' bf16 logits differ by more than tests/
    test_torch_models.py's 2e-2 (5-9% over four seeds), and the reference's
    bf16 logits are 5-8% from its float32 logits on the same weights.
    Held: the port's bf16 logits are no farther from that float32 answer
    than the reference's bf16 logits are."""
    import jax
    from repro_torch.models import Ctx
    jm, jp, model = _carried("bfloat16")
    tokens = _tokens(ssm, (2, 24), seed=7)
    batch = {"tokens": jnp.asarray(tokens)}
    ref16 = np.asarray(jm.forward(jp, batch, JCtx())[0])
    ref32 = np.asarray(jm.forward(
        jax.tree.map(lambda a: a.astype(jnp.float32), jp), batch, JCtx())[0])
    got, _ = model.forward({"tokens": torch.from_numpy(tokens)}, Ctx())
    assert got.dtype == torch.float32
    assert rel_err(got, ref32) <= rel_err(torch.from_numpy(ref16), ref32)


def test_slstm_bf16_matches_reference(torch, ssm):
    """The sLSTM block alone in bf16 (no division by a small denominator:
    n >= 1): within 2e-2, as tests/test_torch_models.py holds bf16."""
    from repro_torch.models import Ctx
    from repro_torch.models import xlstm
    p = _block_params(jxl.slstm_defs(ssm), 6)
    x = np.random.default_rng(7).standard_normal((2, 37, ssm.d_model),
                                                 dtype=np.float32)
    want = jxl.slstm_apply(ssm, {k: jnp.asarray(v, jnp.bfloat16)
                                 for k, v in p.items()},
                           jnp.asarray(x, jnp.bfloat16), JCtx())
    got = xlstm.slstm_apply(port_cfg(ssm),
                            {k: torch.from_numpy(v).to(torch.bfloat16)
                             for k, v in p.items()},
                            torch.from_numpy(x).to(torch.bfloat16), Ctx())
    assert got.dtype == torch.bfloat16
    assert rel_err(got, np.asarray(want, np.float32)) <= 2e-2


def test_xlstm_decode_matches_reference_teacher_forced(torch, ssm):
    """12 tokens through the stacked recurrent states: the logits and the
    states after the last step (the reference's ``kv_dtype`` is ignored:
    there is no cache)."""
    jm, jp, model = _carried()
    tokens = _tokens(ssm, (2, 12), seed=6)
    jstate = jm.init_decode_state(2, 16, "float32", kv_dtype="int8")
    state = model.init_decode_state(2, 16, "float32", kv_dtype="int8")
    assert state.k_cache is None and state.mlstm.C.shape[0] == 3
    worst, _, jstate, state = decode_both(jm, jp, model, tokens, jstate,
                                          state)
    assert worst <= 1e-5, worst
    assert state.length.tolist() == [12, 12]
    for mine, ref in zip((*state.mlstm, *state.slstm),
                         (*jstate.mlstm, *jstate.slstm)):
        assert rel_err(mine, ref) <= 1e-5


def test_xlstm_decode_agrees_with_its_forward(torch, ssm):
    from repro_torch.models import Ctx
    _, _, model = _carried()
    tokens = torch.from_numpy(_tokens(ssm, (2, 10), seed=8))
    ref, _ = model.forward({"tokens": tokens}, Ctx())
    state = model.init_decode_state(2, 16, "float32")
    for t in range(10):
        got, state = model.decode_step(tokens[:, t:t + 1], state)
        assert rel_err(got, ref[:, t:t + 1].numpy()) <= 1e-4, t


def test_xlstm_has_no_paged_pool(torch):
    _, _, model = _carried()
    with pytest.raises(ValueError, match="ROADMAP"):
        model.init_decode_state(2, 8, kv_layout="paged")


def test_xlstm_serving_matches_reference_token_for_token(torch, ssm):
    """8 prompts through 4 slots, max_seq 48: a reused slot keeps the
    recurrent states its last request left (the reference resets only
    ``length``), so the outputs agree only if the port keeps them too."""
    jm, jp, model = _carried()
    jeng, eng = serve_both(ssm, jm, jp, model)
    assert [s.sid for s in eng.finished] == [s.sid for s in jeng.finished]
    assert len(eng.finished) == 8
    for got, want in zip(eng.finished, jeng.finished):
        assert got.out == want.out, got.sid
    assert eng.pages.pages_in_use() == 0 == jeng.pages.pages_in_use()
    assert eng.kv_cfg.n_layers == ssm.n_layers == jeng.kv_cfg.n_layers
    assert rel_err(eng.state.mlstm.C, jeng.state.mlstm.C) <= 1e-4
