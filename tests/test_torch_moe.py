"""The port's MoE family against the reference, on the CPU.

Weights come from the reference (``init_params(PRNGKey(0), ...)`` on the
reduced qwen2_moe and phi35_moe configs: 4 experts, top-2; qwen2_moe with
one shared expert and QKV bias, phi35_moe with neither) and are carried
over with ``from_jax_params``; inputs are numpy-seeded. On the CPU the
dispatch buffer is built by the plain version of ``moe_gather``.

Tolerances: 1e-5 for one MoE layer in float32 (routing, softmax and the
expert products summed in another order), 1e-4 for whole-model logits in
float32, 2e-2 of the largest logit with bf16 parameters (bf16 rounds at
other places in the two frameworks; see tests/test_torch_models.py).
Decode is held against the reference with the capacity lifted to
``n_experts``, as tests/test_models_smoke.py does, so that no slot is
dropped on either side whatever the batch."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_arch, reduced_config
from repro.models import Ctx as JCtx
from repro.models import build_model as jbuild
from repro.models import moe as jmoe
from torch_parity import carry, port_cfg

ARCHS = ["qwen2_moe", "phi35_moe"]


@pytest.fixture(scope="module", autouse=True)
def torch():
    torch = pytest.importorskip("torch")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield torch
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def qwen():
    return reduced_config(get_arch("qwen2_moe"))


@pytest.fixture(scope="module")
def carried(qwen):
    return carry(qwen, "float32")


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape,
                                                dtype=np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_moe_config_is_the_reference_config(arch):
    from repro_torch.configs import get_arch as tget
    from repro_torch.configs import reduced_config as treduced
    full = tget(arch)
    assert dataclasses.asdict(full) == dataclasses.asdict(get_arch(arch))
    assert dataclasses.asdict(treduced(full)) == dataclasses.asdict(
        reduced_config(get_arch(arch)))


def test_qwen2_moe_full_width_param_count_matches_reference():
    from repro_torch.models import build_model
    model = build_model("qwen2_moe")  # meta parameters: nothing allocated
    assert model.blocks.moe.w_gate.is_meta
    assert model.param_count() == jbuild(
        get_arch("qwen2_moe")).param_count() == 14_316_259_328
    # the config's closed form (padded vocab aside) agrees in both packages
    assert model.cfg.param_count() == get_arch(
        "qwen2_moe").param_count() == 14_316_158_976


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_param_tree_paths_match_reference(arch):
    from repro.models import params as jparams
    from repro_torch.models import params
    from repro_torch.models.transformer import model_defs
    cfg = reduced_config(get_arch(arch))
    mine = params.tree_paths(model_defs(port_cfg(cfg)))
    ref = jparams.tree_paths(jbuild(cfg).defs)
    assert {k.replace("/", "."): (d.shape, d.init, d.scale)
            for k, d in ref.items()} == {
        k: (d.shape, d.init, d.scale) for k, d in mine.items()}
    assert "blocks.moe.router" in mine and "blocks.mlp.w_up" not in mine
    assert ("blocks.moe.shared.w_up" in mine) == bool(cfg.n_shared_experts)


@pytest.mark.parametrize("n_tokens", [1, 4, 48, 4096])
def test_expert_capacity_matches_reference(n_tokens):
    from repro_torch.models.moe import expert_capacity
    for arch in ARCHS:
        cfg = get_arch(arch)
        assert expert_capacity(port_cfg(cfg), n_tokens) == \
            jmoe.expert_capacity(cfg, n_tokens)
    assert jmoe.expert_capacity(get_arch("qwen2_moe"), 4096) == 344


def _moe_inputs(cfg, seed=4):
    rng = np.random.default_rng(seed)
    p = {}
    for path, d in jmoe.moe_defs(cfg).items():
        if isinstance(d, dict):
            p[path] = {k: rng.standard_normal(dd.shape, dtype=np.float32)
                       * 0.1 for k, dd in d.items()}
        else:
            p[path] = rng.standard_normal(d.shape, dtype=np.float32) * 0.3
    x = rng.standard_normal((2, 24, cfg.d_model), dtype=np.float32)
    return p, x


def _to(fn, tree):
    return {k: (_to(fn, v) if isinstance(v, dict) else fn(v))
            for k, v in tree.items()}


@pytest.mark.parametrize("case", ["capacity", "overflow", "quantize"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_reference(torch, arch, case):
    """Output and aux loss of one layer. "overflow" cuts the capacity to
    0.25 so that slots are dropped (the same ones on both sides, or the
    outputs would differ); "quantize" runs the int8 dispatch round trip."""
    from repro_torch.models import Ctx
    from repro_torch.models import moe
    cfg = reduced_config(get_arch(arch))
    if case == "overflow":
        cfg = dataclasses.replace(cfg, capacity_factor=0.25)
    quant = case == "quantize"
    p, x = _moe_inputs(cfg)
    want, want_aux = jmoe.moe_apply(cfg, _to(jnp.asarray, p), jnp.asarray(x),
                                    JCtx(quantize_dispatch=quant))
    got, aux = moe.moe_apply(port_cfg(cfg), _to(torch.from_numpy, p),
                             torch.from_numpy(x), Ctx(quantize_dispatch=quant))
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    if case == "overflow":  # slots really were dropped
        full = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
        kept, _ = moe.moe_apply(port_cfg(full), _to(torch.from_numpy, p),
                                torch.from_numpy(x), Ctx())
        assert np.abs(kept.numpy() - got.numpy()).max() > 1e-2


def test_moe_ep_shard_map_waits_for_the_parallelism_layer(torch, qwen,
                                                          tmp_path):
    """``Ctx(ep_shard_map=True)`` without a mesh and an "ep" plan takes the
    single-device path, as the reference's ``moe_apply`` does; with them
    the expert-parallel path trains: on a (data 1, model 2) mesh of two
    rank processes (tests/torch_mesh_ranks.py, gloo) the gradients of
    <y, w> + aux with respect to x and the router are the single device's
    on both ranks, and those of each rank's experts and shared-expert
    columns its slices of the single device's, within 1e-5 of each
    gradient's largest value (the same routes: at one data shard the
    capacity and the drops are the single device's). Its forward is held
    on four ranks by tests/test_torch_mesh.py."""
    from torch_mesh_ranks import Grid, run_ranks

    from repro_torch import tree as tr
    from repro_torch.configs import get_shape
    from repro_torch.core.planner import P, make_plan
    from repro_torch.distributed.elastic import local_slice
    from repro_torch.models import Ctx, build_model
    from repro_torch.models import moe
    cfg = port_cfg(qwen)
    p, x = _to(torch.from_numpy, _moe_inputs(qwen)[0]), torch.from_numpy(
        _moe_inputs(qwen)[1])
    y, aux = moe.moe_apply(cfg, p, x, Ctx(ep_shard_map=True))
    want, want_aux = moe.moe_apply(cfg, p, x, Ctx())
    assert torch.equal(y, want) and torch.equal(aux, want_aux)
    axes = {"data": 1, "model": 2}
    plan = make_plan(cfg, axes, get_shape("train_4k"))
    assert plan.moe_strategy == "ep"
    specs = tr.tree_map(lambda s: P(*s[1:]),  # one layer: no layers dim
                        build_model(cfg).param_specs(plan)["blocks"]["moe"])
    ranks = run_ranks(tmp_path, {"checks": ["ep"], "ep": [{
        "name": "layer", "cfg": dataclasses.asdict(cfg), "mesh": (1, 2),
        "shape": "train_4k", "layer": p, "layer_specs": specs,
        "x": x.numpy()}]}, world=2)
    wants = tr.tree_map(lambda t: t.clone().requires_grad_(True), p)
    xs = x.clone().requires_grad_(True)
    y, aux = moe.moe_apply(cfg, wants, xs, Ctx())
    single = torch.autograd.grad((y * x).sum() + aux,
                                 [xs, *tr.leaves(wants)])
    paths = ["x"] + [".".join(path) for path, _ in
                     tr.leaves_with_path(wants)]
    flat_specs = dict(zip(paths, [P()] + tr.leaves(specs)))
    for r in ranks:
        res = r["ep"]["layer"]
        grid = Grid(axes, **res["coords"])
        assert sorted(res["grads"]) == sorted(paths)
        for path, g in zip(paths, single):
            want = local_slice(g, flat_specs[path], grid)
            got = res["grads"][path]
            assert got.shape == want.shape, path
            assert float((got - want).abs().max()) <= \
                1e-5 * float(g.abs().max()), path


@pytest.mark.parametrize("use_flash", [False, True])
def test_moe_forward_logits_and_aux_match_reference(torch, qwen, carried,
                                                    use_flash):
    from repro_torch.models import Ctx
    jm, jp, model = carried
    tokens = _tokens(qwen, (2, 24))
    want, want_aux = jm.forward(jp, {"tokens": jnp.asarray(tokens)},
                                JCtx(use_flash=use_flash))
    got, aux = model.forward({"tokens": torch.from_numpy(tokens)},
                             Ctx(use_flash=use_flash))
    assert got.dtype == torch.float32 and float(aux) > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    last, _ = model.forward({"tokens": torch.from_numpy(tokens)},
                            Ctx(use_flash=use_flash), last_only=True)
    np.testing.assert_allclose(last.numpy(), np.asarray(want)[:, -1:],
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_bf16_matches_reference(torch, arch):
    """One layer in bf16 on the same bf16 inputs: the router sees equal
    inputs, so routing agrees and the outputs differ by bf16 rounding."""
    from repro_torch.models import Ctx
    from repro_torch.models import moe
    cfg = reduced_config(get_arch(arch))
    p, x = _moe_inputs(cfg)
    want, want_aux = jmoe.moe_apply(
        cfg, _to(lambda a: jnp.asarray(a).astype(jnp.bfloat16), p),
        jnp.asarray(x).astype(jnp.bfloat16), JCtx())
    got, aux = moe.moe_apply(
        port_cfg(cfg), _to(lambda a: torch.from_numpy(a).bfloat16(), p),
        torch.from_numpy(x).bfloat16(), Ctx())
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert err <= 2e-2, err
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


def test_moe_bf16_forward_matches_reference(torch, qwen):
    """Whole model in bf16. The reference's router (std 0.02) leaves some
    tokens' expert probabilities within 1e-4 of each other, and one bf16
    ulp of difference in a layer's input (XLA's silu, see
    tests/test_torch_models.py) then flips that top-k choice; through the
    capacity a flip also moves other tokens' drops. About one token seed
    in four does so at this size. These tokens (seed 1) route with
    margins above bf16 rounding in every layer."""
    from repro_torch.models import Ctx
    jm, jp, model = carry(qwen, "bfloat16")
    assert model.dtype == torch.bfloat16
    tokens = _tokens(qwen, (2, 24), seed=1)
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(tokens)}, JCtx())
    got, _ = model.forward({"tokens": torch.from_numpy(tokens)}, Ctx())
    want = np.asarray(want)
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= 2e-2, err


def test_moe_decode_matches_reference_teacher_forced(torch, qwen):
    lifted = dataclasses.replace(qwen, capacity_factor=float(qwen.n_experts))
    jm, jp, model = carry(lifted, "float32")
    tokens = _tokens(lifted, (2, 12), seed=6)
    jstate = jm.init_decode_state(2, 16, "float32")
    state = model.init_decode_state(2, 16, "float32")
    step = jax.jit(lambda p, t, s: jm.decode_step(p, t, s, JCtx()))
    for t in range(tokens.shape[1]):
        tok = tokens[:, t:t + 1]
        want, jstate = step(jp, jnp.asarray(tok), jstate)
        got, state = model.decode_step(torch.from_numpy(tok), state)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-4, rtol=1e-4, err_msg=f"step {t}")
    assert state.length.tolist() == [12, 12]
