"""The vlm family (internvl2-26b: the InternLM2 stack whose first
``n_patches`` positions take precomputed patch embeddings plus
``patch_pos``) in the port, against the reference on the CPU, at
``reduced_config`` size (4 patch positions, 4/2 heads).

Weights are the reference's ``init_params(PRNGKey(0), ...)`` carried over
with ``from_jax_params``; tokens and patches are numpy-seeded. Tolerances
as in tests/test_torch_dense_configs.py: 1e-5 of the largest |logit| in
float32, 2e-2 with bf16 parameters. Decode reads no patches (the
reference's decode is the dense stack's), so the port's dense, int8 and
paged decode are held against the reference's decode step."""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_arch, reduced_config
from repro.models import Ctx as JCtx
from repro.models import build_model as jbuild
from torch_parity import carry, decode_both, port_cfg, rel_err, serve_both

ARCH = "internvl2_26b"


@pytest.fixture(scope="module", autouse=True)
def torch():
    torch = pytest.importorskip("torch")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield torch
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def vlm():
    return reduced_config(get_arch(ARCH))


@functools.lru_cache(maxsize=None)
def _carried(dtype="float32"):
    return carry(reduced_config(get_arch(ARCH)), dtype)


def _batch(cfg, B=2, S=24, seed=1):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S),
                                   dtype=np.int32),
            "patches": rng.standard_normal((B, cfg.n_patches, cfg.d_model),
                                           dtype=np.float32)}


def test_port_vlm_config_is_the_reference_config(vlm):
    from repro_torch.configs import get_arch as tget
    from repro_torch.configs import reduced_config as treduced
    full = tget("internvl2-26b")
    assert dataclasses.asdict(full) == dataclasses.asdict(get_arch(ARCH))
    assert dataclasses.asdict(treduced(full)) == dataclasses.asdict(vlm)
    assert (full.n_heads // full.n_kv_heads, full.n_patches) == (6, 256)


@pytest.mark.parametrize("reduced", [True, False])
def test_vlm_param_tree_paths_match_reference(reduced):
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
    assert mine["embed.patch_pos"].shape == (cfg.n_patches, cfg.d_model)


def test_vlm_full_width_param_count_matches_reference():
    from repro_torch.models import build_model
    model = build_model(ARCH)  # meta parameters: nothing allocated
    assert model.embed.patch_pos.is_meta
    assert model.param_count() == jbuild(get_arch(ARCH)).param_count() \
        == 19_864_295_424


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("patches", [True, False])
def test_vlm_forward_matches_reference(torch, vlm, use_flash, patches):
    """With the patch embeddings in the batch, and without (a text-only
    prompt, as decode sees it)."""
    from repro_torch.models import Ctx
    jm, jp, model = _carried()
    batch = _batch(vlm)
    if not patches:
        del batch["patches"]
    want, _ = jm.forward(jp, {k: jnp.asarray(v) for k, v in batch.items()},
                         JCtx(use_flash=use_flash))
    got, _ = model.forward({k: torch.from_numpy(v) for k, v in batch.items()},
                           Ctx(use_flash=use_flash))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert rel_err(got, want) <= 1e-5


def test_vlm_patches_replace_the_first_positions(torch, vlm):
    """Logits at every position move with the patch embeddings (causal:
    each position sees the first n_patches); the tokens under the patch
    positions are never read."""
    from repro_torch.models import Ctx
    _, _, model = _carried()
    batch = {k: torch.from_numpy(v) for k, v in _batch(vlm).items()}
    base, _ = model.forward(batch, Ctx())
    hidden = dict(batch, tokens=batch["tokens"].clone())
    hidden["tokens"][:, :vlm.n_patches] = 7
    same, _ = model.forward(hidden, Ctx())
    assert torch.equal(same, base)
    moved, _ = model.forward(dict(batch, patches=batch["patches"] + 1), Ctx())
    assert (moved - base).abs().amax(dim=-1).min() > 0


def test_vlm_bf16_forward_matches_reference(torch, vlm):
    from repro_torch.models import Ctx
    jm, jp, model = _carried("bfloat16")
    batch = _batch(vlm, seed=7)
    batch["patches"] = batch["patches"].astype(jnp.bfloat16)
    want, _ = jm.forward(jp, {k: jnp.asarray(v) for k, v in batch.items()},
                         JCtx())
    got, _ = model.forward(
        {"tokens": torch.from_numpy(batch["tokens"]),
         "patches": torch.from_numpy(
             batch["patches"].astype(np.float32)).to(torch.bfloat16)},
        Ctx())
    assert rel_err(got, want) <= 2e-2


@pytest.mark.parametrize("layout", ["dense", "int8", "paged"])
def test_vlm_decode_matches_reference_teacher_forced(torch, vlm, layout):
    """12 tokens teacher-forced through G=2 heads: dense, int8 (values bit
    for bit) and the paged pool (page 4, pages a random permutation)
    against the reference's dense or int8 decode."""
    jm, jp, model = _carried()
    tokens = _batch(vlm, S=12, seed=6)["tokens"]
    kv = "int8" if layout == "int8" else None
    jstate = jm.init_decode_state(2, 16, "float32", kv_dtype=kv)
    if layout == "paged":
        state = model.init_decode_state(2, 16, "float32", kv_layout="paged",
                                        page_size=4, num_pages=16)
        perm = np.random.default_rng(7).permutation(16)[:8].reshape(2, 4)
        state.kv.block_tables[0] = torch.from_numpy(perm.astype(np.int32))
        state.tail.copy_(state.kv.block_tables[0, :, 0])
    else:
        state = model.init_decode_state(2, 16, "float32", kv_dtype=kv)
    worst, _, jstate, state = decode_both(jm, jp, model, tokens, jstate,
                                          state)
    assert worst <= 1e-5, worst
    assert state.length.tolist() == [12, 12]
    if layout == "int8":
        np.testing.assert_array_equal(state.v_cache.numpy(),
                                      np.asarray(jstate.v_cache))


@pytest.mark.parametrize("kv_layout", ["dense", "paged"])
def test_vlm_serving_matches_reference_token_for_token(torch, vlm, kv_layout):
    """8 prompts through 4 slots, max_seq 48, as ``serve_batch`` serves
    them; the port's engine over its dense cache or its paged pool (page
    8) against the reference's engine over its dense cache."""
    jm, jp, model = _carried()
    jeng, eng = serve_both(vlm, jm, jp, model, kv_layout=kv_layout,
                           page_size=8)
    assert [s.sid for s in eng.finished] == [s.sid for s in jeng.finished]
    assert len(eng.finished) == 8
    for got, want in zip(eng.finished, jeng.finished):
        assert got.out == want.out, got.sid
    assert eng.pages.pages_in_use() == 0 == jeng.pages.pages_in_use()
