"""The Mamba2 SSD and the hybrid stack: the port (``repro_torch.models``,
CPU) against ``repro.models`` for mamba2 (SSD only) and jamba (SSD,
attention and MoE in one period of 8) ``reduced()``, from the
reference's ``init_params`` carried across by ``params_from_reference``.

Tolerances (``tests/test_torch_models.py``'s): loss and metrics rtol
1e-5, logits, layer outputs and caches atol 1e-4, or 2e-5 of the leaf's
largest entry where that is more (jamba's SSM states reach ~30 after 16
layers, where fp32 summation order alone moves them ~2e-4), greedy
tokens equal, decode within 5e-3 of teacher forcing (jamba's at
capacity 8.0, as ``tests/test_models.py:72-73``); ``ssd_chunked``
against the step recurrence at the reference test's 2e-4."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving import greedy_generate as jgreedy  # noqa: E402
from _torch_lm import (CPU, assert_trees_close, full_logits_port,  # noqa: E402
                       full_logits_ref, np_tree, tensors, tokens)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch import tree as TR  # noqa: E402
from repro_torch.models.convert import (params_from_reference,  # noqa: E402
                                        params_to_reference)
from repro_torch.serving import ServeConfig, greedy_generate  # noqa: E402

ARCHS = ["mamba2-780m", "jamba-v0.1-52b"]


@pytest.fixture(scope="module")
def models():
    """arch -> (reference cfg, port cfg, reference params, port model)."""
    out = {}
    for i, arch in enumerate(ARCHS):
        jc, pc = jget(arch).reduced(), get_config(arch).reduced()
        jp = JT.init_params(jc, jax.random.PRNGKey(20 + i))
        out[arch] = (jc, pc, jp, params_from_reference(pc, np_tree(jp),
                                                       device=CPU))
    return out


# ---------------------------------------------------------------------------
# The SSD and the block alone
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("s", [32, 27])
def test_ssd_chunked_matches_reference_and_recurrence(s):
    """``tests/test_models.py:126``'s sizes, ``s`` a multiple of the chunk
    (8) and not one (padded with dt = 0): against the reference's
    ``ssd_chunked`` and the step recurrence; the backward is finite (the
    segment sums are masked before the ``exp``)."""
    rng = np.random.default_rng(0)
    b, h, p, n = 2, 3, 8, 4
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.1, 0.9, size=(b, s, h)).astype(np.float32)
    A = -rng.uniform(0.5, 1.5, size=(h,)).astype(np.float32)
    B = rng.normal(size=(b, s, n)).astype(np.float32)
    C = rng.normal(size=(b, s, n)).astype(np.float32)
    jy, jfinal = JS.ssd_chunked(*map(jnp.asarray, (x, dt, A, B, C)),
                                chunk=8)
    args = [torch.from_numpy(a).requires_grad_(True)
            for a in (x, dt, A, B, C)]
    y, final = S.ssd_chunked(*args, chunk=8)
    assert tuple(y.shape) == (b, s, h, p)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(final.detach().numpy(), np.asarray(jfinal),
                               atol=1e-4, rtol=0)
    st = np.zeros((b, h, p, n), np.float32)
    for t in range(s):
        dA = np.exp(dt[:, t] * A[None])
        st = st * dA[..., None, None] + np.einsum(
            "bhp,bn->bhpn", x[:, t] * dt[:, t][..., None], B[:, t])
        np.testing.assert_allclose(
            y[:, t].detach().numpy(),
            np.einsum("bn,bhpn->bhp", C[:, t], st), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(final.detach().numpy(), st, rtol=2e-4,
                               atol=2e-4)
    grads = torch.autograd.grad((y.sum() + final.sum()), args)
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_ssm_block_prefill_and_decode_match_reference():
    """``ssm_block`` alone: the prefill output and state (``ssm`` fp32,
    ``conv`` the pre-conv taps), then decode steps whose new states are
    written into the given state, against the reference's."""
    cfg = get_config("mamba2-780m").reduced()
    jc = jget("mamba2-780m").reduced()
    jp = JS.init_ssm(jc, jax.random.PRNGKey(8), jnp.float32)
    pp = tensors(jp)
    B, S0, S_ = 2, 20, 24                      # prefill past one chunk
    x = np.random.default_rng(9).normal(size=(B, S_, jc.d_model)
                                        ).astype(np.float32)
    jo, jst = JS.ssm_block(jc, jp, jnp.asarray(x[:, :S0]))
    with torch.no_grad():
        po, pst = S.ssm_block(cfg, pp, torch.from_numpy(x[:, :S0]))
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=1e-4, rtol=0)
    assert_trees_close(jst, pst)
    assert pst["ssm"].dtype == torch.float32
    assert tuple(pst["conv"].shape) == (B, jc.ssm_conv - 1,
                                        jc.d_inner + 2 * jc.ssm_state)
    ssm_t = pst["ssm"]
    for t in range(S0, S_):
        jo, jst = JS.ssm_block(jc, jp, jnp.asarray(x[:, t:t + 1]),
                               state=jst)
        with torch.no_grad():
            po, pst = S.ssm_block(cfg, pp, torch.from_numpy(x[:, t:t + 1]),
                                  state=pst)
        np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=1e-4,
                                   rtol=0)
        assert pst["ssm"] is ssm_t                 # written in place
    assert_trees_close(jst, pst)


# ---------------------------------------------------------------------------
# The stacks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_weights_round_trip(models, arch):
    """The ``ssm`` leaves (fp32 ``A_log``/``dt_bias``/``D`` among them)
    and jamba's ``moe`` and ``attn`` leaves, carried across and back bit
    for bit, in the reference's flatten order."""
    jc, pc, jp, model = models[arch]
    back = params_to_reference(pc, model)
    ja = jax.tree_util.tree_flatten_with_path(jp)[0]
    pa = TR.flatten_with_path(back)
    assert [jax.tree_util.keystr(p) for p, _ in ja] == [p for p, _ in pa]
    for (_, a), (_, b) in zip(ja, pa):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), b)
    assert "['stack'][0]['ssm']['A_log']" in [p for p, _ in pa]


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_matches_reference(models, arch):
    jc, pc, jp, model = models[arch]
    toks = tokens(jc, 2, 20, seed=1)
    jl, jm = JT.forward_train(jc, jp, {"tokens": jnp.asarray(toks)},
                              remat=False)
    with torch.no_grad():
        pl, pm = T.forward_train(pc, model, {"tokens": torch.from_numpy(
            toks)}, remat=False)
    assert sorted(pm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_allclose(full_logits_port(pc, model, toks),
                               full_logits_ref(jc, jp, toks), atol=1e-4,
                               rtol=0)


def test_nested_remat_gives_the_same_grads(models):
    """jamba's period of 8 under ``remat``: each layer checkpointed inside
    the period's checkpoint; loss and grads equal the run without remat
    bit for bit (the recompute is the same computation)."""
    _, pc, _, model = models["jamba-v0.1-52b"]
    assert pc.period == 8
    batch = {"tokens": torch.from_numpy(tokens(pc, 2, 16, seed=2))}
    ps = list(model.parameters())
    out = []
    for remat in (False, True):
        loss, m = T.forward_train(pc, model, batch, remat=remat)
        out.append((loss.detach(), m["aux"].detach(),
                    torch.autograd.grad(loss, ps)))
    (l0, a0, g0), (l1, a1, g1) = out
    assert float(l0) == float(l1) and float(a0) == float(a1) > 0
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(models, arch):
    """Prefill, each decode step and the caches (SSM states in fp32, conv
    taps, jamba's attention ``k``/``v`` with lengths) equal the
    reference's (jamba at its published capacity 1.25, equal T)."""
    jc, pc, jp, model = models[arch]
    toks = tokens(jc, 2, 12, seed=42)
    S0 = 6
    jlg, jcache = JT.prefill(jc, jp, {"tokens": jnp.asarray(toks[:, :S0])},
                             max_len=14)
    plg, pcache = T.prefill(pc, model, {"tokens": torch.from_numpy(
        toks[:, :S0])}, max_len=14)
    np.testing.assert_allclose(plg.numpy(), np.asarray(jlg), atol=1e-4,
                               rtol=0)
    assert_trees_close(jcache, pcache)
    for t in range(S0, 12):
        tok = toks[:, t:t + 1]
        jlg, jcache = JT.decode_step(jc, jp, jnp.asarray(tok), jcache)
        plg, pcache = T.decode_step(pc, model, torch.from_numpy(tok), pcache)
        np.testing.assert_allclose(plg.numpy(), np.asarray(jlg), atol=1e-4,
                                   rtol=0)
    assert_trees_close(jcache, pcache)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_teacher_forcing(models, arch):
    _, pc, _, model = models[arch]
    pc = dataclasses.replace(pc, moe_capacity_factor=8.0)
    toks = tokens(pc, 2, 16, seed=7)
    full = full_logits_port(pc, model, toks)
    lg, caches = T.prefill(pc, model, {"tokens": torch.from_numpy(
        toks[:, :8])}, max_len=20)
    np.testing.assert_allclose(lg.numpy()[:, 0], full[:, 7], rtol=5e-3,
                               atol=5e-3)
    for t in range(8, 16):
        lg, caches = T.decode_step(pc, model,
                                   torch.from_numpy(toks[:, t:t + 1]),
                                   caches)
        np.testing.assert_allclose(lg.numpy()[:, 0], full[:, t],
                                   rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_tokens_equal(models, arch):
    jc, pc, jp, model = models[arch]
    toks = tokens(jc, 2, 8, seed=5)
    want = np.asarray(jgreedy(jc, jp, {"tokens": jnp.asarray(toks)}, 5))
    got = greedy_generate(pc, model, {"tokens": toks}, 5,
                          ServeConfig(max_len=32))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", ARCHS + ["deepseek-v3-671b"])
def test_init_decode_caches_match_reference(models, arch):
    """Fresh caches: the reference's tree, shapes and dtypes (MLA latents,
    SSM states in fp32); for the SSD configs one decode step from them
    equals the reference's."""
    jc, pc = jget(arch).reduced(), get_config(arch).reduced()
    jcache = JT.init_decode_caches(jc, 2, 8)
    pcache = T.init_decode_caches(pc, 2, 8, device=CPU)
    assert_trees_close(jcache, pcache, atol=0)
    if arch in models:
        _, _, jp, model = models[arch]
        tok = tokens(jc, 2, 1, seed=3)
        jlg, _ = JT.decode_step(jc, jp, jnp.asarray(tok), jcache)
        plg, _ = T.decode_step(pc, model, torch.from_numpy(tok), pcache)
        np.testing.assert_allclose(plg.numpy(), np.asarray(jlg), atol=1e-4,
                                   rtol=0)


@pytest.mark.parametrize("S0", [1, 2, 3])
def test_short_prompt_decode_matches_reference(models, S0):
    """A fault of the reference, matched (ROADMAP queue 3): prefill keeps
    the last ``ssm_conv - 1`` = 3 pre-conv taps, so a prompt of 1 or 2
    tokens leaves a shorter conv state and the first decode step cannot
    broadcast it against the 4-tap kernel; the reference raises there,
    and so does the port.  At 3 tokens both decode, equal."""
    jc, pc, jp, model = models["mamba2-780m"]
    toks = tokens(jc, 2, S0 + 1, seed=11)
    jlg, jcache = JT.prefill(jc, jp, {"tokens": jnp.asarray(toks[:, :S0])},
                             max_len=8)
    plg, pcache = T.prefill(pc, model, {"tokens": torch.from_numpy(
        toks[:, :S0])}, max_len=8)
    np.testing.assert_allclose(plg.numpy(), np.asarray(jlg), atol=1e-4,
                               rtol=0)
    conv = pcache["stack"][0]["conv"]
    assert conv.shape[2] == min(S0, jc.ssm_conv - 1)
    nxt = toks[:, S0:S0 + 1]
    if S0 < jc.ssm_conv - 1:
        with pytest.raises((TypeError, ValueError), match="broadcast"):
            JT.decode_step(jc, jp, jnp.asarray(nxt), jcache)
        with pytest.raises(ValueError, match="ROADMAP queue 3"):
            T.decode_step(pc, model, torch.from_numpy(nxt), pcache)
    else:
        jlg, _ = JT.decode_step(jc, jp, jnp.asarray(nxt), jcache)
        plg, _ = T.decode_step(pc, model, torch.from_numpy(nxt), pcache)
        np.testing.assert_allclose(plg.numpy(), np.asarray(jlg), atol=1e-4,
                                   rtol=0)
