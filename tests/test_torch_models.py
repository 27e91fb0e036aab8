"""The dense decoder LM: the port (``repro_torch.models``, CPU) against
``repro.models`` for the six dense configs ``reduced()``, from the
reference's ``init_params`` carried across by ``params_from_reference``.

Tolerances: loss and metrics rtol 1e-5, logits and caches atol 1e-4
(fp32 einsums summed in another order); greedy tokens equal; decode
within 5e-3 of teacher forcing (``tests/test_models.py``'s)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget, list_archs  # noqa: E402
from repro.models import layers as JL, transformer as JT  # noqa: E402
from repro.serving import greedy_generate as jgreedy  # noqa: E402
from repro_torch import tree as TR  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Transformer  # noqa: E402
from repro_torch.models import layers as L, transformer as T  # noqa: E402
from repro_torch.models.convert import (params_from_reference,  # noqa: E402
                                        params_to_reference)
from repro_torch.serving import ServeConfig, greedy_generate  # noqa: E402

CPU = "cpu"
DENSE = ["qwen3-0.6b", "yi-6b", "qwen1.5-110b", "phi3-mini-3.8b",
         "musicgen-medium", "internvl2-26b"]


@pytest.fixture(scope="module")
def models():
    """arch -> (reference cfg, port cfg, reference params, port model)."""
    out = {}
    for i, arch in enumerate(DENSE):
        jc, pc = jget(arch).reduced(), get_config(arch).reduced()
        jp = JT.init_params(jc, jax.random.PRNGKey(i))
        out[arch] = (jc, pc, jp, params_from_reference(
            pc, jax.tree.map(np.asarray, jp), device=CPU))
    return out


def _batch(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    batch = {}
    if cfg.frontend == "audio_stub":
        batch["embeds"] = rng.normal(size=(B, S, cfg.d_model)
                                     ).astype(np.float32)
        batch["labels"] = rng.integers(0, cfg.vocab_size, (B, S)
                                       ).astype(np.int32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)
                                       ).astype(np.int32)
        if cfg.frontend == "vlm_stub":
            batch["patches"] = rng.normal(
                size=(B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return batch


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _full_logits(mod, cfg, params, batch, tree_fn):
    """Logits at every position, as ``tests/test_models.py`` takes them."""
    if mod is JT:
        x, _ = JT._embed_inputs(cfg, params, batch, JT._noshard)
        pos = jnp.arange(x.shape[1], dtype=jnp.int32)[None, :]
        h, _, _ = JT._run_stack(cfg, params, x, pos, None, JT._noshard,
                                False)
        return np.asarray(JT._logits(cfg, params, JL.rmsnorm(
            params["ln_f"], h, cfg.norm_eps)))
    p = tree_fn(params)
    with torch.no_grad():
        x, _ = T._embed_inputs(cfg, p, batch)
        pos = torch.arange(x.shape[1], dtype=torch.int32)[None, :]
        h, _, _ = T._run_stack(cfg, p, x, pos, None, False)
        return T._logits(cfg, p, L.rmsnorm(p["ln_f"], h,
                                           cfg.norm_eps)).numpy()


@pytest.mark.parametrize("arch", DENSE)
def test_weights_round_trip(models, arch):
    jc, pc, jp, model = models[arch]
    assert isinstance(model, Transformer)
    back = params_to_reference(pc, model)
    ja = jax.tree_util.tree_flatten_with_path(jp)[0]
    pa = TR.flatten_with_path(back)
    assert [jax.tree_util.keystr(p) for p, _ in ja] == [p for p, _ in pa]
    for (_, a), (_, b) in zip(ja, pa):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), b)
    n_mod = sum(p.numel() for p in model.parameters())
    assert n_mod == sum(np.asarray(a).size for _, a in ja)


@pytest.mark.parametrize("arch", DENSE)
def test_forward_train_matches_reference(models, arch):
    jc, pc, jp, model = models[arch]
    batch = _batch(jc, 2, 16, seed=1)
    jl, jm = JT.forward_train(jc, jp, _j(batch), remat=False)
    with torch.no_grad():
        pl, pm = T.forward_train(pc, model, _t(batch), remat=False)
        ml, _ = model(_t(batch))               # the module's forward
    assert sorted(pm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-7)
    assert float(ml) == float(pl)
    np.testing.assert_allclose(
        _full_logits(T, pc, model, _t(batch), T.as_tree),
        _full_logits(JT, jc, jp, _j(batch), None), atol=1e-4, rtol=0)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_reference(models, arch):
    jc, pc, jp, model = models[arch]
    B, S, S0 = 2, 12, 6
    batch = _batch(jc, B, S, seed=42)
    b0 = dict(batch)
    for k in ("tokens", "embeds"):
        if k in b0:
            b0[k] = batch[k][:, :S0]
    off = jc.num_patches if jc.frontend == "vlm_stub" else 0
    jlg, jcache = JT.prefill(jc, jp, _j(b0), max_len=off + S + 2)
    plg, pcache = T.prefill(pc, model, _t(b0), max_len=off + S + 2)
    np.testing.assert_allclose(plg.numpy(), np.asarray(jlg), atol=1e-4,
                               rtol=0)
    full = _full_logits(T, pc, model, _t(batch), T.as_tree)
    for t in range(S0, S):
        if jc.frontend == "audio_stub":
            e = batch["embeds"][:, t:t + 1]
            jlg, jcache = JT.decode_step(jc, jp, None, jcache,
                                         embeds=jnp.asarray(e))
            plg, pcache = T.decode_step(pc, model, None, pcache,
                                        embeds=torch.from_numpy(e))
        else:
            tok = batch["tokens"][:, t:t + 1]
            jlg, jcache = JT.decode_step(jc, jp, jnp.asarray(tok), jcache)
            plg, pcache = T.decode_step(pc, model, torch.from_numpy(tok),
                                        pcache)
        np.testing.assert_allclose(plg.numpy(), np.asarray(jlg), atol=1e-4,
                                   rtol=0)
        np.testing.assert_allclose(plg.numpy()[:, 0], full[:, off + t],
                                   rtol=5e-3, atol=5e-3)
    ja = jax.tree_util.tree_flatten_with_path(jcache)[0]
    pa = TR.flatten_with_path(pcache)
    assert [jax.tree_util.keystr(p) for p, _ in ja] == [p for p, _ in pa]
    for (_, a), (_, b) in zip(ja, pa):
        assert np.asarray(a).shape == tuple(b.shape)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4,
                                   rtol=0)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "phi3-mini-3.8b"])
def test_chunked_attention_matches_reference(models, arch):
    """``attn_chunking`` forces the online-softmax path at S = 16 (chunk
    4): the port's chunked path against the reference's chunked path and
    against its own dense path."""
    jc, pc, jp, model = models[arch]
    batch = _batch(jc, 2, 16, seed=3)
    dense = _full_logits(T, pc, model, _t(batch), T.as_tree)
    with JL.attn_chunking(threshold=4, chunk=4), \
            L.attn_chunking(threshold=4, chunk=4):
        assert L.ATTN_KV_CHUNK == 4
        want = _full_logits(JT, jc, jp, _j(batch), None)
        got = _full_logits(T, pc, model, _t(batch), T.as_tree)
        jl, _ = JT.forward_train(jc, jp, _j(batch), remat=False)
        with torch.no_grad():
            pl, _ = T.forward_train(pc, model, _t(batch), remat=False)
    assert L.ATTN_KV_CHUNK == 2048
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got, dense, atol=1e-4, rtol=0)
    np.testing.assert_allclose(float(pl), float(jl), rtol=1e-5)
    # the chunked path itself, with a cache-style kv mask and an offset
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=s).astype(np.float32) for s in
               ((2, 8, 4, 16), (2, 16, 2, 16), (2, 16, 2, 16)))
    m = np.arange(16)[None, :] < np.array([[13], [16]])
    jo = JL._sdpa_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=True, q_offset=5,
                          kv_len_mask=jnp.asarray(m), chunk=4)
    po = L._sdpa_chunked(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), causal=True, q_offset=5,
                         kv_len_mask=torch.from_numpy(m), chunk=4)
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("arch,chunk", [("qwen3-0.6b", 5),
                                        ("internvl2-26b", 4),
                                        ("musicgen-medium", 16)])
def test_loss_chunk_matches_dense_loss(models, arch, chunk):
    jc, pc, jp, model = models[arch]
    batch = _batch(jc, 2, 16, seed=4)
    dense, _ = T.forward_train(pc, model, _t(batch), remat=False)
    chunked, _ = T.forward_train(pc, model, _t(batch), remat=True,
                                 loss_chunk=chunk)
    jl, _ = JT.forward_train(jc, jp, _j(batch), remat=False,
                             loss_chunk=chunk)
    np.testing.assert_allclose(float(chunked.detach()),
                               float(dense.detach()), rtol=1e-5)
    np.testing.assert_allclose(float(chunked.detach()), float(jl),
                               rtol=1e-5)
    ps = list(model.parameters())
    gd = torch.autograd.grad(dense, ps, allow_unused=True)
    gc = torch.autograd.grad(chunked, ps, allow_unused=True)
    for a, b in zip(gd, gc):         # musicgen's embed is unused: None
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-6,
                                       rtol=0)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "yi-6b", "internvl2-26b"])
def test_greedy_generate_tokens_equal(models, arch):
    jc, pc, jp, model = models[arch]
    batch = _batch(jc, 2, 8, seed=5)
    want = np.asarray(jgreedy(jc, jp, _j(batch), 6))
    got = greedy_generate(pc, model, batch, 6, ServeConfig(max_len=64))
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 6)
    np.testing.assert_array_equal(got.numpy(), want)
    again = greedy_generate(pc, model, batch, 6, ServeConfig(max_len=64))
    assert torch.equal(got, again)


@pytest.mark.parametrize("arch", list_archs())
def test_configs_and_param_counts_equal(arch):
    jc, pc = jget(arch), get_config(arch)
    assert type(pc).__module__ == "repro_torch.models.config"
    for a, b in ((jc, pc), (jc.reduced(), pc.reduced())):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.param_count() == b.param_count()
        assert a.active_param_count() == b.active_param_count()
        assert a.period == b.period
    jd, pd = jget("dna-suffix"), get_config("dna-suffix")
    assert dataclasses.asdict(jd) == dataclasses.asdict(pd)


def test_init_params_shapes_and_scales():
    """The port's own init: the reference's tree, shapes and dtypes, from
    a seeded generator (values differ from jax's PRNG)."""
    for arch in DENSE:
        jc, pc = jget(arch).reduced(), get_config(arch).reduced()
        shapes = jax.eval_shape(lambda: JT.init_params(
            jc, jax.random.PRNGKey(0)))
        p = T.init_params(pc, 7, device=CPU)
        ja = jax.tree_util.tree_flatten_with_path(shapes)[0]
        pa = TR.flatten_with_path(p)
        assert [jax.tree_util.keystr(k) for k, _ in ja] == [k for k, _ in pa]
        for (_, a), (_, b) in zip(ja, pa):
            assert tuple(a.shape) == tuple(b.shape)
        assert abs(float(p["embed"].std()) - 0.02) < 0.002
        again = T.init_params(pc, torch.Generator().manual_seed(7),
                              device=CPU)
        assert torch.equal(p["embed"], again["embed"])
