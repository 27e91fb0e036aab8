"""Helpers shared by the LM parity tests of the port
(``tests/test_torch_moe.py``, ``test_torch_ssm.py``,
``test_torch_lm_train.py``): trees between jax and torch, the full
forward's logits in either package, tree comparisons."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import layers as JL, transformer as JT
from repro_torch import tree as TR
from repro_torch.models import layers as L, transformer as T
from repro_torch.models.convert import params_from_reference
from repro_torch.training import TrainState

CPU = "cpu"


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def tensors(tree):
    """A reference tree as a tree of CPU tensors (fp32 leaves)."""
    return TR.map_structure(lambda a: torch.from_numpy(np.array(a)),
                            np_tree(tree))


def tokens(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def full_logits_port(cfg, model, toks, dtype=None):
    """Logits of the port's full forward at every position."""
    p = T.as_tree(model)
    with torch.no_grad():
        x, _ = T._embed_inputs(cfg, p, {"tokens": torch.from_numpy(toks)})
        pos = torch.arange(x.shape[1], dtype=torch.int32)[None, :]
        h, _, _ = T._run_stack(cfg, p, x, pos, None, False)
        logits = T._logits(cfg, p, L.rmsnorm(p["ln_f"], h, cfg.norm_eps))
        return logits.to(dtype or logits.dtype).numpy()


def full_logits_ref(cfg, params, toks):
    """Logits of the reference's full forward at every position."""
    x, _ = JT._embed_inputs(cfg, params, {"tokens": jnp.asarray(toks)},
                            JT._noshard)
    pos = jnp.arange(x.shape[1], dtype=jnp.int32)[None, :]
    h, _, _ = JT._run_stack(cfg, params, x, pos, None, JT._noshard, False)
    return np.asarray(JT._logits(cfg, params, JL.rmsnorm(
        params["ln_f"], h, cfg.norm_eps)))


def assert_trees_close(jtree, ptree, atol=1e-4):
    """Same key paths, shapes and dtypes; leaves within ``atol``, or 2e-5
    of the leaf's largest entry where that is more (``atol=0``: equal)."""
    ja = jax.tree_util.tree_flatten_with_path(np_tree(jtree))[0]
    pa = TR.flatten_with_path(ptree)
    assert [jax.tree_util.keystr(p) for p, _ in ja] == [p for p, _ in pa]
    for (path, a), (_, b) in zip(ja, pa):
        name = jax.tree_util.keystr(path)
        b = b.detach().numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, name
        tol = max(atol, 2e-5 * float(np.abs(a).max(initial=0))) if atol \
            else 0
        np.testing.assert_allclose(b, a, atol=tol, rtol=0, err_msg=name)


def port_state(pc, jstate):
    """The reference's train state carried into the port."""
    return TrainState(
        params=params_from_reference(pc, np_tree(jstate.params), CPU).tree(),
        opt_state=params_from_reference(pc, np_tree(jstate.opt_state), CPU),
        step=torch.tensor(int(jstate.step), dtype=torch.int32))
