"""Training the MoE and SSD families: the port's train step, optimizers,
checkpoints and launcher (CPU) against ``repro``'s, for deepseek-v3
(MLA, MoE, MTP) and mamba2 (the SSD) ``reduced()``.

Tolerances (``tests/test_torch_training.py``'s): metrics (``xent``,
``aux``, ``mtp``, ``loss``) rtol 1e-5; params and optimizer state rtol
1e-4, atol 1e-6; AdamW's momentum atol 1e-5; Adafactor's momentum atol
2e-4: it holds (1 - b1) g / rms, and the router column or expert slab
of an expert that few tokens choose (deepseek's MTP layer sees 30
tokens) has a tiny rms, so fp32 gradient differences under 1e-5 of the
leaf's largest entry (step 1, the same params) reach ~8e-5 there."""
import os

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import CheckpointManager as JMgr  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.data import DataConfig, synthetic_batch  # noqa: E402
from repro.training import OptConfig as JOpt  # noqa: E402
from repro.training import make_train_step as jmake  # noqa: E402
from repro.training import train_state_init as jinit  # noqa: E402
from _torch_lm import CPU, np_tree, port_state  # noqa: E402
from repro_torch import tree as TR  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import train as plaunch  # noqa: E402
from repro_torch.models.convert import params_to_reference  # noqa: E402
from repro_torch.training import (OptConfig, make_train_step,  # noqa: E402
                                  train_state_init)

MOE = "deepseek-v3-671b"
SSM = "mamba2-780m"


@pytest.mark.parametrize("arch", [MOE, SSM])
@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_two_train_steps_match_reference(arch, kind):
    """Two steps; Adafactor factors the ``(n, E, d, f)`` expert leaves and
    the SSD's ``(n, d, 2 di + 2 N + H)`` projection over their last two
    dims, as the reference does."""
    jc, pc = jget(arch).reduced(), get_config(arch).reduced()
    kw = dict(kind=kind, lr=1e-3, warmup_steps=1, total_steps=10)
    js = jinit(jc, JOpt(**kw), jax.random.PRNGKey(0))
    ps = port_state(pc, js)
    jstep = jax.jit(jmake(jc, JOpt(**kw), remat=False))
    pstep = make_train_step(pc, OptConfig(**kw))
    data = DataConfig(global_batch=2, seq_len=16)
    for i in range(2):
        b = synthetic_batch(jc, data, i)
        js, jm = jstep(js, b)
        ps, pm = pstep(ps, b)
        assert sorted(pm) == sorted(jm)
        assert ("mtp" in pm) == bool(jc.mtp_depth)
        for k in jm:
            np.testing.assert_allclose(float(pm[k]), float(jm[k]),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
    if kind == "adafactor":
        leaf = (("stack", 0, "moe", "wi") if arch == MOE
                else ("stack", 0, "ssm", "in_proj"))
        st, p = ps.opt_state, ps.params
        for key in leaf:
            st, p = st[key], p[key]
        assert tuple(st["vr"].shape) == tuple(p.shape[:-1])
        assert tuple(st["vc"].shape) == tuple(p.shape[:-2] + p.shape[-1:])
    ja = jax.tree_util.tree_flatten_with_path(np_tree((js.params,
                                                   js.opt_state)))[0]
    pa = TR.flatten_with_path(params_to_reference(None, (ps.params,
                                                         ps.opt_state)))
    assert [jax.tree_util.keystr(p) for p, _ in ja] == [p for p, _ in pa]
    for (path, a), (_, b) in zip(ja, pa):
        name = jax.tree_util.keystr(path)
        atol = (1e-6 if not name.endswith("['m']") else
                2e-4 if kind == "adafactor" else 1e-5)
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=atol, err_msg=name)


@pytest.mark.parametrize("arch", [MOE, SSM])
def test_microbatches_match_reference(arch):
    """4 microbatches against the reference's 4.  mamba2's equal the full
    batch (loss rtol 1e-5, grad_norm 1e-4); a MoE's do not: capacity
    and the aux loss are per microbatch (T shrinks)."""
    jc, pc = jget(arch).reduced(), get_config(arch).reduced()
    kw = dict(lr=0.0, warmup_steps=0, total_steps=10, weight_decay=0.0)
    js = jinit(jc, JOpt(**kw), jax.random.PRNGKey(0))
    ps = port_state(pc, js)
    batch = synthetic_batch(jc, DataConfig(global_batch=8, seq_len=16), 0)
    _, m4 = make_train_step(pc, OptConfig(**kw), microbatches=4)(ps, batch)
    _, jm4 = jax.jit(jmake(jc, JOpt(**kw), microbatches=4,
                           remat=False))(js, batch)
    assert sorted(jm4) == sorted(m4)
    for k in jm4:
        np.testing.assert_allclose(float(m4[k]), float(jm4[k]), rtol=1e-5)
    if arch == SSM:
        _, m1 = make_train_step(pc, OptConfig(**kw))(ps, batch)
        np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m1["grad_norm"]),
                                   float(m4["grad_norm"]), rtol=1e-4)


def test_moe_train_checkpoint_opens_in_the_other_package(tmp_path):
    """A deepseek-v3 train state (MLA, MoE, MTP leaves; AdamW) saved by
    either package restores in the other, leaf for leaf."""
    jc, pc = jget(MOE).reduced(), get_config(MOE).reduced()
    kw = dict(lr=3e-4, warmup_steps=5, total_steps=10)
    js = jinit(jc, JOpt(**kw), jax.random.PRNGKey(2))
    JMgr(str(tmp_path / "j")).save(3, js, extra={"data_step": 3})
    like = train_state_init(pc, OptConfig(**kw), 0, device=CPU)
    step, got, extra = CheckpointManager(str(tmp_path / "j")
                                         ).restore_latest(like)
    assert step == 3 and extra == {"data_step": 3}
    ja = jax.tree_util.tree_flatten_with_path(np_tree(js))[0]
    pa = TR.flatten_with_path(got)
    assert [jax.tree_util.keystr(p) for p, _ in ja] == [p for p, _ in pa]
    for (_, a), (_, b) in zip(ja, pa):
        np.testing.assert_array_equal(b.numpy(), a)
    paths = [p for p, _ in pa]
    assert ".params['stack'][0]['moe']['wi']" in paths
    assert ".params['mtp']['layer']['moe']['router']" in paths
    assert ".opt_state['m']['prefix'][0]['attn']['wkv_a']" in paths
    CheckpointManager(str(tmp_path / "p")).save(4, got,
                                                extra={"data_step": 4})
    jlike = jinit(jc, JOpt(**kw), jax.random.PRNGKey(9))
    step, back, _ = JMgr(str(tmp_path / "p")).restore_latest(jlike)
    assert step == 4
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(js)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("arch", [MOE, SSM])
def test_launcher_trains_and_resumes(arch, tmp_path, capsys):
    """``python -m repro_torch.launch.train --device cpu --reduced``: the
    reference's lines, and a resume from a checkpoint equal to the
    uninterrupted run."""
    argv = ["--arch", arch, "--reduced", "--batch", "2", "--seq", "16",
            "--device", CPU, "--ckpt-every", "2"]
    full = plaunch.main(argv + ["--steps", "4"])
    d = str(tmp_path / "ck")
    plaunch.main(argv + ["--steps", "2", "--ckpt-dir", d])
    rest = plaunch.main(argv + ["--steps", "4", "--ckpt-dir", d])
    out = [l for l in capsys.readouterr().out.splitlines() if l.strip()]
    assert "[resume] from checkpoint step 2" in out
    assert out[-1].startswith("[done] 2 steps in ")
    assert all(np.isfinite(full)) and rest == full[2:]
    assert sorted(os.listdir(d)) == ["step_0000000002", "step_0000000004"]
