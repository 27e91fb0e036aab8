"""The sharded train step (ZeRO-1 over a data x model mesh), elastic
restore and the launcher's production meshes (``repro_torch.training``,
``distributed.sharding``, ``checkpoint``, ``launch.train``; CPU shards)
against ``repro``'s single-device steps on the same numpy inputs.

The reference's own sharded step raises under this repo's jax (ROADMAP
queue 3, reference entries 2 and 4), and GSPMD's contract is that a
sharded step computes the one-device step, so the oracle is the
reference's single-device step.

Tolerances (``tests/test_torch_training.py``'s): metrics rtol 1e-5, atol
1e-7; params and optimizer state rtol 1e-4, atol 1e-6; momentum ``m``
atol 1e-5 (AdamW) and 2e-4 for Adafactor on deepseek-v3 (its expert
slabs' tiny rms, ``tests/test_torch_lm_train.py``); losses after a
restore rtol 1e-4."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import CheckpointManager as JMgr  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.data import DataConfig, synthetic_batch  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.training import OptConfig as JOpt  # noqa: E402
from repro.training import make_train_step as jmake  # noqa: E402
from repro.training import train_state_init as jinit  # noqa: E402
from _torch_lm import CPU, np_tree, port_state  # noqa: E402
from repro_torch import tree as TR  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import collectives as COL  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.launch import train as plaunch  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.training import (OptConfig, TrainState,  # noqa: E402
                                  make_train_step)

ARCH = "qwen3-0.6b"
MESHES = [(2, 4), (4, 2), (8, 1), (1, 8)]
DATA = DataConfig(global_batch=8, seq_len=16)
_REF: dict = {}


def cpu_mesh(shape):
    return make_mesh(shape, ("data", "model"),
                     devices=[CPU] * int(np.prod(shape)))


def reference(arch, steps, **kw):
    """The reference's single-device run, once per (arch, steps, kw):
    its initial state, the metrics of each step and the final state."""
    key = (arch, steps, tuple(sorted(kw.items())))
    if key not in _REF:
        jc = jget(arch).reduced()
        jo = JOpt(**kw)
        js = jinit(jc, jo, jax.random.PRNGKey(0))
        state0 = js
        jstep = jax.jit(jmake(jc, jo, remat=False))
        metrics = []
        for i in range(steps):
            js, jm = jstep(js, synthetic_batch(jc, DATA, i))
            metrics.append({k: float(v) for k, v in jm.items()})
        _REF[key] = (state0, metrics, np_tree((js.params, js.opt_state)))
    return _REF[key]


def placed(pc, ocfg, state, mesh):
    specs, _ = plaunch.state_specs(pc, ocfg, mesh)
    return SH.place_tree(state, specs, mesh)


def run_sharded(arch, shape, steps, **kw):
    """``steps`` sharded steps from the reference's initial state:
    (metrics per step, the final sharded state)."""
    pc = get_config(arch).reduced()
    ocfg = OptConfig(**kw)
    jstate0, _, _ = reference(arch, steps, **kw)
    mesh = cpu_mesh(shape)
    state = placed(pc, ocfg, port_state(pc, jstate0), mesh)
    step = make_train_step(pc, ocfg, shard=SH.make_shard_fn(mesh))
    out = []
    for i in range(steps):
        state, m = step(state, synthetic_batch(jget(arch).reduced(), DATA,
                                               i))
        out.append({k: float(v) for k, v in m.items()})
    return out, state


def assert_matches_reference(arch, got, state, want, jtree, m_atol=1e-5):
    for pm, jm in zip(got, want):
        assert sorted(pm) == sorted(jm)
        for k in jm:
            np.testing.assert_allclose(pm[k], jm[k], rtol=1e-5, atol=1e-7,
                                       err_msg=k)
    joined = SH.join_tree(state)
    ja = jax.tree_util.tree_flatten_with_path(jtree)[0]
    pa = TR.flatten_with_path((joined.params, joined.opt_state))
    assert [jax.tree_util.keystr(p) for p, _ in ja] == [p for p, _ in pa]
    for (path, a), (_, b) in zip(ja, pa):
        name = jax.tree_util.keystr(path)
        atol = m_atol if name.endswith("['m']") else 1e-6
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-4, atol=atol,
                                   err_msg=name)


ADAMW = dict(kind="adamw", lr=1e-3, warmup_steps=1, total_steps=10)


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_two_sharded_steps_match_reference(shape):
    got, state = run_sharded(ARCH, shape, 2, **ADAMW)
    _, want, jtree = reference(ARCH, 2, **ADAMW)
    assert_matches_reference(ARCH, got, state, jtree=jtree, want=want)
    wq = state.params["stack"][0]["attn"]["wq"]
    assert isinstance(wq, SH.Sharded) and len(wq.pieces) == 8
    # each distinct block is stored once: a replicated leaf has one block
    norm = state.params["ln_f"]["scale"]
    assert len(norm.blocks) == 1 and norm.layout.splits == 1
    assert SH.stored_bytes(state.params) == sum(
        int(np.prod(x.shape)) * 4 for x in TR.leaves(state.params))
    assert int(SH.join_tree(state).step) == 2


@pytest.mark.parametrize("b1", [0.0, 0.9])
def test_adafactor_splits_the_reduced_dim(b1):
    """On (2, 4) the MLP's ``wi`` (n, d, f) is (None, data, model): both
    of its factored means total partial sums over the axes that split
    the reduced dim (grouped psums)."""
    kw = dict(kind="adafactor", lr=1e-3, warmup_steps=1, total_steps=10,
              b1=b1)
    with COL.counting(8) as counts:
        got, state = run_sharded(ARCH, (2, 4), 2, **kw)
    _, want, jtree = reference(ARCH, 2, **kw)
    assert_matches_reference(ARCH, got, state, jtree=jtree, want=want)
    wi = state.params["stack"][0]["mlp"]["wi"]
    assert wi.spec == SH.P(None, ("data",), "model")
    vr = state.opt_state["stack"][0]["mlp"]["wi"]["vr"]
    assert vr.layout.splits == 2 and len(wi.blocks) == 8
    assert counts.count["psum"] > 2          # more than the grad norms
    assert ("m" in state.opt_state["stack"][0]["mlp"]["wi"]) == (b1 > 0)


def test_clipping_binds():
    kw = dict(ADAMW, clip_norm=1e-3)
    got, state = run_sharded(ARCH, (2, 4), 2, **kw)
    _, want, jtree = reference(ARCH, 2, **kw)
    assert all(m["grad_norm"] > 1e-3 * 100 for m in want)
    assert_matches_reference(ARCH, got, state, jtree=jtree, want=want)


@pytest.mark.parametrize("arch,kind", [("deepseek-v3-671b", "adafactor"),
                                       ("jamba-v0.1-52b", "adamw")])
def test_other_families_one_step(arch, kind):
    """MLA, MoE and MTP leaves (deepseek-v3, Adafactor) and the hybrid
    stack (jamba, AdamW) over (2, 4)."""
    kw = dict(kind=kind, lr=1e-3, warmup_steps=1, total_steps=10)
    got, state = run_sharded(arch, (2, 4), 1, **kw)
    _, want, jtree = reference(arch, 1, **kw)
    assert_matches_reference(arch, got, state, jtree=jtree, want=want,
                             m_atol=2e-4 if kind == "adafactor" else 1e-5)


@pytest.fixture(scope="module")
def elastic(tmp_path_factory):
    """Three steps on (2, 4), saved; the fourth step there too."""
    d = str(tmp_path_factory.mktemp("elastic"))
    _, state = run_sharded(ARCH, (2, 4), 3, **ADAMW)
    CheckpointManager(d).save(3, state, extra={"data_step": 3})
    pc = get_config(ARCH).reduced()
    step = make_train_step(pc, OptConfig(**ADAMW),
                           shard=SH.make_shard_fn(cpu_mesh((2, 4))))
    _, m = step(state, synthetic_batch(jget(ARCH).reduced(), DATA, 3))
    return d, SH.join_tree(state), float(m["loss"])


@pytest.mark.parametrize("target", [(8, 1), (1, 8), None],
                         ids=["8x1", "1x8", "one-device"])
def test_elastic_restore_onto_another_mesh(elastic, target):
    d, joined, loss4 = elastic
    pc = get_config(ARCH).reduced()
    ocfg = OptConfig(**ADAMW)
    like = placed(pc, ocfg, joined, cpu_mesh((2, 4)))
    if target is None:
        shardings, shard = None, None
    else:
        mesh = cpu_mesh(target)
        shardings = (mesh, plaunch.state_specs(pc, ocfg, mesh)[0])
        shard = SH.make_shard_fn(mesh)
    at, state, extra = CheckpointManager(d).restore_latest(like, shardings)
    assert at == 3 and extra == {"data_step": 3}
    leaves = TR.leaves(state)
    if target is None:
        assert all(isinstance(x, torch.Tensor) for x in leaves)
    else:
        assert all(isinstance(x, SH.Sharded) and x.mesh == mesh
                   for x in leaves)
    for a, b in zip(TR.leaves(SH.join_tree(state)), TR.leaves(joined)):
        assert torch.equal(a, b)
    _, m = make_train_step(pc, ocfg, shard=shard)(
        state, synthetic_batch(jget(ARCH).reduced(), DATA, 3))
    _, want, _ = reference(ARCH, 4, **ADAMW)
    np.testing.assert_allclose(float(m["loss"]), loss4, rtol=1e-4)
    np.testing.assert_allclose(float(m["loss"]), want[3]["loss"], rtol=1e-4)


def test_reference_opens_the_sharded_checkpoint(elastic):
    d, joined, _ = elastic
    like = jinit(jget(ARCH).reduced(), JOpt(**ADAMW), jax.random.PRNGKey(5))
    step, got, extra = JMgr(d).restore_latest(like)
    assert step == 3 and extra == {"data_step": 3}
    ja = jax.tree_util.tree_flatten_with_path(np_tree(got))[0]
    pa = TR.flatten_with_path(joined)
    assert [jax.tree_util.keystr(p) for p, _ in ja] == [p for p, _ in pa]
    for (_, a), (_, b) in zip(ja, pa):
        np.testing.assert_array_equal(a, b.numpy())


STEP = re.compile(r"^step +\d+ ")


def _launch(capsys, mesh):
    plaunch.main(["--arch", ARCH, "--reduced", "--steps", "2", "--batch",
                  "4", "--seq", "16", "--device", CPU, "--mesh", mesh])
    return [l for l in capsys.readouterr().out.splitlines() if l.strip()]


@pytest.mark.parametrize("mesh,shards", [("single", 256), ("multi", 512)])
def test_launcher_production_meshes(capsys, mesh, shards):
    auto = _launch(capsys, "auto")
    got = _launch(capsys, mesh)
    assert [l for l in got if STEP.match(l)] == \
        [l for l in auto if STEP.match(l)]
    assert len([l for l in got if STEP.match(l)]) == 2
    head = [l for l in got if l.startswith("[mesh  ]")]
    assert len(head) == 1 and f"shards={shards} " in head[0] \
        and "descriptor=True" in head[0]
    assert "shards=1 " in [l for l in auto if l.startswith("[mesh")][0]


def test_launcher_refuses_a_full_config_on_the_descriptor_mesh():
    with pytest.raises(RuntimeError, match=r"deepseek-v3-671b.*'data': 16"):
        plaunch.main(["--arch", "deepseek-v3-671b", "--steps", "1",
                      "--device", CPU, "--mesh", "single"])


def test_reference_launcher_ep_context_closes_before_tracing():
    """``repro.launch.train`` creates its ``jax.jit`` inside
    ``ep_sharding(mesh)`` and calls it outside: tracing happens at the
    call, where the module's ``_EP_MESH`` is None again, so the
    reference launcher's MoE layers take the one-device path, and so do
    the port's (ROADMAP queue 3, reference entry 5).  If this fails,
    the reference changed and the port's launcher must follow."""
    seen = []

    def f(x):
        seen.append(JM._EP_MESH)
        return x + 1

    mesh = jax.make_mesh((1, 1), ("data", "model"))
    with JM.ep_sharding(mesh):
        jf = jax.jit(f)
    jf(jnp.ones((2,), jnp.float32))
    assert seen == [None]
