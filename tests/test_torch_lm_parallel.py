"""The port's LM parallelism (``distributed.collectives`` over named axes,
``sharding.make_shard_fn``, ``distributed.compression``,
``distributed.pipeline`` and the expert-parallel ``models.moe``) on CPU
meshes of per-shard tensors, against the reference on 8 XLA host
devices.

One module-scoped fixture runs the reference once in a subprocess
(``conftest.run_multidevice``) and saves ``.npz`` of: the shardings that
``make_shard_fn``'s constraint applies to concrete arrays; the
compressed exchange's int8 blocks, scales, error feedback and means over
8 shards (two rounds); ``pipeline_apply`` under ``jax.set_mesh`` and
``jit``, with its gradients; and ``_moe_ffn_ep`` without shared experts
(the reference's EP path raises with them under this jax: ROADMAP queue
3) on (2, 4) and (1, 8) at capacity 8.0 and 1.25.  The int8 payload must
be EQUAL; means within 1e-6, pipeline outputs within 1e-5 and gradients
within 1e-4, EP ``out`` within 5e-4 and ``aux`` within 1e-4 (the
reference's own test bounds)."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import run_multidevice  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro_torch import tree as TR  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import collectives as COL  # noqa: E402
from repro_torch.distributed import compression as CP  # noqa: E402
from repro_torch.distributed import pipeline as PL  # noqa: E402
from repro_torch.distributed import sharding as S  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402

CPU = torch.device("cpu")
MESHES = [((2, 4), ("data", "model")), ((8, 1), ("data", "model")),
          ((2, 2, 2), ("pod", "data", "model"))]
SHARD_CASES = [("act", (8, 16, 32)), ("act", (3, 16, 32)),
               ("act", (8, 6, 32)), ("tokens2d", (16, 32)),
               ("tokens2d", (6, 32)), ("moe_ecd", (8, 16, 32)),
               ("moe_ecd", (6, 4, 32)), ("ssd_h2", (8, 2, 4, 16, 8)),
               ("ssd_h2", (2, 2, 3, 16, 8))]
EP_CASES = [((2, 4), 8.0), ((2, 4), 1.25), ((1, 8), 8.0), ((1, 8), 1.25)]
PIPE = dict(L=8, D=16, n_micro=6, mb=4, stages=4)

REFERENCE = r'''
import dataclasses, json
import numpy as np, jax, jax.numpy as jnp
from functools import partial
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.compat import shard_map
from repro.configs import get_config
from repro.distributed import sharding as shd
from repro.distributed.compression import _quantize, compressed_pmean
from repro.distributed.pipeline import pipeline_apply, stage_slice
from repro.models.moe import init_moe, moe_ffn, ep_sharding

out = {}

def norm(spec):
    s = [None if p is None else (list(p) if isinstance(p, tuple) else [p])
         for p in spec]
    while s and s[-1] is None:
        s.pop()
    return s

# make_shard_fn: the sharding its constraint applies to concrete arrays
# (Auto axes: this jax's make_mesh defaults to Explicit ones, which the
# constraint refuses)
specs = {}
for shape, names in MESHES:
    mesh = jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(shape))
    for seq in (False, True):
        fn = shd.make_shard_fn(mesh, seq_shard=seq)
        for name, xs in SHARD_CASES:
            y = fn(jnp.zeros(xs, jnp.float32), name)
            specs[f"{shape}|{seq}|{name}|{xs}"] = norm(y.sharding.spec)
out["shard_specs"] = np.array(json.dumps(specs))

# compressed_pmean over 8 shards: two rounds of error feedback
mesh = jax.make_mesh((8,), ("pod",))
rng = np.random.default_rng(0)
leaves = {"a": np.asarray(rng.normal(size=(8, 4096)), np.float32),
          "b": np.asarray(rng.normal(size=(8, 1000)), np.float32)}
leaves["b"][:, 256:512] = 0.0          # an all-zero block
@partial(shard_map, mesh=mesh, in_specs=(P("pod"), P("pod")),
         out_specs=(P("pod"),) * 4)
def cm(v, e):
    q, s, _ = _quantize((v[0] + e[0]).reshape(-1))
    m, ne = compressed_pmean(v[0], "pod", e[0])
    return m[None], ne[None], q[None], s[None]
for k, v in leaves.items():
    out[f"cp_{k}_vals"] = v
    err = np.zeros_like(v)
    for r in range(2):
        m, err, q, s = (np.asarray(a) for a in cm(v, err))
        out[f"cp_{k}_{r}_mean"], out[f"cp_{k}_{r}_err"] = m, err
        out[f"cp_{k}_{r}_q"], out[f"cp_{k}_{r}_s"] = q, s

# pipeline_apply under set_mesh + jit (the reference test's stack)
L, D = PIPE["L"], PIPE["D"]
mesh = jax.make_mesh((PIPE["stages"],), ("pp",),
                     devices=jax.devices()[:PIPE["stages"]])
rng = np.random.default_rng(0)
Ws = np.asarray(rng.normal(size=(L, D, D)) * 0.5, np.float32)
xm = np.asarray(rng.normal(size=(PIPE["n_micro"], PIPE["mb"], D)),
                np.float32)
def stage_fn(params, h):
    o, _ = jax.lax.scan(lambda c, w: (jnp.tanh(c @ w), None), h, params)
    return o
@partial(shard_map, mesh=mesh, in_specs=(P(), P()), out_specs=P())
def run(W, x):
    return pipeline_apply(stage_fn, stage_slice(W, "pp", L), x, "pp")
with jax.set_mesh(mesh):
    pout = jax.jit(run)(Ws, xm)
    g = jax.jit(jax.grad(lambda W, x: jnp.sum(run(W, x) ** 2),
                         argnums=(0, 1)))(jnp.asarray(Ws), jnp.asarray(xm))
out["pipe_W"], out["pipe_x"], out["pipe_out"] = Ws, xm, np.asarray(pout)
out["pipe_gW"], out["pipe_gx"] = np.asarray(g[0]), np.asarray(g[1])

# _moe_ffn_ep without shared experts, deepseek-v3 reduced
cfg0 = dataclasses.replace(get_config("deepseek-v3-671b").reduced(),
                           num_shared_experts=0)
p = init_moe(cfg0, jax.random.PRNGKey(0), jnp.float32)
for k, v in p.items():
    out[f"ep_p_{k}"] = np.asarray(v)
rng = np.random.default_rng(0)
# a shared offset skews the routing, so capacity 1.25 drops
x = np.asarray(rng.normal(size=(8, 512, cfg0.d_model)) * 0.3
               + rng.normal(size=(cfg0.d_model,)), np.float32)
out["ep_x"] = x
for shape, cf in EP_CASES:
    cfg = dataclasses.replace(cfg0, moe_capacity_factor=cf)
    mesh = jax.make_mesh(shape, ("data", "model"))
    def f(p_, x_):
        with ep_sharding(mesh):
            return moe_ffn(cfg, p_, x_)
    pspec = {"router": P(), "wi": P("model", ("data",), None),
             "wg": P("model", ("data",), None),
             "wo": P("model", None, ("data",))}
    pp = jax.device_put(p, jax.tree.map(
        lambda s: NamedSharding(mesh, s), pspec,
        is_leaf=lambda z: isinstance(z, P)))
    xx = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P(("data",))))
    o, aux = jax.jit(f)(pp, xx)
    out[f"ep_{shape}_{cf}_out"] = np.asarray(o)
    out[f"ep_{shape}_{cf}_aux"] = np.asarray(aux)
np.savez(OUT, **out)
print("REF_OK")
'''


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lm_par_ref") / "ref.npz")
    code = (f"OUT = {path!r}\nMESHES = {MESHES!r}\n"
            f"SHARD_CASES = {SHARD_CASES!r}\nEP_CASES = {EP_CASES!r}\n"
            f"PIPE = {PIPE!r}\n" + REFERENCE)
    assert "REF_OK" in run_multidevice(code, n_devices=8, timeout=300)
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def cpu_mesh(shape, names):
    return make_mesh(shape, names, devices=[CPU] * int(np.prod(shape)))


def norm(spec):
    s = [None if p is None else (list(p) if isinstance(p, tuple) else [p])
         for p in spec]
    while s and s[-1] is None:
        s.pop()
    return s


# ---------------------------------------------------------------------------
# collectives over named axes
# ---------------------------------------------------------------------------
def test_grouped_collectives_follow_lax():
    m = cpu_mesh((2, 4), ("data", "model"))
    xs = [torch.tensor([float(i)]) for i in range(8)]
    # psum over model: each data row sums its 4 shards
    assert [float(t) for t in COL.psum(xs, "model", mesh=m)] \
        == [6.0] * 4 + [22.0] * 4
    assert [float(t) for t in COL.psum(xs, "data", mesh=m)] \
        == [4.0, 6.0, 8.0, 10.0] * 2
    assert COL.axis_index(m, "model") == [0, 1, 2, 3] * 2
    assert COL.axis_index(m, ("data", "model")) == list(range(8))
    # untiled gathers stack a new dim; tiled ones concatenate along axis
    g = COL.all_gather([t.reshape(1, 1) for t in xs], "data", mesh=m)
    assert torch.equal(g[1], torch.tensor([[[1.0]], [[5.0]]]))
    g = COL.all_gather([t.reshape(1, 1) for t in xs], "data", mesh=m,
                       axis=1, tiled=True)
    assert torch.equal(g[6], torch.tensor([[2.0, 6.0]]))
    assert g[2] is g[6]              # one gathered copy per group
    one = cpu_mesh((1, 8), ("data", "model"))
    g1 = COL.all_gather(xs, "data", mesh=one, tiled=True)
    assert all(a is b for a, b in zip(g1, xs))     # a group of one
    # ppermute within each model row, by index along the axis
    got = COL.ppermute(xs, [(0, 1), (1, 2), (2, 3), (3, 0)], "model", mesh=m)
    assert [float(t) for t in got] == [3.0, 0.0, 1.0, 2.0,
                                       7.0, 4.0, 5.0, 6.0]
    with pytest.raises(ValueError):
        COL.psum(xs, "model")                      # no mesh
    with pytest.raises(ValueError):
        COL.psum(xs[:4], "model", mesh=m)          # wrong shard count


# ---------------------------------------------------------------------------
# make_shard_fn
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,names", MESHES,
                         ids=["x".join(map(str, s)) for s, _ in MESHES])
@pytest.mark.parametrize("seq", [False, True])
def test_shard_fn_specs_equal_the_applied_shardings(ref, shape, names, seq):
    want = json.loads(str(ref["shard_specs"]))
    fn = S.make_shard_fn(cpu_mesh(shape, names), seq_shard=seq)
    for name, xs in SHARD_CASES:
        x = torch.zeros(xs)
        assert fn(x, name) is x
        assert norm(fn.spec(xs, name)) == want[f"{shape}|{seq}|{name}|{xs}"]


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("leaf", ["a", "b"])
def test_compressed_pmean_equals_reference(ref, leaf):
    vals = ref[f"cp_{leaf}_vals"]
    xs = [torch.from_numpy(v.copy()) for v in vals]
    errs = [torch.zeros_like(x) for x in xs]
    m8 = cpu_mesh((8,), ("pod",))
    for r in range(2):
        flat = [(x + e).reshape(-1) for x, e in zip(xs, errs)]
        for i, f in enumerate(flat):
            q, s, _ = CP._quantize(f)
            np.testing.assert_array_equal(q.numpy(),
                                          ref[f"cp_{leaf}_{r}_q"][i])
            np.testing.assert_array_equal(s.numpy(),
                                          ref[f"cp_{leaf}_{r}_s"][i])
        means, errs = CP.compressed_pmean(xs, "pod", errs, mesh=m8)
        assert all(m is means[0] for m in means)   # one mean on the CPU
        np.testing.assert_array_equal(np.stack([e.numpy() for e in errs]),
                                      ref[f"cp_{leaf}_{r}_err"])
        np.testing.assert_allclose(np.stack([m.numpy() for m in means]),
                                   ref[f"cp_{leaf}_{r}_mean"], atol=1e-6,
                                   rtol=0)
    if leaf == "b":                   # the zero block quantizes to zeros
        assert (ref["cp_b_0_q"][:, 1] == 0).all()


def test_compressed_tree_converges_and_counts_wire_bytes(ref):
    """The reference test's bounds on a tree of both leaves over a plain
    list of 8 shards: one exchange within 5%, 16 error-feedback
    exchanges' average within 1%."""
    trees = [{"a": torch.from_numpy(ref["cp_a_vals"][i].copy()),
              "b": torch.from_numpy(ref["cp_b_vals"][i].copy())}
             for i in range(8)]
    true = {k: np.mean([t[k].numpy() for t in trees], 0) for k in "ab"}
    errs = [CP.zeros_like_tree(t) for t in trees]
    for k in "ab":                    # zeros, and no storage of their own
        assert torch.equal(errs[0][k], torch.zeros_like(trees[0][k]))
        assert errs[0][k].stride() == (0,)
    means, errs = CP.compressed_pmean_tree(trees, None, errs)
    for k in "ab":
        rel = np.abs(means[3][k].numpy() - true[k]).max() \
            / np.abs(true[k]).max()
        assert rel < 0.05, (k, rel)
    assert max(float(e["a"].abs().max()) for e in errs) > 0
    total = {k: np.zeros_like(true[k]) for k in "ab"}
    errs = [CP.zeros_like_tree(t) for t in trees]
    for _ in range(16):
        means, errs = CP.compressed_pmean_tree(trees, None, errs)
        for k in "ab":
            total[k] += means[0][k].numpy()
    for k in "ab":
        rel = np.abs(total[k] / 16 - true[k]).max() / np.abs(true[k]).max()
        assert rel < 0.01, (k, rel)
    n = 4096 + 1000
    assert CP.wire_bytes(trees[0]) == n + 4 * (16 + 4)
    assert CP.wire_bytes(trees[0]) < 4 * n / 3.9   # ~4x under fp32


# ---------------------------------------------------------------------------
# pipeline
# ---------------------------------------------------------------------------
def _tanh_stage(params, h):
    for w in params:
        h = torch.tanh(h @ w)
    return h


def test_pipeline_matches_reference(ref):
    mesh = cpu_mesh((PIPE["stages"],), ("pp",))
    W = torch.from_numpy(ref["pipe_W"].copy()).requires_grad_(True)
    x = torch.from_numpy(ref["pipe_x"].copy()).requires_grad_(True)
    stages = PL.stage_slice(W, "pp", PIPE["L"], mesh)
    assert [s.shape[0] for s in stages] == [2] * 4
    assert all(s.data_ptr() == W[2 * d].data_ptr()        # views
               for d, s in enumerate(stages))
    outs = PL.pipeline_apply(_tanh_stage, stages, [x] * 4, "pp", mesh)
    assert all(o is outs[0] for o in outs)
    np.testing.assert_allclose(outs[0].detach().numpy(), ref["pipe_out"],
                               atol=1e-5, rtol=0)
    (outs[0] ** 2).sum().backward()
    np.testing.assert_allclose(W.grad.numpy(), ref["pipe_gW"], atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(x.grad.numpy(), ref["pipe_gx"], atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("stages,n_micro", [(2, 1), (4, 3), (8, 2)])
def test_pipeline_ticks_and_plain_stack(stages, n_micro):
    """p + n_micro - 1 ticks (stage calls counted: the bubble is skipped)
    and outputs equal to the plain stack over a (2, stages) mesh, whose
    two data rows pipeline independently."""
    mesh = cpu_mesh((2, stages), ("data", "pp"))
    g = torch.Generator().manual_seed(stages)
    W = torch.randn((8, 6, 6), generator=g) * 0.5
    xs = [torch.randn((n_micro, 3, 6), generator=g) for _ in range(2)]
    calls = []

    def stage_fn(params, h):
        calls.append(1)
        return _tanh_stage(params, h)

    per = PL.stage_slice(W, "pp", 8, mesh)
    x_sh = [xs[0]] * stages + [xs[1]] * stages
    outs = PL.pipeline_apply(stage_fn, per, x_sh, "pp", mesh)
    assert len(calls) == 2 * stages * n_micro
    for r in range(2):
        want = _tanh_stage(W, xs[r])
        for o in outs[r * stages:(r + 1) * stages]:
            torch.testing.assert_close(o, want, atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# expert parallelism
# ---------------------------------------------------------------------------
def _ep_inputs(ref, cf, shared: bool):
    pc = dataclasses.replace(get_config("deepseek-v3-671b").reduced(),
                             moe_capacity_factor=cf,
                             num_shared_experts=int(shared))
    p = {k[5:]: torch.from_numpy(ref[k].copy()) for k in ref
         if k.startswith("ep_p_")}
    return pc, p, torch.from_numpy(ref["ep_x"].copy())


@pytest.mark.parametrize("shape,cf", EP_CASES,
                         ids=[f"{s[0]}x{s[1]}-{c}" for s, c in EP_CASES])
def test_ep_without_shared_experts_matches_reference_ep(ref, shape, cf):
    pc, p, x = _ep_inputs(ref, cf, shared=False)
    with M.ep_sharding(cpu_mesh(shape, ("data", "model"))):
        out, aux = M.moe_ffn(pc, p, x)
    np.testing.assert_allclose(out.numpy(), ref[f"ep_{shape}_{cf}_out"],
                               atol=5e-4, rtol=0)
    assert abs(float(aux) - float(ref[f"ep_{shape}_{cf}_aux"])) < 1e-4
    if cf == 1.25:                    # the rows' capacity drops
        xt = x.reshape(2 if shape[0] == 2 else 1, -1, pc.d_model)
        assert any(int((M.route(pc, p, r)[1]
                        == pc.num_experts * M.capacity(pc, r.shape[0])
                        ).sum()) > 0 for r in xt)


@pytest.mark.parametrize("shape,cf", EP_CASES,
                         ids=[f"{s[0]}x{s[1]}-{c}" for s, c in EP_CASES])
def test_ep_with_shared_experts_matches_one_device_rows(shape, cf):
    """The reference's EP path raises with a shared expert (ROADMAP
    queue 3), so each data row is held to the reference's one-device
    ``moe_ffn`` on that row's tokens; ``aux`` is the rows' mean."""
    jc = dataclasses.replace(jget("deepseek-v3-671b").reduced(),
                             moe_capacity_factor=cf)
    pc = dataclasses.replace(get_config("deepseek-v3-671b").reduced(),
                             moe_capacity_factor=cf)
    assert jc.num_shared_experts == 1
    jp = JM.init_moe(jc, jax.random.PRNGKey(1), jnp.float32)
    x = (np.random.default_rng(1).normal(size=(8, 512, jc.d_model))
         * 0.3).astype(np.float32)
    p = TR.map_structure(lambda a: torch.from_numpy(np.array(a)),
                         jax.tree.map(np.asarray, jp))
    with M.ep_sharding(cpu_mesh(shape, ("data", "model"))):
        out, aux = M.moe_ffn(pc, p, torch.from_numpy(x))
    rows = np.split(x, shape[0])
    want = [JM.moe_ffn(jc, jp, jnp.asarray(r)) for r in rows]
    np.testing.assert_allclose(
        out.numpy(), np.concatenate([np.asarray(o) for o, _ in want]),
        atol=5e-4, rtol=0)
    assert abs(float(aux) - np.mean([float(a) for _, a in want])) < 1e-4


def test_ep_gradient_equals_one_device_gradient():
    """At capacity 8.0 (nothing drops) the EP path's gradients, shared
    expert included, equal the one-device path's."""
    pc = dataclasses.replace(get_config("deepseek-v3-671b").reduced(),
                             moe_capacity_factor=8.0)
    g = torch.Generator().manual_seed(0)
    p = M.init_moe(pc, g, torch.float32)
    x2 = torch.randn((8, 512, pc.d_model), generator=g) * 0.3

    def grads(ep):
        leaves = [t.clone().requires_grad_(True) for t in TR.leaves(p)]
        xx = x2.clone().requires_grad_(True)
        pp = TR.unflatten_like(p, leaves)
        if ep:
            with M.ep_sharding(cpu_mesh((1, 8), ("data", "model"))):
                out, aux = M.moe_ffn(pc, pp, xx)
        else:
            out, aux = M.moe_ffn(pc, pp, xx)
        ((out ** 2).sum() + aux).backward()
        return [xx.grad] + [t.grad for t in leaves]

    calls = []
    inner = M._moe_ffn_ep

    def counting(*a):
        calls.append(1)
        return inner(*a)

    M._moe_ffn_ep = counting
    try:
        ep, one = grads(True), grads(False)
    finally:
        M._moe_ffn_ep = inner
    assert len(calls) == 1
    for a, b in zip(ep, one):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


def test_ep_takes_the_reference_rule(ref):
    """EP only for ``E % model == 0`` and ``B * S >= 4096``."""
    pc, p, x = _ep_inputs(ref, 8.0, shared=False)
    calls = []
    inner = M._moe_ffn_ep

    def counting(*a):
        calls.append(a[-1].axis_sizes)
        return inner(*a)

    M._moe_ffn_ep = counting
    try:
        with M.ep_sharding(cpu_mesh((1, 8), ("data", "model"))):
            M.moe_ffn(pc, p, x)                      # 4,096 tokens
            M.moe_ffn(pc, p, x[:, :511])             # 4,088: one device
        with M.ep_sharding(cpu_mesh((2, 3), ("data", "model"))):
            M.moe_ffn(pc, p, x)                      # 8 % 3 != 0
        M.moe_ffn(pc, p, x)                          # no mesh
    finally:
        M._moe_ffn_ep = inner
    assert calls == [(1, 8)]
