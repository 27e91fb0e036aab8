"""The port's LM sharding rules (``repro_torch.distributed.sharding``,
``launch.specs``, ``launch.mesh``) against the reference's, in-process.

The rules need only a mesh's axis names and sizes, so the reference's
side runs on ``jax.sharding.AbstractMesh`` and its shapes come from
``jax.eval_shape``; the port's shapes are ``meta`` tensors.  Nothing is
allocated, so every config is held at its published widths, on small
meshes and on the production ones (256 and 512 shards).  Specs must be
EQUAL entry for entry, after normalising a one-name tuple to the name
(jax 0.9 prints ``('model', ('data',))`` as ``('model', 'data')``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import AbstractMesh, PartitionSpec as JP  # noqa: E402
from repro.configs import get_config as jget, list_archs  # noqa: E402
from repro.distributed import sharding as JS  # noqa: E402
from repro.launch import specs as JSPEC  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.training import OptConfig as JOpt  # noqa: E402
from repro_torch import tree as TR  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import sharding as S  # noqa: E402
from repro_torch.launch import specs as SPEC  # noqa: E402
from repro_torch.launch.mesh import (Mesh, make_pipeline_mesh,  # noqa: E402
                                     make_production_mesh)
from repro_torch.training import OptConfig  # noqa: E402

MESHES = [((2, 4), ("data", "model")), ((8, 1), ("data", "model")),
          ((2, 2, 2), ("pod", "data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
MESH_IDS = ["x".join(map(str, s)) for s, _ in MESHES]
ARCHS = list_archs()


def port_mesh(shape, names):
    n = int(np.prod(shape))
    return Mesh(tuple(names), tuple(shape), (torch.device("cpu"),) * n)


def norm(spec):
    """A spec as a tuple: None, or a tuple of axis names, per dim, with
    the trailing Nones dropped (jax keeps or drops them by version)."""
    out = [None if p is None else (tuple(p) if isinstance(p, tuple)
                                   else (p,)) for p in spec]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def ref_flat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))
    return [(jax.tree_util.keystr(p), norm(s)) for p, s in flat]


def port_flat(tree):
    return [(p, norm(s)) for p, s in TR.flatten_with_path(tree)]


@pytest.fixture(scope="module")
def shapes():
    """arch -> (reference param shapes, port param meta tensors)."""
    out = {}
    for arch in ARCHS:
        jc = jget(arch)
        jp = jax.eval_shape(lambda: JT.init_params(
            jc, jax.random.PRNGKey(0), jnp.bfloat16))
        out[arch] = (jp, SPEC.param_shapes(get_config(arch)))
    return out


def test_param_shapes_are_meta_and_match_the_reference(shapes):
    for arch, (jp, pp) in shapes.items():
        ja = jax.tree_util.tree_flatten_with_path(jp)[0]
        pa = TR.flatten_with_path(pp)
        assert [jax.tree_util.keystr(p) for p, _ in ja] == [p for p, _ in pa]
        for (_, a), (_, b) in zip(ja, pa):
            assert tuple(a.shape) == tuple(b.shape), arch
            assert b.device.type == "meta"


@pytest.mark.parametrize("shape,names", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("fsdp", [True, False])
def test_param_specs_match_reference(shapes, shape, names, fsdp):
    jm, pm = AbstractMesh(shape, names), port_mesh(shape, names)
    for arch, (jp, pp) in shapes.items():
        want = ref_flat(JS.param_specs(jp, jm, fsdp))
        got = port_flat(S.param_specs(pp, pm, fsdp))
        assert got == want, arch
        assert any(s for _, s in got), arch       # something is sharded


@pytest.mark.parametrize("shape,names", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("kind,b1", [("adamw", 0.9), ("adafactor", 0.9),
                                     ("adafactor", 0.0)])
def test_opt_state_specs_match_reference(shapes, shape, names, kind, b1):
    jm, pm = AbstractMesh(shape, names), port_mesh(shape, names)
    for arch, (jp, pp) in shapes.items():
        want = ref_flat(JS.opt_state_specs(
            JOpt(kind=kind, b1=b1), jp, JS.param_specs(jp, jm)))
        got = port_flat(S.opt_state_specs(
            OptConfig(kind=kind, b1=b1), pp, S.param_specs(pp, pm)))
        assert got == want, arch


@pytest.mark.parametrize("shape,names", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("cell", ["decode_32k", "long_500k"])
def test_cache_specs_match_reference(shape, names, cell):
    jm, pm = AbstractMesh(shape, names), port_mesh(shape, names)
    batch = JSPEC.SHAPES[cell]["global_batch"]
    for arch in ARCHS:
        jc, pc = jget(arch), get_config(arch)
        jcache = JSPEC.decode_cache_shapes(jc, cell)
        pcache = SPEC.decode_cache_shapes(pc, cell)
        ja = jax.tree_util.tree_flatten_with_path(jcache)[0]
        pa = TR.flatten_with_path(pcache)
        assert [(jax.tree_util.keystr(p), tuple(x.shape)) for p, x in ja] \
            == [(p, tuple(x.shape)) for p, x in pa], arch
        assert all(x.device.type == "meta" for _, x in pa)
        got = port_flat(S.cache_specs(pcache, pm, batch))
        assert got == ref_flat(JS.cache_specs(jcache, jm, batch)), arch
        if cell == "long_500k" and jc.family == "hybrid":
            # batch 1: the KV sequence takes the data axes
            seq = [s for p, s in got if p.endswith("['k']")]
            assert seq and all(any("data" in (d or ()) for d in s)
                               for s in seq)


@pytest.mark.parametrize("shape,names", MESHES, ids=MESH_IDS)
def test_batch_specs_and_runnable_cells_match_reference(shape, names):
    jm, pm = AbstractMesh(shape, names), port_mesh(shape, names)
    for arch in ARCHS:
        jc, pc = jget(arch), get_config(arch)
        for cell in JSPEC.SHAPES:
            assert SPEC.cell_runnable(pc, cell) == JSPEC.cell_runnable(
                jc, cell)
            if not SPEC.cell_runnable(pc, cell)[0]:
                continue
            jb, pb = JSPEC.batch_specs(jc, cell), SPEC.batch_specs(pc, cell)
            assert {k: (tuple(v.shape), str(v.dtype)) for k, v in jb.items()} \
                == {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                    for k, v in pb.items()}
            assert port_flat(S.batch_spec_tree(pb, pm)) \
                == ref_flat(JS.batch_spec_tree(jb, jm)), (arch, cell)


def test_production_meshes_follow_the_reference():
    for mesh, shape in [(make_production_mesh(device="cpu"), (16, 16)),
                        (make_production_mesh(multi_pod=True, device="cpu"),
                         (2, 16, 16)),
                        (make_pipeline_mesh(device="cpu"), (2, 16, 16))]:
        names = ("pod", "data", "model")[-len(shape):]
        assert mesh.axis_names == names
        assert dict(mesh.shape) == dict(zip(names, shape))
        assert list(mesh.shape) == list(names)
        assert mesh.size == int(np.prod(shape)) and mesh.descriptor
        assert S.data_axes(mesh) == JS.data_axes(AbstractMesh(shape, names))
        assert S.mesh_axis_size(mesh, "model") == 16
        assert S.mesh_axis_size(mesh, S.data_axes(mesh)) \
            == int(np.prod(shape[:-1]))


def test_mesh_groups_and_axis_index_are_row_major():
    m = port_mesh((2, 2, 2), ("pod", "data", "model"))
    assert m.coords(5) == (1, 0, 1)
    # the shards sharing pod and data coordinates, by model index
    assert m.groups("model") == [[0, 1], [2, 3], [4, 5], [6, 7]]
    # ('pod', 'data') is row-major in the order given
    assert m.groups(("pod", "data")) == [[0, 2, 4, 6], [1, 3, 5, 7]]
    assert m.groups(("data", "pod")) == [[0, 4, 2, 6], [1, 5, 3, 7]]
    assert [m.index_along(i, ("pod", "data")) for i in range(8)] \
        == [0, 0, 1, 1, 2, 2, 3, 3]
    with pytest.raises(ValueError):
        m.groups("tensor")


def test_split_gives_views_and_join_restores():
    m = port_mesh((2, 4), ("data", "model"))
    x = torch.arange(8 * 6 * 4, dtype=torch.float32).reshape(8, 6, 4)
    spec = S.P("model", ("data",), None)
    pieces = S.split(x, spec, m)
    assert len(pieces) == 8
    for i, piece in enumerate(pieces):
        r, c = m.coords(i)
        assert piece.shape == (2, 3, 4)
        assert piece.untyped_storage().data_ptr() \
            == x.untyped_storage().data_ptr()            # a view
        assert torch.equal(piece, x[2 * c:2 * c + 2, 3 * r:3 * r + 3])
    assert torch.equal(S.join(pieces, spec, m), x)
    # replicated dims: every shard of a row sees the same rows
    rows = S.split(x, S.P(("data",), None, None), m)
    assert all(torch.equal(rows[i], x[:4]) for i in range(4))
    assert torch.equal(S.join(rows, S.P(("data",), None, None), m), x)
    with pytest.raises(ValueError):
        S.split(torch.zeros(3, 4), S.P("model"), m)


def test_shard_fn_returns_its_input_and_exposes_the_spec():
    m = port_mesh((2, 4), ("data", "model"))
    fn = S.make_shard_fn(m, seq_shard=True)
    x = torch.zeros(4, 8, 16)
    assert fn(x, "act") is x
    assert norm(fn.spec(x.shape, "act")) == (("data",), ("model",))
    assert fn.spec(x.shape, "other") is None


def test_descriptor_mesh_runs_reduced_configs_and_raises_beyond():
    mesh = make_production_mesh(device="cpu")
    mesh.require_room(1 << 20, "a reduced config")
    with pytest.raises(RuntimeError, match="256 devices"):
        mesh.require_room(1 << 40, "deepseek-v3 at published widths")
    port_mesh((2, 4), ("data", "model")).require_room(1 << 60, "any")
