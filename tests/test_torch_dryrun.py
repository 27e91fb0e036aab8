"""The port's dry run (``repro_torch.launch.dryrun``, ``launch.roofline``,
the collective counters of ``distributed.collectives``; CPU and meta
tensors) against the same step on real CPU tensors and against
``repro.launch.hlo_analysis``'s analytic memory floor."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget  # noqa: E402
from repro.launch import hlo_analysis as JH  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.data import DataConfig, synthetic_batch  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import roofline as R  # noqa: E402
from repro_torch.launch import specs as SP  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.training import OptConfig, train_state_init  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("data", "model")


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_meta_counts_equal_real_cpu_counts(kind):
    """The sharded step of reduced qwen3 on a (2, 4) mesh: FLOPs,
    collectives and one shard's state and batch bytes are the same on
    meta tensors as on real CPU tensors; the unfused op bytes within
    1e-4 (a few scalar ops dispatch differently off meta)."""
    cfg = get_config("qwen3-0.6b").reduced()
    ocfg = OptConfig(kind=kind, lr=1e-3, warmup_steps=1, total_steps=10)
    batch = synthetic_batch(cfg, DataConfig(global_batch=4, seq_len=16), 0)
    real_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    meta_batch = {k: SP.sds(v.shape, v.dtype) for k, v in
                  real_batch.items()}
    meta_mesh = make_mesh((2, 4), NAMES, devices=["meta"] * 8)
    cpu_mesh = make_mesh((2, 4), NAMES, devices=["cpu"] * 8)
    run_m, mem_m = D.train_run(cfg, ocfg, meta_mesh,
                               D.meta_state(cfg, ocfg, torch.float32),
                               meta_batch)
    run_c, mem_c = D.train_run(cfg, ocfg, cpu_mesh,
                               train_state_init(cfg, ocfg, 0, device="cpu"),
                               real_batch)
    got, want = D.count(run_m, 8), D.count(run_c, 8)
    assert got["flops"] == want["flops"] > 0
    assert got["hbm_bytes"] == pytest.approx(want["hbm_bytes"], rel=1e-4)
    assert got["collective"] == want["collective"]
    assert got["collective"]["count_by_kind"]["gather"] > 0
    assert got["collective"]["count_by_kind"]["scatter"] > 0
    assert mem_m == mem_c


def test_expert_parallel_collectives_count_once_a_shard():
    """``moe_ffn`` under ``ep_sharding`` on a (2, 4) meta mesh: one psum
    and one all-gather of each expert weight a shard, though the port
    gathers one model column's group at a time."""
    cfg = get_config("deepseek-v3-671b").reduced()
    mesh = make_mesh((2, 4), NAMES, devices=["meta"] * 8)
    p = SP.param_shapes(cfg, torch.float32)["stack"][0]["moe"]
    p = {k: (v[0] if k != "shared" else {n: w[0] for n, w in v.items()})
         for k, v in p.items()}
    x = SP.sds((2, M.EP_MIN_TOKENS // 2, cfg.d_model), torch.float32)
    with D.COL.counting(8) as counts, M.ep_sharding(mesh):
        out, _aux = M.moe_ffn(cfg, p, x)
    assert tuple(out.shape) == tuple(x.shape)
    n_w = 3 if cfg.mlp_act == "swiglu" else 2
    assert counts.summary()["count_by_kind"] == {"psum": 1,
                                                 "all_gather": n_w}


@pytest.mark.parametrize("arch", list_archs())
def test_memory_floor_equals_reference(arch):
    cfg, jcfg = get_config(arch), jget(arch)
    for shape, info in SP.SHAPES.items():
        if not SP.cell_runnable(cfg, shape)[0]:
            continue
        for chips in (256, 512):
            assert R.analytic_memory_floor(cfg, info, info["kind"], chips) \
                == JH.analytic_memory_floor(jcfg, info, info["kind"], chips)


def test_full_size_meta_cell():
    """qwen3-0.6b:decode_32k:single at published widths on meta."""
    res = D.run_cell("qwen3-0.6b", "decode_32k", False, {})
    assert res["label"] == "qwen3-0.6b:decode_32k:16x16"
    assert res["chips"] == 256 and res["device"] == "meta"
    cfg = get_config("qwen3-0.6b")
    assert res["model_flops"] == 2 * cfg.active_param_count() * 128
    assert res["flops"] >= res["model_flops"] > 0
    mem = res["memory"]
    assert mem["temp_bytes"] is None and mem["cache_bytes_per_dev"] > 0
    mesh, params = D.make_production_mesh(device="meta"), SP.param_shapes(cfg)
    assert mem["state_bytes_per_dev"] == SH.shard_bytes(
        params, SH.param_specs(params, mesh), mesh)
    roof = res["roofline"]
    assert roof["link_bw"] == R.NET_BW and roof["peak_flops"] == 989.4e12
    np.testing.assert_allclose(roof["compute_s"],
                               res["flops"] / (256 * R.PEAK_FLOPS))
    assert res["memory_floor_bytes_per_dev"] == JH.analytic_memory_floor(
        jget("qwen3-0.6b"), SP.SHAPES["decode_32k"], "decode", 256)


def test_cli_writes_then_caches_a_cell(tmp_path, capsys):
    argv = ["--arch", "qwen3-0.6b", "--shape", "decode_32k", "--mesh",
            "single", "--out-dir", str(tmp_path)]
    done = D.main(argv)
    path = tmp_path / "qwen3-0.6b__decode_32k__single.json"
    assert list(done) == ["qwen3-0.6b__decode_32k__single"]
    rec = json.loads(path.read_text())
    assert rec["flops"] > 0 and "error" not in rec and rec["wall_s"] >= 0
    assert D.main(argv) == {}
    assert "[cached] qwen3-0.6b__decode_32k__single" in capsys.readouterr().out
    skipped = D.main(["--arch", "qwen3-0.6b", "--shape", "long_500k",
                      "--mesh", "single", "--out-dir", str(tmp_path)])
    assert skipped["qwen3-0.6b__long_500k__single"]["skipped"]


def test_roofline_terms_at_h100_figures():
    t = R.roofline_terms(989.4e12 * 8, 3.35e12 * 4, 450e9 * 16, 8)
    assert t["compute_s"] == pytest.approx(1.0)
    assert t["memory_s"] == pytest.approx(0.5)
    assert t["collective_s"] == pytest.approx(2.0)
    assert t["dominant"] == "collective" and t["bound_step_s"] == t[
        "collective_s"]
    assert R.link_bw(8) == 450e9 and R.link_bw(256) == 50e9
    empty = R.roofline_terms(None, None, 100e9, 256)
    assert empty["compute_s"] is None and empty["dominant"] == "collective"


def test_no_tpu_constant_in_the_port():
    """The reference's TPU v5e figures (197e12 FLOP/s, 819e9 B/s)
    appear nowhere in the port."""
    for root, _d, files in os.walk(os.path.join(REPO, "src", "repro_torch")):
        for f in files:
            if f.endswith(".py"):
                text = open(os.path.join(root, f)).read()
                for c in ("197e12", "819e9", "v5e"):
                    assert c not in text, (f, c)


def test_require_room_passes_meta_and_refuses_a_real_placement():
    """A meta mesh holds any shard (nothing is allocated); the same mesh
    of CPU shards refuses what its memory cannot hold."""
    meta = D.make_production_mesh(device="meta")
    assert meta.descriptor and {d.type for d in meta.devices} == {"meta"}
    meta.require_room(1 << 50, "deepseek-v3 on meta")
    with pytest.raises(RuntimeError, match="deepseek-v3 on the cpu"):
        D.make_production_mesh(device="cpu").require_room(
            1 << 50, "deepseek-v3 on the cpu")
