"""Dry run of every (arch x shape x mesh) cell — the port of
``repro.launch.dryrun``.

The reference lowers and compiles each cell for the production meshes
and reads XLA's cost and memory analyses.  The port compiles nothing,
so it runs each LM cell eagerly on ``meta`` tensors over the production
mesh of ``meta`` shards (``make_production_mesh(device="meta")``):
shapes only, nothing allocated, no card needed.  Per cell it records

* FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over the sharded
  train step (``training.make_train_step`` on a placed state), or over
  ``prefill`` / ``decode_step``; eager code runs every layer, so the
  reference's layer-count probes are not needed;
* bytes: per-shard state, batch and cache bytes from the specs
  (``distributed.sharding``), and every op's operand and result bytes
  (``roofline.OpBytes``, the unfused upper bound); no compiler temp
  estimate (``temp_bytes`` null);
* collectives: count and bytes per kind from the single controller's
  counters (``distributed.collectives.counting``): the step's FSDP
  gathers and gradient scatters, Adafactor's grouped psums and EP's
  psums and gathers.  GSPMD's tensor-parallel activation traffic is
  not counted: the port's executor does not move it;
* ``model_flops``, ``useful_ratio``, the analytic memory floor and the
  roofline terms at the H100's figures (``launch.roofline``).

``dna-suffix`` cells run on the card (``--device``, default ``cuda``)
at ``configs/dna_suffix.py``'s 250,000,000 bases over a tablet mesh of
256 (``single``) or 512 (``multi``) tablets on the visible devices:
``serve`` one batch of 1,024 patterns through ``query_sharded`` (or
``query_routed`` with ``--routed``), held against the single-device
search; ``build`` one distributed prefix-doubling step
(``build_suffix_array_sharded``, ``num_steps=1``).  They record seconds,
the measured device peak, the counted collective bytes and the roofline
terms.

Results are cached under ``experiments/dryrun_torch/<cell>.json``::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import tree as TR
from repro_torch.configs import get_config, list_archs
from repro_torch.distributed import collectives as COL
from repro_torch.distributed import sharding as shd
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import make_production_mesh, make_tablet_mesh
from repro_torch.launch.roofline import (HBM_BW, OpBytes,
                                         analytic_memory_floor,
                                         roofline_terms)
from repro_torch.launch.train import state_specs
from repro_torch.models import decode_step, prefill
from repro_torch.models.config import ModelConfig
from repro_torch.training import OptConfig, TrainState, make_train_step
from repro_torch.training import optimizer as opt

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")
PARAM_DTYPE = torch.bfloat16
META = "meta"
COLLECTIVES_MOVED = ("the port's executor: FSDP gathers and gradient "
                     "scatters of the sharded step, Adafactor's grouped "
                     "psums, EP psums and gathers; GSPMD's tensor-parallel "
                     "activation traffic is not counted")


def _opt_for(cfg: ModelConfig) -> OptConfig:
    big = cfg.param_count() > 3e11
    return OptConfig(kind="adafactor" if big else "adamw",
                     b1=0.0 if big else 0.9,
                     state_dtype=torch.bfloat16 if cfg.param_count() > 5e10
                     else torch.float32)


def train_run(cfg: ModelConfig, opt_cfg: OptConfig, mesh, state, batch,
              *, microbatches: int = 1, loss_chunk=None, seq_shard=True):
    """``(run, bytes)``: ``run()`` takes one sharded train step of
    ``state`` and ``batch`` (tensors or meta tensors on ``mesh``'s device
    type) placed on ``mesh`` by the specs; ``bytes`` are one shard's
    state and batch bytes."""
    dtype = TR.leaves(state.params)[0].dtype
    sspecs, per_shard = state_specs(cfg, opt_cfg, mesh, dtype)
    bspecs = shd.batch_spec_tree(batch, mesh)
    placed = shd.place_tree(state, sspecs, mesh)
    placed_batch = shd.place_tree(batch, bspecs, mesh)
    step_fn = make_train_step(cfg, opt_cfg, microbatches=microbatches,
                              shard=shd.make_shard_fn(mesh, seq_shard),
                              loss_chunk=loss_chunk)
    return (lambda: step_fn(placed, placed_batch),
            {"state_bytes_per_dev": per_shard,
             "batch_bytes_per_dev": shd.shard_bytes(batch, bspecs, mesh)})


def meta_state(cfg: ModelConfig, opt_cfg: OptConfig,
               dtype=PARAM_DTYPE) -> TrainState:
    """The train state as meta tensors."""
    params = SP.param_shapes(cfg, dtype)
    return TrainState(params=params, opt_state=opt.init(opt_cfg, params),
                      step=SP.sds((), torch.int32))


def serve_cell(cfg: ModelConfig, mesh, shape_name: str):
    """``(run, bytes)``: ``prefill`` or one ``decode_step`` of the cell on
    meta tensors, and one shard's param, batch and cache bytes."""
    params = SP.param_shapes(cfg, PARAM_DTYPE)
    batch = SP.batch_specs(cfg, shape_name)
    caches = SP.decode_cache_shapes(cfg, shape_name, PARAM_DTYPE)
    info = SP.SHAPES[shape_name]
    if info["kind"] == "prefill":
        def run():
            return prefill(cfg, params, batch, max_len=info["seq_len"])
    else:
        def run():
            return decode_step(cfg, params, batch.get("tokens"), caches,
                               embeds=batch.get("embeds"))
    cspecs = shd.cache_specs(caches, mesh, info["global_batch"])
    return run, {
        "state_bytes_per_dev": shd.shard_bytes(
            params, shd.param_specs(params, mesh), mesh),
        "batch_bytes_per_dev": shd.shard_bytes(
            batch, shd.batch_spec_tree(batch, mesh), mesh),
        "cache_bytes_per_dev": shd.shard_bytes(caches, cspecs, mesh)}


def count(run, shards: int) -> dict:
    """FLOPs, unfused op bytes and collectives of one ``run()``."""
    flops = FlopCounterMode(display=False)
    op_bytes = OpBytes()
    t0 = time.perf_counter()
    with COL.counting(shards) as coll, flops, op_bytes:
        run()
    return {"trace_s": time.perf_counter() - t0,
            "flops": float(flops.get_total_flops()),
            "hbm_bytes": float(op_bytes.bytes),
            "collective": coll.summary()}


def lm_cell(arch: str, shape_name: str, multi_pod: bool, opts: dict,
            label: str) -> dict:
    cfg = get_config(arch)
    ok, why = SP.cell_runnable(cfg, shape_name)
    if not ok:
        return {"label": label, "skipped": why}
    kind = SP.SHAPES[shape_name]["kind"]
    mesh = make_production_mesh(multi_pod=multi_pod, device=META)
    chips = mesh.size

    from repro_torch.models import layers as _L
    from repro_torch.models import moe as _M
    chunk_ctx = (
        _L.attn_chunking(opts["attn_threshold"],
                         opts.get("attn_chunk", 1024))
        if opts.get("attn_threshold") else contextlib.nullcontext())
    ep_ctx = (_M.ep_sharding(mesh) if opts.get("ep") and cfg.is_moe
              else contextlib.nullcontext())
    if kind == "train":
        opt_cfg = _opt_for(cfg)
        run, mem = train_run(cfg, opt_cfg, mesh, meta_state(cfg, opt_cfg),
                             SP.batch_specs(cfg, shape_name),
                             microbatches=opts.get("microbatches", 1),
                             loss_chunk=opts.get("loss_chunk"),
                             seq_shard=opts.get("seq_shard", True))
    else:
        run, mem = serve_cell(cfg, mesh, shape_name)
    with chunk_ctx, ep_ctx:
        st = count(run, chips)
    flops, hbm = st["flops"], st["hbm_bytes"]
    coll = dict(st["collective"], moved_by=COLLECTIVES_MOVED)
    mem["argument_bytes"] = sum(mem.values())
    mem["temp_bytes"] = None
    res = {
        "label": label, "chips": chips, "kind": kind, "device": META,
        "trace_s": st["trace_s"],
        "flops": flops, "hbm_bytes": hbm,
        "flops_per_dev": flops / chips, "hbm_bytes_per_dev": hbm / chips,
        "collective": coll, "memory": mem,
        "roofline": roofline_terms(flops, hbm, coll["bytes"] * chips,
                                   chips),
    }
    info = SP.SHAPES[shape_name]
    tokens = info["global_batch"] * (info["seq_len"] if kind != "decode"
                                     else 1)
    model_flops = (6 if kind == "train" else 2) \
        * cfg.active_param_count() * tokens
    res["model_flops"] = model_flops
    res["useful_ratio"] = model_flops / max(flops, 1)
    floor = analytic_memory_floor(cfg, info, kind, chips)
    res["memory_floor_bytes_per_dev"] = floor
    res["memory_floor_s"] = floor / HBM_BW
    return res


# ---------------------------------------------------------------------------
# The paper's workload, on the card
# ---------------------------------------------------------------------------
def _sa_text(text_len: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 4, text_len,
                                                dtype=np.uint8)


def sa_serve_cell(n_tablets: int, *, routed: bool, text_len: int,
                  device) -> dict:
    """One batch of ``query_batch`` paper patterns over ``n_tablets``
    tablets of a ``text_len``-base store, against the one-device search."""
    from repro_torch.configs.dna_suffix import CONFIG as SA
    from repro_torch.core import query as Q
    from repro_torch.core.tablet import build_tablet_store, shard_store
    t0 = time.perf_counter()
    store = build_tablet_store(_sa_text(text_len), is_dna=True,
                               max_query_len=SA.max_query_len,
                               num_tablets=n_tablets, device=device)
    tablets = shard_store(store, make_tablet_mesh(n_tablets, device))
    _codes, patt, plen = Q.encode_patterns(
        Q.random_patterns(SA.query_batch, seed=1), SA.max_query_len,
        device=device)
    build_s = time.perf_counter() - t0
    serve = (lambda: Q.query_routed(tablets, patt, plen)) if routed \
        else (lambda: Q.query_sharded(tablets, patt, plen))
    serve()                                     # builds and warms kernels
    _sync(device)
    peak0 = _peak_reset(device)
    t0 = time.perf_counter()
    with COL.counting(n_tablets) as coll:
        got = serve()
        _sync(device)
    seconds = time.perf_counter() - t0
    want = Q.query(store, patt, plen)
    exact = bool(torch.equal(got.count, want.count)
                 and torch.equal(got.first_pos, want.first_pos))
    if routed:                   # -1 overflow / -2 saturated are retried
        exact = bool(torch.equal(got.count[got.count >= 0],
                                 want.count[got.count >= 0]))
    return {"seconds": seconds, "build_s": build_s,
            "device_peak_bytes": _peak(device, peak0),
            "collective": coll.summary(), "equals_single_device": exact,
            "queries": SA.query_batch,
            "store_bytes": (store.sa.numel() * 4
                            + store.text_packed.numel() * 4)}


def sa_build_cell(n_tablets: int, *, method: str, text_len: int,
                  device) -> dict:
    """One distributed prefix-doubling step over ``n_tablets`` tablets."""
    from repro_torch.core.dsa import _split, build_suffix_array_sharded
    mesh = make_tablet_mesh(n_tablets, device)
    m = -(-text_len // n_tablets)
    padded = np.zeros((m * n_tablets,), np.int32)
    padded[:text_len] = _sa_text(text_len)
    codes = _split(padded, mesh)
    _sync(device)
    peak0 = _peak_reset(device)
    t0 = time.perf_counter()
    with COL.counting(n_tablets) as coll:
        sa, _rank = build_suffix_array_sharded(
            codes, n_real=text_len, method=method, num_steps=1)
        _sync(device)
    return {"seconds": time.perf_counter() - t0,
            "device_peak_bytes": _peak(device, peak0),
            "collective": coll.summary(), "rows": m * n_tablets,
            "sa_rows_out": sum(int(s.shape[0]) for s in sa)}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _peak_reset(device) -> int:
    if torch.device(device).type != "cuda":
        return 0
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _peak(device, base: int):
    """Bytes allocated at the peak over ``base`` (None off the card: a
    CPU run measures no device)."""
    if torch.device(device).type != "cuda":
        return None
    return torch.cuda.max_memory_allocated() - base


def sa_cell(shape_name: str, multi_pod: bool, opts: dict,
            label: str) -> dict:
    from repro_torch.configs.dna_suffix import CONFIG as SA
    chips = 512 if multi_pod else 256
    text_len = int(opts.get("text_len") or SA.text_len)
    device = opts.get("device", "cuda")
    if shape_name == "serve":
        st = sa_serve_cell(chips, routed=opts.get("routed", False),
                           text_len=text_len, device=device)
    else:
        st = sa_build_cell(chips, method=opts.get("sort", "bitonic"),
                           text_len=text_len, device=device)
    res = {"label": label, "chips": chips, "kind": shape_name,
           "device": (torch.cuda.get_device_name(0)
                      if torch.device(device).type == "cuda" else
                      str(device)),
           "text_len": text_len, **st}
    if text_len != SA.text_len:
        res["reduced"] = [f"text_len {SA.text_len} -> {text_len}"]
    res["flops"] = res["hbm_bytes"] = None    # timed on the card instead
    res["roofline"] = roofline_terms(None, None,
                                     st["collective"]["bytes"] * chips,
                                     chips)
    return res


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             opts: dict | None = None) -> dict:
    opts = opts or {}
    label = f"{arch}:{shape_name}:{'2x16x16' if multi_pod else '16x16'}"
    if arch == "dna-suffix":
        return sa_cell(shape_name, multi_pod, opts, label)
    return lm_cell(arch, shape_name, multi_pod, opts, label)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--loss-chunk", type=int, default=None)
    ap.add_argument("--attn-threshold", type=int, default=None)
    ap.add_argument("--attn-chunk", type=int, default=1024)
    ap.add_argument("--routed", action="store_true")
    ap.add_argument("--ep", action="store_true")
    ap.add_argument("--no-seq-shard", action="store_true")
    ap.add_argument("--sort", default="bitonic")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--device", default="cuda",
                    help="the device of the dna-suffix cells")
    ap.add_argument("--out-dir", default=OUT_DIR)
    args = ap.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    archs = list_archs() + ["dna-suffix"] if args.all else [args.arch]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    done = {}
    for arch in archs:
        shapes = (["serve", "build"] if arch == "dna-suffix"
                  else list(SP.SHAPES))
        if args.shape:
            shapes = [args.shape]
        for shape in shapes:
            for mp in meshes:
                cell = f"{arch}__{shape}__{'multi' if mp else 'single'}"
                if args.tag:
                    cell += f"__{args.tag}"
                path = os.path.join(args.out_dir, cell + ".json")
                if os.path.exists(path) and not args.force:
                    print(f"[cached] {cell}")
                    continue
                print(f"[trace] {cell} ...", flush=True)
                t0 = time.time()
                try:
                    res = run_cell(arch, shape, mp, {
                        "microbatches": args.microbatches,
                        "seq_shard": not args.no_seq_shard,
                        "sort": args.sort,
                        "loss_chunk": args.loss_chunk,
                        "attn_threshold": args.attn_threshold,
                        "attn_chunk": args.attn_chunk,
                        "routed": args.routed,
                        "ep": args.ep,
                        "device": args.device,
                    })
                    res["wall_s"] = round(time.time() - t0, 1)
                except Exception as e:  # noqa: BLE001 — record failures too
                    res = {"label": cell, "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-2000:]}
                    traceback.print_exc()
                with open(path, "w") as f:
                    json.dump(res, f, indent=1, default=str)
                done[cell] = res
                status = ("SKIP" if res.get("skipped")
                          else "FAIL" if res.get("error") else "ok")
                print(f"[{status}] {cell} ({time.time() - t0:.0f}s)",
                      flush=True)
    return done


if __name__ == "__main__":
    failed = [c for c, r in main().items() if r.get("error")]
    raise SystemExit(1 if failed else 0)
