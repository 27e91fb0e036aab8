"""Roofline terms at the NVIDIA H100's figures — the port's counterpart
of ``repro.launch.hlo_analysis``.

The reference parses the compiled HLO for collective bytes and takes
FLOPs and bytes from XLA's cost analysis.  The port compiles nothing:
the dry run (``launch.dryrun``) counts FLOPs with
``torch.utils.flop_counter.FlopCounterMode``, bytes with
:class:`OpBytes` (every aten op's operands and results, the unfused
upper bound, as XLA's "bytes accessed") and collectives with the
single controller's own counters (``distributed.collectives.counting``).

The figures are the NVIDIA H100 80GB HBM3 (SXM5) at 700 W, from NVIDIA's
H100 datasheet: 989.4e12 FLOP/s bf16 dense, 3.35e12 B/s of HBM3, and per
GPU 50e9 B/s across nodes (one 400 Gb/s NDR NIC a GPU: the production
meshes of 256 and 512 GPUs span nodes) or 450e9 B/s of NVLink a
direction within a node of 8.
"""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

PEAK_FLOPS = 989.4e12        # bf16 dense, per GPU
HBM_BW = 3.35e12             # bytes/s per GPU
NET_BW = 50e9                # bytes/s per GPU across nodes
NVLINK_BW = 450e9            # bytes/s per GPU a direction, <= 8 GPUs
NODE_GPUS = 8


def link_bw(chips: int) -> float:
    """The bytes/s a GPU moves to its peers: NVLink within a node,
    the network beyond one."""
    return NVLINK_BW if chips <= NODE_GPUS else NET_BW


def roofline_terms(flops, hbm_bytes, coll_bytes: float,
                   chips: int) -> dict:
    """Seconds of compute, memory and collectives for the whole mesh's
    ``flops``, ``hbm_bytes`` and ``coll_bytes`` spread over ``chips``
    GPUs; the largest bounds the step.  A term whose count is None (not
    counted) is None and bounds nothing."""
    terms = {
        "compute_s": None if flops is None
        else flops / (chips * PEAK_FLOPS),
        "memory_s": None if hbm_bytes is None
        else hbm_bytes / (chips * HBM_BW),
        "collective_s": coll_bytes / (chips * link_bw(chips)),
    }
    known = {k: v for k, v in terms.items() if v is not None}
    dominant = max(known, key=known.get)
    return dict(terms, dominant=dominant.removesuffix("_s"),
                bound_step_s=known[dominant], peak_flops=PEAK_FLOPS,
                hbm_bw=HBM_BW, link_bw=link_bw(chips))


def _nbytes(x) -> int:
    return x.numel() * x.element_size() \
        if isinstance(x, torch.Tensor) else 0


class OpBytes(TorchDispatchMode):
    """Sums the bytes of every aten op's tensor operands and results
    (views move nothing and are left out): the traffic of a program
    that fuses nothing.  Works on meta tensors."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            flat = torch.utils._pytree.tree_leaves((args, kwargs, out))
            self.bytes += sum(_nbytes(x) for x in flat)
        return out


def analytic_memory_floor(cfg, shape_info, kind: str, chips: int,
                          param_bytes: int = 2) -> float:
    """Lower-bound HBM bytes per device per step (perfect fusion):
    params traffic + one write+read of each layer's residual stream +
    logits traffic + KV-cache traffic for decode.  The unfused op
    bytes are the UPPER bound; truth lies between.  (The reference's
    formula, term for term.)"""
    L, d, V = cfg.num_layers, cfg.d_model, cfg.vocab_size
    B = shape_info["global_batch"]
    S = shape_info["seq_len"] if kind != "decode" else 1
    tokens = B * S
    n_params = cfg.param_count()
    act_bytes = 2
    if kind == "train":
        p_traffic = 4 * n_params * param_bytes      # fwd + bwd reads, upd rw
        a_traffic = 4 * L * tokens * d * act_bytes  # residual save + remat
        logits = 3 * tokens * V * act_bytes
    elif kind == "prefill":
        p_traffic = n_params * param_bytes
        a_traffic = 2 * L * tokens * d * act_bytes
        logits = B * V * act_bytes
    else:
        n_active = cfg.active_param_count()
        p_traffic = n_active * param_bytes
        a_traffic = 2 * L * tokens * d * act_bytes
        logits = tokens * V * act_bytes
        # KV/state cache read per step
        Sc = shape_info["seq_len"]
        n_attn = sum(cfg.layer_kind(i) == "attn" for i in range(L))
        n_ssm = L - n_attn
        cache = B * (n_attn * (Sc * cfg.num_kv_heads * cfg.head_dim * 2
                               if cfg.attn_type != "mla" else
                               Sc * (cfg.kv_lora_rank + cfg.rope_head_dim))
                     + n_ssm * cfg.ssm_heads * cfg.ssm_headdim
                     * cfg.ssm_state * 2) * param_bytes
        a_traffic += cache
    total = p_traffic + a_traffic + logits
    return total / chips
