#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one CUDA card::

    python3 chip_smoke.py

It builds the hand-written kernels from ``src/repro_torch/kernels/csrc``
(one ``nvcc`` per source, all at once), then drives the port's main path
through the public entry points at chromosome scale:

1. ``[build]``   ``SuffixTable.from_codes`` over 2**26 random bases on
                 the card (SA by prefix doubling, text packed by pack2bit);
2. ``[count]``   the paper's workload (10,000 random patterns of 1-100
                 bases) through ``SuffixTable.scan`` in batches of 512;
3. ``[append]``  three appends of 2**17 bases: the second seals a run at
                 ``memtable_limit``, so a run and a memtable are live;
4. ``[merged]``  the workload again over base + run + memtable (the tier
                 scan kernel), then ``locate(top_k=5)``;
5. ``[linear]``  ``ops.tablet_scan`` of the first batch over every sorted
                 row of that table's base (the tablet scan kernel), held
                 against the plain binary search's bounds for every
                 query of the batch;
6. ``[freeze]``  a second table over the same bases, frozen onto an FM
                 index by the ``fm_threshold`` policy;
7. ``[frozen]``  the workload through the frozen table, base only (the
                 fm_scan kernel); counts and first_pos must equal
                 ``[count]``;
8. ``[frozen-merged]`` the same three appends to the frozen table, the
                 workload and ``locate(top_k=5)`` again (fm_scan plus the
                 tier scan kernel); must equal ``[merged]`` and
                 ``[locate]``;
9. ``[compact]`` major compaction of the live table (the merge's
                 insertion search is a ``bounded_search`` launch, the
                 re-attach packs the text with pack2bit): the merged SA
                 must equal a from-scratch build on every row, and the
                 workload on the compacted table (``[compacted]``) must
                 equal ``[merged]``;
10. ``[frozen-compact]`` the same for the frozen table: its SA rebuilt
                 from the index, merged, frozen again; it must stay
                 frozen and ``[frozen-compacted]`` must equal ``[merged]``;
11. ``[persist]`` ``SuffixTable.create`` under a directory in
                 ``build/``, the three appends, ``flush``, then ``open``
                 in a fresh object (``[reopened]`` must equal
                 ``[merged]``); seconds and bytes on disk;
12. ``[wal]``    one more append to the reopened table, no flush, and
                 ``open`` again: the commit log's replay must give the
                 appending table's answers (``[replayed]``);
13. ``[long]``   patterns past 16 words: a third 2**26-base table at
                 ``max_query_len=1024`` (W = 64) serves 512 patterns of
                 1-1000 bases (half cut from the text) base only, then
                 after an append, ``minor_compact`` and an append (the tier
                 scan kernel); a frozen table over a 2**22-base slice
                 serves its own 512 (``fm_scan``); counts against a host
                 brute force for 16 patterns of each; then each search
                 kernel against its plain versions at W = 17, 32 and 64
                 (``[long:W=..]``) and its W = 64 times (``[long:kernel]``);
14. ``[client]`` the live table attached to ``Database.in_memory()``:
                 ``benchmarks/client_bench.py``'s three arms through the
                 port (``per_call``: 128 callers, a batch of 1 each;
                 ``coalesced``: ``query_many``; ``scheduler``: 128 threads
                 calling ``submit``), 8 waves of the paper workload with
                 ``top_k=5``, the string cache cleared before every wave;
                 the three arms' answers must be bit-identical;
15. ``[serve]``  ``python -m repro_torch.launch.serve`` in the process at
                 2**26 bases, 10,000 queries in batches of 512, under a
                 root in ``build/`` (removed at the end); an unflushed
                 append; the launcher again on the root (the ``[open ]``
                 path: the commit log must replay the append); then
                 ``--dump-stats``.  ``[locate]`` is held against a host
                 brute force, ``[stream]``'s page total against the
                 one-shot count, ``[write ]``'s rise against the planted
                 occurrences, and the feed must hold the reference's rows;
16. ``[staged]`` ``SuffixTable.create(max_device_bytes=100,663,296)``
                 over the first 2**25 of those bases (8 chunks of 2**22
                 rows, each sorted on the card as sub-chunks that fit the
                 budget), the SA streamed into the snapshot shard by
                 shard: the snapshot's SA must equal an in-memory build's
                 on every row and
                 the build's measured device peak stay within the budget
                 (``[sort-footprint]`` gives one chunk sort's bytes a
                 row); a second staged build of 2**24 bases spilled to a
                 directory in ``build/`` must equal the in-memory build
                 and leave the directory empty (``[staged:spill]``); a
                 third of 2**20 bases with ``staged=True`` and no budget
                 must sort each 2**16-row chunk whole, one sort a chunk
                 a round (``[staged:whole]``); the staged table reopened
                 serves the workload, equal to the in-memory build's
                 answers (``[staged-served]``);
17. ``[plane]``  one unflushed append of 2**17 bases to that table, then
                 ``ServingPlane.deploy`` (4 tablets x 2 replicas of numpy
                 tablet workers over the snapshot, the owner replaying
                 the log's tail): the workload as ``count`` and
                 ``scan(top_k=4)`` through ``Database.connect_plane``,
                 and ``locate_range`` of its first 2,048 patterns (one
                 call each; cut from 10,000 to keep the run within half
                 its time limit), must equal the card table's merged
                 answers; ``count`` again after ``kill -9`` of one
                 replica of tablet 0, and after its restart one batch of
                 ``scan(top_k=4)`` and the text CRC it had before;
                 ``[plane:hedged]``: the paper's workload (1,000 queries
                 in batches of 50) through ``HedgedScanService`` over the
                 plane's ``RemoteTable``, hedged off and on: the routed
                 batches' wall ms, the router's RPCs and backup RPCs per
                 arm, each arm's answers (``found``, ``count``,
                 ``first_pos``) equal to the card table's on the same
                 seeds, query by query;
18. ``[mesh]``   ``REPRO_TORCH_HOST_DEVICES=8`` in the process: 8
                 tablets of 2**23 rows on the card.  ``[mesh:build]``
                 ``SuffixTable.from_codes`` of the 2**26 bases (the
                 distributed bitonic build; its SA must equal
                 ``[build]``'s, its seconds and device peak beside
                 them); ``[mesh:broadcast]`` (``routed_min_batch`` above
                 the batch) and ``[mesh:routed]`` (capacity factor 2.0,
                 then 0.25, where overflows must be retried): counts and
                 first_pos equal ``[count]``'s, the planner's four fields
                 the plain search's; ``[mesh:merged]`` the three appends
                 and the workload, equal to ``[merged]``;
                 ``[mesh:compact]`` ``compact()`` with
                 ``distributed_build`` (SA equal to a single-device
                 build); ``[mesh-sort-footprint]`` one super-chunk
                 sort over the 8 tablets (2**14 and 2**16 rows a tablet,
                 random and tie-heavy keys) holds no more device bytes
                 than the staged build sizes its mesh sorts by;
                 ``[mesh:staged]`` ``create`` of 2**22 bases under a
                 67,108,864-byte budget of the card the 8 tablets share
                 (SA equal to the in-memory build, the build's measured
                 device peak within the budget; a 6,400,000-byte budget
                 raises before the catalog names the table);
                 ``[mesh:kernels]`` each kernel of
                 the path (``bounded_search`` per tablet, the routed
                 owner choice's ``pattern_compare``, ``tier_scan``,
                 ``pack2bit``) against its plain version on the phase's
                 inputs;
19. ``[dedup]``  corpus dedup and contamination on the card: a 2**26-
                 token corpus (16,384 documents of 4,096 tokens of a
                 151,936 vocabulary, 1 in 20 a planted copy of another)
                 and ``dna_corpus(2**26, dup_fraction=0.1)``:
                 ``duplicate_span_mask`` (min_len 50 and 32) must equal
                 a numpy check keying every gram on every position,
                 ``filter_duplicate_docs`` drop both members of every
                 planted pair and nothing else, the DNA mask cover the
                 planted span and its copy, and ``contamination_check``
                 (4,096 windows, half cut from the corpus) equal the
                 numpy gram set, on each store and on a table after an
                 append; build, ``adjacent_lcp`` (seconds, device peak)
                 and queries/s;
20. ``[paper]``  after the search phases have released the card: the
                 paper's case study at chr1's length through
                 ``examples/dna_search_torch.py`` (248,956,422 seeded
                 bases into a table created under ``build/``, Tables
                 III, IV and V and the hedged run of 10,000 queries
                 each, locate, an 8-base probe streamed in pages of
                 100 and resumed from its cursor, the straddling
                 append, compact and reopen); every answer of the three
                 runs (``found``, ``count``, ``first_pos``) held against
                 the plain search on the card, every found ``first_pos``
                 against the seeded text, the 16 longest found and 16
                 shortest missed patterns counted by brute force, the
                 hit rate within 5 sigma of the random-text expectation
                 (0.1386), Table V's correlations and Table IV's tail;
    ``[examples]`` the four example scripts of the port at their
                 default sizes on the card (their own asserts; seconds);
21. ``[lm]``     after those phases:
                 qwen3-0.6b at full width in fp32 from seeded weights:
                 ``greedy_generate`` of 8 prompts of 512 tokens, 64 new,
                 ``max_len`` 1024, and the same through ``make_prefill_fn``
                 / ``make_decode_fn``: equal tokens, every step's logits
                 within 5e-3 of a full forward (``[lm:serve]``); 10
                 AdamW steps on one 8 x 512 batch, the loss falling,
                 microbatches 4 against 1 at lr 0, a save at step 5 and
                 a resume equal to the uninterrupted run
                 (``[lm:train]``); ``[lm:moe]``: deepseek-v3 at its
                 published widths cut to 4 layers (3 dense, 1 MoE; MTP
                 depth 1) in bf16, ~26.7e9 parameters: 8 prompts of 512
                 into a 1,024-slot MLA latent cache, 32 decoded tokens,
                 the loss with its aux and MTP terms; at capacity 1.25
                 prefill's last logits equal a full forward's and the
                 dropped assignments are counted; at 8.0 decode against
                 teacher forcing, the tokens routed otherwise at near
                 ties counted apart, and layer 0's MLA in fp32 holds the
                 absorbed decode within 5e-3 of the materialized path;
                 ``[lm:ssm:*]``: mamba2-780m whole in fp32, served and
                 trained as qwen3 (resumed losses bit-equal) and
                 ``ssd_chunked`` against the step recurrence;
                 ``[lm:archs]``: all ten configs reduced, card against
                 CPU within 5e-3, decode against teacher forcing (the
                 MoE configs at capacity 8.0), one AdamW step of each
                 MoE or SSD config; LM sharding over shards of the card,
                 single controller: ``[lm:shard:ep]`` (in ``[lm:moe]``)
                 the fp32 MoE layer expert-parallel over (1, 16) and
                 (2, 8) shards against the one-device call,
                 ``[lm:shard:pipe]`` (in ``[lm:train]``) qwen3 as 4 GPipe
                 stages against the plain stack, ``[lm:shard:compress]``
                 its 8 row gradients through the int8 exchange;
22. ``[kernels]`` every kernel's launches on each of the thirteen paths
                 (serving 1-8, compaction 9-10, persistence 11-12, long 13,
                 client 14, serve 15, staged 16, plane 17 and its hedged
                 run, mesh 18, dedup 19, paper and examples 20; the [lm]
                 path runs no kernel of its own: its
                 matmuls and attention are plain torch, as the
                 reference's are plain jnp; the
                 counts are set to 0 before each and read after it) and
                 its result held against its plain PyTorch version(s)
                 on inputs taken from that run, and timed, between
                 phases 12 and 13; a sample of counts is
                 checked against a numpy brute-force scan of the text.
                 The three searches (``bounded_search``, ``tablet_scan``,
                 ``tier_scan``) also print their rounds and probes
                 (``[search]``, ``[tablet]``, ``[tiers]``), ``[fm]`` the
                 backward search's ranks and words, and ``[ptxas]``
                 lines give every kernel's registers, shared memory and
                 spills.

``pattern_compare`` runs on the serving path as the epilogue of the
``bounded_search`` launch (``pattern_scan.bounded_match_cuda``): its
standalone kernel must show no launch there, and ``found == (count >
0)`` must hold on every query of every live single-device phase; the
epilogue's four outputs are held against their plain version on a whole
batch.  On the mesh path the standalone kernel runs by design (the
routed owner choice), and a mesh search is ``bounded_search`` bounds
only.

It prints one JSON line of per-kernel numbers (``ms``: time per call as
the host issues them; ``device_ms``: device time of launches queued back
to back, the L2 warm; ``cold_ms``: device time of a launch that follows
a flush of the L2; ``ms_after_phases``: ``ms`` again after phase 15)
and, last, the device line.  Any build, launch or mismatch
failure exits non-zero without it.
It imports neither jax nor the JAX package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

TEXT_LEN = 2**26
MEMTABLE_LIMIT = 2**18
APPEND_LEN = 2**17
N_QUERIES = 10_000
BATCH = 512
MAX_QUERY_LEN = 128
SLICE_ROWS = 2**18          # rows the dense plain tablet scan is held on
FLUSH_WORDS = 2**26         # int32 words (256 MiB) written to flush the L2
LONG_QUERY_LEN = 1024       # [long]: W = 64 pattern words
LONG_MAX_PATTERN = 1000
LONG_WIDTHS = (17, 32, 64)
FROZEN_SLICE = 2**22        # [long]: bases of the frozen table
LONG_TABLET_ROWS = 2**20    # [long]: sorted rows tablet_scan is held on
CALLERS = 128               # [client]: callers per wave
CLIENT_WAVES = 8
STAGED_LEN = 2**25          # [staged]: the first 2**25 bases of [build]'s
STAGED_BUDGET = 100_663_296 # [staged]: max_device_bytes -> 2**22-row chunks
SPILL_LEN = 2**24           # [staged]: bases of the spilled build
WHOLE_LEN = 2**20           # [staged]: bases of the build without a budget
PLANE_TABLETS = 4           # [plane]: tablets x replicas
PLANE_REPLICAS = 2
PLANE_LOCATE = 2048         # [plane]: patterns located one call each
PLANE_HEDGED_QUERIES = 1_000    # [plane:hedged]: the paper's workload
PLANE_HEDGED_BATCH = 50         # (Table IV's 50 users) through the plane
PLANE_HEDGED_SEED = 4
MESH_TABLETS = 8            # [mesh]: tablets on the one card
MESH_STAGED_LEN = 2**22     # [mesh:staged]: bases
MESH_STAGED_BUDGET = 67_108_864  # [mesh:staged]: the card's bytes, 8 tablets
MESH_TOO_SMALL = 6_400_000  # [mesh:staged]: a budget 8 tablets cannot share
MESH_FOOTPRINT_ROWS = (2**14, 2**16)  # [mesh-sort-footprint]: a tablet's
PAPER_LEN = 248_956_422     # [paper]: chr1's length (GRCh38), seeded bases
PAPER_QUERIES = 10_000      # [paper]: each of Tables III, IV and hedged
PAPER_CHECK_BATCH = 512     # [paper]: patterns a plain-search call
PAPER_BRUTE = 16            # [paper]: found and missed patterns counted
                            # by brute force over the seeded text
DEDUP_SEED = 0              # [dedup]: corpora and windows
DEDUP_DOCS = 16_384         # [dedup]: documents of DEDUP_DOC_LEN tokens
DEDUP_DOC_LEN = 4_096
DEDUP_VOCAB = 151_936       # [dedup]: qwen3's vocabulary
DEDUP_COPY_EVERY = 20       # [dedup]: 1 document in 20 is a planted copy
DEDUP_MIN_LEN = 50          # [dedup]: tokens (Lee et al.'s 50-token spans)
DEDUP_THRESHOLD = 0.5
DEDUP_DNA_DUP = 0.1         # [dedup]: dna_corpus(dup_fraction=0.1)
DEDUP_DNA_MIN_LEN = 32
DEDUP_WINDOWS = 4_096       # [dedup]: contamination windows, half cut
DEDUP_QUERY_LEN = 64
LM_ARCH = "qwen3-0.6b"      # [lm]: full width, fp32, seeded weights
LM_SEED = 0
LM_PROMPTS = 8              # [lm:serve]: prompts x tokens, new tokens
LM_PROMPT_LEN = 512
LM_NEW = 64
LM_MAX_LEN = 1024
LM_TRAIN_BATCH = 8          # [lm:train]: one fixed batch
LM_TRAIN_SEQ = 512
LM_STEPS = 10
LM_SAVE_AT = 5
LM_LR = 3e-4
LM_DENSE = ("qwen3-0.6b", "yi-6b", "qwen1.5-110b", "phi3-mini-3.8b",
            "musicgen-medium", "internvl2-26b")
LM_ARCHS = LM_DENSE + ("deepseek-v3-671b", "kimi-k2-1t-a32b",
                       "jamba-v0.1-52b", "mamba2-780m")
LM_MOE_ARCH = "deepseek-v3-671b"   # [lm:moe]: published widths, bf16
LM_MOE_LAYERS = 4           # its 3 dense layers + 1 MoE layer (of 61)
LM_MOE_NEW = 32             # [lm:moe]: new tokens (prompts as [lm])
LM_MOE_TOL = 5e-2           # [lm:moe]: bf16 decode vs teacher forcing
LM_MOE_NEAR_TIE = 0.1       # [lm:moe]: router-logit gap of a near tie
LM_SSM_ARCH = "mamba2-780m"      # [lm:ssm]: full width and depth, fp32
SHARD_EP_TOKENS = (8, 512)  # [lm:shard:ep]: T = 4,096, the EP threshold
SHARD_EP_CAPACITY = 1.25    # [lm:shard:ep]: the published factor: drops
SHARD_EP_MESHES = ((1, 16), (2, 8))   # (data, model) shards on the card
SHARD_EP_TOL = 5e-4         # [lm:shard:ep]: out; aux within 1e-4
SHARD_AUX_TOL = 1e-4
SHARD_PIPE_STAGES = 4       # [lm:shard:pipe]: 4 stages x 7 layers,
SHARD_PIPE_MICRO = 4        # 4 microbatches of 2 x 512
SHARD_ROUNDS = 16           # [lm:shard:compress]: error-feedback rounds
SHARD_TRAIN_BATCH = (16, 256)   # [lm:shard:train]: 4,096 tokens, 16 rows
SHARD_TRAIN_STEPS = 3       # [lm:shard:train]: steps, then save
SHARD_RESTORE_MESH = (2, 4)     # [lm:shard:train]: the elastic restore's
SHARD_TRAIN_RTOL = 1e-4
DRYRUN_CELLS = (("qwen3-0.6b", "train_4k", "single"),
                ("deepseek-v3-671b", "decode_32k", "multi"),
                ("mamba2-780m", "long_500k", "single"),
                ("dna-suffix", "serve", "single"))

# Published H100 SXM peaks (NVIDIA data sheet), used for the bounds.
MEM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12          # float32 outside the tensor cores


def cuda_ms(torch, fn, reps: int, *, queue_ahead: bool = False,
            flush=None) -> float:
    """Mean time of ``fn`` in ms over ``reps`` runs after one warm-up, by
    CUDA events.  Plain events time the calls as the host issues them:
    for a kernel of tens of µs the wrapper's host work per call is the
    larger part.  With ``queue_ahead`` the card first spins ~25 ms
    (``torch.cuda._sleep``), so the host has queued every launch before
    the first starts, and the events time the kernels back to back: each
    launch finds in the L2 what the one before it read.  With ``flush``
    (a tensor larger than the 50 MB L2; queued ahead as well) every run
    follows a write of that tensor and has its own pair of events: the
    device time of a launch whose inputs start in HBM."""
    fn()
    torch.cuda.synchronize()

    def ev():
        return torch.cuda.Event(enable_timing=True)

    if queue_ahead or flush is not None:
        torch.cuda._sleep(50_000_000)
    if flush is not None:
        pairs = [(ev(), ev()) for _ in range(reps)]
        for start, end in pairs:
            flush.zero_()
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in pairs) / reps
    start, end = ev(), ev()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / MEM_BYTES_PER_S * 1e3
    t_ops = n_ops / ALU_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(torch, got, want) -> int:
    err = 0
    for g, w in zip(got, want):
        d = (g.to(torch.int64) - w.to(torch.int64)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    return err


def fm_traffic(torch, FM, fa, syms):
    """What the backward search of the plan ``syms`` needs on index
    ``fa``, counted on this run's data: per active step one rank at
    ``lo`` and, while the run is not empty, one at ``hi`` (fm_scan.cu
    takes one rank once ``lo == hi``); each rank reads one Occ entry and
    the ceil(rem / 16) BWT words below its row.  Steps the search in
    plain torch; returns (ranks, words, lo, hi)."""
    B = int(syms.shape[1])
    cc = fa.cc.to(torch.int64)
    lo = torch.zeros(B, dtype=torch.int64, device=syms.device)
    hi = torch.full_like(lo, fa.n + 1)
    ranks = torch.zeros((), dtype=torch.int64, device=syms.device)
    words = torch.zeros_like(ranks)
    for t in range(int(syms.shape[0])):
        s = syms[t].to(torch.int64)
        act = s >= 0
        two = act & (hi > lo)
        ranks += act.sum() + two.sum()
        words += ((lo % FM.SB + 15) // 16)[act].sum()
        words += ((hi % FM.SB + 15) // 16)[two].sum()
        sc = s.clamp(0, fa.vocab - 1)
        lo2 = cc[sc] + FM.rank(fa, sc, lo)
        hi2 = cc[sc] + FM.rank(fa, sc, hi)
        lo = torch.where(act, lo2, lo)
        hi = torch.where(act, hi2, hi)
    return int(ranks), int(words), lo.to(torch.int32), hi.to(torch.int32)


def probed_rows(torch, trace):
    """What a traced 17-ary search (``kary.search``) probed: the distinct
    rows, each with the most window words any probe of it read, the
    rounds in which some lane probed, the probes and the words they read
    in all."""
    rows = torch.cat([r for r, _ in trace])
    words = torch.cat([w for _, w in trace])
    uniq, inv = torch.unique(rows, return_inverse=True)
    most = torch.zeros(uniq.shape, dtype=torch.int64, device=rows.device)
    most.scatter_reduce_(0, inv, words, "amax")
    rounds = sum(1 for r, _ in trace if r.numel())
    return uniq, most, rounds, int(rows.numel()), int(words.sum())


def text_bytes(torch, pos, most, text_packed):
    """4 B per distinct packed text word that early-exit compares read
    of the suffixes at ``pos``, ``most[i]`` window words of the suffix at
    ``pos[i]`` (words ``pos // 16 ..``, one more when ``pos % 16``
    shifts the window across a word)."""
    pos = pos.to(torch.int64)
    n_words = int(text_packed.shape[0])
    span = most + (((pos % 16) != 0) & (most > 0)).to(torch.int64)
    mark = torch.zeros(n_words, dtype=torch.bool, device=pos.device)
    for j in range(int(span.max()) if span.numel() else 0):
        idx = (pos // 16 + j)[span > j]
        mark[idx[idx < n_words]] = True
    return 4 * int(mark.sum())


def search_traffic(torch, trace, sa, text_packed):
    """Bytes a traced search of the sorted rows ``sa`` of one store
    reads (each read once): 4 per distinct probed row (its ``sa``
    entry) + the text words its compares read (:func:`text_bytes`);
    plus the rounds, the probes and the words compared in all.  From a
    binary search's trace this is what the function needs."""
    uniq, most, rounds, probes, words = probed_rows(torch, trace)
    return (4 * int(uniq.numel()) + text_bytes(torch, sa[uniq], most,
                                               text_packed),
            rounds, probes, words)


def tablet_traffic(torch, trace):
    """Bytes a traced tablet search of this run's data reads (each read
    once): 4 per distinct probed row (its position) + 4 per window word
    the early-exit compare reads of it; plus the rounds, the probes and
    the words compared in all.  From a binary search's trace this is what
    the function needs; from the kernel's 17-ary one, what its probes
    read."""
    uniq, most, rounds, probes, words = probed_rows(torch, trace)
    return 4 * int(uniq.numel()) + 4 * int(most.sum()), rounds, probes, words


def tier_traffic(torch, traces, sa, text_packed, run_lo, run_hi):
    """Bytes a traced tier search and the sweep of the match runs
    ``[run_lo, run_hi)`` (T, B) of this run's data read (each read once):
    per tier, 4 per distinct sa row that a probe or a swept run reads,
    and 4 per distinct packed text word that the early-exit compares read
    (words ``pos // 16 ..``, one more when ``pos % 16`` shifts the window
    across a word); plus the most rounds of any tier, the probes and the
    words compared in all.  Binary and 17-ary traces as in
    :func:`tablet_traffic`."""
    T, R = sa.shape
    dev = sa.device
    n_bytes, rounds, probes, words = 0, 0, 0, 0
    for t in range(T):
        uniq, most, r, p, w = probed_rows(torch, traces[t])
        rounds, probes, words = max(rounds, r), probes + p, words + w
        lb = run_lo[t].to(torch.int64)
        ub = run_hi[t].to(torch.int64)
        cover = torch.zeros(R + 1, dtype=torch.int64, device=dev)
        cover.index_add_(0, lb, torch.ones_like(lb))
        cover.index_add_(0, ub, -torch.ones_like(ub))
        touched = torch.cumsum(cover, 0)[:R] > 0
        touched[uniq] = True
        n_bytes += 4 * int(touched.sum()) + text_bytes(
            torch, sa[t, uniq], most, text_packed[t])
    return n_bytes, rounds, probes, words


def used_words(torch, plen) -> int:
    """Pattern words the masks keep, summed over the batch."""
    return int(((plen.to(torch.int64) + 15) // 16).sum())


def match_traffic(torch, kary, codec, store, patt, plen, lb, bin_trace):
    """What ``bounded_match_cuda`` needs on ``store`` (each byte once):
    the binary search's reads (``bin_trace``, :func:`search_traffic`)
    plus the epilogue's compare at ``lb`` (its sa row and the text words
    it reads, into the same dedup), the pattern words in use, plen and 13
    B of outputs a query; ~4 operations per word compared.  Also the
    bounds alone (8 B of outputs a query), and the epilogue's words and
    positions."""
    B, W = (int(d) for d in patt.shape)
    s_bytes, rounds, probes, words = search_traffic(
        torch, bin_trace, store.sa, store.text_packed)
    lbc = lb.clamp(max=store.n_pad - 1).to(torch.int64)
    pos_lb = store.sa[lbc]
    _, _, w_lb = kary.compare(
        codec.extract_window(store.text_packed, pos_lb, W)[None, :, None],
        pos_lb[None, :, None], patt, plen, store.n_real)
    w_lb = w_lb.reshape(-1)
    e_bytes, _, _, _ = search_traffic(
        torch, bin_trace + [(lbc, w_lb)], store.sa, store.text_packed)
    fixed = 4 * used_words(torch, plen) + 4 * B
    return {"bytes": e_bytes + fixed + 13 * B,
            "ops": 4 * (words + int(w_lb.sum())),
            "bounds_bytes": s_bytes + fixed + 8 * B, "bounds_ops": 4 * words,
            "rounds": rounds, "probes": probes, "words": words,
            "w_lb": w_lb, "pos_lb": pos_lb}


def tier_runs(torch, TS, stack, got):
    """The match runs past their padding that the tier kernel sweeps,
    (run_lo, run_hi) (T, B), from its outputs ``got``."""
    less = got[1].to(torch.int64)
    run_hi = less + got[2]
    run_lo = less.maximum(TS.pad_prefix(stack.pad_cnt)[:, None]).minimum(
        run_hi)
    return run_lo, run_hi


def tier_fixed(torch, stack, plen) -> int:
    """The tier scan's bytes besides the searches and sweeps: the
    pattern words in use, plen, meta, two pad_cnt entries per tier and
    16 B of outputs per (tier, query)."""
    T, B = int(stack.sa.shape[0]), int(plen.shape[0])
    return 4 * used_words(torch, plen) + 4 * B + 40 * T + 16 * T * B


def ptxas_report(build_dir, names):
    """Registers, shared memory and spills of every kernel entry in the
    nvcc logs of ``names`` (built with -Xptxas -v), one dict each."""
    import re
    out = []
    for name in names:
        log = build_dir / f"{name}.log"
        if not log.exists():
            continue
        cur = None
        for line in log.read_text().splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                k = re.search(r"\d+(\w+_kernel)", m.group(1))
                cur = {"kernel": k.group(1) if k else m.group(1)}
                out.append(cur)
            elif cur is not None:
                for key, pat in (("spill_stores", r"(\d+) bytes spill stores"),
                                 ("spill_loads", r"(\d+) bytes spill loads"),
                                 ("registers", r"Used (\d+) registers"),
                                 ("smem_bytes", r"(\d+) bytes smem")):
                    m = re.search(pat, line)
                    if m:
                        cur[key] = int(m.group(1))
    return out


def brute_positions(np, text, pattern):
    """All start positions of ``pattern`` in ``text`` (uint8 codes), by a
    vectorised numpy scan that filters candidates one base at a time."""
    L = len(pattern)
    cand = np.flatnonzero(text[:len(text) - L + 1] == pattern[0])
    for k in range(1, L):
        cand = cand[text[cand + k] == pattern[k]]
    return cand


def sorted_windows(torch, codec, store, n_words: int, chunk: int = 2**22):
    """(W, n_real) uint32: the packed window of every real sorted row of
    ``store``, extracted ``chunk`` rows at a time (the one-shot
    extraction's int64 temporaries would take ~10x the result)."""
    pos = store.sa[store.pad_count:]
    n = int(pos.shape[0])
    wt = torch.empty((n_words, n), dtype=torch.uint32, device=pos.device)
    for i in range(0, n, chunk):
        win = codec.extract_window(store.text_packed, pos[i:i + chunk],
                                   n_words)
        wt.view(torch.int32)[:, i:i + chunk] = win.view(torch.int32).T
    return wt


def long_patterns(np, codec, Q, text, n: int, max_len: int, seed: int):
    """``n`` patterns of 1..``max_len`` bases: the even ones cut from
    ``text`` (so they match), the odd ones random."""
    rng = np.random.default_rng(seed)
    rand = Q.random_patterns(n, 1, max_len, seed=seed)
    out = []
    for i in range(n):
        if i % 2:
            out.append(rand[i])
            continue
        L = int(rng.integers(1, max_len + 1))
        s = int(rng.integers(0, len(text) - L))
        out.append(codec.decode_dna(text[s:s + L]))
    return out


def run_cli(main, argv) -> str:
    """Run ``main(argv)`` in this process; return what it printed, and
    print it too."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    out = buf.getvalue()
    print(out, end="", flush=True)
    return out


def cli_line(out: str, prefix: str) -> str:
    """The first line of ``out`` starting with ``prefix`` ('' if none)."""
    return next((ln for ln in out.splitlines() if ln.startswith(prefix)),
                "")


def profile_batches(torch, table, patterns, tag: str) -> None:
    """Device busy share and top kernels over four batches (cache
    cleared), by torch.profiler; outside the counted main path."""
    table.clear_cache()
    profile_fn(torch, lambda: [table.scan(patterns[i:i + BATCH])
                               for i in range(0, 4 * BATCH, BATCH)],
               tag, "batches=4")


def profile_fn(torch, fn, tag: str, what: str) -> None:
    """Device busy share of ``fn()`` (wall time to a synchronize) and its
    top kernels by device time, by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        kernels = [e for e in prof.key_averages()
                   if str(getattr(e, "device_type", "")).endswith("CUDA")]
        dev_us = sum(getattr(e, "self_device_time_total", 0.0)
                     for e in kernels)
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
        print(f"[profile:{tag}] {what} wall_ms={wall_us / 1e3:.3f} "
              f"device_busy_ms={dev_us / 1e3:.3f} "
              f"device_busy_share={dev_us / wall_us:.4f}", flush=True)
        for e in top:
            print(f"[profile:kernel] {e.key[:60]} calls={e.count} "
                  f"device_ms={e.self_device_time_total / 1e3:.3f}",
                  flush=True)
    except (RuntimeError, AttributeError) as exc:   # profiler unavailable
        print(f"[profile:{tag}] not measured: {exc}", flush=True)


def gram_keys(np, codes, L: int, dna: bool):
    """One uint64 key per ``L``-gram of ``codes`` (positions 0 .. n-L),
    by doubling: key_2k(p) = key_k(p) * B**k + key_k(p + k).  For DNA
    with L <= 32 the key is the gram itself (2 bits a base, exact); for
    tokens a polynomial hash mod 2**64 (random corpus: a collision among
    2**26 grams has probability ~2**-13, and can only add positions)."""
    base = 4 if dna else 0x9E3779B97F4A7C15

    def power(k):                               # base**k mod 2**64
        return np.uint64(pow(base, k, 2**64))

    n = len(codes) - L + 1
    keys = {1: codes.astype(np.uint64)}
    k = 1
    while 2 * k <= L:
        prev = keys[k]
        keys[2 * k] = prev[:-k] * power(k) + prev[k:]
        k *= 2
    out, off = None, 0
    for bit in sorted(keys, reverse=True):      # L = sum of powers of 2
        if L - off >= bit:
            part = keys[bit][off:off + n]
            out = part.copy() if out is None else out * power(bit) + part
            off += bit
    return out


def dup_mask_from_keys(np, keys, n: int):
    """(mask over the n positions: its gram occurs at least twice, the
    keys sorted) — the independent check of ``duplicate_span_mask``."""
    order = np.argsort(keys)
    sk = keys[order]
    eq = sk[1:] == sk[:-1]
    dup = np.zeros(len(sk), bool)
    dup[1:] |= eq
    dup[:-1] |= eq
    mask = np.zeros(n, bool)
    mask[order] = dup
    return mask, sk


def in_sorted(np, sk, keys):
    """keys found in the sorted key array ``sk``."""
    at = np.minimum(np.searchsorted(sk, keys), len(sk) - 1)
    return sk[at] == keys


def dedup_phase(np, torch, _build, check, dev, smi) -> tuple:
    """The [dedup] path: a 2**26-token corpus with planted document
    copies and a 2**26-base DNA corpus with a planted span, through
    ``repro_torch.core.dedup`` and ``data.pipeline`` on the card, each
    held against the numpy gram check.  Returns (launches, the kernels'
    errors against their plain versions, seconds)."""
    from repro_torch.api import SuffixTable
    from repro_torch.core import codec
    from repro_torch.core import dedup as D
    from repro_torch.core.suffix_array import adjacent_lcp
    from repro_torch.core.tablet import build_tablet_store
    from repro_torch.data.pipeline import dna_corpus
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import tier_scan as TS
    from repro_torch.kernels.pack2bit import pack2bit_cuda
    from repro_torch.kernels.pattern_scan import (bounded_match_cuda,
                                                  bounded_match_plain)
    secs: dict = {}
    t_all = time.perf_counter()
    rng = np.random.default_rng(DEDUP_SEED)
    n_tok = DEDUP_DOCS * DEDUP_DOC_LEN
    toks = rng.integers(0, DEDUP_VOCAB, n_tok, dtype=np.int32)
    docs = toks.reshape(DEDUP_DOCS, DEDUP_DOC_LEN)
    perm = rng.permutation(DEDUP_DOCS)
    n_copy = DEDUP_DOCS // DEDUP_COPY_EVERY
    src, dst = perm[:n_copy], perm[n_copy:2 * n_copy]
    docs[dst] = docs[src]                       # planted exact copies
    doc_ids = np.repeat(np.arange(DEDUP_DOCS), DEDUP_DOC_LEN)
    half = DEDUP_WINDOWS // 2
    L = DEDUP_MIN_LEN
    starts = rng.integers(0, n_tok - L, half)
    win = np.concatenate([
        np.stack([toks[s:s + L] for s in starts]),
        rng.integers(0, DEDUP_VOCAB, (half, L), dtype=np.int32)])
    fresh = rng.integers(0, DEDUP_VOCAB, L, dtype=np.int32)
    dna = dna_corpus(TEXT_LEN, seed=DEDUP_SEED, dup_fraction=DEDUP_DNA_DUP)
    Ld = DEDUP_DNA_MIN_LEN
    dstarts = rng.integers(0, TEXT_LEN - Ld, half)
    dwin = np.concatenate([
        np.stack([dna[s:s + Ld] for s in dstarts]),
        rng.integers(0, 4, (half, Ld))]).astype(np.int32)
    dfresh = rng.integers(0, 4, Ld).astype(np.uint8)
    secs["data"] = time.perf_counter() - t_all

    # ---- counted: the dedup path through the public entry points ----
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    tstore = build_tablet_store(toks, is_dna=False,
                                max_query_len=DEDUP_QUERY_LEN, device=dev)
    torch.cuda.synchronize()
    secs["token_build"] = time.perf_counter() - t0
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lcp = adjacent_lcp(tstore.text_codes, tstore.sa, L)
    torch.cuda.synchronize()
    secs["token_lcp"] = time.perf_counter() - t0
    lcp_peak = torch.cuda.max_memory_allocated() - resident
    n_dup_pairs = int((lcp >= L).sum())
    del lcp
    t0 = time.perf_counter()
    tmask = D.duplicate_span_mask(tstore, L).cpu().numpy()
    keep = D.filter_duplicate_docs(tstore, doc_ids, L, DEDUP_THRESHOLD)
    secs["token_mask_and_filter"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    found = D.contamination_check(tstore, win)
    secs["token_contamination"] = time.perf_counter() - t0
    ttable = SuffixTable.from_store(tstore)
    ttable.append(fresh)
    found_t = D.contamination_check(ttable, np.concatenate([win,
                                                            fresh[None]]))
    t0 = time.perf_counter()
    dstore = build_tablet_store(dna, is_dna=True,
                                max_query_len=DEDUP_QUERY_LEN, device=dev)
    torch.cuda.synchronize()
    secs["dna_build"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dlcp = adjacent_lcp(dstore.text_codes, dstore.sa, Ld)
    torch.cuda.synchronize()
    secs["dna_lcp"] = time.perf_counter() - t0
    del dlcp
    dmask = D.duplicate_span_mask(dstore, Ld).cpu().numpy()
    dfrac = float(D.duplicate_fraction(dstore, Ld))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dfound = D.contamination_check(dstore, dwin)
    secs["dna_contamination"] = time.perf_counter() - t0
    dtable = SuffixTable.from_store(dstore)
    dtable.append(dfresh)
    dfound_t = D.contamination_check(dtable, np.concatenate(
        [dwin, dfresh[None].astype(np.int32)]))
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"[dedup-launches] " + " ".join(
        f"{k}={v}" for k, v in launches.items()), flush=True)
    for k in ("pack2bit", "bounded_search", "tier_scan"):
        check(launches[k] > 0, f"{k} launched on the [dedup] path")

    # ---- the independent numpy gram check ----
    t0 = time.perf_counter()
    want, sk = dup_mask_from_keys(np, gram_keys(np, toks, L, False), n_tok)
    w_found = in_sorted(np, sk, gram_keys(np, win.reshape(-1), L, False)
                        [::L])
    del sk
    secs["token_numpy_check"] = time.perf_counter() - t0
    keep_want = np.ones(DEDUP_DOCS, bool)
    keep_want[src] = keep_want[dst] = False
    print(f"[dedup:tokens] n={n_tok} docs={DEDUP_DOCS} planted_pairs="
          f"{n_copy} min_len={L} build_seconds={secs['token_build']:.4f} "
          f"adjacent_lcp_seconds={secs['token_lcp']:.4f} "
          f"adjacent_lcp_peak_bytes={lcp_peak} dup_pairs={n_dup_pairs} "
          f"dup_positions={int(tmask.sum())} "
          f"mask_equals_numpy={str(bool(np.array_equal(tmask, want))).lower()} "
          f"dropped={int((~keep).sum())} contamination_windows="
          f"{len(win)} found={int(found.sum())} queries_per_s="
          f"{len(win) / secs['token_contamination']:.1f} "
          f"card=\"{smi}\"", flush=True)
    check(np.array_equal(tmask, want),
          "[dedup:tokens] duplicate_span_mask equals the numpy gram check "
          "on every position")
    check(np.array_equal(keep, keep_want),
          "[dedup:tokens] filter_duplicate_docs drops both members of "
          "every planted pair and keeps every other document")
    check(np.array_equal(found, w_found) and found[:half].all(),
          "[dedup:tokens] contamination_check equals the numpy gram set")
    check(np.array_equal(found_t[:-1], found) and bool(found_t[-1]),
          "[dedup:tokens] contamination_check on a table finds an "
          "appended window")
    t0 = time.perf_counter()
    want, sk = dup_mask_from_keys(np, gram_keys(np, dna, Ld, True),
                                  TEXT_LEN)
    w_found = in_sorted(np, sk, gram_keys(np, dwin.reshape(-1), Ld, True)
                        [::Ld])
    del sk
    secs["dna_numpy_check"] = time.perf_counter() - t0
    span = int(TEXT_LEN * DEDUP_DNA_DUP / 2)
    planted = (dmask[:span - Ld + 1].all()
               and dmask[TEXT_LEN - span:TEXT_LEN - Ld + 1].all())
    print(f"[dedup:dna] n={TEXT_LEN} dup_fraction={DEDUP_DNA_DUP} "
          f"min_len={Ld} build_seconds={secs['dna_build']:.4f} "
          f"adjacent_lcp_seconds={secs['dna_lcp']:.4f} "
          f"duplicate_fraction={dfrac:.6f} "
          f"mask_equals_numpy={str(bool(np.array_equal(dmask, want))).lower()} "
          f"planted_span_covered={str(bool(planted)).lower()} "
          f"contamination_windows={len(dwin)} found={int(dfound.sum())} "
          f"queries_per_s={len(dwin) / secs['dna_contamination']:.1f} "
          f"card=\"{smi}\"", flush=True)
    check(np.array_equal(dmask, want),
          "[dedup:dna] duplicate_span_mask equals the numpy gram check on "
          "every position")
    check(bool(planted), "[dedup:dna] the mask covers the planted span "
          "and its copy")
    check(np.array_equal(dfound, w_found) and dfound[:half].all(),
          "[dedup:dna] contamination_check equals the numpy gram set")
    check(np.array_equal(dfound_t[:-1], dfound) and bool(dfound_t[-1]),
          "[dedup:dna] contamination_check on a table finds an appended "
          "window")

    # ---- each kernel of the path against its plain version ----
    dcodes = torch.from_numpy(dna).to(dev)
    got = pack2bit_cuda(dcodes)
    e_pk = max_abs_err(torch, [codec.words_i64(got)], [codec.words_i64(
        ref.pack2bit_ref(dcodes.to(torch.int64).reshape(-1, 16).T))])
    patt = codec.as_tensor(codec.pack_2bit_batch(dwin)[
        :, :codec.packed_length(Ld)], dev)
    plen = torch.full((len(dwin),), Ld, dtype=torch.int32, device=dev)
    e_bs = max_abs_err(
        torch, bounded_match_cuda(dstore.sa, dstore.text_packed,
                                  dstore.n_real, patt, plen, dstore.n_pad,
                                  dstore.pad_count),
        bounded_match_plain(dstore, patt, plen))
    stack = dtable._tierset().stack
    targs = (patt.T.contiguous(), plen, stack.text_packed, stack.sa,
             stack.pad_cnt, ops.tier_meta(stack))
    e_ts = max_abs_err(torch, TS.tier_scan_cuda(*targs),
                       TS.tier_scan_plain(*targs))
    errs = {"pack2bit": e_pk, "bounded_search": e_bs, "tier_scan": e_ts}
    print(f"[dedup:kernels] " + " ".join(
        f"{k}_max_abs_err={v}" for k, v in errs.items())
        + f" windows={len(dwin)}", flush=True)
    del tstore, ttable, dstore, dtable, dcodes, stack, targs
    secs["total"] = time.perf_counter() - t_all
    print(f"[dedup] " + " ".join(f"{k}_seconds={v:.4f}"
                                 for k, v in secs.items())
          + f" card=\"{smi}\"", flush=True)
    return launches, errs, secs


def within(torch, got, want, tol: float = 5e-3) -> tuple:
    """(ok, worst excess): |got - want| <= tol + tol * |want| everywhere
    (``np.testing.assert_allclose(rtol=tol, atol=tol)``)."""
    excess = ((got - want).abs() - tol - tol * want.abs()).max()
    return bool(excess <= 0), float(excess)


def lm_full_logits(torch, T, cfg, params, batch, start: int):
    """Logits of a full forward at positions ``start..``."""
    with torch.no_grad():
        x, _ = T._embed_inputs(cfg, params, batch)
        pos = torch.arange(x.shape[1], dtype=torch.int32,
                           device=x.device)[None]
        h, _, _ = T._run_stack(cfg, params, x, pos, None, False)
        h = T.Ls.rmsnorm(params["ln_f"], h[:, start:], cfg.norm_eps)
        return T._logits(cfg, params, h)


def lm_serve(np, torch, cfg, params, tag: str, check, smi, secs,
             resident: int) -> None:
    """``greedy_generate`` of LM_PROMPTS x LM_PROMPT_LEN prompts, LM_NEW
    new tokens, ``max_len`` LM_MAX_LEN, then the same through
    ``make_prefill_fn`` / ``make_decode_fn``: equal tokens, and every
    step's logits within 5e-3 of a full forward.  ``resident``: the
    device bytes allocated before the weights were made (the peak
    statistics were reset there), so the peak counts the weights."""
    from repro_torch import tree as TR
    from repro_torch.models import transformer as T
    from repro_torch.serving import (ServeConfig, greedy_generate,
                                     make_decode_fn, make_prefill_fn)
    t_all = time.perf_counter()
    dev = T.param_device(params)
    n_params = sum(x.numel() for x in TR.leaves(params))
    rng = np.random.default_rng(LM_SEED)
    prompts = rng.integers(0, cfg.vocab_size, (LM_PROMPTS, LM_PROMPT_LEN),
                           dtype=np.int32)
    serve = ServeConfig(max_len=LM_MAX_LEN)
    t0 = time.perf_counter()
    toks_a = greedy_generate(cfg, params, {"tokens": prompts}, LM_NEW, serve)
    torch.cuda.synchronize()
    secs["greedy"] = time.perf_counter() - t0
    prefill_fn, decode_fn = make_prefill_fn(cfg, serve), make_decode_fn(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = prefill_fn(params, {"tokens": prompts})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
    steps, out = [logits[:, 0]], [tok]
    t0 = time.perf_counter()
    for _ in range(LM_NEW - 1):
        logits, caches = decode_fn(params, tok, caches)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        steps.append(logits[:, 0])
        out.append(tok)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    serve_peak = torch.cuda.max_memory_allocated() - resident
    toks_b = torch.cat(out, dim=1)
    profile_fn(torch, lambda: [decode_fn(params, tok, caches)
                               for _ in range(4)],
               tag.strip("[]").replace("serve", "decode"), "steps=4")
    del caches
    seq = torch.cat([torch.from_numpy(prompts).to(dev),
                     toks_b[:, :-1]], dim=1)
    full = lm_full_logits(torch, T, cfg, params, {"tokens": seq},
                          LM_PROMPT_LEN - 1)
    ok, excess = within(torch, torch.stack(steps, dim=1), full)
    max_diff = float((torch.stack(steps, dim=1) - full).abs().max())
    del full, steps
    n_new = LM_PROMPTS * LM_NEW
    dtype = str(TR.leaves(params)[0].dtype).replace("torch.", "")
    print(f"{tag} arch={cfg.name} d_model={cfg.d_model} layers="
          f"{cfg.num_layers} vocab={cfg.vocab_size} params={n_params} "
          f"dtype={dtype} prompts={LM_PROMPTS}x{LM_PROMPT_LEN} new={LM_NEW} "
          f"max_len={LM_MAX_LEN} prefill_ms={prefill_s * 1e3:.3f} "
          f"decode_ms_per_token={decode_s / (LM_NEW - 1) * 1e3:.3f} "
          f"tokens_per_s={n_new / (prefill_s + decode_s):.1f} "
          f"greedy_seconds={secs['greedy']:.4f} peak_bytes_over_resident="
          f"{serve_peak} teacher_forcing_max_abs_diff={max_diff:.3g} "
          f"deterministic={str(bool(torch.equal(toks_a, toks_b))).lower()} "
          f"card=\"{smi}\"", flush=True)
    check(ok, f"{tag} every decoded step's logits within 5e-3 of a full "
          f"forward (worst excess {excess:.3g})")
    check(torch.equal(toks_a, toks_b), f"{tag} two runs give the same "
          "tokens")
    check(bool(((toks_a >= 0) & (toks_a < cfg.vocab_size)).all()),
          f"{tag} tokens in the vocabulary")
    secs["serve"] = time.perf_counter() - t_all


def lm_train(np, torch, cfg, tag: str, check, smi, secs, dev,
             after=None) -> None:
    """LM_STEPS AdamW steps on one LM_TRAIN_BATCH x LM_TRAIN_SEQ batch
    (the loss falls), microbatches 4 against 1 at lr 0, a save at step
    LM_SAVE_AT under ``build/`` and a resume whose losses equal the
    uninterrupted run's bit for bit.  ``after(params, tokens)`` runs on
    the resumed params and the batch's tokens on the card."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.training import (OptConfig, make_train_step,
                                      train_state_init)
    t1 = time.perf_counter()
    batch = synthetic_batch(cfg, DataConfig(seed=LM_SEED,
                                            global_batch=LM_TRAIN_BATCH,
                                            seq_len=LM_TRAIN_SEQ), 0)
    ocfg = OptConfig(kind="adamw", lr=LM_LR, warmup_steps=2,
                     total_steps=LM_STEPS)
    state0 = train_state_init(cfg, ocfg, LM_SEED, device=dev)
    zero = OptConfig(lr=0.0, warmup_steps=0, total_steps=LM_STEPS,
                     weight_decay=0.0)
    _, m1 = make_train_step(cfg, zero, microbatches=1)(state0, batch)
    _, m4 = make_train_step(cfg, zero, microbatches=4)(state0, batch)
    mb = {k: (float(m1[k]), float(m4[k])) for k in ("loss", "grad_norm")}
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step_fn = make_train_step(cfg, ocfg)
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_lm_",
                             dir=os.path.join(ROOT, "build"))
    try:
        state, losses, step_s = state0, [], []
        for i in range(LM_STEPS):
            t0 = time.perf_counter()
            state, m = step_fn(state, batch)
            losses.append(float(m["loss"]))
            step_s.append(time.perf_counter() - t0)
            if i + 1 == LM_SAVE_AT:
                t0 = time.perf_counter()
                CheckpointManager(ckdir).save(LM_SAVE_AT, state,
                                              extra={"data_step": i + 1})
                secs["save"] = time.perf_counter() - t0
        train_peak = torch.cuda.max_memory_allocated() - resident
        del state0
        t0 = time.perf_counter()
        at, resumed, extra = CheckpointManager(ckdir).restore_latest(state)
        secs["restore"] = time.perf_counter() - t0
        del state
        again = []
        for i in range(at, LM_STEPS):
            resumed, m = step_fn(resumed, batch)
            again.append(float(m["loss"]))
        profile_fn(torch, lambda: step_fn(resumed, batch),
                   tag.strip("[]"), "steps=1")
        if after is not None:
            t0 = time.perf_counter()
            after(resumed.params, torch.from_numpy(batch["tokens"]).to(dev))
            secs["shard"] = time.perf_counter() - t0
        del resumed
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    rel = max(abs(a - b) / abs(b) for a, b in zip(again,
                                                  losses[LM_SAVE_AT:]))
    mean_step = sum(step_s[1:]) / (len(step_s) - 1)
    print(f"{tag} arch={cfg.name} batch={LM_TRAIN_BATCH}x{LM_TRAIN_SEQ} "
          f"steps={LM_STEPS} optimizer=adamw lr={LM_LR} losses="
          f"{','.join(f'{x:.6f}' for x in losses)} "
          f"step_ms={mean_step * 1e3:.3f} first_step_ms={step_s[0] * 1e3:.3f} "
          f"tokens_per_s={LM_TRAIN_BATCH * LM_TRAIN_SEQ / mean_step:.1f} "
          f"peak_bytes_over_resident={train_peak} "
          f"microbatch_loss={mb['loss'][0]:.7f}/{mb['loss'][1]:.7f} "
          f"microbatch_grad_norm={mb['grad_norm'][0]:.6f}/"
          f"{mb['grad_norm'][1]:.6f} resumed_from={at} "
          f"resume_max_rel_diff={rel:.3g} save_seconds={secs['save']:.3f} "
          f"restore_seconds={secs['restore']:.3f} card=\"{smi}\"",
          flush=True)
    check(losses[-1] < losses[0], f"{tag} the loss falls over "
          f"{LM_STEPS} steps on one batch")
    check(abs(mb["loss"][0] - mb["loss"][1]) <= 1e-5 * abs(mb["loss"][0]),
          f"{tag} microbatches=4 loss within rtol 1e-5 of one batch")
    check(abs(mb["grad_norm"][0] - mb["grad_norm"][1])
          <= 1e-4 * abs(mb["grad_norm"][0]),
          f"{tag} microbatches=4 grad_norm within rtol 1e-4")
    check(at == LM_SAVE_AT and extra == {"data_step": LM_SAVE_AT},
          f"{tag} resumed from the step-{LM_SAVE_AT} checkpoint")
    check(again == losses[LM_SAVE_AT:], f"{tag} resumed losses equal the "
          "uninterrupted run's bit for bit")
    secs["train"] = time.perf_counter() - t1


def lm_phase(np, torch, check, dev, smi) -> dict:
    """The [lm] path: qwen3-0.6b at full width, fp32, random weights from
    a seeded generator — served (``greedy_generate``, ``make_prefill_fn``
    / ``make_decode_fn``) and trained (AdamW, microbatches, checkpoint
    and resume).  Returns the phase's seconds."""
    from repro_torch import tree as TR
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    secs: dict = {}
    t_all = time.perf_counter()
    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "[lm] fp32 matmuls at full precision (no TF32)")
    cfg = get_config(LM_ARCH)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(cfg, LM_SEED, device=dev)
    torch.cuda.synchronize()
    secs["init"] = time.perf_counter() - t0
    n_params = sum(x.numel() for x in TR.leaves(params))
    check(n_params == cfg.param_count() + 2 * cfg.d_model * cfg.num_layers
          + cfg.d_model + 2 * cfg.head_dim * cfg.num_layers,
          "[lm] the params tree has the config's parameter count (plus "
          "norm scales)")
    lm_serve(np, torch, cfg, params, "[lm:serve]", check, smi, secs,
             resident)
    del params
    lm_train(np, torch, cfg, "[lm:train]", check, smi, secs, dev,
             after=lambda params, tokens: (
                 lm_shard_pipe(np, torch, cfg, params, tokens, check, smi),
                 lm_shard_compress(np, torch, cfg, params, tokens, check,
                                   smi)))
    secs["total"] = time.perf_counter() - t_all
    print(f"[lm] " + " ".join(f"{k}_seconds={v:.4f}"
                              for k, v in secs.items())
          + f" card=\"{smi}\"", flush=True)
    return secs


@contextlib.contextmanager
def recording_moe(Moe, calls: list):
    """``models.moe.moe_ffn`` records, per call, (experts, gap): each
    token's chosen experts, sorted, ``(B, S, k)``, -1 where the router
    dropped the assignment at capacity; and the router-logit gap between
    its k-th and (k+1)-th expert ``(B, S)``, the margin a rounding
    difference must cross to change its route.  An extra ``route`` and
    a router product per call, so only untimed runs use it."""
    inner = Moe.moe_ffn

    def recording(cfg, p, x):
        B, S, d = x.shape
        k = cfg.experts_per_token
        xt = x.reshape(-1, d)
        _, slots, C, _ = Moe.route(cfg, p, xt)
        experts = (slots // C).masked_fill(slots == cfg.num_experts * C, -1)
        top = (xt.float() @ p["router"]).topk(k + 1, dim=-1).values
        calls.append((experts.T.sort(dim=-1).values.reshape(B, S, k),
                      (top[:, k - 1] - top[:, k]).reshape(B, S)))
        return inner(cfg, p, x)

    Moe.moe_ffn = recording
    try:
        yield calls
    finally:
        Moe.moe_ffn = inner


def dropped(calls) -> int:
    return sum(int((e < 0).sum()) for e, _ in calls)


def moe_fp32_check(torch, Moe, cfg, p, x) -> dict:
    """``moe_ffn`` of one swiglu MoE layer ``p`` (fp32) on ``x`` (B, S, d)
    three ways: one call over all B * S tokens; S calls of B tokens, as
    decode runs it (another capacity and slot layout); and, for the
    first position's B tokens, a plain per-token sum over their top-k
    experts' weights plus the shared expert.  Returns the worst excess
    over 5e-3 of the decode-shaped calls against the one call and of the
    plain sum against both, and the assignments dropped at capacity."""
    F = torch.nn.functional
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    drops = 0
    with torch.no_grad():
        whole, _ = Moe.moe_ffn(cfg, p, x)
        parts = [x] + [x[:, t:t + 1] for t in range(S)]
        for xs in parts:
            _, slots, C, _ = Moe.route(cfg, p, xs.reshape(-1, d))
            drops += int((slots == E * C).sum())
        steps = torch.cat([Moe.moe_ffn(cfg, p, xs)[0] for xs in parts[1:]],
                          dim=1)
        x0, sh = x[:, 0], p["shared"]
        gates, idx = torch.topk(torch.softmax(x0 @ p["router"], -1), k, -1)
        gates = gates / gates.sum(-1, keepdim=True)
        plain = []
        for b in range(B):
            e = idx[b]
            z = F.silu(torch.einsum("d,edf->ef", x0[b], p["wg"][e])) \
                * torch.einsum("d,edf->ef", x0[b], p["wi"][e])
            y = torch.einsum("ef,efd->ed", z, p["wo"][e])
            plain.append((gates[b, :, None] * y).sum(0)
                         + (F.silu(x0[b] @ sh["wg"]) * (x0[b] @ sh["wi"]))
                         @ sh["wo"])
        plain = torch.stack(plain)[:, None]
    return {"decode_vs_whole": within(torch, steps, whole)[1],
            "plain_vs_decode": within(torch, steps[:, :1], plain)[1],
            "plain_vs_whole": within(torch, whole[:, :1], plain)[1],
            "max_abs_diff": float((steps - whole).abs().max()),
            "dropped": drops}


def lm_moe_phase(np, torch, check, dev, smi) -> int:
    """[lm:moe]: deepseek-v3 at its published widths, cut to depth
    LM_MOE_LAYERS (its 3 dense layers and 1 MoE layer, MTP depth 1), bf16
    weights from a seed.  Serves 8 prompts of 512 into a 1,024-slot
    cache and decodes 32 tokens through the absorbed latent cache; the
    loss (xent, aux, mtp) of a forward on 8 x 512.  At the published
    capacity factor 1.25, prefill's last logits equal a full forward's
    (equal T) and the dropped assignments are counted; at 8.0 (the
    reference's teacher-forcing setting, ``tests/test_models.py:72-73``)
    every decoded step lies within LM_MOE_TOL of teacher forcing.
    Returns the phase's peak device bytes."""
    from repro_torch import tree as TR
    from repro_torch.configs import get_config
    from repro_torch.models import moe as Moe, transformer as T
    from repro_torch.serving import ServeConfig, greedy_generate
    t_all = time.perf_counter()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    print(f"[lm:moe] resident_bytes_at_start={resident} "
          f"reserved_bytes={torch.cuda.memory_reserved()}", flush=True)
    full_cfg = get_config(LM_MOE_ARCH)
    cfg = dataclasses.replace(full_cfg, num_layers=LM_MOE_LAYERS)
    t0 = time.perf_counter()
    params = T.init_params(cfg, LM_SEED, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = TR.leaves(params)
    n_params = sum(x.numel() for x in leaves)
    n_bytes = sum(x.numel() * x.element_size() for x in leaves)
    print(f"[lm:moe] arch={cfg.name} layers={cfg.num_layers} (cut from "
          f"{full_cfg.num_layers}: {cfg.first_dense_layers} dense + "
          f"{cfg.num_layers - cfg.first_dense_layers} MoE, mtp_depth="
          f"{cfg.mtp_depth}) d_model={cfg.d_model} heads={cfg.num_heads} "
          f"q_lora={cfg.q_lora_rank} kv_lora={cfg.kv_lora_rank} experts="
          f"{cfg.num_experts}+{cfg.num_shared_experts} top_k="
          f"{cfg.experts_per_token} moe_d_ff={cfg.moe_d_ff} vocab="
          f"{cfg.vocab_size} params={n_params} param_bytes={n_bytes} "
          f"dtype=bfloat16 init_seconds={init_s:.3f} peak_bytes_after_init="
          f"{torch.cuda.max_memory_allocated()}", flush=True)
    rng = np.random.default_rng(LM_SEED)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (LM_PROMPTS, LM_PROMPT_LEN), dtype=np.int32)
        ).to(dev)
    pbatch = {"tokens": prompts}

    # serve at the published capacity factor 1.25, timed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = T.prefill(cfg, params, pbatch, max_len=LM_MAX_LEN)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    first = logits
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
    out = [tok]
    t0 = time.perf_counter()
    for _ in range(LM_MOE_NEW - 1):
        logits, caches = T.decode_step(cfg, params, tok, caches)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        out.append(tok)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    toks_a = torch.cat(out, dim=1)
    c0 = caches["prefix"][0]
    cache_bytes = (c0["ckv"].shape[-1] + c0["krope"].shape[-1]) \
        * c0["ckv"].element_size()
    kv_bytes = cfg.num_heads * (cfg.head_dim + cfg.rope_head_dim
                                + cfg.v_head_dim) * c0["ckv"].element_size()
    profile_fn(torch, lambda: [T.decode_step(cfg, params, tok, caches)
                               for _ in range(4)], "lm:moe:decode",
               "steps=4")
    del caches
    # the same again, counting drops: same tokens; prefill's last logits
    # equal a full forward's at the same T
    calls: list = []
    with recording_moe(Moe, calls):
        toks_b = greedy_generate(cfg, params, pbatch, LM_MOE_NEW,
                                 ServeConfig(max_len=LM_MAX_LEN))
        prefill_drops, decode_drops = dropped(calls[:1]), dropped(calls[1:])
        calls.clear()
        with torch.no_grad():
            x, _ = T._embed_inputs(cfg, params, pbatch)
            pos = torch.arange(x.shape[1], dtype=torch.int32,
                               device=dev)[None]
            h, _, _ = T._run_stack(cfg, params, x, pos, None, False)
            h = T.Ls.rmsnorm(params["ln_f"], h, cfg.norm_eps)
            fwd_last = T._logits(cfg, params, h[:, -1:])
        del x, h
        t0 = time.perf_counter()
        with torch.no_grad():
            _, metrics = T.forward_train(cfg, params, pbatch, remat=False)
        torch.cuda.synchronize()
        loss_s = time.perf_counter() - t0
        loss_drops = dropped(calls)
        calls.clear()
    metrics = {k: float(v) for k, v in metrics.items()}
    last_equal = bool(torch.equal(first, fwd_last))
    last_diff = float((first.float() - fwd_last.float()).abs().max())
    del first, fwd_last

    # teacher forcing at capacity factor 8.0 (no drops), each step's
    # routes beside teacher forcing's
    cfg8 = dataclasses.replace(cfg, moe_capacity_factor=8.0)
    with recording_moe(Moe, calls):
        logits, caches = T.prefill(cfg8, params, pbatch, max_len=LM_MAX_LEN)
        steps = [logits[:, 0].float()]
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        out = [tok]
        for _ in range(LM_MOE_NEW - 1):
            logits, caches = T.decode_step(cfg8, params, tok, caches)
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
            steps.append(logits[:, 0].float())
            out.append(tok)
        del caches
        # per token, the experts of every MoE layer: (B, steps, layers * k)
        n_moe = sum(cfg.layer_is_moe(i) for i in range(cfg.num_layers))
        per_step = [calls[i:i + n_moe] for i in range(0, len(calls), n_moe)]
        dec = torch.cat([torch.cat([e[:, -1:] for e, _ in per_step[0]], -1)]
                        + [torch.cat([e for e, _ in st], -1)
                           for st in per_step[1:]], dim=1)
        drops8 = dropped(calls)
        calls.clear()
        seq = torch.cat([prompts, torch.cat(out, dim=1)[:, :-1]], dim=1)
        full = lm_full_logits(torch, T, cfg8, params, {"tokens": seq},
                              LM_PROMPT_LEN - 1).float()
        drops8 += dropped(calls)
        tf = torch.cat([e for e, _ in calls], -1)[:, LM_PROMPT_LEN - 1:]
        gap = torch.stack([g for _, g in calls], -1).amin(-1)[
            :, LM_PROMPT_LEN - 1:]
        calls.clear()
    diff = (torch.stack(steps, dim=1) - full).abs().amax(dim=-1)  # (B, n)
    same = (dec == tf).all(dim=-1)          # routed as teacher forcing
    worst = float(diff.max())
    worst_same = float(diff[same].max()) if bool(same.any()) else 0.0
    n_over = int((diff > LM_MOE_TOL).sum())
    n_flip = int((~same).sum())
    flip_gap = float(gap[~same].max()) if n_flip else 0.0
    del full, steps, diff, seq

    # the absorbed path against the materialized one where rounding does
    # not hide a fault: layer 0's MLA at full width in fp32, prefill of
    # the first LM_PROMPT_LEN positions, then decode over the latent cache
    mla = TR.map_structure(lambda t: t.float(), params["prefix"][0]["attn"])
    g = torch.Generator(device=dev).manual_seed(LM_SEED)
    S1 = LM_PROMPT_LEN + LM_MOE_NEW
    xs = torch.randn((LM_PROMPTS, S1, cfg.d_model), generator=g, device=dev)
    pos = torch.arange(S1, dtype=torch.int32, device=dev)[None]
    with torch.no_grad():
        want, _ = T.Ls.mla_attention(cfg, mla, xs, pos)
        got, cache = T.Ls.mla_attention(cfg, mla, xs[:, :LM_PROMPT_LEN],
                                        pos[:, :LM_PROMPT_LEN])
        cache = {k: torch.nn.functional.pad(v, (0, 0, 0, S1 - LM_PROMPT_LEN))
                 for k, v in cache.items()}
        cache["length"] = torch.tensor(LM_PROMPT_LEN, dtype=torch.int32,
                                       device=dev)
        outs = [got[:, -1:]]
        for t in range(LM_PROMPT_LEN, S1):
            o, cache = T.Ls.mla_attention(cfg, mla, xs[:, t:t + 1],
                                          pos[:, t:t + 1], kv_cache=cache)
            outs.append(o)
    _, e_mla = within(torch, torch.cat(outs, dim=1),
                      want[:, LM_PROMPT_LEN - 1:])
    del mla, xs, want, got, cache, outs

    # the full-width MoE layer where rounding does not hide a fault: its
    # weights in fp32 (45 GB; the rest of the model freed first, the
    # leaves cast one by one), capacity 8.0, on LM_PROMPTS x LM_MOE_NEW
    # seeded hidden states
    moe = TR.map_structure(lambda t: t[0], params["stack"][0]["moe"])
    del params, leaves
    gc.collect()
    torch.cuda.empty_cache()
    for name in list(moe):
        moe[name] = TR.map_structure(lambda t: t.float(), moe[name])
    hs = torch.randn((LM_PROMPTS, LM_MOE_NEW, cfg.d_model), generator=g,
                     device=dev)
    mf = moe_fp32_check(torch, Moe, cfg8, moe, hs)
    del hs
    peak = lm_shard_ep(np, torch, Moe, cfg, moe, g, check, smi)
    del moe
    peak = max(peak, torch.cuda.max_memory_allocated())
    secs = time.perf_counter() - t_all
    print(f"[lm:moe] prompts={LM_PROMPTS}x{LM_PROMPT_LEN} new={LM_MOE_NEW} "
          f"max_len={LM_MAX_LEN} capacity_factor={cfg.moe_capacity_factor} "
          f"prefill_ms={prefill_s * 1e3:.3f} decode_ms_per_token="
          f"{decode_s / (LM_MOE_NEW - 1) * 1e3:.3f} tokens_per_s="
          f"{LM_PROMPTS * LM_MOE_NEW / (prefill_s + decode_s):.1f} "
          f"mla_cache_bytes_per_token_layer={cache_bytes} "
          f"materialized_kv_bytes_per_token_layer={kv_bytes} "
          f"dropped_assignments_prefill={prefill_drops} "
          f"dropped_assignments_decode={decode_drops} "
          f"dropped_assignments_loss={loss_drops} "
          f"prefill_last_equals_forward={str(last_equal).lower()} "
          f"prefill_last_max_abs_diff={last_diff:.3g} "
          f"deterministic={str(bool(torch.equal(toks_a, toks_b))).lower()} "
          f"card=\"{smi}\"", flush=True)
    print(f"[lm:moe] loss batch={LM_PROMPTS}x{LM_PROMPT_LEN} " + " ".join(
        f"{k}={v:.6f}" for k, v in sorted(metrics.items()))
        + f" forward_ms={loss_s * 1e3:.3f}", flush=True)
    print(f"[lm:moe] capacity_factor=8.0 dropped_assignments={drops8} "
          f"teacher_forcing_max_abs_diff={worst:.4g} tolerance={LM_MOE_TOL} "
          f"worst_excess={worst - LM_MOE_TOL:.4g} tokens={same.numel()} "
          f"routed_otherwise={n_flip} same_route_max_abs_diff="
          f"{worst_same:.4g} same_route_worst_excess="
          f"{worst_same - LM_MOE_TOL:.4g} tokens_over_tolerance={n_over} "
          f"routed_otherwise_max_router_gap={flip_gap:.4g} "
          f"near_tie={LM_MOE_NEAR_TIE} mla_fp32_worst_excess={e_mla:.3g} "
          f"peak_bytes={peak} seconds={secs:.3f} card=\"{smi}\"",
          flush=True)
    print(f"[lm:moe:fp32] layer={cfg.first_dense_layers} tokens="
          f"{LM_PROMPTS}x{LM_MOE_NEW} capacity_factor=8.0 dropped_assignments="
          f"{mf['dropped']} decode_vs_whole_max_abs_diff="
          f"{mf['max_abs_diff']:.3g} decode_vs_whole_worst_excess="
          f"{mf['decode_vs_whole']:.3g} plain_vs_decode_worst_excess="
          f"{mf['plain_vs_decode']:.3g} plain_vs_whole_worst_excess="
          f"{mf['plain_vs_whole']:.3g}", flush=True)
    check(e_mla <= 0, f"[lm:moe] the absorbed MLA decode of layer 0 in "
          f"fp32 within 5e-3 of the materialized path (worst excess "
          f"{e_mla:.3g})")
    check(mf["dropped"] == 0 and max(mf["decode_vs_whole"],
                                     mf["plain_vs_decode"],
                                     mf["plain_vs_whole"]) <= 0,
          "[lm:moe] the full-width MoE layer in fp32 at capacity 8.0: "
          "decode-shaped calls, one call and a plain per-token sum agree "
          "within 5e-3, nothing dropped")
    check(flip_gap <= LM_MOE_NEAR_TIE, f"[lm:moe] a decoded token routed "
          f"otherwise than under teacher forcing is a near tie (router gap "
          f"{flip_gap:.4g} <= {LM_MOE_NEAR_TIE})")
    check(drops8 == 0, "[lm:moe] capacity 8.0 drops nothing")
    check(last_equal, "[lm:moe] at capacity 1.25 prefill's last logits "
          "equal the full forward's")
    check(all(np.isfinite(metrics[k]) for k in ("xent", "aux", "mtp",
                                                 "loss")),
          "[lm:moe] xent, aux and mtp are finite")
    check(torch.equal(toks_a, toks_b), "[lm:moe] two runs give the same "
          "tokens")
    gc.collect()
    torch.cuda.empty_cache()
    return peak


def timed_ms(torch, fn) -> tuple:
    """(fn(), host ms around it, the card synchronised at both ends)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


@contextlib.contextmanager
def counting_drops(Moe, drops: list):
    """``models.moe.route`` records each call's dropped assignments."""
    inner = Moe.route

    def recording(cfg, p, xt):
        got = inner(cfg, p, xt)
        drops.append(int((got[1] == cfg.num_experts * got[2]).sum()))
        return got

    Moe.route = recording
    try:
        yield drops
    finally:
        Moe.route = inner


def lm_shard_ep(np, torch, Moe, cfg, moe, g, check, smi) -> int:
    """[lm:shard:ep]: the full-width fp32 MoE layer of [lm:moe:fp32]
    (E = 256, k = 8, d 7,168, expert d_ff 2,048, 1 shared expert) on
    8 x 512 seeded hidden states with a shared offset at capacity 1.25
    (so assignments drop), expert-parallel over
    (1, 16) and (2, 8) (data, model) shards of the card.  (1, 16) is
    held to the one-device ``moe_ffn`` on all 4,096 tokens, (2, 8) row
    by row to the one-device call on that row's 2,048 (each row routes
    at its own capacity); out within 5e-4, aux within 1e-4, the dropped
    assignments equal; the gradient with respect to x through the
    (1, 16) path is finite.  Returns the device peak from before it; its
    own peak counts from its start."""
    from repro_torch.launch.mesh import make_mesh
    cfg = dataclasses.replace(cfg, moe_capacity_factor=SHARD_EP_CAPACITY)
    B, S = SHARD_EP_TOKENS
    # a shared offset skews the routing (hidden states share a mean), so
    # the busiest experts overflow their capacity
    x = torch.randn((B, S, cfg.d_model), generator=g, device=g.device) \
        + 0.5 * torch.randn((cfg.d_model,), generator=g, device=g.device)
    torch.cuda.synchronize()
    base_peak = torch.cuda.max_memory_allocated()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        drops: list = []
        with counting_drops(Moe, drops):
            want, want_aux = Moe.moe_ffn(cfg, moe, x)
            one_drops = drops[:]
            drops.clear()
            rows = [Moe.moe_ffn(cfg, moe, r) for r in x.chunk(2)]
            row_drops = drops[:]
        _, one_ms = timed_ms(torch, lambda: Moe.moe_ffn(cfg, moe, x))
    one_peak = torch.cuda.max_memory_allocated()
    for shape in SHARD_EP_MESHES:
        mesh = make_mesh(shape, ("data", "model"),
                         devices=[g.device] * (shape[0] * shape[1]))
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad(), Moe.ep_sharding(mesh):
            drops = []
            with counting_drops(Moe, drops):
                out, aux = Moe.moe_ffn(cfg, moe, x)
            _, ep_ms = timed_ms(torch, lambda: Moe.moe_ffn(cfg, moe, x))
        if shape[0] == 1:
            ref_out, ref_aux, ref_drops = want, want_aux, one_drops[0]
        else:
            ref_out = torch.cat([o for o, _ in rows])
            ref_aux = torch.stack([a for _, a in rows]).mean()
            ref_drops = sum(row_drops)
        ep_drops = sum(drops) // shape[1]    # every model shard routes
        diff = float((out - ref_out).abs().max())
        aux_diff = abs(float(aux) - float(ref_aux))
        arm_peak = torch.cuda.max_memory_allocated()
        grad = ""
        if shape[0] == 1:
            torch.cuda.reset_peak_memory_stats()
            xg = x.clone().requires_grad_(True)

            def backward():
                with Moe.ep_sharding(mesh):
                    o, a = Moe.moe_ffn(cfg, moe, xg)
                (o.pow(2).mean() + a).backward()
                return xg.grad
            gx, grad_ms = timed_ms(torch, backward)
            finite = bool(torch.isfinite(gx).all())
            grad = (f"grad_x_finite={str(finite).lower()} "
                    f"forward_backward_ms={grad_ms:.3f} forward_backward_"
                    f"peak_bytes={torch.cuda.max_memory_allocated()} ")
            check(finite, "[lm:shard:ep] the gradient with respect to x "
                  "through the (1, 16) EP path is finite")
            del xg, gx
        print(f"[lm:shard:ep] arch={cfg.name} mesh={shape[0]}x{shape[1]} "
              f"experts_per_shard={cfg.num_experts // shape[1]} tokens="
              f"{B}x{S} capacity_factor={cfg.moe_capacity_factor} "
              f"ms={ep_ms:.3f} one_device_ms={one_ms:.3f} "
              f"max_abs_diff={diff:.3g} aux_abs_diff={aux_diff:.3g} "
              f"dropped={ep_drops} one_device_dropped={ref_drops} {grad}"
              f"peak_bytes={arm_peak} one_device_peak_bytes={one_peak} "
              f"resident_bytes_at_start={resident} card=\"{smi}\"",
              flush=True)
        check(diff <= SHARD_EP_TOL and aux_diff <= SHARD_AUX_TOL
              and ep_drops == ref_drops and ref_drops > 0,
              f"[lm:shard:ep] {shape} EP out within {SHARD_EP_TOL} "
              f"({diff:.3g}), aux within {SHARD_AUX_TOL} ({aux_diff:.3g}) "
              f"of the one-device call, drops equal ({ep_drops} vs "
              f"{ref_drops}, some)")
        del out
    return base_peak


def lm_shard_pipe(np, torch, cfg, params, tokens, check, smi) -> None:
    """[lm:shard:pipe]: qwen3-0.6b's 28 layers as 4 GPipe stages of 7
    over 4 shards of the card, 4 microbatches of 2 x 512 from the
    [lm:train] batch: the final hidden states within 1e-4 x max|h| of
    the plain stack, the loss within rtol 1e-5 and every gradient leaf
    within 1e-3 x its max |g| of the unpipelined backward."""
    from repro_torch import tree as TR
    from repro_torch.distributed import pipeline as PL
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T
    p, n_micro = SHARD_PIPE_STAGES, SHARD_PIPE_MICRO
    dev = tokens.device
    B, S = tokens.shape
    leaves = [t.detach().requires_grad_(True) for t in TR.leaves(params)]
    P_ = TR.unflatten_like(params, leaves)
    pos = torch.arange(S, dtype=torch.int32, device=dev)[None]
    per = cfg.num_layers // p

    def stage_fn(sp, h):
        for layer in range(per):
            h, _, _ = T._apply_layer(cfg, T._period(sp, layer), h, pos, None)
        return h

    def loss_of(h):
        h = T.Ls.rmsnorm(P_["ln_f"], h, cfg.norm_eps)
        return T.xent_from_hidden(cfg, P_, h[:, :-1], tokens[:, 1:])

    def plain():
        x, _ = T._embed_inputs(cfg, P_, {"tokens": tokens})
        h, _, _ = T._run_stack(cfg, P_, x, pos, None, False)
        loss = loss_of(h)
        return h.detach(), loss.detach(), torch.autograd.grad(loss, leaves)

    mesh = make_mesh((p,), ("pp",), devices=[dev] * p)
    ticks = []
    hand_off = PL.COL.ppermute

    def pipelined():
        x, _ = T._embed_inputs(cfg, P_, {"tokens": tokens})
        stages = PL.stage_slice(P_["stack"][0], "pp", cfg.num_layers, mesh)
        xm = x.reshape(n_micro, B // n_micro, S, cfg.d_model)
        h = PL.pipeline_apply(stage_fn, stages, [xm] * p, "pp", mesh)[0]
        h = h.reshape(B, S, cfg.d_model)
        loss = loss_of(h)
        return h.detach(), loss.detach(), torch.autograd.grad(loss, leaves)

    def counted(*a, **kw):
        ticks.append(1)
        return hand_off(*a, **kw)

    (h0, l0, g0), plain_ms = timed_ms(torch, plain)
    PL.COL.ppermute = counted
    try:
        (h1, l1, g1), pipe_ms = timed_ms(torch, pipelined)
    finally:
        PL.COL.ppermute = hand_off
    h_scale = float(h0.abs().max())
    h_diff = float((h1 - h0).abs().max())
    l_rel = abs(float(l1) - float(l0)) / abs(float(l0))
    worst = 0.0                       # max |dg| / max |g| over the leaves
    for a, b in zip(g1, g0):
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        worst = max(worst, err / scale if scale else (0.0 if err == 0
                                                       else float("inf")))
    n_ticks = len(ticks)
    print(f"[lm:shard:pipe] arch={cfg.name} layers={cfg.num_layers} "
          f"stages={p}x{per} microbatches={n_micro}x{B // n_micro}x{S} "
          f"ticks={n_ticks} bubble_share={(p - 1) / n_ticks:.4f} "
          f"ms={pipe_ms:.3f} plain_ms={plain_ms:.3f} "
          f"hidden_max_abs_diff={h_diff:.3g} hidden_max_abs={h_scale:.4g} "
          f"loss={float(l1):.7f} plain_loss={float(l0):.7f} "
          f"loss_rel_diff={l_rel:.3g} grad_leaves={len(g0)} "
          f"grad_worst_rel={worst:.3g} card=\"{smi}\"", flush=True)
    check(n_ticks == n_micro + p - 1, f"[lm:shard:pipe] {n_micro + p - 1} "
          f"ticks ({n_ticks})")
    check(h_diff <= 1e-4 * h_scale, "[lm:shard:pipe] hidden states within "
          "1e-4 x max|h| of the plain stack")
    check(l_rel <= 1e-5, "[lm:shard:pipe] loss within rtol 1e-5")
    check(worst <= 1e-3, f"[lm:shard:pipe] every gradient leaf within "
          f"1e-3 x its max |g| ({worst:.3g})")
    del h0, h1, g0, g1


def lm_shard_compress(np, torch, cfg, params, tokens, check, smi) -> None:
    """[lm:shard:compress]: qwen3-0.6b's gradient trees of the [lm:train]
    batch's 8 rows of 1 x 512 as 8 data shards of the card, through
    ``compressed_pmean_tree``: each leaf's mean within 5% (relative to
    the leaf's max |mean|) of the true mean; 16 error-feedback exchanges
    of the same gradients average within 1%; the largest leaf's int8
    blocks and scales equal the same function's on the CPU."""
    from repro_torch import tree as TR
    from repro_torch.distributed import compression as CP
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T
    dev = tokens.device
    n = tokens.shape[0]
    leaves = [t.detach().requires_grad_(True) for t in TR.leaves(params)]
    P_ = TR.unflatten_like(params, leaves)
    grads = []
    for i in range(n):
        loss, _ = T.forward_train(cfg, P_, {"tokens": tokens[i:i + 1]},
                                  remat=False)
        grads.append(TR.unflatten_like(params, [
            g.detach() for g in torch.autograd.grad(loss, leaves)]))
    del leaves, P_
    mesh = make_mesh((n,), ("data",), devices=[dev] * n)
    flat = [TR.leaves(t) for t in grads]
    true = [torch.stack([f[j] for f in flat]).mean(0)
            for j in range(len(flat[0]))]

    def rel(got, want):
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        return err / scale if scale else (0.0 if err == 0 else float("inf"))

    errs = [CP.zeros_like_tree(t) for t in grads]
    (means, errs), one_ms = timed_ms(
        torch, lambda: CP.compressed_pmean_tree(grads, "data", errs,
                                                mesh=mesh))
    worst_one = max(rel(m, t) for m, t in zip(TR.leaves(means[0]), true))
    del means, errs
    # 16 exchanges of the same gradients, leaf by leaf (one leaf's error
    # buffers live at a time)
    worst_avg, ef_ms = 0.0, 0.0
    for j, want in enumerate(true):
        xs = [f[j] for f in flat]
        err = [torch.zeros_like(x) for x in xs]
        total = torch.zeros_like(want)
        for _ in range(SHARD_ROUNDS):
            (m, err), ms = timed_ms(
                torch, lambda: CP.compressed_pmean(xs, "data", err,
                                                   mesh=mesh))
            total += m[0]
            ef_ms += ms
        worst_avg = max(worst_avg, rel(total / SHARD_ROUNDS, want))
        del err, total
    big = max(range(len(true)), key=lambda j: true[j].numel())
    q_dev, s_dev, _ = CP._quantize(flat[0][big].reshape(-1))
    q_cpu, s_cpu, _ = CP._quantize(flat[0][big].reshape(-1).cpu())
    same = bool(torch.equal(q_dev.cpu(), q_cpu)
                and torch.equal(s_dev.cpu(), s_cpu))
    n_values = sum(t.numel() for t in true)
    wire = CP.wire_bytes(grads[0])
    print(f"[lm:shard:compress] arch={cfg.name} shards={n} leaves="
          f"{len(true)} values={n_values} wire_bytes={wire} fp32_bytes="
          f"{4 * n_values} wire_ratio={wire / (4 * n_values):.4f} "
          f"exchange_ms={one_ms:.3f} error_feedback_ms_per_exchange="
          f"{ef_ms / SHARD_ROUNDS:.3f} one_exchange_worst_rel={worst_one:.4g} "
          f"avg{SHARD_ROUNDS}_worst_rel={worst_avg:.4g} largest_leaf_values="
          f"{true[big].numel()} int8_equal_cpu={str(same).lower()} "
          f"card=\"{smi}\"", flush=True)
    check(worst_one < 0.05, f"[lm:shard:compress] one exchange within 5% "
          f"of the true mean on every leaf ({worst_one:.4g})")
    check(worst_avg < 0.01, f"[lm:shard:compress] {SHARD_ROUNDS} error-"
          f"feedback exchanges average within 1% ({worst_avg:.4g})")
    check(same, "[lm:shard:compress] the largest leaf's int8 blocks and "
          "scales equal the CPU's")
    del grads, flat, true


def lm_ssm_phase(np, torch, check, dev, smi) -> int:
    """[lm:ssm]: mamba2-780m at full width and depth, fp32 without TF32,
    random weights from a seed: served and trained as [lm] serves and
    trains qwen3 (resumed losses bit for bit), then ``ssd_chunked`` on the
    card against the step recurrence.  Returns the phase's peak device
    bytes."""
    from repro_torch import tree as TR
    from repro_torch.configs import get_config
    from repro_torch.models import ssm as Ssm, transformer as T
    secs: dict = {}
    t_all = time.perf_counter()
    cfg = get_config(LM_SSM_ARCH)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(cfg, LM_SEED, device=dev)
    torch.cuda.synchronize()
    secs["init"] = time.perf_counter() - t0
    n_params = sum(x.numel() for x in TR.leaves(params))
    di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    extra = cfg.num_layers * (di + 2 * N + 3 * H + di + cfg.d_model) \
        + cfg.d_model          # conv_b, A_log, dt_bias, D, norms; ln_f
    check(n_params == cfg.param_count() + extra,
          "[lm:ssm] the params tree has the config's parameter count (plus "
          "norm scales, conv biases and the per-head A_log, dt_bias, D)")
    lm_serve(np, torch, cfg, params, "[lm:ssm:serve]", check, smi, secs,
             resident)
    del params
    peak = torch.cuda.max_memory_allocated()
    lm_train(np, torch, cfg, "[lm:ssm:train]", check, smi, secs, dev)
    peak = max(peak, torch.cuda.max_memory_allocated())

    # ssd_chunked against the step recurrence (tests/test_models.py:126)
    g = torch.Generator(device=dev).manual_seed(LM_SEED)
    b, s, h, p, n = 2, 32, 3, 8, 4
    x = torch.randn((b, s, h, p), generator=g, device=dev)
    dt = 0.1 + 0.8 * torch.rand((b, s, h), generator=g, device=dev)
    A = -(0.5 + torch.rand((h,), generator=g, device=dev))
    Bm = torch.randn((b, s, n), generator=g, device=dev)
    Cm = torch.randn((b, s, n), generator=g, device=dev)
    y, final = Ssm.ssd_chunked(x, dt, A, Bm, Cm, chunk=8)
    st = torch.zeros((b, h, p, n), device=dev)
    ys = []
    for t in range(s):
        st = st * torch.exp(dt[:, t] * A)[..., None, None] + torch.einsum(
            "bhp,bn->bhpn", x[:, t] * dt[:, t][..., None], Bm[:, t])
        ys.append(torch.einsum("bn,bhpn->bhp", Cm[:, t], st))
    ok_ssd, e_ssd = within(torch, y, torch.stack(ys, dim=1), 2e-4)
    ok_fin, e_fin = within(torch, final, st, 2e-4)
    secs["total"] = time.perf_counter() - t_all
    print(f"[lm:ssm:ssd] b={b} s={s} h={h} p={p} n={n} chunk=8 "
          f"y_worst_excess={e_ssd:.3g} state_worst_excess={e_fin:.3g}",
          flush=True)
    check(ok_ssd and ok_fin, "[lm:ssm] ssd_chunked on the card equals the "
          "step recurrence (rtol/atol 2e-4)")
    print(f"[lm:ssm] " + " ".join(f"{k}_seconds={v:.4f}"
                                  for k, v in secs.items())
          + f" peak_bytes={peak} card=\"{smi}\"", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return peak


def lm_archs_phase(np, torch, check, dev, smi) -> None:
    """[lm:archs]: all ten LM configs ``reduced()``, the same weights on
    the card and the CPU: logits within 5e-3, decode equal to teacher
    forcing on the card (the MoE configs at capacity 8.0, as the
    reference's test), and one AdamW step of each config ported after
    the dense ones, with finite parameters afterwards."""
    from repro_torch import tree as TR
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.models import transformer as T
    from repro_torch.training import OptConfig, TrainState, make_train_step
    from repro_torch.training import optimizer as opt
    t1 = time.perf_counter()
    worst: dict = {}
    for i, arch in enumerate(LM_ARCHS):
        c = get_config(arch).reduced()
        if c.is_moe:
            c = dataclasses.replace(c, moe_capacity_factor=8.0)
        p_cpu = T.init_params(c, i, device="cpu")
        p_gpu = TR.map_structure(lambda x: x.to(dev), p_cpu)
        b = synthetic_batch(c, DataConfig(global_batch=2, seq_len=16), i)
        res = []
        for p, d in ((p_cpu, torch.device("cpu")), (p_gpu, dev)):
            bt = {k: torch.from_numpy(v).to(d) for k, v in b.items()}
            b0 = {k: (v[:, :8] if k in ("tokens", "embeds") else v)
                  for k, v in bt.items()}
            lg, caches = T.prefill(c, p, b0, max_len=c.num_patches + 20)
            st = [lg[:, 0]]
            for t in range(8, 16):
                if c.frontend == "audio_stub":
                    lg, caches = T.decode_step(
                        c, p, None, caches, embeds=bt["embeds"][:, t:t + 1])
                else:
                    lg, caches = T.decode_step(
                        c, p, bt["tokens"][:, t:t + 1], caches)
                st.append(lg[:, 0])
            off = c.num_patches if c.frontend == "vlm_stub" else 0
            full = lm_full_logits(torch, T, c, p, bt, 0)
            res.append((full.cpu(), torch.stack(st, 1).cpu(),
                        full[:, off + 7:off + 16].cpu()))
        ok_dev, e_dev = within(torch, res[1][0], res[0][0])
        ok_tf, e_tf = within(torch, res[1][1], res[1][2])
        worst[arch] = max(e_dev, e_tf)
        check(ok_dev, f"[lm:archs] {arch} card logits within 5e-3 of CPU")
        check(ok_tf, f"[lm:archs] {arch} decode equals teacher forcing on "
              f"the card")
        if arch not in LM_DENSE:
            ocfg = OptConfig(kind="adamw", lr=1e-3, warmup_steps=1,
                             total_steps=10)
            state = TrainState(params=p_gpu, opt_state=opt.init(ocfg, p_gpu),
                               step=torch.zeros((), dtype=torch.int32,
                                                device=dev))
            state, m = make_train_step(c, ocfg)(state, b)
            finite = all(bool(torch.isfinite(x).all())
                         for x in TR.leaves(state.params))
            check(finite and np.isfinite(float(m["loss"])),
                  f"[lm:archs] {arch} one AdamW step on the card leaves "
                  f"finite parameters")
    print(f"[lm:archs] " + " ".join(f"{a}:worst_excess={v:.3g}"
                                    for a, v in worst.items())
          + f" seconds={time.perf_counter() - t1:.4f}", flush=True)


def lm_shard_train_phase(np, torch, check, dev, smi) -> int:
    """[lm:shard:train]: qwen3-0.6b at published widths, fp32, AdamW at
    [lm:train]'s settings, on the production (16, 16) mesh as 256 shards
    of the card through ``launch.train``'s mesh and placement code, three
    steps beside the one-device step on the same batches; save at step
    3, restore onto (2, 4) and onto one device, one more step on each
    and on (16, 16).  Returns the phase's device peak."""
    from repro_torch import tree as TR
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.distributed import collectives as COL
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import train as LT
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.training import (OptConfig, make_train_step,
                                      train_state_init)
    t_all = time.perf_counter()
    cfg = get_config(LM_ARCH)
    ocfg = OptConfig(kind="adamw", lr=LM_LR, warmup_steps=2,
                     total_steps=LM_STEPS)
    rows, seq = SHARD_TRAIN_BATCH
    data = DataConfig(seed=LM_SEED, global_batch=rows, seq_len=seq)
    batches = [synthetic_batch(cfg, data, i)
               for i in range(SHARD_TRAIN_STEPS + 1)]

    def timed(fn, state, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = fn(state, batch)
        torch.cuda.synchronize()
        return state, m, time.perf_counter() - t0

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    state0 = train_state_init(cfg, ocfg, LM_SEED, device=dev)
    one_bytes = sum(x.numel() * x.element_size()
                    for x in TR.leaves((state0.params, state0.opt_state)))
    one_fn = make_train_step(cfg, ocfg)
    one, one_m, one_s, state = [], [], [], state0
    for i in range(SHARD_TRAIN_STEPS + 1):
        state, m, dt = timed(one_fn, state, batches[i])
        one_m.append((float(m["loss"]), float(m["grad_norm"])))
        one_s.append(dt)
    del state

    mesh = LT.make_mesh_for("single", dev)
    specs, per_shard = LT.state_specs(cfg, ocfg, mesh)
    mesh.require_room(per_shard, f"the train state of {cfg.name}")
    t0 = time.perf_counter()
    state = SH.place_tree(state0, specs, mesh)
    place_s = time.perf_counter() - t0
    del state0
    stored = SH.stored_bytes((state.params, state.opt_state))
    bspecs = SH.batch_spec_tree(batches[0], mesh)
    step = make_train_step(cfg, ocfg, shard=SH.make_shard_fn(mesh))
    sh_m, sh_s, coll = [], [], []
    for i in range(SHARD_TRAIN_STEPS):
        with COL.counting(mesh.size) as counts:
            state, m, dt = timed(step, state,
                                 SH.place_tree(batches[i], bspecs, mesh))
        sh_m.append((float(m["loss"]), float(m["grad_norm"])))
        sh_s.append(dt)
        coll.append(counts.summary())
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_shard_",
                             dir=os.path.join(ROOT, "build"))
    try:
        t0 = time.perf_counter()
        CheckpointManager(ckdir).save(SHARD_TRAIN_STEPS, state,
                                      extra={"data_step": SHARD_TRAIN_STEPS})
        save_s = time.perf_counter() - t0
        last = batches[SHARD_TRAIN_STEPS]
        after, m, _ = timed(step, state, SH.place_tree(last, bspecs, mesh))
        fourth = {"16x16": float(m["loss"])}
        del after, m
        restore_s = {}
        small = make_mesh(SHARD_RESTORE_MESH, ("data", "model"),
                          devices=[dev] * math.prod(SHARD_RESTORE_MESH))
        for name, target in (("2x4", small), ("one-device", None)):
            shardings = None if target is None else \
                (target, LT.state_specs(cfg, ocfg, target)[0])
            gc.collect()
            t0 = time.perf_counter()
            at, restored, extra = CheckpointManager(ckdir).restore_latest(
                state, shardings)
            torch.cuda.synchronize()
            restore_s[name] = time.perf_counter() - t0
            check(at == SHARD_TRAIN_STEPS and extra["data_step"] == at,
                  f"[lm:shard:train] restored step {at} onto {name}")
            if target is None:
                kinds = {type(x) for x in TR.leaves(restored)}
                check(kinds == {torch.Tensor}, "[lm:shard:train] the "
                      "one-device restore holds whole tensors")
                fn, b = make_train_step(cfg, ocfg), last
            else:
                fn = make_train_step(cfg, ocfg,
                                     shard=SH.make_shard_fn(target))
                b = SH.place_tree(last, SH.batch_spec_tree(last, target),
                                  target)
            after, m, _ = timed(fn, restored, b)
            fourth[name] = float(m["loss"])
            del after, m, b, restored
        del state
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated() - base
    gc.collect()
    torch.cuda.empty_cache()
    rel = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(sh_m, one_m))
    gn_rel = max(abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(sh_m, one_m))
    f = list(fourth.values())
    f_rel = max(abs(a - b) / abs(b) for a in f for b in f)
    mean = lambda xs: sum(xs[1:]) / (len(xs) - 1)
    print(f"[lm:shard:train] arch={cfg.name} mesh=16x16 shards={mesh.size} "
          f"descriptor={mesh.descriptor} batch={rows}x{seq} steps="
          f"{SHARD_TRAIN_STEPS} optimizer=adamw lr={LM_LR} losses="
          f"{','.join(f'{a[0]:.6f}' for a in sh_m)} one_device_losses="
          f"{','.join(f'{a[0]:.6f}' for a in one_m[:SHARD_TRAIN_STEPS])} "
          f"grad_norms={','.join(f'{a[1]:.6f}' for a in sh_m)} "
          f"one_device_grad_norms="
          f"{','.join(f'{a[1]:.6f}' for a in one_m[:SHARD_TRAIN_STEPS])} "
          f"loss_max_rel_diff={rel:.3g} grad_norm_max_rel_diff={gn_rel:.3g} "
          f"step_ms={mean(sh_s) * 1e3:.3f} first_step_ms={sh_s[0] * 1e3:.3f} "
          f"one_device_step_ms={mean(one_s) * 1e3:.3f} "
          f"shard_state_bytes={per_shard} stored_state_bytes={stored} "
          f"one_device_state_bytes={one_bytes} "
          f"gather_bytes_per_step={coll[-1]['by_kind'].get('gather', 0)} "
          f"scatter_bytes_per_step={coll[-1]['by_kind'].get('scatter', 0)} "
          f"collective_counts={json.dumps(coll[-1]['count_by_kind'])} "
          f"place_seconds={place_s:.3f} save_seconds={save_s:.3f} "
          f"restore_seconds="
          f"{json.dumps({k: round(v, 3) for k, v in restore_s.items()})} "
          f"fourth_losses="
          f"{json.dumps({k: round(v, 7) for k, v in fourth.items()})} "
          f"one_device_fourth_loss={one_m[-1][0]:.7f} "
          f"fourth_max_rel_diff={f_rel:.3g} peak_bytes={peak} "
          f"seconds={time.perf_counter() - t_all:.3f} card=\"{smi}\"",
          flush=True)
    check(rel <= SHARD_TRAIN_RTOL, f"[lm:shard:train] (16, 16) losses within "
          f"rtol {SHARD_TRAIN_RTOL} of the one-device run's ({rel:.3g})")
    check(f_rel <= SHARD_TRAIN_RTOL, f"[lm:shard:train] the fourth step's "
          f"loss on (16, 16), (2, 4) and one device within rtol "
          f"{SHARD_TRAIN_RTOL} of each other ({f_rel:.3g})")
    check(stored == one_bytes, "[lm:shard:train] the 256 shards store each "
          "distinct block once: the one-device state's bytes")
    return peak


def lm_dryrun_phase(np, torch, check, smi) -> None:
    """[lm:dryrun]: ``python -m repro_torch.launch.dryrun``'s cells
    DRYRUN_CELLS, one record line each: the LM cells on meta tensors over
    the production meshes, ``dna-suffix:serve:single`` on the card."""
    from repro_torch.launch import dryrun as DR
    out = tempfile.mkdtemp(prefix="chip_smoke_dryrun_",
                           dir=os.path.join(ROOT, "build"))
    try:
        for arch, shape, mesh in DRYRUN_CELLS:
            t0 = time.perf_counter()
            done = DR.main(["--arch", arch, "--shape", shape, "--mesh", mesh,
                            "--force", "--out-dir", out])
            secs = time.perf_counter() - t0
            cell = f"{arch}__{shape}__{mesh}"
            rec = done.get(cell, {"error": "no record"})
            ok = "error" not in rec and not rec.get("skipped")
            check(ok, f"[lm:dryrun] {cell} ran: {rec.get('error')}")
            if not ok:
                continue
            roof = rec["roofline"]
            fields = {"cell": rec["label"], "seconds": round(secs, 3),
                      "device": rec["device"], "chips": rec["chips"]}
            if arch == "dna-suffix":
                fields.update(
                    text_len=rec["text_len"], serve_seconds=rec["seconds"],
                    build_seconds=rec["build_s"],
                    device_peak_bytes=rec["device_peak_bytes"],
                    equals_single_device=rec["equals_single_device"])
                check(rec["equals_single_device"], f"[lm:dryrun] {cell} "
                      "answers equal the one-device search")
            else:
                fields.update(
                    flops=rec["flops"], model_flops=rec["model_flops"],
                    useful_ratio=round(rec["useful_ratio"], 4),
                    hbm_bytes=rec["hbm_bytes"], memory=rec["memory"],
                    memory_floor_s=rec["memory_floor_s"])
                check(rec["flops"] > 0, f"[lm:dryrun] {cell} counts FLOPs")
            fields.update(collective=rec["collective"].get("by_kind"),
                          collective_counts=rec["collective"].get(
                              "count_by_kind"),
                          roofline={k: roof[k] for k in (
                              "compute_s", "memory_s", "collective_s",
                              "dominant", "bound_step_s")})
            print(f"[lm:dryrun] {json.dumps(fields)} card=\"{smi}\"",
                  flush=True)
    finally:
        shutil.rmtree(out, ignore_errors=True)


@contextlib.contextmanager
def scratch_tempdir(prefix: str):
    """Points ``tempfile``'s default directory at a fresh directory in
    ``build/`` (the example scripts make their roots there) and removes
    it afterwards."""
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    d = tempfile.mkdtemp(prefix=prefix, dir=os.path.join(ROOT, "build"))
    old = tempfile.tempdir
    tempfile.tempdir = d
    try:
        yield d
    finally:
        tempfile.tempdir = old
        shutil.rmtree(d, ignore_errors=True)


def run_example(name: str, argv, tag: str) -> tuple:
    """Runs ``examples/<name>.py``'s ``main(argv)`` in this process,
    its lines printed under ``[tag:name]``; (what main returned,
    seconds)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            out = mod.main(argv)
    finally:
        for ln in buf.getvalue().splitlines():
            print(f"[{tag}:{name}] {ln}", flush=True)
    return out, time.perf_counter() - t0


def add_path_launches(rows, path: str, launches: dict) -> None:
    """Adds one path's launches to every kernel row's
    ``launches_by_path`` (``pattern_compare``: fused plus standalone, as
    on the other paths)."""
    for r in rows:
        r["launches_by_path"][path] = (
            launches["pattern_compare_fused"] + launches["pattern_compare"]
            if r["name"] == "pattern_compare" else launches[r["name"]])


def expected_hit_rate(n: int, lo: int, hi: int) -> float:
    """The chance that a uniform random pattern of a uniform length in
    [lo, hi] occurs in n uniform random bases: the mean over L of
    1 - exp(-(n - L + 1) / 4**L) (occurrences as a Poisson count)."""
    return sum(1.0 - math.exp(-(n - L + 1) / 4.0**L)
               for L in range(lo, hi + 1)) / (hi - lo + 1)


def examples_phase(np, torch, _build, check, smi, dev) -> dict:
    """[examples]: the four example scripts of the port in this process
    on the card at their default sizes (their own asserts hold).
    Returns the path's launches."""
    _build.reset_launches()
    secs = {}
    with scratch_tempdir("chip_smoke_examples_"):
        for name in ("quickstart_torch", "corpus_dedup_torch",
                     "dna_search_torch", "serve_queries_torch"):
            _, secs[name] = run_example(name, ["--device", str(dev)],
                                        "examples")
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print("[examples] " + " ".join(f"{k}_seconds={v:.4f}"
                                   for k, v in secs.items())
          + f" card=\"{smi}\"", flush=True)
    print("[examples-launches] " + " ".join(
        f"{k}={v}" for k, v in launches.items()), flush=True)
    for k in ("pack2bit", "bounded_search", "tier_scan"):
        check(launches[k] > 0, f"{k} launched on the [examples] path")
    return launches


@contextlib.contextmanager
def recorded_service_scans():
    """While open, every ``HedgedScanService.scan`` batch is recorded:
    yields a list of (the base store it was served from, ``None`` for a
    remote table; packed patterns, lengths, found, count, first_pos, the
    arrays on the host)."""
    from repro_torch.serving import engine
    inner = engine.HedgedScanService.scan
    recorded = []

    def recording_scan(self, patterns_packed, plen, hedged=True):
        res, lat = inner(self, patterns_packed, plen, hedged=hedged)
        recorded.append((None if self.is_remote else self.store, *(
            engine._host(v) for v in (patterns_packed, plen, res.found,
                                      res.count, res.first_pos))))
        return res, lat

    engine.HedgedScanService.scan = recording_scan
    try:
        yield recorded
    finally:
        engine.HedgedScanService.scan = inner


def answers(np, recorded, i0: int = 0, i1: int = None) -> list:
    """The recorded batches ``i0:i1`` as whole columns: [packed
    patterns, lengths, found, count, first_pos]."""
    return [np.concatenate([r[k] for r in recorded[i0:i1]])
            for k in range(1, 6)]


def brute_count_first(torch, text, pat) -> tuple:
    """(count, smallest position) of ``pat`` in ``text`` (uint8 codes on
    the card) from a compare at every position: no index is read."""
    m = text.numel() - len(pat) + 1
    hit = text[:m] == int(pat[0])
    for k in range(1, len(pat)):
        hit &= text[k:k + m] == int(pat[k])
    at = torch.nonzero(hit).flatten()
    return int(at.numel()), (int(at[0]) if at.numel() else -1)


def paper_phase(np, torch, _build, check, smi, dev) -> tuple:
    """[paper]: the paper's case study at chr1's length through
    ``examples/dna_search_torch.py``: 248,956,422 seeded random bases
    into a table created in a root under ``build/``, Tables III (batch
    10), IV (batch 50) and V and the hedged run of 10,000 queries each,
    the locate, the stream, the straddling append, compact and reopen.
    Then every answer of the three runs is held against the plain search
    on the card, and against the seeded text: each found ``first_pos``
    holds its pattern, and a few dozen patterns are counted by brute
    force; the hit rate against the random-text expectation.  Returns
    (the path's launches, peak device bytes)."""
    from repro_torch.api import Database
    from repro_torch.core import codec
    from repro_torch.kernels.pattern_scan import bounded_match_plain

    texts = []
    inner_create = Database.create_table

    def recording_create(self, name, codes, **kw):
        texts.append(codes)
        return inner_create(self, name, codes, **kw)

    _build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    Database.create_table = recording_create
    try:
        with scratch_tempdir("chip_smoke_paper_"), \
                recorded_service_scans() as recorded:
            fig, secs = run_example(
                "dna_search_torch",
                ["--text-len", str(PAPER_LEN), "--queries",
                 str(PAPER_QUERIES), "--device", str(dev)], "paper")
    finally:
        Database.create_table = inner_create
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    # every answer of the three runs against the plain search on the base
    # store they were served from, the recorded batches in batches of
    # PAPER_CHECK_BATCH
    store = recorded[0][0]
    one_store = all(r[0] is store for r in recorded)
    n_calls = len(recorded)
    pp, plen, *got = answers(np, recorded)
    recorded.clear()
    t0 = time.perf_counter()
    want = [[], [], []]
    for i in range(0, len(plen), PAPER_CHECK_BATCH):
        found, count, rank, _pos = bounded_match_plain(
            store, codec.as_tensor(pp[i:i + PAPER_CHECK_BATCH], dev),
            codec.as_tensor(plen[i:i + PAPER_CHECK_BATCH], dev))
        found, count, rank = (v.cpu().numpy() for v in (found, count, rank))
        # text-order first_pos: the smallest position of the SA slice
        first = np.full(count.shape, -1, np.int64)
        for j in np.flatnonzero(found):
            r0 = store.pad_count + int(rank[j])
            first[j] = int(store.sa[r0:r0 + int(count[j])].min())
        for k, v in enumerate((found, count, first)):
            want[k].append(v)
    plain_s = time.perf_counter() - t0
    want = [np.concatenate(w) for w in want]
    mism = {k: int((np.asarray(g).astype(np.int64)
                    != np.asarray(w).astype(np.int64)).sum())
            for k, g, w in zip(("found", "count", "first_pos"), got, want)}
    del store

    # the answers against the seeded text itself, which no SA has read:
    # every found first_pos holds its pattern, and the 16 longest found
    # and 16 shortest missed patterns are counted by brute force
    text = texts.pop()
    pats = codec.unpack_2bit_batch(pp, pp.shape[1] * codec.BASES_PER_WORD)
    found, count, first = got
    hit_idx = np.flatnonzero(found)
    holds = sum(int(np.array_equal(text[f:f + L], pats[j, :L]))
                for j, f, L in zip(hit_idx, first[hit_idx], plen[hit_idx]))
    miss_idx = np.flatnonzero(~found.astype(bool))
    picks = np.concatenate([
        hit_idx[np.argsort(-plen[hit_idx], kind="stable")[:PAPER_BRUTE]],
        miss_idx[np.argsort(plen[miss_idx], kind="stable")[:PAPER_BRUTE]]])
    t0 = time.perf_counter()
    text_dev = torch.from_numpy(text).to(dev)
    brute = [brute_count_first(torch, text_dev, pats[j, :plen[j]])
             for j in picks]
    torch.cuda.synchronize()
    brute_s = time.perf_counter() - t0
    brute_bad = sum(int((c, f) != (int(count[j]), int(first[j])))
                    for (c, f), j in zip(brute, picks))
    del text_dev, text

    ing, t3, t4, hd = (fig["ingest"], fig["table_iii"], fig["table_iv"],
                       fig["hedged"])
    expect = expected_hit_rate(PAPER_LEN, 1, 100)
    sigma = math.sqrt(expect * (1 - expect) / PAPER_QUERIES)
    z = {k: (st["hit_rate"] - expect) / sigma
         for k, st in (("iii", t3), ("iv", t4), ("hedged", hd))}
    print(f"[paper] n={PAPER_LEN} seconds={secs:.4f} "
          f"ingest_seconds={ing['seconds']:.4f} "
          f"mbase_per_s={ing['mbase_per_s']:.4f} "
          f"ingest_peak_bytes={ing['device_peak_bytes']} "
          f"disk_bytes={ing['disk_bytes']} phase_peak_bytes={peak} "
          f"compact_seconds={fig['compact']['seconds']:.4f} "
          f"open_seconds={fig['compact']['open_seconds']:.4f} "
          f"service_calls={n_calls} card=\"{smi}\"", flush=True)
    for tag, st in (("III", t3), ("IV", t4), ("hedged", hd)):
        print(f"[paper:{tag}] " + " ".join(
            f"{k}={v}" for k, v in st.items()), flush=True)
    print(f"[paper:check] answers={len(plen)} "
          f"mismatches={json.dumps(mism)} plain_seconds={plain_s:.4f} "
          f"found={len(hit_idx)} first_pos_holds_pattern={holds} "
          f"brute_force={len(picks)} brute_force_lens="
          f"{','.join(str(int(plen[j])) for j in picks)} "
          f"brute_force_mismatches={brute_bad} "
          f"brute_force_seconds={brute_s:.4f} "
          f"expected_hit_rate={expect:.6f} sigma={sigma:.6f} "
          f"z={json.dumps(z)}", flush=True)
    st = fig["stream"]
    print(f"[paper:stream] probe_len={len(st['probe'])} count={st['count']} "
          f"first_page={st['first_page']} resumed={st['resumed']}",
          flush=True)
    print("[paper-launches] " + " ".join(
        f"{k}={v}" for k, v in launches.items()), flush=True)
    check(one_store and not texts and len(plen) == 3 * PAPER_QUERIES
          and t3["n"] == t4["n"] == hd["n"] == PAPER_QUERIES,
          "[paper] every query of the three runs went through the "
          "service, all on the one base store")
    check(not any(mism.values()),
          "[paper] every answer (found, count, first_pos) of the three "
          "runs equals the plain search's")
    check(holds == len(hit_idx) > 0,
          "[paper] every found first_pos holds its pattern in the seeded "
          "text")
    check(len(picks) == 2 * PAPER_BRUTE and brute_bad == 0,
          "[paper] the brute-force count and first position of the "
          "longest found and shortest missed patterns equal the answers")
    check(abs(round(expect, 4) - 0.1386) < 1e-9,
          "[paper] the random-text hit rate at chr1's length is 0.1386")
    check(all(abs(v) <= 5 for v in z.values()),
          "[paper] every run's hit rate is within 5 sigma of the "
          "random-text expectation")
    check(t4["corr_len_outcome"] < -0.3 and abs(t4["corr_len_time"]) < 0.1,
          "[paper] Table V: corr(len, hit) < -0.3 and |corr(len, time)| "
          "< 0.1")
    check(t4["max_ms"] > 10 * t4["mean_ms"] and hd["max_ms"] < t4["max_ms"],
          "[paper] Table IV's single-read max exceeds 10x its mean and the "
          "hedged max is below it")
    check(0 < st["first_page"] < st["count"]
          and st["first_page"] + st["resumed"] == st["count"]
          and fig["compact"]["reopened_count"] == fig["append"]["after"]
          == fig["append"]["before"] + 1
          and fig["compact"]["bases"] == PAPER_LEN + 507,
          "[paper] the stream resumed from its cursor, the straddling "
          "append and the reopened table's count")
    for k in ("pack2bit", "bounded_search", "tier_scan"):
        check(launches[k] > 0, f"{k} launched on the [paper] path")
    gc.collect()
    torch.cuda.empty_cache()
    return launches, peak


def plane_hedged_phase(np, torch, _build, check, smi, remote, table,
                       db) -> dict:
    """[plane:hedged]: the paper's workload (Table IV's batches of 50)
    through ``HedgedScanService`` over the plane's ``RemoteTable``, hedged
    off and on: its latencies are the routed batches' wall ms, the hedge
    is the router's own backup RPC to another worker.  Each arm's answers
    (``found``, ``count``, ``first_pos``) must equal the card table's
    (``table``) on the same seeds, query by query.  Returns the path's
    launches (the card arm's)."""
    from repro_torch.serving import HedgedScanService
    _build.reset_launches()
    router = remote.router
    hedged_arms = {}
    with recorded_service_scans() as recorded:
        for arm in (False, True):
            st0 = router.stats()
            i0 = len(recorded)
            svc = HedgedScanService(remote, database=db)
            st = svc.run_workload(
                PLANE_HEDGED_QUERIES, batch=PLANE_HEDGED_BATCH,
                hedged=arm, seed=PLANE_HEDGED_SEED)
            hedged_arms[arm] = (st, st0, router.stats(), i0, len(recorded))
        i0 = len(recorded)
        card_stats = HedgedScanService(table, database=db).run_workload(
            PLANE_HEDGED_QUERIES, batch=PLANE_HEDGED_BATCH, hedged=False,
            seed=PLANE_HEDGED_SEED)
        card = answers(np, recorded, i0)
    for arm, (st, st0, st1, a0, a1) in hedged_arms.items():
        ours = answers(np, recorded, a0, a1)
        diff = {k: int((g.astype(np.int64) != w.astype(np.int64)).sum())
                for k, g, w in zip(("found", "count", "first_pos"),
                                   ours[2:], card[2:])}
        print(f"[plane:hedged] hedged={str(arm).lower()} "
              f"queries={st['n']} batch={PLANE_HEDGED_BATCH} "
              f"wall_mean_ms={st['mean_ms']:.4f} "
              f"wall_p99_ms={st['p99_ms']:.4f} "
              f"wall_max_ms={st['max_ms']:.4f} "
              f"rpcs={st1['rpcs'] - st0['rpcs']} "
              f"hedge_fired={st1['hedge_fired'] - st0['hedge_fired']} "
              f"hedge_wins={st1['hedge_wins'] - st0['hedge_wins']} "
              f"hit_rate={st['hit_rate']} "
              f"card_hit_rate={card_stats['hit_rate']} "
              f"mismatches={json.dumps(diff)} "
              f"hedge_enabled_after={str(router.hedge_enabled).lower()} "
              f"card=\"{smi}\"", flush=True)
        check(st["n"] == PLANE_HEDGED_QUERIES
              and st["hit_rate"] == card_stats["hit_rate"]
              and all(np.array_equal(g, w) for g, w in zip(ours[:2],
                                                           card[:2]))
              and not any(diff.values()),
              f"[plane:hedged] hedged={arm}: every answer (found, count, "
              f"first_pos) through the plane equals the card table's on "
              f"the same patterns")
    _, off0, off1, _, _ = hedged_arms[False]
    check(off1["hedge_fired"] == off0["hedge_fired"]
          and router.hedge_enabled,
          "[plane:hedged] hedged=False fires no backup and leaves the "
          "router's hedging as it was")
    recorded.clear()
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print("[plane-hedged-launches] " + " ".join(
        f"{k}={v}" for k, v in launches.items()), flush=True)
    for k in ("bounded_search", "tier_scan"):
        check(launches[k] > 0,
              f"{k} launched on the [plane:hedged] path (the card arm)")
    return launches


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    failures: list[str] = []

    def check(ok: bool, what: str) -> None:
        if not ok:
            failures.append(what)
            print(f"[FAIL] {what}", flush=True)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"[device] {smi}", flush=True)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    rows, peak = search_paths(np, torch, check, smi)
    # [paper] and the LM phases run on a card that the search phases no
    # longer hold
    gc.collect()
    torch.cuda.empty_cache()
    from repro_torch.kernels import _build
    dev = torch.device("cuda")
    paper_launches, paper_peak = paper_phase(np, torch, _build, check, smi,
                                             dev)
    peak = max(peak, paper_peak)
    example_launches = examples_phase(np, torch, _build, check, smi, dev)
    add_path_launches(rows, "paper", paper_launches)
    add_path_launches(rows, "examples", example_launches)
    print("[kernels:paths] " + " ".join(
        f"{r['name']}:" + ",".join(f"{k}={v}" for k, v in
                                   r["launches_by_path"].items())
        for r in rows), flush=True)
    lm_phase(np, torch, check, dev, smi)
    peak = max(peak, lm_moe_phase(np, torch, check, dev, smi))
    peak = max(peak, lm_ssm_phase(np, torch, check, dev, smi))
    lm_archs_phase(np, torch, check, dev, smi)
    peak = max(peak, lm_shard_train_phase(np, torch, check, dev, smi))
    lm_dryrun_phase(np, torch, check, smi)
    print(f"[memory] peak_bytes={peak}", flush=True)
    print(smi, flush=True)          # card name and power limit, as is
    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed: {failures}",
              file=sys.stderr)
        return 1
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def search_paths(np, torch, check, smi) -> tuple:
    """Phases 1-19 and the kernels' rows: every search path, each kernel
    held against its plain versions and timed.  Returns (rows, peak
    device bytes); what it built is released when it returns."""
    from repro_torch.api import SuffixTable
    from repro_torch.core import codec
    from repro_torch.core import query as Q
    from repro_torch.kernels import _build, kary, ops, ref
    from repro_torch.kernels import fm_scan as FM
    from repro_torch.kernels import tier_scan as TS
    from repro_torch.kernels.tablet_scan import BIG as NO_ROW
    from repro_torch.kernels.tablet_scan import (tablet_scan_cuda,
                                                 tablet_scan_plain)
    from repro_torch.kernels.pack2bit import pack2bit_cuda
    from repro_torch.kernels.pattern_scan import (bounded_match_cuda,
                                                  bounded_match_plain,
                                                  bounded_search_cuda,
                                                  bounded_search_plain,
                                                  pattern_compare_cuda)
    from repro_torch.core.suffix_array import build_suffix_array

    t0 = time.perf_counter()
    _build.build()
    print(f"[nvcc] built {', '.join(_build.SOURCES)} in "
          f"{time.perf_counter() - t0:.3f} s into {_build.BUILD_DIR}",
          flush=True)
    for k in ptxas_report(_build.BUILD_DIR, _build.SOURCES):
        print("[ptxas] " + " ".join(f"{a}={b}" for a, b in k.items()),
              flush=True)

    # ---------------- main path: every launch from here is counted ------
    _build.reset_launches()
    base = codec.random_dna(TEXT_LEN, seed=0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    table = SuffixTable.from_codes(base, is_dna=True,
                                   max_query_len=MAX_QUERY_LEN,
                                   memtable_limit=MEMTABLE_LIMIT)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"[build] n={TEXT_LEN} seconds={dt:.4f} "
          f"mbase_per_s={TEXT_LEN / dt / 1e6:.3f} "
          f"resident_bytes={torch.cuda.memory_allocated()} "
          f"peak_bytes={torch.cuda.max_memory_allocated()}", flush=True)
    check(table.store.device.type == "cuda", "table lives on the card")
    build_s0, build_peak0 = dt, torch.cuda.max_memory_allocated()
    base_sa = table.store.sa[table.store.pad_count:].cpu().numpy()

    patterns = Q.random_patterns(N_QUERIES, 1, 100, seed=0)

    # every base search of a live table is one query.query call (the
    # planner's and ops.fused_single's): keep its results, to check
    # found == (count > 0) on every query after each phase
    live_results = []
    search = Q.query

    def recording_query(store, patt, plen):
        res = search(store, patt, plen)
        live_results.append(res)
        return res

    Q.query = recording_query

    served_qps: dict = {}

    def serve(tag: str, table) -> tuple[np.ndarray, np.ndarray]:
        """The workload through ``table.scan``: (counts, first_pos)."""
        lat, counts, firsts = [], [], []
        live_results.clear()
        table.tracer.reset()
        t_all = time.perf_counter()
        for i in range(0, N_QUERIES, BATCH):
            t = time.perf_counter()
            out = table.scan(patterns[i:i + BATCH])
            lat.append((time.perf_counter() - t) * 1e3)
            counts.append(out.count)
            firsts.append(out.first_pos)
        total = time.perf_counter() - t_all
        c = np.concatenate(counts)
        served_qps[tag] = len(c) / total
        lat = np.asarray(lat)
        print(f"[{tag}] queries={len(c)} batches={len(lat)} "
              f"p50_ms={np.percentile(lat, 50):.4f} "
              f"p99_ms={np.percentile(lat, 99):.4f} "
              f"queries_per_s={len(c) / total:.1f} "
              f"found={int((c > 0).sum())}", flush=True)
        check(c.shape == (N_QUERIES,) and bool((c >= 0).all()),
              f"{tag}: counts have the expected shape and are >= 0")
        if not table.is_frozen and table.mesh is None:
            n_q = sum(int(r.count.shape[0]) for r in live_results)
            ok = all(torch.equal(r.found, r.count > 0) for r in live_results)
            print(f"[found:{tag}] searches={len(live_results)} "
                  f"queries={n_q} found_eq_count_gt_0="
                  f"{str(bool(ok)).lower()}", flush=True)
            # (queries the table's string cache answered never reach it)
            check(ok and n_q > 0,
                  f"{tag}: found == (count > 0) on every searched query")
        spans = table.tracer.snapshot()
        print(f"[spans:{tag}] " + " ".join(
            f"{k}:sum_ms={v['sum_ms']},p50_ms={v['p50_ms']}"
            for k, v in spans.items()), flush=True)
        return c, np.concatenate(firsts)

    def append_all(tag: str, table) -> None:
        for chunk in appended:
            table.append(chunk)
        st = table.stats()["tiers"]
        print(f"[{tag}] runs={st['run_count']} run_rows={st['run_rows']} "
              f"memtable_rows={st['memtable_rows']}", flush=True)
        check(st["run_count"] == 1 and st["memtable_rows"] == APPEND_LEN,
              f"{tag}: one sealed run and one live memtable after three "
              f"appends")

    base_counts, base_first = serve("count", table)
    appended = [codec.random_dna(APPEND_LEN, seed=1 + i) for i in range(3)]
    append_all("append", table)
    merged_counts, merged_first = serve("merged", table)
    loc_pats = ["ACGT", "GATTACA", "TTTT"]
    located = table.locate(loc_pats, top_k=5)

    # [linear] the tablet scan over every sorted row of the base, held
    # against the plain binary search's bounds on every query: count =
    # ub - lb, less = lb, first_row = lb where found (rows without the
    # store's pad rows), 2**30 elsewhere
    store = table.store
    patt, plen = table.planner.encode(patterns[:BATCH])
    B, W = patt.shape
    rows_wt = sorted_windows(torch, codec, store, W)
    pos_sorted = store.sa[store.pad_count:]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lin = ops.tablet_scan(patt, plen, rows_wt.T, pos_sorted, n_real=store.n_real)
    torch.cuda.synchronize()
    lin_s = time.perf_counter() - t0
    plb, pub = Q.search_bounds_plain(store, patt, plen)
    lb_real = plb - store.pad_count
    lin_err = max_abs_err(torch, lin, (pub - plb, lb_real,
                                       torch.where(pub > plb, lb_real,
                                                   NO_ROW)))
    res = Q.query(store, patt, plen)
    ok = lin_err == 0 and torch.equal(lin[0], res.count)
    print(f"[linear] queries={B} rows={rows_wt.shape[1]} words={W} "
          f"seconds={lin_s:.4f} found={int((pub > plb).sum())} "
          f"max_abs_err={lin_err} match={str(bool(ok)).lower()}",
          flush=True)
    check(bool(ok), "tablet_scan count / less / first_row equal the plain "
          "binary search's bounds for every query")

    # [freeze] a second table over the same bases, frozen by the policy
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frozen = SuffixTable.from_codes(base, is_dna=True,
                                    max_query_len=MAX_QUERY_LEN,
                                    memtable_limit=MEMTABLE_LIMIT,
                                    fm_threshold=TEXT_LEN)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    build_s = frozen.stats()["build"]["elapsed_s"]
    fm_bytes = frozen.stats()["tiers"]["resident_bytes"]["fm"]
    sa_bytes = table.stats()["tiers"]["resident_bytes"]["base_sa"]
    print(f"[freeze] n={TEXT_LEN} build_seconds={build_s:.4f} "
          f"freeze_seconds={total_s - build_s:.4f} fm_bytes={fm_bytes} "
          f"live_base_sa_bytes={sa_bytes} "
          f"fm_over_sa={fm_bytes / sa_bytes:.4f} "
          f"is_frozen={str(frozen.is_frozen).lower()}", flush=True)
    check(frozen.is_frozen and frozen.stats()["tiers"]["frozen"],
          "fm_threshold froze the second table")

    fc, ff = serve("frozen", frozen)
    check(np.array_equal(fc, base_counts) and np.array_equal(ff, base_first),
          "frozen base-only counts and first_pos equal the live table's")
    append_all("frozen-append", frozen)
    fmc, fmf = serve("frozen-merged", frozen)
    check(np.array_equal(fmc, merged_counts)
          and np.array_equal(fmf, merged_first),
          "frozen merged counts and first_pos equal the live table's")
    floc = frozen.locate(loc_pats, top_k=5)
    check(np.array_equal(floc, located),
          "frozen locate(top_k=5) equals the live table's")
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    # ---------------- end of the main path ------------------------------
    print(f"[serve-launches] " + " ".join(
        f"{k}={v}" for k, v in launches.items()), flush=True)
    check(launches["pattern_compare"] == 0,
          "the standalone pattern_compare kernel is not launched on the "
          "serving path (its compare is bounded_search's epilogue)")
    text = np.concatenate([base] + appended)
    # outside the counted paths: profiles of the merged phases, and the
    # tier stack and FM index the kernel rows below are measured on
    profile_batches(torch, table, patterns, "merged")
    profile_batches(torch, frozen, patterns, "frozen-merged")
    tier_stack = table._tierset().stack
    fm_arrays = frozen.fm.arrays

    # ---------------- compaction path: counted apart --------------------
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    version = table.compact()
    torch.cuda.synchronize()
    merge_s = time.perf_counter() - t0
    merge_searches = _build.LAUNCHES["bounded_search"]
    t0 = time.perf_counter()
    rebuilt = build_suffix_array(torch.from_numpy(text).to(table.device))
    torch.cuda.synchronize()
    rebuild_s = time.perf_counter() - t0
    st = table.store
    same_sa = torch.equal(st.sa[st.pad_count:], rebuilt)
    del rebuilt
    print(f"[compact] n={len(text)} delta={len(text) - TEXT_LEN} "
          f"dirty={len(text) - TEXT_LEN + MAX_QUERY_LEN - 1} "
          f"version={version} merge_seconds={merge_s:.4f} "
          f"rebuild_seconds={rebuild_s:.4f} "
          f"merge_search_launches={merge_searches} "
          f"sa_equals_rebuild={str(same_sa).lower()}", flush=True)
    check(same_sa, "the compacted SA equals a from-scratch build on every "
          "row")
    check(version == 1 and not table.runs and table.memtable.size == 0,
          "compaction folded the run and the memtable into version 1")
    check(merge_searches >= 1, "the merge's insertion search ran as a "
          "bounded_search launch")
    cc, cf = serve("compacted", table)
    check(np.array_equal(cc, merged_counts)
          and np.array_equal(cf, merged_first),
          "compacted counts and first_pos equal the merged phase's")
    check(np.array_equal(table.locate(loc_pats, top_k=5), located),
          "compacted locate(top_k=5) equals the merged phase's")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fversion = frozen.compact()
    torch.cuda.synchronize()
    fmerge_s = time.perf_counter() - t0
    print(f"[frozen-compact] version={fversion} seconds={fmerge_s:.4f} "
          f"is_frozen={str(frozen.is_frozen).lower()} "
          f"fm_n={frozen.fm.n if frozen.fm is not None else -1}",
          flush=True)
    check(frozen.is_frozen and fversion == 1 and frozen.fm.n == len(text),
          "the frozen table stays frozen across compaction")
    fcc, fcf = serve("frozen-compacted", frozen)
    check(np.array_equal(fcc, merged_counts)
          and np.array_equal(fcf, merged_first),
          "frozen-compacted counts and first_pos equal the merged phase's")
    torch.cuda.synchronize()
    compact_launches = dict(_build.LAUNCHES)
    print(f"[compact-launches] " + " ".join(
        f"{k}={v}" for k, v in compact_launches.items()), flush=True)
    for k in ("bounded_search", "pack2bit", "fm_scan"):
        check(compact_launches[k] > 0, f"{k} launched on the compaction "
              f"path")

    # ---------------- persistence path: counted apart -------------------
    _build.reset_launches()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_tables_",
                            dir=os.path.join(ROOT, "build"))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ptable = SuffixTable.create("chip", base, root=root, is_dna=True,
                                    max_query_len=MAX_QUERY_LEN,
                                    memtable_limit=MEMTABLE_LIMIT)
        torch.cuda.synchronize()
        create_s = time.perf_counter() - t0
        for chunk in appended:
            ptable.append(chunk)
        t0 = time.perf_counter()
        ptable.flush()
        flush_s = time.perf_counter() - t0
        del ptable
        disk = sum(os.path.getsize(os.path.join(d, f))
                   for d, _, fs in os.walk(root) for f in fs)
        t0 = time.perf_counter()
        opened = SuffixTable.open("chip", root=root)
        torch.cuda.synchronize()
        open_s = time.perf_counter() - t0
        st = opened.stats()["tiers"]
        print(f"[persist] create_seconds={create_s:.4f} "
              f"flush_seconds={flush_s:.4f} open_seconds={open_s:.4f} "
              f"bytes_on_disk={disk} runs={st['run_count']} "
              f"memtable_rows={st['memtable_rows']}", flush=True)
        check(st["run_count"] == 1 and st["memtable_rows"] == APPEND_LEN,
              "open restored the sealed run and the memtable")
        oc, of = serve("reopened", opened)
        check(np.array_equal(oc, merged_counts)
              and np.array_equal(of, merged_first),
              "reopened counts and first_pos equal the merged phase's")
        extra = codec.random_dna(APPEND_LEN, seed=4)
        opened.append(extra)            # logged, acked, not flushed
        ac, af = serve("appended", opened)
        del opened
        t0 = time.perf_counter()
        replayed = SuffixTable.open("chip", root=root)
        torch.cuda.synchronize()
        replay_s = time.perf_counter() - t0
        rec = replayed.stats()["wal"]["recovery"] or {}
        print(f"[wal] open_seconds={replay_s:.4f} "
              f"records_replayed={rec.get('records_replayed')} "
              f"reason={rec.get('reason')} "
              f"memtable_rows={replayed.memtable.size}", flush=True)
        check(rec.get("records_replayed") == 1
              and replayed.memtable.size == 2 * APPEND_LEN,
              "the commit log replayed the unflushed append")
        rc, rf = serve("replayed", replayed)
        check(np.array_equal(rc, ac) and np.array_equal(rf, af),
              "replayed counts and first_pos equal the appending table's")
        del replayed
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.synchronize()
    persist_launches = dict(_build.LAUNCHES)
    print(f"[persist-launches] " + " ".join(
        f"{k}={v}" for k, v in persist_launches.items()), flush=True)
    for k in ("pack2bit", "bounded_search", "tier_scan"):
        check(persist_launches[k] > 0, f"{k} launched on the persistence "
              f"path")

    # ---------------- each kernel against its plain version -------------
    # at W = 8, timed before the [long], [client] and [serve] phases add
    # their tables, results and threads to the process; each row gains
    # those paths' launches and its [long] numbers after the last phase
    dev = store.device
    rows, timed = [], []
    flush = torch.empty(FLUSH_WORDS, dtype=torch.int32, device=dev)

    def times(kernel, reps) -> dict:
        """``ms``: time per call of ``kernel`` as the host issues them,
        host work of the wrapper included; ``device_ms``: device time of
        launches back to back (L2 warm); ``cold_ms``: of a launch after
        an L2 flush."""
        return {"ms": cuda_ms(torch, kernel, reps),
                "device_ms": cuda_ms(torch, kernel, reps, queue_ahead=True),
                "cold_ms": cuda_ms(torch, kernel, reps, flush=flush)}

    def row(name, source, replaces, err, kernel, reps, plain_ms, n_bytes,
            n_ops, library_ms=None, **extra):
        """One kernel's JSON row, its times as :func:`times`."""
        b, by = bound_ms(n_bytes, n_ops)
        counted = "pattern_compare_fused" if name == "pattern_compare" \
            else name
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[counted],
                     "max_abs_err": err, "plain_ms": plain_ms,
                     "bound_ms": b, "bound_by": by,
                     "library_ms": library_ms, **times(kernel, reps),
                     **extra})
        timed.append((counted, kernel, reps))
        check(launches[counted] > 0, f"{name} launched on the main path")
        check(err == 0, f"{name} equals its plain version")

    # pack2bit over the whole base text
    codes = torch.from_numpy(base).to(dev)
    n_words = codec.packed_length(TEXT_LEN)
    lanes = codes.to(torch.int64).reshape(n_words, 16)
    got = pack2bit_cuda(codes)
    want = ref.pack2bit_ref(lanes.T)
    err = max_abs_err(torch, [codec.words_i64(got)], [codec.words_i64(want)])
    check(torch.equal(got.view(torch.int32),
                      store.text_packed.view(torch.int32)),
          "pack2bit output is the table's packed text")
    shifts = 30 - 2 * torch.arange(16, dtype=torch.int64, device=dev)
    row("pack2bit", "src/repro_torch/kernels/csrc/pack2bit.cu",
        "src/repro/kernels/pack2bit.py:30", err,
        lambda: pack2bit_cuda(codes), 20,
        cuda_ms(torch, lambda: ref.pack2bit_ref(lanes.T), 3),
        TEXT_LEN + 4 * n_words, 2 * 16 * n_words,
        library_ms=cuda_ms(torch, lambda: (lanes << shifts).sum(dim=1), 5))

    # bounded_search on the base store, first batch of the workload, as
    # the serving path launches it: with the compare epilogue
    # (bounded_match_cuda), held against its plain version on all 512
    # queries; its bounds alone (bounded_search_cuda, the compaction
    # merge's launch) against the plain binary search ([linear]'s plb,
    # pub) and the plain 17-ary version.  Bytes: what the binary search
    # reads (traced with arity=2, each sa row and text word once) plus
    # the epilogue's compare at lb (its sa row and the text words it
    # reads, into the same dedup), the pattern words in use, plen and
    # the outputs (13 B a query; 8 for the bounds alone); operations:
    # ~4 per word compared.
    n_used = used_words(torch, plen)
    sargs = (store.sa, store.text_packed, store.n_real, patt, plen,
             store.n_pad)
    margs = sargs + (store.pad_count,)
    lb, ub = bounded_search_cuda(*sargs)
    epi = bounded_match_cuda(*margs)
    epi_plain = bounded_match_plain(store, patt, plen)
    epi_err = max_abs_err(torch, epi, epi_plain)
    epi_found_ok = torch.equal(epi[0], epi[1] > 0)
    check(epi_err == 0 and epi_found_ok,
          "the search epilogue's four outputs equal their plain version on "
          "all queries, and found == (count > 0)")
    trace, bin_trace = [], []
    kary_bounds = bounded_search_plain(*sargs, trace=trace)
    bin_bounds = bounded_search_plain(*sargs, trace=bin_trace, arity=2)
    m = match_traffic(torch, kary, codec, store, patt, plen, lb, bin_trace)
    w_lb, pos_lb = m["w_lb"], m["pos_lb"]
    _, s_rounds, s_probes, s_words = search_traffic(
        torch, trace, store.sa, store.text_packed)
    bounds_only = (lambda: bounded_search_cuda(*sargs))
    row("bounded_search", "src/repro_torch/kernels/csrc/pattern_scan.cu",
        "src/repro/kernels/pattern_scan.py:55",
        max(max_abs_err(torch, [lb, ub], [plb, pub]),
            max_abs_err(torch, [lb, ub], kary_bounds),
            max_abs_err(torch, bin_bounds, [plb, pub]), epi_err),
        lambda: bounded_match_cuda(*margs), 20,
        cuda_ms(torch, lambda: bounded_match_plain(store, patt, plen), 2),
        m["bytes"], m["ops"], rounds=s_rounds, binary_rounds=m["rounds"],
        kary_plain_ms=cuda_ms(torch, lambda: bounded_search_plain(*sargs),
                              2),
        bounds_only_ms=cuda_ms(torch, bounds_only, 20),
        bounds_only_device_ms=cuda_ms(torch, bounds_only, 20,
                                      queue_ahead=True),
        bounds_only_cold_ms=cuda_ms(torch, bounds_only, 20, flush=flush),
        bounds_only_bound_ms=bound_ms(m["bounds_bytes"],
                                      m["bounds_ops"])[0])
    check(s_rounds <= kary.max_rounds(store.n_pad),
          "bounded_search ends within floor(log17 n_pad) + 1 rounds")
    print(f"[search] rows={store.n_pad} rounds={s_rounds} "
          f"max_rounds={kary.max_rounds(store.n_pad)} probes={s_probes} "
          f"words={s_words} binary_rounds={m['rounds']} "
          f"binary_probes={m['probes']} binary_words={m['words']} "
          f"bound_bytes={m['bytes']} "
          f"bounds_only_bound_bytes={m['bounds_bytes']} "
          f"epilogue_words={int(w_lb.sum())}", flush=True)
    print(f"[epilogue] queries={B} max_abs_err={epi_err} "
          f"found={int(epi[0].sum())} found_eq_count_gt_0="
          f"{str(epi_found_ok).lower()} pattern_compare_standalone_launches="
          f"{launches['pattern_compare']} fused_launches="
          f"{launches['pattern_compare_fused']} bounded_search_launches "
          f"serve={launches['bounded_search']} "
          f"compact={compact_launches['bounded_search']} "
          f"persist={persist_launches['bounded_search']}", flush=True)

    # pattern_compare: the standalone entry point (the TPU kernel's
    # contract over explicit windows) on the suffixes at those lower
    # bounds.  On the serving path the compare runs as the epilogue
    # above: its launches are the row's, its outputs are in max_abs_err,
    # and epilogue_bound_ms counts its own bytes (the sa row at lb, the
    # text words its compare reads, the pattern words, 13 B of outputs)
    lb_pos = store.sa[lb.clamp(0, store.n_pad - 1).to(torch.int64)]
    win = codec.extract_window(store.text_packed, lb_pos, W)
    got = pattern_compare_cuda(win, patt, plen, lb_pos, n_real=store.n_real)
    want = ref.pattern_compare_ref(win.T, patt.T, plen, lb_pos,
                                   n_real=store.n_real)
    row("pattern_compare", "src/repro_torch/kernels/csrc/pattern_scan.cu",
        "src/repro/kernels/pattern_scan.py:55",
        max(max_abs_err(torch, got, want), epi_err),
        lambda: pattern_compare_cuda(
            win, patt, plen, lb_pos, n_real=store.n_real), 50,
        cuda_ms(torch, lambda: ref.pattern_compare_ref(
            win.T, patt.T, plen, lb_pos, n_real=store.n_real), 5),
        2 * B * W * 4 + 2 * B * 4 + 3 * B, B * W,
        standalone_launches=launches["pattern_compare"],
        fused_into="bounded_search",
        epilogue_bound_ms=bound_ms(
            4 * B + text_bytes(torch, pos_lb, w_lb, store.text_packed)
            + 4 * n_used + 13 * B, 4 * int(w_lb.sum()))[0])

    # tier_scan over the live run + memtable: the kernel reads the stacked
    # packed text and sa; held against its plain 17-ary version, the
    # dense plain version (the TPU kernel's algorithm, over windows) and
    # the binary-search twin
    stack = tier_stack
    meta = ops.tier_meta(stack)
    pt = patt.T.contiguous()
    args = (pt, plen, stack.text_packed, stack.sa, stack.pad_cnt, meta)
    got = TS.tier_scan_cuda(*args)
    traces, bin_traces = [], []
    plain = TS.tier_scan_plain(*args, trace=traces)
    binary = TS.tier_scan_plain(*args, trace=bin_traces, arity=2)
    wt = ref.tier_windows(stack, W)
    t1 = time.perf_counter()
    dense = ref.tier_scan_ref(pt, plen, wt, stack.sa, meta)
    torch.cuda.synchronize()
    dense_ms = (time.perf_counter() - t1) * 1e3
    del wt
    twin = TS.fused_tier_scan(stack, patt, plen)
    err = max(max_abs_err(torch, got, w)
              for w in (plain, binary, dense, twin))
    T, R = (int(d) for d in stack.sa.shape)
    # bytes: the sa rows and text words that a binary search of both
    # bounds and the match runs past their padding read (tier_traffic),
    # the pattern words in use, plen, meta, two pad_cnt entries per tier
    # and the outputs; operations: ~4 per word compared.  The 17-ary
    # search's own reads are counted apart (kary_bytes).
    fixed = tier_fixed(torch, stack, plen)
    run_lo, run_hi = tier_runs(torch, TS, stack, got)
    t_bytes, t_bin_rounds, t_bin_probes, t_bin_words = tier_traffic(
        torch, bin_traces, stack.sa, stack.text_packed, run_lo, run_hi)
    k_bytes, t_rounds, t_probes, t_words = tier_traffic(
        torch, traces, stack.sa, stack.text_packed, run_lo, run_hi)
    row("tier_scan", "src/repro_torch/kernels/csrc/tier_scan.cu",
        "src/repro/kernels/tier_scan.py:338", err,
        lambda: TS.tier_scan_cuda(*args), 50,
        cuda_ms(torch, lambda: TS.tier_scan_plain(*args), 2),
        t_bytes + fixed, 4 * t_bin_words, rounds=t_rounds,
        binary_rounds=t_bin_rounds, kary_bytes=k_bytes + fixed,
        dense_plain_ms=dense_ms)
    print(f"[tiers] T={T} rows={R} n_rows={stack.n_rows.tolist()} "
          f"rounds={t_rounds} max_rounds={kary.max_rounds(R)} "
          f"probes={t_probes} words={t_words} kary_bytes={k_bytes + fixed} "
          f"binary_rounds={t_bin_rounds} binary_probes={t_bin_probes} "
          f"binary_words={t_bin_words} bound_bytes={t_bytes + fixed} "
          f"run_rows={int(got[2].sum())} longest_run={int(got[2].max())} "
          f"swept_rows={int((run_hi - run_lo).sum())} "
          f"longest_sweep={int((run_hi - run_lo).max())} "
          f"dense_plain_ms={dense_ms:.4f} twin_ms="
          f"{cuda_ms(torch, lambda: TS.fused_tier_scan(stack, patt, plen), 2):.4f}",
          flush=True)

    # tablet_scan: the main path's launch over all 2**26 rows was held
    # against the plain binary search's bounds in [linear]; here the
    # kernel on all rows against its plain 17-ary version, and on a
    # contiguous slice of 2**18 rows against the dense plain version
    # (all 2**26 would take minutes)
    R = int(rows_wt.shape[1])
    full = (pt, plen, rows_wt, pos_sorted)
    got = tablet_scan_cuda(*full, n_real=store.n_real)
    trace, bin_trace = [], []
    plain = tablet_scan_plain(*full, n_real=store.n_real, trace=trace)
    binary = tablet_scan_plain(*full, n_real=store.n_real, trace=bin_trace,
                               arity=2)
    sl = slice(TEXT_LEN // 2, TEXT_LEN // 2 + SLICE_ROWS)
    part = (pt, plen, rows_wt[:, sl], pos_sorted[sl])
    got_sl = tablet_scan_cuda(*part, n_real=store.n_real)
    t1 = time.perf_counter()
    dense = ref.tablet_scan_ref(*part, n_real=store.n_real)
    torch.cuda.synchronize()
    dense_ms = (time.perf_counter() - t1) * 1e3
    fixed = 4 * n_used + 4 * B + 3 * B * 4
    b_bytes, b_bin_rounds, b_bin_probes, b_bin_words = tablet_traffic(
        torch, bin_trace)
    k_bytes, b_rounds, b_probes, b_words = tablet_traffic(torch, trace)
    row("tablet_scan", "src/repro_torch/kernels/csrc/tablet_scan.cu",
        "src/repro/kernels/tablet_scan.py:82",
        max(lin_err, max_abs_err(torch, got, plain),
            max_abs_err(torch, got, binary),
            max_abs_err(torch, got_sl, dense)),
        lambda: tablet_scan_cuda(*full, n_real=store.n_real), 50,
        cuda_ms(torch, lambda: tablet_scan_plain(*full, n_real=store.n_real),
                2),
        b_bytes + fixed, 4 * b_bin_words, rounds=b_rounds,
        binary_rounds=b_bin_rounds, kary_bytes=k_bytes + fixed,
        dense_plain_ms=dense_ms, dense_plain_rows=SLICE_ROWS)
    slice_ms = cuda_ms(torch, lambda: tablet_scan_cuda(
        *part, n_real=store.n_real), 50, queue_ahead=True)
    print(f"[tablet] rows={R} rounds={b_rounds} "
          f"max_rounds={kary.max_rounds(R)} probes={b_probes} "
          f"words={b_words} kary_bytes={k_bytes + fixed} "
          f"binary_rounds={b_bin_rounds} binary_probes={b_bin_probes} "
          f"binary_words={b_bin_words} bound_bytes={b_bytes + fixed} "
          f"slice_rows={SLICE_ROWS} "
          f"kernel_slice_ms={slice_ms:.4f} dense_plain_slice_ms="
          f"{dense_ms:.4f}", flush=True)

    # fm_scan on the frozen table's index, first batch of the workload:
    # the kernel reads the packed patterns; its plain version
    # (backward_search) steps search_syms over the (16 W, B) plan
    fa = fm_arrays
    fm_steps = W * 16
    syms = FM.syms_from_packed(patt, plen, fm_steps)
    got = FM.fm_scan_cuda(patt, plen, fa.bwt, fa.occ, fa.meta)
    want = FM.search_syms(fa, syms)
    # bytes: 4 per rank (Occ entry) + 4 per BWT word read, the packed
    # patterns, plen, the outputs and meta; operations: ~9 per word (xor,
    # not, and, shift, and, mask, popcount, add)
    ranks, words, tlo, thi = fm_traffic(torch, FM, fa, syms)
    check(torch.equal(tlo, got[0]) and torch.equal(thi, got[1]),
          "the fm_scan traffic count followed the kernel's search")
    row("fm_scan", "src/repro_torch/kernels/csrc/fm_scan.cu",
        "src/repro/kernels/fm_scan.py:260", max_abs_err(torch, got, want),
        lambda: FM.fm_scan_cuda(patt, plen, fa.bwt, fa.occ, fa.meta), 50,
        cuda_ms(torch, lambda: FM.backward_search(fa, patt, plen), 1),
        4 * ranks + 4 * words + B * W * 4 + B * 4 + 2 * B * 4 + 32,
        9 * words)
    lo, hi = got
    print(f"[fm] steps={fm_steps} active_steps={int(plen.sum())} "
          f"ranks={ranks} words={words} found={int((hi > lo).sum())} "
          f"bwt_words={fa.bwt.shape[0]} occ_rows={fa.occ.shape[0]}",
          flush=True)

    # ---------------- [long] path: patterns past 16 words ---------------
    _build.reset_launches()

    def serve_long(tag, t, pats):
        """One batch of ``pats`` through ``t.scan``: (counts, first_pos)."""
        live_results.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = t.scan(pats)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        ok = all(torch.equal(r.found, r.count > 0) for r in live_results)
        print(f"[{tag}] queries={len(pats)} "
              f"max_len={max(map(len, pats))} "
              f"words={codec.packed_length(t.max_query_len)} "
              f"seconds={dt:.4f} found={int((out.count > 0).sum())} "
              f"found_eq_count_gt_0={str(bool(ok)).lower()}", flush=True)
        check(ok and (t.is_frozen or len(live_results) > 0),
              f"{tag}: found == (count > 0) on every searched query")
        return out.count, out.first_pos

    long_pats = long_patterns(np, codec, Q, base, BATCH, LONG_MAX_PATTERN, 5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ltable = SuffixTable.from_codes(base, is_dna=True,
                                    max_query_len=LONG_QUERY_LEN,
                                    memtable_limit=MEMTABLE_LIMIT)
    torch.cuda.synchronize()
    print(f"[long] n={TEXT_LEN} max_query_len={LONG_QUERY_LEN} "
          f"build_seconds={time.perf_counter() - t0:.4f}", flush=True)
    lc, lf = serve_long("long", ltable, long_pats)
    ltable.append(appended[0])
    ltable.minor_compact()
    ltable.append(appended[1])
    check(len(ltable.runs) == 1 and ltable.memtable.size == APPEND_LEN,
          "[long]: one sealed run and one live memtable")
    lmc, lmf = serve_long("long-merged", ltable, long_pats)
    long_text = np.concatenate([base, appended[0], appended[1]])
    fslice = base[:FROZEN_SLICE]
    ftable = SuffixTable.from_codes(fslice, is_dna=True,
                                    max_query_len=LONG_QUERY_LEN,
                                    fm_threshold=FROZEN_SLICE)
    check(ftable.is_frozen, "[long]: the slice's table is frozen")
    fpats = long_patterns(np, codec, Q, fslice, BATCH, LONG_MAX_PATTERN, 6)
    flc, flf = serve_long("long-frozen", ftable, fpats)
    torch.cuda.synchronize()
    long_launches = dict(_build.LAUNCHES)
    print(f"[long-launches] " + " ".join(
        f"{k}={v}" for k, v in long_launches.items()), flush=True)
    for k in ("bounded_search", "tier_scan", "fm_scan"):
        check(long_launches[k] > 0, f"{k} launched on the [long] path")
    ok = True
    for i in np.random.default_rng(1).choice(BATCH, size=16, replace=False):
        for lp, ltext, (cnt, fst) in ((long_pats, base, (lc, lf)),
                                      (long_pats, long_text, (lmc, lmf)),
                                      (fpats, fslice, (flc, flf))):
            pos = brute_positions(np, ltext, codec.encode_dna(lp[i]))
            ok &= (cnt[i] == len(pos)
                   and fst[i] == (pos[0] if len(pos) else -1))
    print(f"[long-brute] patterns=16 tables=3 match={str(bool(ok)).lower()}",
          flush=True)
    check(bool(ok), "[long] counts and first_pos agree with a brute-force "
          "scan of the text")

    # ---------------- [client] path: the client frontend -----------------
    _build.reset_launches()
    from repro_torch.api import Database, Query
    cdb = Database.in_memory(coalesce_window_ms=2.0)
    cdb.attach("live", table)
    waves = [[Query.scan("live", [p], top_k=5)
              for p in Q.random_patterns(CALLERS, 1, 100, seed=100 + w)]
             for w in range(CLIENT_WAVES)]
    cdb.query(waves[0][0])                  # first use of every path
    cdb.query_many(waves[0])
    arms: dict = {}

    def per_call(wave):
        lat, got = [], []
        for q in wave:
            t = time.perf_counter()
            got.append(cdb.query(q))
            lat.append((time.perf_counter() - t) * 1e3)
        return got, lat

    def coalesced(wave):
        t = time.perf_counter()
        got = cdb.query_many(wave)
        return got, [(time.perf_counter() - t) * 1e3] * len(wave)

    def scheduler(wave):
        got, lat = [None] * len(wave), [0.0] * len(wave)
        gate = threading.Barrier(len(wave))

        def caller(i):
            gate.wait()
            t = time.perf_counter()
            got[i] = cdb.submit(wave[i]).result(timeout=120.0)
            lat[i] = (time.perf_counter() - t) * 1e3

        threads = [threading.Thread(target=caller, args=(i,))
                   for i in range(len(wave))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(180.0)
        return got, lat

    for name, fn in (("per_call", per_call), ("coalesced", coalesced),
                     ("scheduler", scheduler)):
        s0 = cdb.scheduler.stats_snapshot()
        got_all, lat_all, wall = [], [], 0.0
        for wave in waves:
            table.clear_cache()
            t = time.perf_counter()
            got, lat = fn(wave)
            wall += time.perf_counter() - t
            got_all += got
            lat_all += lat
        s1 = cdb.scheduler.stats_snapshot()
        arms[name] = got_all
        lat_all = np.asarray(lat_all)
        if name == "per_call":
            # a call's top-5 enumerates its whole SA slice on the host:
            # the time of the patterns of <= 3 bases, apart
            short = np.asarray([len(q.patterns[0]) <= 3
                                for wave in waves for q in wave])
            print(f"[client] arm=per_call short_patterns="
                  f"{int(short.sum())} short_ms={lat_all[short].sum():.4f} "
                  f"other_ms={lat_all[~short].sum():.4f}", flush=True)
        print(f"[client] arm={name} callers={CALLERS} waves={CLIENT_WAVES} "
              f"queries={len(got_all)} "
              f"queries_per_s={len(got_all) / wall:.1f} "
              f"p50_ms={np.percentile(lat_all, 50):.4f} "
              f"p95_ms={np.percentile(lat_all, 95):.4f} "
              f"batches={s1['batches'] - s0['batches']} "
              f"coalesced_queries="
              f"{s1['coalesced_queries'] - s0['coalesced_queries']} "
              f"fast_path_queries="
              f"{s1['fast_path_queries'] - s0['fast_path_queries']}",
              flush=True)
        check(all(r is not None and r.ok for r in got_all),
              f"[client] {name}: every query answered")

    def answer(r):
        return (r.count.tolist(), r.first_pos.tolist(),
                r.positions.tolist())

    same = all(answer(a) == answer(b) == answer(c) for a, b, c in
               zip(arms["per_call"], arms["coalesced"], arms["scheduler"]))
    print(f"[client] identical={str(same).lower()} "
          f"found={sum(int(r.count[0] > 0) for r in arms['per_call'])}",
          flush=True)
    check(same, "[client] counts, first_pos and top-5 positions are "
          "bit-identical across per_call, coalesced and scheduler")
    cdb.close()
    torch.cuda.synchronize()
    client_launches = dict(_build.LAUNCHES)
    print(f"[client-launches] " + " ".join(
        f"{k}={v}" for k, v in client_launches.items()), flush=True)
    check(client_launches["bounded_search"] > 0,
          "bounded_search launched on the [client] path")

    # ---------------- [serve] path: the serving launcher -----------------
    _build.reset_launches()
    from repro_torch.launch import serve as serve_cli
    from repro_torch.serving.metrics import aggregate_metrics, read_lines
    sroot = os.path.join(ROOT, "build", "chip_serve")
    shutil.rmtree(sroot, ignore_errors=True)
    cli = ["--text-len", str(TEXT_LEN), "--queries", str(N_QUERIES),
           "--batch", str(BATCH), "--root", sroot, "--metrics-interval",
           "0.5"]
    planted = codec.encode_dna("GATTACA" * 3)
    demo = np.concatenate([planted, codec.random_dna(993, seed=1)])
    extra = codec.random_dna(4096, seed=9)
    stexts = [base, np.concatenate([base, demo, extra])]
    try:
        outs, walls = [], []
        for k in range(2):
            if k == 1:        # an acked append that only the log holds
                t = SuffixTable.open("dna_serve", root=sroot)
                t.append(extra)
                t.close()
                del t
            t0 = time.perf_counter()
            outs.append(run_cli(serve_cli.main, cli))
            walls.append(time.perf_counter() - t0)
        varz = run_cli(serve_cli.main, ["--root", sroot, "--table",
                                        "dna_serve", "--dump-stats"])
        feed = read_lines(os.path.join(sroot, "dna_serve", "metrics.jsonl"))
        agg = aggregate_metrics(os.path.join(sroot, "dna_serve",
                                             "metrics.jsonl"))
    finally:
        shutil.rmtree(sroot, ignore_errors=True)
    first, second = outs
    check("[build]" in first and "[open ]" in second,
          "[serve] the second run opened the first run's table")
    want_len = TEXT_LEN + len(demo) + len(extra)
    check(f"[wal  ] recovered: replayed=1 skipped=0 torn_bytes=0"
          in second and f", {want_len} bases" in cli_line(second, "[open ] v"),
          "[serve] the reopen replayed the unflushed append: nothing lost")
    ok = True
    for out, stext in zip(outs, stexts):
        for ln in out.splitlines():
            m = re.match(r"\[locate\] '(\w+)': count=(\d+) first_5=(.*)",
                         ln)
            if m:
                pos = brute_positions(np, stext, codec.encode_dna(m[1]))
                ok &= (int(m[2]) == len(pos)
                       and json.loads(m[3]) == pos[:5].tolist())
        ln = cli_line(out, "[stream]")
        ok &= bool(ln) and int(ln.split(":")[1].split()[0]) == int(
            ln.split("one-shot count")[1].strip(" )"))
        m = re.search(r"count\(GATTACAGAT\.\.\.\) (\d+) -> (\d+)",
                      cli_line(out, "[write ]"))
        after = np.concatenate([stext, demo])
        rise = (len(brute_positions(np, after, planted))
                - len(brute_positions(np, stext, planted)))
        ok &= m is not None and int(m[2]) - int(m[1]) == rise
    print(f"[serve] create_run_seconds={walls[0]:.4f} "
          f"open_run_seconds={walls[1]:.4f} feed_rows={len(feed)} "
          f"emitters={agg['summary']['emitters']} "
          f"feed_queries={agg['summary']['queries']} "
          f"checks={str(bool(ok)).lower()}", flush=True)
    check(bool(ok), "[serve] [locate] equals a brute-force scan, [stream]'s "
          "pages total the one-shot count, [write ] rises by the planted "
          "occurrences")
    row_keys = {"role", "table", "pid", "queries", "p50_ms", "p95_ms",
                "p99_ms", "stats", "ts"}
    check(len(feed) >= 2 and all(set(r) == row_keys for r in feed)
          and agg["summary"]["tables"] >= 1
          and "[varz  ] table-proc dna_serve" in varz,
          "[serve] the feed holds the reference's rows and --dump-stats "
          "reads it")
    torch.cuda.synchronize()
    serve_launches = dict(_build.LAUNCHES)
    print(f"[serve-cli-launches] " + " ".join(
        f"{k}={v}" for k, v in serve_launches.items()), flush=True)
    for k in ("pack2bit", "bounded_search", "tier_scan"):
        check(serve_launches[k] > 0, f"{k} launched on the [serve] path")

    # ---------------- [staged] path: the out-of-core build --------------
    # the in-memory build of the bases the staged build takes: [staged] is
    # held to its SA and to its answers to the workload.  It is built and
    # freed before the path's counts are set to 0, so that they count only
    # the staged path's own launches
    staged_codes = base[:STAGED_LEN]
    mem = SuffixTable.from_codes(staged_codes, is_dna=True,
                                 max_query_len=MAX_QUERY_LEN)
    mem_sa = mem.store.sa[mem.store.pad_count:].cpu().numpy()
    mem_out = [mem.scan(patterns[i:i + BATCH])
               for i in range(0, N_QUERIES, BATCH)]
    mem_counts = np.concatenate([o.count for o in mem_out])
    mem_first = np.concatenate([o.first_pos for o in mem_out])
    mem.close()
    del mem, mem_out
    gc.collect()
    torch.cuda.empty_cache()
    _build.reset_launches()
    from repro_torch.api import Database, Query
    from repro_torch.api import table as table_mod
    from repro_torch.checkpoint.manager import CheckpointManager, by_key
    from repro_torch.core import build_pipeline as BP
    from repro_torch.serving import rpc
    from repro_torch.serving.plane import ServingPlane
    torch.cuda.synchronize()
    peak_before_staged = torch.cuda.max_memory_allocated()
    build_peaks, sort_s, sort_n = [], [], []
    inner_build = table_mod.staged_suffix_array
    inner_sort = BP._sort_chunk

    def timed_sort(*args):
        """One chunk sort: upload, ``torch.sort`` and copy back, which
        waits for the card; its wall time and count are summed per
        build."""
        t = time.perf_counter()
        out = inner_sort(*args)
        sort_s[-1] += time.perf_counter() - t
        sort_n[-1] += 1
        return out

    def measured_build(*args, **kw):
        """The table's staged build, its device peak measured: the
        bytes allocated at the peak less those resident before."""
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        sort_s.append(0.0)
        sort_n.append(0)
        out = inner_build(*args, **kw)
        torch.cuda.synchronize()
        build_peaks.append(torch.cuda.max_memory_allocated() - before)
        return out

    sroot = tempfile.mkdtemp(prefix="chip_smoke_staged_",
                             dir=os.path.join(ROOT, "build"))
    plane = pdb = None
    try:
        # the device footprint of one chunk sort against the figure the
        # build sizes its sorts by (bytes a row plus a fixed margin)
        foot = {}
        for n_rows in (2**16, 2**20, 2**22):
            key = np.random.default_rng(n_rows).integers(0, 2**50,
                                                         size=n_rows)
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            BP._sort_chunk(key, 0, dev)
            torch.cuda.synchronize()
            foot[n_rows] = torch.cuda.max_memory_allocated() - before
        print("[sort-footprint] " + " ".join(
            f"rows={r}:peak_bytes={v},bytes_per_row={v / r:.4f}"
            for r, v in foot.items())
            + f" model_bytes_per_row={BP.SORT_BYTES_PER_ROW} "
            f"model_fixed_bytes={BP.SORT_FIXED_BYTES}", flush=True)
        check(all(v <= r * BP.SORT_BYTES_PER_ROW + BP.SORT_FIXED_BYTES
                  for r, v in foot.items()),
              "[staged] a chunk sort holds no more device bytes than the "
              "build sizes its sorts by")
        table_mod.staged_suffix_array = measured_build
        BP._sort_chunk = timed_sort
        try:
            t0 = time.perf_counter()
            stable = SuffixTable.create("staged", staged_codes, root=sroot,
                                        is_dna=True,
                                        max_query_len=MAX_QUERY_LEN,
                                        max_device_bytes=STAGED_BUDGET)
            torch.cuda.synchronize()
            staged_s = time.perf_counter() - t0
            spill = os.path.join(sroot, "spill")
            small = codec.random_dna(SPILL_LEN, seed=5)
            t0 = time.perf_counter()
            spilled = SuffixTable.create(
                "spilled", small, root=sroot, is_dna=True,
                max_query_len=MAX_QUERY_LEN, spill_dir=spill,
                max_device_bytes=SPILL_LEN // 16 * BP.BYTES_PER_ROW)
            torch.cuda.synchronize()
            spill_s = time.perf_counter() - t0
            # before the next create: its catalog reconcile removes
            # every directory of the root that names no table
            left = os.listdir(spill)
            whole_codes = codec.random_dna(WHOLE_LEN, seed=6)
            whole = SuffixTable.create("whole", whole_codes, root=sroot,
                                       is_dna=True, staged=True,
                                       max_query_len=MAX_QUERY_LEN)
        finally:
            table_mod.staged_suffix_array = inner_build
            BP._sort_chunk = inner_sort
        b = stable.stats()["build"]
        sort_rows = BP.device_sort_rows(b["chunk_rows"], STAGED_BUDGET,
                                        dev)
        step_dir = os.path.join(sroot, "staged", "step_0000000001")
        with open(os.path.join(step_dir, "meta.json")) as f:
            n_shards = json.load(f)["shards"]["sa_real"]["count"]
        arrays, _ = CheckpointManager(os.path.join(sroot, "staged")
                                      ).restore_arrays(1)
        snap_sa = by_key(arrays)["sa_real"]
        sa_ok = (np.array_equal(snap_sa, mem_sa) and np.array_equal(
            stable.store.sa[stable.store.pad_count:].cpu().numpy(), mem_sa))
        del arrays, snap_sa, mem_sa
        print(f"[staged] n={STAGED_LEN} rounds={b['rounds']} "
              f"chunks={b['n_chunks']}x{b['chunk_rows']} "
              f"sort_rows={sort_rows} runs_per_round="
              f"{-(-STAGED_LEN // sort_rows)} seconds={staged_s:.4f} "
              f"build_seconds={b['elapsed_s']:.4f} "
              f"mbase_per_s={STAGED_LEN / b['elapsed_s'] / 1e6:.4f} "
              f"sort_seconds={sort_s[0]:.4f} host_share="
              f"{1 - sort_s[0] / b['elapsed_s']:.4f} "
              f"measured_peak_bytes={build_peaks[0]} "
              f"max_device_bytes={STAGED_BUDGET} "
              f"modelled_peak_device_bytes={b['peak_device_bytes']} "
              f"sort_bytes_per_row={build_peaks[0] / sort_rows:.4f} "
              f"shards={n_shards} sa_equals_build={str(sa_ok).lower()} "
              f"card=\"{smi}\"", flush=True)
        check(b["mode"] == "staged" and b["n_chunks"] == STAGED_LEN >> 22,
              "[staged] the budget gave chunks of 2**22 rows")
        check(build_peaks[0] <= STAGED_BUDGET,
              "[staged] the build's measured device peak is within "
              "max_device_bytes")
        check(sa_ok, "[staged] the snapshot's SA equals the in-memory "
              "build's on every row")
        check(n_shards == STAGED_LEN >> 22,
              "[staged] the SA was streamed a shard a chunk")
        sb = spilled.stats()["build"]
        small_sa = build_suffix_array(torch.from_numpy(small).to(dev))
        spill_ok = torch.equal(
            spilled.store.sa[spilled.store.pad_count:], small_sa)
        print(f"[staged:spill] n={SPILL_LEN} rounds={sb['rounds']} "
              f"chunks={sb['n_chunks']}x{sb['chunk_rows']} "
              f"seconds={spill_s:.4f} build_seconds={sb['elapsed_s']:.4f} "
              f"mbase_per_s={SPILL_LEN / sb['elapsed_s'] / 1e6:.4f} "
              f"sort_seconds={sort_s[1]:.4f} "
              f"spill_bytes={sb['spill_bytes']} "
              f"measured_peak_bytes={build_peaks[1]} max_device_bytes="
              f"{SPILL_LEN // 16 * BP.BYTES_PER_ROW} "
              f"sa_equals_in_memory={str(spill_ok).lower()} "
              f"spill_files_left={len(left)}", flush=True)
        check(spill_ok and sb["n_chunks"] == 16 and sb["spill_bytes"] > 0,
              "[staged:spill] the spilled build's SA equals the in-memory "
              "build")
        check(not left, "[staged:spill] the spill dir is empty afterwards")
        check(build_peaks[1] <= SPILL_LEN // 16 * BP.BYTES_PER_ROW,
              "[staged:spill] the measured device peak is within "
              "max_device_bytes")
        wb = whole.stats()["build"]
        whole_ok = torch.equal(
            whole.store.sa[whole.store.pad_count:],
            build_suffix_array(torch.from_numpy(whole_codes).to(dev)))
        print(f"[staged:whole] n={WHOLE_LEN} rounds={wb['rounds']} "
              f"chunks={wb['n_chunks']}x{wb['chunk_rows']} "
              f"sorts={sort_n[2]} measured_peak_bytes={build_peaks[2]} "
              f"sa_equals_in_memory={str(whole_ok).lower()}", flush=True)
        check(whole_ok and sort_n[2] == wb["rounds"] * wb["n_chunks"],
              "[staged:whole] without a budget every round sorts each "
              "chunk whole, and the SA equals the in-memory build")
        whole.close()
        spilled.close()
        stable.close()
        del spilled, stable, small_sa, whole
        t0 = time.perf_counter()
        staged = SuffixTable.open("staged", root=sroot)
        torch.cuda.synchronize()
        reopen_s = time.perf_counter() - t0
        print(f"[staged:open] seconds={reopen_s:.4f} "
              f"mode={staged.stats()['build']['mode']}", flush=True)
        sc, sf = serve("staged-served", staged)
        check(np.array_equal(sc, mem_counts)
              and np.array_equal(sf, mem_first),
              "[staged] the reopened staged table's counts and first_pos "
              "equal the in-memory build's")
        torch.cuda.synchronize()
        staged_launches = dict(_build.LAUNCHES)
        print(f"[staged-launches] " + " ".join(
            f"{k}={v}" for k, v in staged_launches.items()), flush=True)
        for k in ("pack2bit", "bounded_search"):
            check(staged_launches[k] > 0, f"{k} launched on the [staged] "
                  f"path")

        # ------------ [plane] path: tablet workers over the snapshot ----
        _build.reset_launches()
        staged.append(codec.random_dna(APPEND_LEN, seed=21))  # log only
        pdb = Database(sroot)
        pdb.attach("staged", staged)
        t0 = time.perf_counter()
        plane = ServingPlane.deploy(sroot, "staged", PLANE_TABLETS,
                                    replicas=PLANE_REPLICAS)
        up_s = time.perf_counter() - t0
        alias = "staged@plane"
        remote = pdb.connect_plane("staged", attach_as=alias)

        def through(name, kind, **kw):
            """The workload as typed queries on ``name``, in batches:
            (results, seconds)."""
            ctor = getattr(Query, kind)
            t = time.perf_counter()
            out = [pdb.query(ctor(name, patterns[i:i + BATCH], **kw))
                   for i in range(0, N_QUERIES, BATCH)]
            return out, time.perf_counter() - t

        def same(a, b) -> bool:
            return all(x.ok and y.ok and all(
                (getattr(x, f) is None and getattr(y, f) is None)
                or np.array_equal(getattr(x, f), getattr(y, f))
                for f in ("found", "count", "first_pos", "positions"))
                for x, y in zip(a, b))

        staged.clear_cache()
        card_count, card_s = through("staged", "count")
        plane_count, plane_s = through(alias, "count")
        staged.clear_cache()
        card_scan, card_scan_s = through("staged", "scan", top_k=4)
        plane_scan, plane_scan_s = through(alias, "scan", top_k=4)
        t = time.perf_counter()
        card_loc = [staged.locate_range(p) for p in patterns[:PLANE_LOCATE]]
        card_loc_s = time.perf_counter() - t
        t = time.perf_counter()
        plane_loc = [remote.locate_range(p)
                     for p in patterns[:PLANE_LOCATE]]
        plane_loc_s = time.perf_counter() - t
        loc_ok = all(np.array_equal(a, b) for a, b in zip(card_loc,
                                                          plane_loc))
        owner = plane._sock_path(PLANE_TABLETS - 1, 0)
        t0r0 = plane._sock_path(0, 0)

        def worker_stats(path):
            c = rpc.RpcClient(path)
            try:
                return c.call({"op": "stats"})["stats"]
            finally:
                c.close()

        ost = worker_stats(owner)
        crc_before = worker_stats(t0r0)["text_crc"]
        plane.kill(0, 0)
        failed_over, _ = through(alias, "count")
        plane.restart(0, 0)
        crc_after = worker_stats(t0r0)["text_crc"]
        again = [pdb.query(Query.scan(alias, patterns[:BATCH], top_k=4))]
        rs = remote.router.stats()
        counts_ok = same(card_count, plane_count)
        scan_ok = same(card_scan, plane_scan)
        fo_ok = same(card_count, failed_over) and same(card_scan[:1], again)
        print(f"[plane] tablets={PLANE_TABLETS} replicas={PLANE_REPLICAS} "
              f"n_base={STAGED_LEN} delta={ost['delta_len']} "
              f"owner_wal_replayed={ost['wal_records_replayed']} "
              f"up_seconds={up_s:.4f} queries={N_QUERIES} "
              f"count_queries_per_s={N_QUERIES / plane_s:.1f} "
              f"card_count_queries_per_s={N_QUERIES / card_s:.1f} "
              f"scan_top4_queries_per_s={N_QUERIES / plane_scan_s:.1f} "
              f"card_scan_top4_queries_per_s="
              f"{N_QUERIES / card_scan_s:.1f} "
              f"located={PLANE_LOCATE} "
              f"locate_range_per_s={PLANE_LOCATE / plane_loc_s:.1f} "
              f"card_locate_range_per_s={PLANE_LOCATE / card_loc_s:.1f} "
              f"card=\"{smi}\"", flush=True)
        print(f"[plane] rpcs={rs['rpcs']} hedge_fired={rs['hedge_fired']} "
              f"hedge_wins={rs['hedge_wins']} failovers={rs['failovers']} "
              f"p50_ms={rs['p50_ms']} p95_ms={rs['p95_ms']} "
              f"count_equal={str(counts_ok).lower()} "
              f"scan_top4_equal={str(scan_ok).lower()} "
              f"locate_range_equal={str(loc_ok).lower()} "
              f"after_kill9_equal={str(fo_ok).lower()} "
              f"crc_before={crc_before} crc_after={crc_after}", flush=True)
        check(ost["wal_records_replayed"] == 1
              and ost["delta_len"] == APPEND_LEN,
              "[plane] the owner tablet replayed the unflushed append")
        check(counts_ok and scan_ok and loc_ok,
              "[plane] count, scan(top_k=4) and locate_range through the "
              "plane equal the card table's")
        check(fo_ok and rs["failovers"] > 0,
              "[plane] answers unchanged after kill -9 of a replica")
        check(crc_after == crc_before,
              "[plane] the restarted replica serves the same text")
        torch.cuda.synchronize()
        plane_launches = dict(_build.LAUNCHES)
        print(f"[plane-launches] " + " ".join(
            f"{k}={v}" for k, v in plane_launches.items()), flush=True)
        for k in ("bounded_search", "tier_scan"):
            check(plane_launches[k] > 0, f"{k} launched on the [plane] "
                  f"path")

        plane_hedged_launches = plane_hedged_phase(
            np, torch, _build, check, smi, remote, staged, pdb)
        staged.close()
        del staged
    finally:
        if plane is not None:
            plane.stop()
        if pdb is not None:
            pdb.close()
        shutil.rmtree(sroot, ignore_errors=True)

    # ------------ [mesh] path: 8 tablets on the one card ----------------
    # REPRO_TORCH_HOST_DEVICES=8 (the counterpart of 8 XLA host devices):
    # every table below resolves a mesh of 8 tablets on cuda:0 (from_codes,
    # compact, create(staged=True)); each phase checks against the
    # single-device phases above
    from repro_torch.core.tablet import shard_store
    from repro_torch.launch.mesh import HOST_DEVICES_ENV
    _build.reset_launches()
    os.environ[HOST_DEVICES_ENV] = str(MESH_TABLETS)
    mroot = tempfile.mkdtemp(prefix="chip_smoke_mesh_",
                             dir=os.path.join(ROOT, "build"))
    mesh_t0 = time.perf_counter()
    mesh_secs: dict = {}
    try:
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        mt = SuffixTable.from_codes(base, is_dna=True,
                                    max_query_len=MAX_QUERY_LEN,
                                    memtable_limit=MEMTABLE_LIMIT)
        torch.cuda.synchronize()
        mesh_secs["build"] = time.perf_counter() - t0
        mesh_peak = torch.cuda.max_memory_allocated() - resident
        msa_ok = np.array_equal(
            mt.store.sa[mt.store.pad_count:].cpu().numpy(), base_sa)
        print(f"[mesh:build] n={TEXT_LEN} tablets={mt.planner.num_tablets} "
              f"rows_per_tablet={mt.store.tablet_rows(MESH_TABLETS)} "
              f"method=bitonic seconds={mesh_secs['build']:.4f} "
              f"peak_bytes_over_resident={mesh_peak} "
              f"build_seconds={build_s0:.4f} "
              f"build_peak_bytes={build_peak0} "
              f"sa_equals_build={str(msa_ok).lower()} card=\"{smi}\"",
              flush=True)
        check(mt.mesh is not None
              and mt.planner.num_tablets == MESH_TABLETS
              and all(d.type == "cuda" for d in mt.mesh.devices),
              "[mesh:build] the table resolved 8 tablets on the card")
        check(msa_ok, "[mesh:build] the distributed SA equals [build]'s "
              "on every row")

        def exact_vs_plain() -> bool:
            """The planner's answers over the workload (its planned mode,
            retries included) equal the plain binary search over the
            table's whole SA: found, count, first_rank, first_pos."""
            ok = True
            for i in range(0, N_QUERIES, BATCH):
                pp, pl = mt.planner.encode(patterns[i:i + BATCH])
                got = mt.planner.scan_encoded(pp, pl)
                want = bounded_match_plain(mt.store, pp, pl)
                ok &= all(torch.equal(g, w) for g, w in zip(
                    (got.found, got.count, got.first_rank, got.first_pos),
                    want))
            return bool(ok)

        # [mesh:broadcast] (routed_min_batch above the batch) and
        # [mesh:routed] at capacity_factor 2.0, then 0.25
        for tag, rmb, cf in (("mesh:broadcast", 1024, 2.0),
                             ("mesh:routed", 64, 2.0),
                             ("mesh:routed-0.25", 64, 0.25)):
            mt.planner.routed_min_batch, mt.planner.capacity_factor = rmb, cf
            mt.planner.reset_stats()
            mt.clear_cache()
            t0 = time.perf_counter()
            c, f = serve(tag, mt)
            mesh_secs[tag] = time.perf_counter() - t0
            st = mt.planner.stats
            served = dict(_build.LAUNCHES)    # the check's launches are
            exact = exact_vs_plain()          # not the path's
            _build.LAUNCHES.update(served)
            print(f"[{tag}:plan] capacity_factor={cf} routed_min_batch="
                  f"{rmb} modes={st.mode_counts} retried="
                  f"{st.retried_overflow}/{st.retried_saturated}/"
                  f"{st.retried_inexact_rank} queries_per_s="
                  f"{served_qps[tag]:.1f} count_queries_per_s="
                  f"{served_qps['count']:.1f} seconds={mesh_secs[tag]:.4f} "
                  f"rank_equals_single={str(exact).lower()}", flush=True)
            mode = "broadcast" if rmb > BATCH else "routed"
            check(np.array_equal(c, base_counts)
                  and np.array_equal(f, base_first) and exact,
                  f"[{tag}] counts, first_pos and first_rank equal the "
                  f"single-device [count] answers")
            check(st.mode_counts[mode] > 0,
                  f"[{tag}] the planner chose {mode}")
            if cf < 1:
                check(st.retried_overflow > 0,
                      f"[{tag}] dispatch overflows were retried")

        # [mesh:merged] the three appends, then the workload
        mt.planner.routed_min_batch, mt.planner.capacity_factor = 64, 2.0
        append_all("mesh:append", mt)
        t0 = time.perf_counter()
        mmc, mmf = serve("mesh:merged", mt)
        mesh_secs["merged"] = time.perf_counter() - t0
        check(np.array_equal(mmc, merged_counts)
              and np.array_equal(mmf, merged_first),
              "[mesh:merged] counts and first_pos equal [merged]")
        # inputs of the kernel checks below: the merged read's tier stack,
        # the tablets of the uncompacted base, the first batch
        mstack = mt._tierset().stack
        mtablets = mt.planner.tablets()
        mpatt, mplen = mt.planner.encode(patterns[:BATCH])
        mpacked = mt.store.text_packed

        # [mesh:compact] compact() with distributed_build: a full rebuild
        # over the mesh, held against a single-device build
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mver = mt.compact()
        torch.cuda.synchronize()
        mesh_secs["compact"] = time.perf_counter() - t0
        rebuilt = build_suffix_array(torch.from_numpy(text).to(dev))
        mcomp_ok = torch.equal(mt.store.sa[mt.store.pad_count:], rebuilt)
        del rebuilt
        print(f"[mesh:compact] n={len(text)} version={mver} "
              f"distributed_build={str(mt._distributed_build).lower()} "
              f"seconds={mesh_secs['compact']:.4f} merge_seconds="
              f"{merge_s:.4f} sa_equals_single_build="
              f"{str(mcomp_ok).lower()}", flush=True)
        check(mcomp_ok and mver == 1 and mt.mesh is not None,
              "[mesh:compact] the rebuilt SA equals a single-device build "
              "on every row")
        mcc, mcf = serve("mesh:compacted", mt)
        check(np.array_equal(mcc, merged_counts)
              and np.array_equal(mcf, merged_first),
              "[mesh:compacted] counts and first_pos equal [merged]")
        mt.close()
        del mt

        # [mesh-sort-footprint] one super-chunk sort over the 8 tablets of
        # the card against the figure the staged build sizes it by
        from repro_torch.api.catalog import Catalog
        from repro_torch.core.dsa import make_superchunk_sorter
        from repro_torch.launch.mesh import table_mesh
        smesh = table_mesh(dev)
        msort = make_superchunk_sorter(smesh)
        mfoot = {}
        for f_rows in MESH_FOOTPRINT_ROWS:
            f_n = f_rows * MESH_TABLETS
            f_rng = np.random.default_rng(f_rows)
            f_idx = np.arange(f_n, dtype=np.int32)
            for f_kind, f_key, f_nxt in (
                    ("random", f_rng.integers(0, f_n, f_n),
                     f_rng.integers(-1, f_n, f_n)),
                    ("ties", f_rng.integers(0, 4, f_n), np.zeros(f_n))):
                f_key, f_nxt = f_key.astype(np.int32), f_nxt.astype(np.int32)
                torch.cuda.synchronize()
                before = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                f_got = msort(f_key, f_nxt, f_idx)
                torch.cuda.synchronize()
                mfoot[(f_rows, f_kind)] = (torch.cuda.max_memory_allocated()
                                           - before)
                check(np.array_equal(f_got[2], f_idx[np.lexsort(
                    (f_idx, f_nxt, f_key))]),
                      f"[mesh-sort-footprint] the {f_kind} super-chunk of "
                      f"{f_rows} rows a tablet is sorted")
        print("[mesh-sort-footprint] tablets=" + str(MESH_TABLETS) + " "
              + " ".join(f"rows_per_tablet={r}:{k}:peak_bytes={v},"
                         f"bytes_per_tablet_row={v / (r * MESH_TABLETS):.4f}"
                         for (r, k), v in mfoot.items())
              + f" model_bytes_per_row={BP.MESH_SORT_BYTES_PER_ROW} "
              f"model_fixed_bytes={BP.MESH_SORT_FIXED_BYTES}", flush=True)
        check(all(v <= MESH_TABLETS * (r * BP.MESH_SORT_BYTES_PER_ROW
                                       + BP.MESH_SORT_FIXED_BYTES)
                  for (r, _), v in mfoot.items()),
              "[mesh-sort-footprint] a super-chunk sort holds no more "
              "device bytes than the staged build sizes it by")
        del f_got, f_key, f_nxt, f_idx

        # [mesh:staged] create(staged=True) under a budget of the card the
        # 8 tablets share: one 8-tablet sample sort per super-chunk of
        # mesh_sort_rows rows a tablet; the build's device peak measured
        small = codec.random_dna(MESH_STAGED_LEN, seed=8)
        mpeaks = []

        def mesh_measured_build(*args, **kw):
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = inner_build(*args, **kw)
            torch.cuda.synchronize()
            mpeaks.append(torch.cuda.max_memory_allocated() - before)
            return out

        table_mod.staged_suffix_array = mesh_measured_build
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mst = SuffixTable.create("mesh_staged", small, root=mroot,
                                     is_dna=True,
                                     max_query_len=MAX_QUERY_LEN,
                                     max_device_bytes=MESH_STAGED_BUDGET)
            torch.cuda.synchronize()
            mesh_secs["staged"] = time.perf_counter() - t0
        finally:
            table_mod.staged_suffix_array = inner_build
        too_small = False
        try:
            SuffixTable.create("mesh_tiny", small, root=mroot,
                               is_dna=True, max_query_len=MAX_QUERY_LEN,
                               max_device_bytes=MESH_TOO_SMALL)
        except ValueError:
            too_small = "mesh_tiny" not in Catalog(mroot)
        sb = mst.stats()["build"]
        tablet_rows = BP.mesh_sort_rows(sb["chunk_rows"],
                                        MESH_STAGED_BUDGET, smesh)
        super_rows = tablet_rows * MESH_TABLETS
        mst_ok = torch.equal(
            mst.store.sa[mst.store.pad_count:],
            build_suffix_array(torch.from_numpy(small).to(dev)))
        print(f"[mesh:staged] n={MESH_STAGED_LEN} tablets="
              f"{mst.planner.num_tablets} rounds={sb['rounds']} "
              f"chunks={sb['n_chunks']}x{sb['chunk_rows']} "
              f"rows_per_tablet={tablet_rows} super_chunk_rows="
              f"{super_rows} runs_per_round="
              f"{-(-MESH_STAGED_LEN // super_rows)} "
              f"seconds={mesh_secs['staged']:.4f} build_seconds="
              f"{sb['elapsed_s']:.4f} measured_peak_bytes={mpeaks[0]} "
              f"max_device_bytes={MESH_STAGED_BUDGET} "
              f"modelled_peak_device_bytes={sb['peak_device_bytes']} "
              f"too_small_refused={str(too_small).lower()} "
              f"sa_equals_in_memory={str(mst_ok).lower()} "
              f"card=\"{smi}\"", flush=True)
        check(mst_ok and sb["mode"] == "staged"
              and mst.planner.num_tablets == MESH_TABLETS,
              "[mesh:staged] the staged mesh build's SA equals the "
              "in-memory build")
        check(mpeaks[0] <= MESH_STAGED_BUDGET,
              "[mesh:staged] the build's measured device peak is within "
              "max_device_bytes on the card the 8 tablets share")
        check(too_small, f"[mesh:staged] max_device_bytes={MESH_TOO_SMALL} "
              f"raised before the catalog named the table")
        mst.close()
        del mst
        torch.cuda.synchronize()
        mesh_launches = dict(_build.LAUNCHES)
        print(f"[mesh-launches] " + " ".join(
            f"{k}={v}" for k, v in mesh_launches.items()), flush=True)
        for k in ("pack2bit", "bounded_search", "pattern_compare",
                  "tier_scan"):
            check(mesh_launches[k] > 0, f"{k} launched on the [mesh] path")

        # each kernel of the mesh path against its plain version on this
        # phase's inputs (outside the counted path)
        e_bs = max(max_abs_err(
            torch, bounded_search_cuda(t.sa, t.text_packed, t.n_real, mpatt,
                                       mplen, int(t.sa.shape[0])),
            Q.search_bounds_plain(t, mpatt, mplen))
            for t in mtablets)
        split = torch.stack([t.sa[0] for t in mtablets])
        Bl = BATCH // MESH_TABLETS
        cargs = (codec.extract_window(mpacked, split, W).repeat(Bl, 1),
                 mpatt[:Bl].repeat_interleave(MESH_TABLETS, 0),
                 mplen[:Bl].repeat_interleave(MESH_TABLETS),
                 split.repeat(Bl))
        e_pc = max_abs_err(
            torch, pattern_compare_cuda(*cargs, n_real=TEXT_LEN),
            ref.pattern_compare_ref(cargs[0].T, cargs[1].T, *cargs[2:],
                                    n_real=TEXT_LEN))
        targs = (mpatt.T.contiguous(), mplen, mstack.text_packed,
                 mstack.sa, mstack.pad_cnt, ops.tier_meta(mstack))
        e_ts = max_abs_err(torch, TS.tier_scan_cuda(*targs),
                           TS.tier_scan_plain(*targs))
        lanes = torch.from_numpy(base).to(dev).to(torch.int64).reshape(
            -1, 16)
        e_pk = max_abs_err(torch, [codec.words_i64(mpacked)],
                           [codec.words_i64(ref.pack2bit_ref(lanes.T))])
        mesh_err = {"bounded_search": e_bs, "pattern_compare": e_pc,
                    "tier_scan": e_ts, "pack2bit": e_pk}
        print(f"[mesh:kernels] " + " ".join(
            f"{k}_max_abs_err={v}" for k, v in mesh_err.items())
            + f" tablets={len(mtablets)} owner_compare_rows="
            f"{int(cargs[0].shape[0])}", flush=True)
        del mtablets, mstack, lanes
    finally:
        os.environ.pop(HOST_DEVICES_ENV, None)
        shutil.rmtree(mroot, ignore_errors=True)
    mesh_secs["total"] = time.perf_counter() - mesh_t0
    print(f"[mesh] " + " ".join(f"{k}_seconds={v:.4f}"
                                for k, v in mesh_secs.items())
          + f" card=\"{smi}\"", flush=True)

    # ------------ [dedup] and [lm]: the LM data path, then the LM -------
    dedup_launches, dedup_err, _ = dedup_phase(np, torch, _build, check,
                                               dev, smi)

    by_path = {"serve": launches, "compact": compact_launches,
               "persist": persist_launches, "long": long_launches,
               "client": client_launches, "serve_cli": serve_launches,
               "staged": staged_launches, "plane": plane_launches,
               "plane_hedged": plane_hedged_launches,
               "mesh": mesh_launches, "dedup": dedup_launches}
    Q.query = search
    print(f"[locate] {json.dumps({p: located[i].tolist() for i, p in enumerate(loc_pats)})}",
          flush=True)
    check(bool((merged_counts >= base_counts).all()),
          "appends never lower a count")

    # brute-force sample over the base text and the whole logical text
    rng = np.random.default_rng(0)
    sample = rng.choice(N_QUERIES, size=16, replace=False)
    ok = True
    for i in sample:
        p = codec.encode_dna(patterns[i])
        want_base = len(brute_positions(np, base, p))
        want_all = len(brute_positions(np, text, p))
        ok &= base_counts[i] == want_base and merged_counts[i] == want_all
    print(f"[brute] patterns=16 match={str(bool(ok)).lower()}", flush=True)
    check(bool(ok), "counts agree with a brute-force scan of the text")
    for i, p in enumerate(loc_pats):
        want = brute_positions(np, text, codec.encode_dna(p))[:5]
        got = located[i][located[i] >= 0]
        check(np.array_equal(got, want), f"locate({p!r}) = smallest positions")

    # [long]: each search kernel against its plain versions at W = 17, 32
    # and 64 on the [long] tables (patterns cut to 16 W bases), and its
    # times and bound at W = 64
    def long_kernels() -> dict:
        """name -> the [long] numbers of that kernel's row."""
        wide = {k: {"wide_max_abs_err": 0} for k in
                ("bounded_search", "tier_scan", "tablet_scan", "fm_scan")}
        lst = ltable.store
        lstack = ltable._tierset().stack
        lmeta = ops.tier_meta(lstack)
        lfa = ftable.fm.arrays
        # tablet_scan's rows: LONG_TABLET_ROWS consecutive sorted rows
        # around the lower bound of the first (cut, so matching) pattern
        _, pp0, pl0 = Q.encode_patterns(long_pats[:1], LONG_QUERY_LEN,
                                        device=dev)
        lb0 = int(Q.search_bounds_plain(lst, pp0, pl0)[0][0]) \
            - lst.pad_count
        t_lo = min(max(lb0 - LONG_TABLET_ROWS // 2, 0),
                   lst.n_real - LONG_TABLET_ROWS)
        r0 = lst.pad_count + t_lo
        lpos = lst.sa[r0:r0 + LONG_TABLET_ROWS]
        lwt = codec.extract_window(lst.text_packed, lpos,
                                   LONG_WIDTHS[-1]).T.contiguous()
        for W in LONG_WIDTHS:
            _, pp, pl = Q.encode_patterns([p[:16 * W] for p in long_pats],
                                          16 * W, device=dev)
            _, fpp, fpl = Q.encode_patterns([p[:16 * W] for p in fpats],
                                            16 * W, device=dev)
            Bw = int(pp.shape[0])
            sargs = (lst.sa, lst.text_packed, lst.n_real, pp, pl, lst.n_pad)
            lb, ub = bounded_search_cuda(*sargs)
            plb, pub = Q.search_bounds_plain(lst, pp, pl)
            e_bs = max(max_abs_err(torch, [lb, ub], [plb, pub]),
                       max_abs_err(torch, bounded_match_cuda(*sargs,
                                                             lst.pad_count),
                                   bounded_match_plain(lst, pp, pl)))
            pt = pp.T.contiguous()
            targs = (pt, pl, lstack.text_packed, lstack.sa, lstack.pad_cnt,
                     lmeta)
            tgot = TS.tier_scan_cuda(*targs)
            e_ts = max_abs_err(torch, tgot, TS.tier_scan_plain(*targs))
            bargs = (pt, pl, lwt[:W], lpos)
            bgot = tablet_scan_cuda(*bargs, n_real=lst.n_real)
            e_tb = max_abs_err(torch, bgot, tablet_scan_plain(
                *bargs, n_real=lst.n_real))
            fgot = FM.fm_scan_cuda(fpp, fpl, lfa.bwt, lfa.occ, lfa.meta)
            e_fm = max_abs_err(torch, fgot, FM.backward_search(lfa, fpp, fpl))
            for k, e in (("bounded_search", e_bs), ("tier_scan", e_ts),
                         ("tablet_scan", e_tb), ("fm_scan", e_fm)):
                wide[k]["wide_max_abs_err"] = max(
                    wide[k]["wide_max_abs_err"], e)
            print(f"[long:W={W}] max_len={16 * W} bounded_search_err={e_bs} "
                  f"tier_scan_err={e_ts} tablet_scan_err={e_tb} "
                  f"fm_scan_err={e_fm} found={int((ub > lb).sum())} "
                  f"tier_matches={int(tgot[2].sum())} "
                  f"tablet_found={int((bgot[0] > 0).sum())} "
                  f"fm_found={int((fgot[1] > fgot[0]).sum())}", flush=True)
            if W != LONG_WIDTHS[-1]:
                continue
            # bounds at W = 64, counted as the W = 8 rows' are
            bin_trace = []
            bounded_search_plain(*sargs, trace=bin_trace, arity=2)
            m = match_traffic(torch, kary, codec, lst, pp, pl, lb, bin_trace)
            bin_traces = []
            TS.tier_scan_plain(*targs, trace=bin_traces, arity=2)
            t_bytes, _, _, t_words = tier_traffic(
                torch, bin_traces, lstack.sa, lstack.text_packed,
                *tier_runs(torch, TS, lstack, tgot))
            tb_trace = []
            tablet_scan_plain(*bargs, n_real=lst.n_real, trace=tb_trace,
                              arity=2)
            b_bytes, _, _, b_words = tablet_traffic(torch, tb_trace)
            f_ranks, f_words, _, _ = fm_traffic(
                torch, FM, lfa, FM.syms_from_packed(fpp, fpl, 16 * W))
            u = used_words(torch, pl)
            for k, fn, reps, nb, no in (
                    ("bounded_search",
                     lambda: bounded_match_cuda(*sargs, lst.pad_count), 20,
                     m["bytes"], m["ops"]),
                    ("tier_scan", lambda: TS.tier_scan_cuda(*targs), 50,
                     t_bytes + tier_fixed(torch, lstack, pl), 4 * t_words),
                    ("tablet_scan",
                     lambda: tablet_scan_cuda(*bargs, n_real=lst.n_real), 50,
                     b_bytes + 4 * u + 4 * Bw + 12 * Bw, 4 * b_words),
                    ("fm_scan",
                     lambda: FM.fm_scan_cuda(fpp, fpl, lfa.bwt, lfa.occ,
                                             lfa.meta), 50,
                     4 * f_ranks + 4 * f_words + Bw * W * 4 + Bw * 4
                     + 2 * Bw * 4 + 32, 9 * f_words)):
                b, by = bound_ms(nb, no)
                wide[k].update({f"w{W}_{key}": v
                                for key, v in times(fn, reps).items()},
                               **{f"w{W}_bound_ms": b, f"w{W}_bound_by": by})
                print(f"[long:kernel] {k} W={W} " + " ".join(
                    f"{key}={v:.6g}" if isinstance(v, float) else f"{key}={v}"
                    for key, v in wide[k].items()), flush=True)
        return wide

    # the rows gain every path's launches and, for a search kernel, its
    # [long] numbers: the largest error at W = 17, 32 and 64, folded into
    # max_abs_err, and its W = 64 times and bound.  ``ms_after_phases``
    # times each W = 8 call as issued once more, with the later phases'
    # state in the process
    wide = long_kernels()
    for r, (counted, kernel, reps) in zip(rows, timed):
        long = wide.get(r["name"], {})
        r["max_abs_err"] = max(r["max_abs_err"],
                               long.get("wide_max_abs_err", 0),
                               mesh_err.get(r["name"], 0),
                               dedup_err.get(r["name"], 0))
        # pattern_compare's launches: fused epilogues plus the standalone
        # compare (the mesh's routed owner choice; 0 on the other paths)
        r.update(long, launches_by_path={
            k: v[counted] + (v["pattern_compare"]
                             if r["name"] == "pattern_compare" else 0)
            for k, v in by_path.items()},
            mesh_max_abs_err=mesh_err.get(r["name"]),
            dedup_max_abs_err=dedup_err.get(r["name"]),
            ms_after_phases=cuda_ms(torch, kernel, reps))
        check(r["max_abs_err"] == 0,
              f"{r['name']} equals its plain version at every width")
    print(f"[after-phases] threads={threading.active_count()} " + " ".join(
        f"{r['name']}:ms={r['ms']:.6f},ms_after_phases="
        f"{r['ms_after_phases']:.6f}" for r in rows), flush=True)
    for r in rows:
        if "w64_device_ms" in r:
            print(f"[width] {r['name']} " + " ".join(
                f"{w}:ms={r[p + 'ms']:.6f},device_ms={r[p + 'device_ms']:.6f},"
                f"cold_ms={r[p + 'cold_ms']:.6f},bound_ms="
                f"{r[p + 'bound_ms']:.3g}"
                for w, p in (("W=8", ""), ("W=64", "w64_"))), flush=True)
    print("[kernels] " + " ".join(
        f"{r['name']}:launches={r['launches']},staged="
        f"{r['launches_by_path']['staged']},plane="
        f"{r['launches_by_path']['plane']},mesh="
        f"{r['launches_by_path']['mesh']},dedup="
        f"{r['launches_by_path']['dedup']},match="
        f"{str(r['max_abs_err'] == 0).lower()}" for r in rows), flush=True)
    return rows, max(peak_before_staged, torch.cuda.max_memory_allocated())


if __name__ == "__main__":
    sys.exit(main())
