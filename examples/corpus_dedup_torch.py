"""LM-pipeline integration of the PyTorch port: suffix-array dedup and
contamination search over a token corpus, as ``examples/corpus_dedup.py``
does with the JAX package — the paper's scan engine as training-data
infrastructure, served from a named table behind a
``repro_torch.api.Database`` handle.  Contamination checks go through the
table's merged read path, so tokens appended after the build are searched
too; the eval-leak lookup at the end rides a typed raw-codes ``Query``
through the client.

    PYTHONPATH=src python examples/corpus_dedup_torch.py [--device cpu]
"""
import argparse
import tempfile

import numpy as np

from repro_torch.api import Database, Query
from repro_torch.core import dedup
from repro_torch.device import resolve_device


def main(argv=None) -> dict:
    """Runs the dedup demo under a fresh root; returns the figures it
    prints."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)

    # a document pool with planted duplication and eval contamination
    docs = [rng.integers(0, 32000, 400).astype(np.int32) for _ in range(8)]
    docs[5] = docs[1].copy()                     # exact duplicate document
    eval_window = docs[3][100:140].copy()        # eval n-gram leaked in train

    tokens = np.concatenate(docs)
    doc_ids = np.repeat(np.arange(len(docs)), 400)

    db = Database(tempfile.mkdtemp(prefix="repro_torch_tables_"),
                  device=dev)
    table = db.create_table("train_tokens", tokens, is_dna=False,
                            max_query_len=64)
    print(f"database {db.root}: {db.list_tables()}")

    scores = dedup.doc_dup_scores(table, doc_ids, min_len=48)
    keep = dedup.filter_duplicate_docs(table, doc_ids, min_len=48)
    print("per-document duplicated fraction:")
    for i, (s, k) in enumerate(zip(scores, keep)):
        print(f"  doc {i}: dup={s:.2f} keep={bool(k)}")
    assert not (keep[1] and keep[5]), "one of the duplicate pair must drop"

    hits = dedup.contamination_check(table, eval_window[None, :])
    print(f"eval window contaminated: {bool(hits[0])} (expected True)")
    clean = dedup.contamination_check(
        table, rng.integers(32000, 64000, 40).astype(np.int32)[None, :])
    print(f"random window contaminated: {bool(clean[0])} (expected False)")

    # the same leak lookup as a typed raw-codes client query: token tables
    # take int32 code rows padded to the table's query cap, plus row lengths
    w = np.zeros((1, table.max_query_len), np.int32)
    w[0, :eval_window.size] = eval_window
    res = db.query(Query(table="train_tokens", kind="count", codes=w,
                         lens=np.array([eval_window.size], np.int32)))
    leak_count = int(res.value[0])
    print(f"typed Query count of the leaked window: {leak_count}")
    assert leak_count >= 1

    # a late-arriving training shard: append is searched without a rebuild
    late_window = rng.integers(0, 32000, 40).astype(np.int32)
    assert not dedup.contamination_check(table, late_window[None, :])[0]
    table.append(late_window)
    assert dedup.contamination_check(table, late_window[None, :])[0]
    print("appended shard visible to contamination search (merged read)")
    db.close()
    return {"scores": [float(s) for s in scores],
            "keep": [bool(k) for k in keep], "eval_hit": bool(hits[0]),
            "random_hit": bool(clean[0]), "leak_count": leak_count}


if __name__ == "__main__":
    main()
