"""``python -m repro_torch.launch.serve`` with ``--device cpu`` at
``tests/test_serve.py``'s TINY sizes, beside ``repro.launch.serve`` on
the same seed: the printed result lines must be equal, and the port's
flags (reopen, ``--no-wal``, the ``--max-pattern`` clamp, ``--freeze``,
``--dump-stats`` on a feed the port wrote) must behave as the
reference's."""
import ast
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro.api import SuffixTable as RTable  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro_torch.api import SuffixTable  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

TINY = ["--text-len", "1500", "--queries", "120", "--batch", "48",
        "--max-pattern", "12", "--top-k", "2", "--page-size", "16",
        "--coalesce-window", "0.5"]
CPU = ["--device", "cpu"]
# result lines that depend on nothing but the seed, the text and the
# workload (timings, dispatch counts and the planner's pad_slots differ)
SAME = ("[single]", "[hedged]", "[locate]", "[stream]", "[write ]",
        "[table ]", "[tiers ]")


def _lines(out, prefixes=SAME):
    return [ln for ln in out.splitlines() if ln.startswith(prefixes)]


def _run(main, args, capsys):
    main(args)
    return capsys.readouterr().out


def test_serve_in_memory_lines_match_reference(capsys):
    out = _run(serve.main, TINY + CPU, capsys)
    want = _run(ref_serve.main, TINY, capsys)
    assert "[build]" in out and "[open ]" not in out
    assert "[client]" in out and "dispatch(es)" in out
    assert "[wal   ] disabled" in out
    assert len(_lines(out)) == 9 and _lines(out) == _lines(want)
    line = next(ln for ln in out.splitlines() if ln.startswith("[stream]"))
    n_pos = int(line.split(":")[1].split()[0])
    assert n_pos == int(line.split("one-shot count")[1].strip(" )\n"))
    plan = next(ln for ln in out.splitlines() if ln.startswith("[plan  ]"))
    assert "pad_slots=0 " in plan and "retried=0/0/0" in plan
    for line in out.splitlines():     # locate rows: ascending positions
        if line.startswith("[locate]") and "first_" in line:
            row = ast.literal_eval(line.split("=", 2)[-1].strip())
            assert row == sorted(row) and all(x >= 0 for x in row)


def test_serve_create_then_reopen_honors_flags(tmp_path, capsys):
    """create, then reopen with --capacity-factor (no rebuild), then a
    crash after an unflushed append: the reopen replays it from the
    commit log; every run's result lines equal the reference's."""
    args = TINY + ["--table", "t1", "--aux-table", "t2",
                   "--memtable-limit", "600", "--max-runs", "2",
                   "--group-commit-ms", "1.0"]
    root, rroot = str(tmp_path / "port"), str(tmp_path / "ref")
    first = _run(serve.main, args + CPU + ["--root", root], capsys)
    assert "[build]" in first and "[wal   ] seq=" in first
    assert os.path.isdir(os.path.join(root, "t1", "wal"))
    assert _lines(first) == _lines(
        _run(ref_serve.main, args + ["--root", rroot], capsys))
    again = args + ["--capacity-factor", "1.5"]
    second = _run(serve.main, again + CPU + ["--root", root], capsys)
    assert "[open ]" in second and "[build]" not in second
    assert "(no rebuild, cf=1.5)" in second
    assert "[tiers ]" in second and "[wal   ] seq=" in second
    assert _lines(second) == _lines(
        _run(ref_serve.main, again + ["--root", rroot], capsys))
    # both write demos landed durably; the reference opens the port's table
    assert len(RTable.open("t1", root=root)) == 1500 + 2 * (21 + 993)
    t = SuffixTable.open("t1", root=root, device="cpu")
    t.append("ACGTTGCA" * 4)           # acked by the log, never flushed
    del t
    third = _run(serve.main, args + CPU + ["--root", root], capsys)
    assert "[wal  ] recovered: replayed=1 skipped=0 torn_bytes=0" in third
    assert f"[open ] v3, {1500 + 2 * (21 + 993) + 32} bases" in third


def test_serve_no_wal_flag(tmp_path, capsys):
    root = str(tmp_path / "root")
    out = _run(serve.main, TINY + CPU + ["--root", root, "--no-wal"],
               capsys)
    assert "[wal   ] disabled" in out
    assert not os.path.exists(os.path.join(root, "dna_serve", "wal"))


def test_serve_clamps_max_pattern(capsys):
    out = _run(serve.main, TINY + CPU + ["--max-pattern", "4096"], capsys)
    assert "[clamp ]" in out and "-> 128" in out


def test_serve_freeze_flags_and_bytes_line(tmp_path, capsys):
    """--freeze serves the workload through the frozen FM tier with the
    live run's answers; --fm-threshold persists across a reopen."""
    live = _lines(_run(serve.main, TINY + CPU, capsys))
    out = _run(serve.main, TINY + CPU + ["--freeze"], capsys)
    assert "[freeze]" in out
    bl = next(ln for ln in out.splitlines() if ln.startswith("[bytes ]"))
    assert "frozen=True" in bl and "base_sa=0" in bl
    assert int(bl.split("fm=")[1].split()[0]) > 0
    assert "'fm':" in out
    assert _lines(out) == live
    root = str(tmp_path / "root")
    args = TINY + CPU + ["--root", root, "--fm-threshold", "1000"]
    first = _run(serve.main, args, capsys)
    assert "[build]" in first and "frozen=True" in first
    assert os.path.isdir(os.path.join(root, "dna_serve", "fm"))
    second = _run(serve.main, args, capsys)
    assert "[open ]" in second and "frozen=True" in second


def test_serve_dump_stats_reads_the_ports_feed(tmp_path, capsys):
    """--dump-stats aggregates the feed the port's table wrote, prints
    what the reference's --dump-stats prints for it, and imports no
    torch."""
    root = str(tmp_path / "root")
    _run(serve.main, TINY + CPU + ["--root", root, "--metrics-interval",
                                   "0"], capsys)
    dump = ["--root", root, "--table", "dna_serve", "--dump-stats"]
    varz = _run(serve.main, dump, capsys)
    assert "[varz  ] table=dna_serve" in varz and "tables=1" in varz
    assert "[varz  ] table-proc dna_serve" in varz
    assert "queries=" in varz and "frozen=False" in varz
    assert varz == _run(ref_serve.main, dump, capsys)
    code = ("import sys\n"
            "for m in ('torch', 'numpy', 'jax', 'repro'):\n"
            "    sys.modules[m] = None\n"
            "from repro_torch.launch import serve\n"
            f"serve.main({dump!r})\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout == varz


def test_serve_dump_stats_needs_root(capsys):
    out = _run(serve.main, ["--dump-stats"], capsys)
    assert "--dump-stats needs --root" in out


def test_serve_rejects_what_is_not_ported(capsys):
    with pytest.raises(SystemExit):
        serve.main(["--queries", "not-a-number"])
    with pytest.raises(SystemExit):                # XLA-only, not carried
        serve.main(TINY + CPU + ["--host-devices", "2"])
    with pytest.raises(NotImplementedError, match="serving plane"):
        serve.main(TINY + CPU + ["--tablets", "2"])
