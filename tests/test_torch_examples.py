"""The port's example scripts (``examples/*_torch.py``) against the JAX
package's (``examples/*.py``), run in the process on the CPU: the same
printed lines, except those that hold a wall time or a temporary path.
The service's latencies are seeded numpy draws, so the Table III/IV/V
and hedged statistics are equal too."""
import contextlib
import io
import os
import re
import runpy
import sys
import tempfile

import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")
SECONDS = re.compile(r"\b\d+(\.\d+)?s\b")


def _run(path, argv):
    """Runs a script as ``__main__`` with ``argv``; what it printed."""
    out = io.StringIO()
    old = sys.argv
    sys.argv = [path] + list(argv)
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_path(path, run_name="__main__")
    finally:
        sys.argv = old
    return out.getvalue()


def _call_main(name, argv):
    """Loads ``examples/<name>`` and calls its ``main(argv)``;
    (stdout, what main returned)."""
    g = runpy.run_path(os.path.join(EXAMPLES, name), run_name="example")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ret = g["main"](argv)
    return out.getvalue(), ret


def _stable(text, tmp):
    """The lines that hold neither a temporary path nor a time in
    seconds."""
    return [ln for ln in text.splitlines()
            if str(tmp) not in ln and not SECONDS.search(ln)]


@pytest.fixture
def tmp_root(tmp_path, monkeypatch):
    """Every ``tempfile.mkdtemp`` of a script lands under ``tmp_path``."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    return tmp_path


@pytest.mark.parametrize("name, argv", [
    ("quickstart", []),
    ("corpus_dedup", []),
    ("dna_search", ["--text-len", "20000", "--queries", "500"]),
])
def test_script_prints_the_reference_lines(tmp_root, name, argv):
    ref_out = _run(os.path.join(EXAMPLES, f"{name}.py"), argv)
    out, figures = _call_main(f"{name}_torch.py", argv + ["--device", "cpu"])
    want, got = _stable(ref_out, tmp_root), _stable(out, tmp_root)
    assert len(got) >= 5 and got == want
    dropped = len(out.splitlines()) - len(got)
    assert dropped == len(ref_out.splitlines()) - len(want) <= 1
    assert isinstance(figures, dict) and figures


def test_dna_search_figures_are_the_printed_ones(tmp_root):
    out, f = _call_main("dna_search_torch.py",
                        ["--device", "cpu", "--text-len", "20000",
                         "--queries", "500"])
    assert f["table_iii"]["n"] == f["table_iv"]["n"] == 500
    assert f"hit={f['table_iv']['hit_rate']:.3f}" in out
    assert f"max={f['hedged']['max_ms']:.0f}ms" in out
    assert f["hedged"]["max_ms"] < f["table_iv"]["max_ms"]
    s = f["stream"]
    assert len(s["probe"]) == 3
    assert s["first_page"] == min(100, s["count"]) < s["count"]
    assert s["first_page"] + s["resumed"] == s["count"]
    assert f["append"]["after"] == f["append"]["before"] + 1
    assert f["compact"]["reopened_count"] == f["append"]["after"]
    assert f["compact"]["bases"] == 20000 + 507
    assert f["ingest"]["disk_bytes"] > 0
    assert f["ingest"]["device_peak_bytes"] is None


@pytest.mark.parametrize("text_len, probe_len", [
    (20_000, 3), (300_000, 3), (409_600, 3), (409_601, 4),
    (248_956_422, 8)])
def test_stream_probe_len_keeps_the_stream_short(text_len, probe_len):
    g = runpy.run_path(os.path.join(EXAMPLES, "dna_search_torch.py"),
                       run_name="example")
    assert g["stream_probe_len"](text_len) == probe_len
    # its expected positions fit in the page budget; one base shorter
    # would not (past the reference's 3 bases)
    budget = g["STREAM_MAX_PAGES"] * g["PAGE_SIZE"]
    assert text_len / 4**probe_len <= budget
    assert probe_len == 3 or text_len / 4**(probe_len - 1) > budget


def test_serve_queries_hands_the_reference_argv(monkeypatch):
    import repro.launch.serve as j_serve
    import repro_torch.launch.serve as t_serve
    calls = []
    monkeypatch.setattr(j_serve, "main", lambda argv: calls.append(argv))
    monkeypatch.setattr(t_serve, "main", lambda argv: calls.append(argv))
    _run(os.path.join(EXAMPLES, "serve_queries.py"), [])
    g = runpy.run_path(os.path.join(EXAMPLES, "serve_queries_torch.py"),
                       run_name="example")
    g["main"](["--device", "cpu"])
    g["main"]([])
    ref, cpu, default = calls
    assert cpu == ref + ["--device", "cpu"]
    assert default == ref + ["--device", "cuda"]


@pytest.mark.parametrize("name", ["quickstart_torch.py",
                                  "corpus_dedup_torch.py",
                                  "dna_search_torch.py"])
def test_scripts_default_to_cuda(tmp_root, name):
    if torch.cuda.is_available():
        from repro_torch.device import resolve_device
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _call_main(name, [])
    assert not os.listdir(tmp_root)        # raised before making a root
