"""The port stands alone: it imports neither jax nor any module of the
JAX package, and its entry points run on the card unless told otherwise."""
import ast
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "src", "repro_torch")


def _modules():
    out = []
    for root, _dirs, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f),
                                      os.path.join(REPO, "src"))
                mod = rel[:-3].replace(os.sep, ".")
                out.append(mod[:-len(".__init__")]
                           if mod.endswith(".__init__") else mod)
    return sorted(out)


def _imported_names(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_every_module_imports_with_jax_blocked():
    mods = _modules()
    assert "repro_torch.api.table" in mods and len(mods) >= 15
    for m in ("repro_torch.core.dsa", "repro_torch.core.dsort",
              "repro_torch.distributed.collectives",
              "repro_torch.distributed.sharding",
              "repro_torch.launch.mesh", "repro_torch.core.dedup",
              "repro_torch.data", "repro_torch.data.pipeline",
              "repro_torch.tree", "repro_torch.models",
              "repro_torch.models.config", "repro_torch.models.layers",
              "repro_torch.models.transformer", "repro_torch.models.convert",
              "repro_torch.models.moe", "repro_torch.models.ssm",
              "repro_torch.configs", "repro_torch.configs.qwen3_0_6b",
              "repro_torch.configs.dna_suffix", "repro_torch.training",
              "repro_torch.training.optimizer",
              "repro_torch.training.train_step",
              "repro_torch.launch.train", "repro_torch.launch.dryrun",
              "repro_torch.launch.roofline",
              "repro_torch.checkpoint.manager"):
        assert m in mods, m
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "assert not any(k == 'jax' or k.startswith('jax.') "
            "for k, v in sys.modules.items() if v is not None)\n"
            "print('ok')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "ok"


def test_plane_modules_import_with_torch_blocked():
    """The plane's worker contract, the reference's: the rpc, router,
    plane and tablet-server modules run on numpy alone, so a worker
    starts without the accelerator runtime."""
    mods = [f"repro_torch.serving.{m}"
            for m in ("rpc", "router", "plane", "tablet_server")]
    code = ("import sys\n"
            "for m in ('torch', 'jax', 'repro'):\n"
            "    sys.modules[m] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "from repro_torch.serving import ServingPlane, connect\n"
            "assert not any(k == 'torch' or k.startswith('torch.') "
            "for k, v in sys.modules.items() if v is not None)\n"
            "print('ok')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize("path", sorted([
    *[os.path.join(r, f) for r, _d, fs in os.walk(PKG) for f in fs
      if f.endswith(".py")],
    os.path.join(REPO, "chip_smoke.py"),
    *[os.path.join(REPO, "examples", f)
      for f in os.listdir(os.path.join(REPO, "examples"))
      if f.endswith("_torch.py")],
]), ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_repro_import(path):
    for name in _imported_names(path):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "repro"), (path, name)


def test_entry_points_default_to_cuda():
    from repro_torch.api import SuffixTable
    from repro_torch.core.tablet import build_tablet_store
    from repro_torch.device import resolve_device
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import dedup_token_pool
    from repro_torch.models import init_params
    from repro_torch.training import OptConfig, train_state_init
    np = __import__("numpy")
    cfg = get_config("qwen3-0.6b").reduced()
    for build in (lambda: SuffixTable.from_codes("ACGTACGT"),
                  lambda: build_tablet_store(np.zeros(8, "uint8")),
                  lambda: resolve_device("cuda"),
                  lambda: dedup_token_pool(np.arange(8), np.zeros(8, int),
                                           4),
                  lambda: init_params(cfg),
                  lambda: train_state_init(cfg, OptConfig())):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    assert resolve_device("cpu").type == "cpu"
