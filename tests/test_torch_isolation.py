"""``repro_torch`` stands alone: it imports torch, never jax, and nothing
of the JAX package ``repro`` -- not even its jax-free modules."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

PKG = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_imports_jax_or_repro():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 20
    bad = [(str(f.relative_to(PKG)), mod) for f in files
           for mod in _imported_modules(f)
           if mod.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []
    text = [(f.name, line) for f in files
            for line in f.read_text().splitlines()
            if line.strip().startswith(("import jax", "from jax",
                                        "import repro ", "from repro "))
            or line.strip().startswith(("import repro.", "from repro."))]
    assert text == []


def test_serve_import_loads_neither_jax_nor_repro():
    code = ("import sys, repro_torch.launch.serve; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(PKG.parent))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_decode_engine_import_loads_neither_jax_nor_repro():
    code = ("import sys, repro_torch.decode.engine; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(PKG.parent))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("module", ["repro_torch.runtime",
                                    "repro_torch.fleet",
                                    "repro_torch.checkpoint"])
def test_fault_tolerance_tiers_load_neither_jax_nor_repro(module):
    code = (f"import sys, {module}; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(PKG.parent))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("call", ["scaled_dot_product_attention", "_int_mm",
                                  "torch.compile"])
def test_no_source_calls_a_library_kernel(call):
    """The port's kernels are its own: no module calls SDPA,
    ``torch._int_mm`` or ``torch.compile`` (``chip_smoke.py`` times the
    first two beside the kernels as yardsticks, outside the package)."""
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 20
    assert [f.name for f in files if call in f.read_text()] == []


@pytest.mark.parametrize("module", ["repro_torch.models.whisper",
                                    "repro_torch.launch.cuda_reporter",
                                    "repro_torch.launch.profile_serve"])
def test_encdec_and_reporter_load_neither_jax_nor_repro(module):
    code = (f"import sys, {module}; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(PKG.parent))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_imports_neither_jax_nor_repro():
    path = PKG.parents[1] / "chip_smoke.py"
    mods = list(_imported_modules(path))
    assert "repro_torch.models" in mods
    assert [m for m in mods
            if m.split(".")[0] in ("jax", "jaxlib", "repro")] == []


@pytest.mark.parametrize("module", ["repro_torch.data",
                                    "repro_torch.optim",
                                    "repro_torch.launch.steps",
                                    "repro_torch.launch.train",
                                    "repro_torch.models.rwkv6",
                                    "repro_torch.models.rglru"])
def test_training_path_loads_neither_jax_nor_repro(module):
    code = (f"import sys, {module}; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(PKG.parent))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("module", ["repro_torch.launch.dryrun",
                                    "repro_torch.launch.sharding",
                                    "repro_torch.launch.mesh",
                                    "repro_torch.configs"])
def test_dryrun_loads_neither_jax_nor_repro(module):
    code = (f"import sys, {module}; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(PKG.parent))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
