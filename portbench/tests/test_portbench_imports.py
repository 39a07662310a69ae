"""Nothing the harness loads is JAX's or the JAX package's: every module
of the benchmark but its tests, imported in a fresh process, leaves no
module whose top-level name, compared whole, is ``jax``, ``jaxlib``,
``flax`` or ``repro`` -- while ``repro_torch``, whose name begins with
``repro``, is there."""
import json
import os
import subprocess
import sys

from .cells import ROOT

PROBE = r"""
import importlib, json, pkgutil, sys
sys.path[:0] = [{root!r}, {src!r}]
import portbench
from portbench import harness
names = []
for info in pkgutil.walk_packages(portbench.__path__, "portbench."):
    if ".tests" not in info.name:
        importlib.import_module(info.name)
        names.append(info.name)
base = harness.HERE
for sub in ("metrics", "systems", "reference"):
    for path in sorted((base / sub).glob("*.py")):
        harness.load_module(path, f"portbench.{{sub}}.{{path.stem}}")
        names.append(path.name)
tops = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps({{"imported": names, "tops": tops}}))
"""


def test_no_jax_or_jax_package_is_loaded():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(root=str(ROOT),
                                            src=str(ROOT / "src"))],
        capture_output=True, text=True, env=env, timeout=240, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert "portbench.harness" in res["imported"]
    assert "lm_spmd.py" in res["imported"] and "mfu.prefill.py" in \
        res["imported"]
    assert "repro_torch" in res["tops"]
    assert not {"jax", "jaxlib", "flax", "repro"} & set(res["tops"])
