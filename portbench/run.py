"""One run of one cell of the port's benchmark, on the card(s) of this
machine:

    python3 portbench/run.py --workload resnet50-offline-b128 --seed 7 \
        --seconds 30 --trace 0

Prints the result as one JSON object on the last line of standard output
(see ``harness.py``), each compared number beside its limit as the last
lines of standard error.  Exits with a code other than 0, and prints no
result, without enough CUDA devices, without the program beside it, or
where JAX or the JAX package was loaded.
"""
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    # every build and kernel cache of the program inside the checkout
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["USE_FLAX"] = "0"
    from portbench import harness
    return harness.main(argv, root=ROOT)


if __name__ == "__main__":
    sys.exit(main())
