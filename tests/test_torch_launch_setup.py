"""Kernel launch setup on every card: a source check of ``kernels/csrc/``.

``cudaFuncSetAttribute(..., cudaFuncAttributeMaxDynamicSharedMemorySize,
...)`` sets state of the current device.  A launcher that set it behind a
process-wide flag configured only the first card it ran on, so its first
launch on a second card above 48 KB of dynamic shared memory failed.
Every launcher that raises the limit now sets it on every call, with no
flag, once-flag or atomic in front of it.

The launches on several cards are held on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``'s four-card phase).
"""
import pathlib
import re

import pytest

CSRC = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        / "kernels" / "csrc")
# the launchers that raise their kernels' dynamic shared-memory limit
LAUNCHERS = ("flash_attention.cu", "flash_attention_bwd.cu",
             "flash_decode.cu", "rglru_scan.cu", "rglru_scan_bwd.cu",
             "rwkv6_scan.cu", "rwkv6_scan_bwd.cu")
SET = "cudaFuncSetAttribute("


def _sources():
    return {p.name: p.read_text()
            for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))}


def test_no_launcher_keeps_its_shared_memory_setup_per_process():
    srcs = _sources()
    assert set(LAUNCHERS) <= set(srcs)
    flags = {name: re.findall(r"static\s+(?:bool|int|unsigned|std::atomic|"
                              r"std::once_flag)\b[^;]*;|std::call_once",
                              text)
             for name, text in srcs.items()}
    assert {k: v for k, v in flags.items() if v} == {}
    assert {name for name, text in srcs.items() if SET in text} == set(
        LAUNCHERS)


@pytest.mark.parametrize("name", LAUNCHERS)
def test_launcher_sets_its_shared_memory_limit_on_every_call(name):
    """Each call of the attribute is a statement of its launcher on every
    launch: nothing in the lines before it guards it."""
    lines = _sources()[name].splitlines()
    at = [i for i, line in enumerate(lines) if SET in line]
    assert at, name
    for i in at:
        assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in " ".join(
            lines[i:i + 2]), (name, i + 1)
        before = "\n".join(lines[max(0, i - 8):i])
        assert not re.search(r"\bstatic\b|\bif \(!|configured|once",
                             before), (name, i + 1, before)
