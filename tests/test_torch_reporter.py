"""The card's segment memory reporter (``launch/cuda_reporter.py``) against
the reference's XLA one (``repro/launch/xla_reporter.py``).

Without a card the measurement itself cannot run here: the depth-to-block
mapping is compared directly, the CPU refusal is pinned, and the refine
arithmetic is compared with both reporters' measurement steps replaced by
the same fixed bytes per block count (the reference's by a stand-in for
``jax.jit`` whose compiled memory analysis reports those bytes).  The
measurement on the card is ``tests/test_torch_cuda.py``'s.
"""
import dataclasses
import functools
import types

import jax
import pytest

torch = pytest.importorskip("torch")

from repro import api as jfront
from repro import configs as jconfigs
from repro.core.refine import refine_cuts as jrefine_cuts
from repro.launch import xla_reporter as jxla
from repro.models import lm_graph as jlm_graph
from repro_torch import api as tfront
from repro_torch import configs as tconfigs
from repro_torch.core.refine import refine_cuts as trefine_cuts
from repro_torch.launch.cuda_reporter import CudaSegmentReporter
from repro_torch.models import lm_graph as tlm_graph

ARCH = "qwen3-1.7b"
# the smoke config at 12 layers and a vocab of 1024: the embedding weighs
# about 1.6 blocks, so the balanced cuts give the stages 1, 4, 4 and 3
# blocks and a budget of 3 blocks' bytes makes two of them spill
LAYERS = 12
VOCAB = 1024
SEQ = 32
OVERHEAD = 300_000          # the stand-in's bytes of input and activations


def _configs(layers=None):
    j = jconfigs.get(ARCH).smoke_config()
    t = tconfigs.get(ARCH).smoke_config()
    if layers is not None:
        j = dataclasses.replace(j, n_layers=layers, vocab=VOCAB)
        t = dataclasses.replace(t, n_layers=layers, vocab=VOCAB)
    return j, t


def _graphs(layers=LAYERS):
    jcfg, tcfg = _configs(layers)
    return (jcfg, tcfg, jlm_graph.lm_layer_graph(jcfg, seq_len=SEQ),
            tlm_graph.lm_layer_graph(tcfg, seq_len=SEQ))


@functools.lru_cache(maxsize=None)
def _per_block():
    """A block's weight bytes in the graph (what the card measures per
    block, as the refiner's multi-step moves assume)."""
    return _graphs()[3].nodes["block_0"].weight_bytes


def _bytes(n_blocks):
    """The stand-in measurement of ``n_blocks`` blocks."""
    return n_blocks * _per_block() + OVERHEAD


def _fake_jit(_fn):
    """``jax.jit`` as the reference reporter calls it, whose compiled
    memory analysis reports :func:`_bytes` of the stacked blocks' count."""
    def lower(blocks, _x):
        n = jax.tree.leaves(blocks)[0].shape[0]
        mem = types.SimpleNamespace(argument_size_in_bytes=_bytes(n),
                                    output_size_in_bytes=0,
                                    temp_size_in_bytes=0)
        compiled = types.SimpleNamespace(memory_analysis=lambda: mem)
        return types.SimpleNamespace(compile=lambda: compiled)
    return types.SimpleNamespace(lower=lower)


@pytest.fixture
def fixed_bytes(monkeypatch):
    """Both reporters' measurement steps replaced by :func:`_bytes`; the
    port's records each block count it was asked for."""
    monkeypatch.setattr(jxla, "jax", types.SimpleNamespace(
        jit=_fake_jit, eval_shape=jax.eval_shape,
        ShapeDtypeStruct=jax.ShapeDtypeStruct, lax=jax.lax))
    asked = []

    def measure(self, n_blocks):
        asked.append(n_blocks)
        return _bytes(n_blocks)

    monkeypatch.setattr(CudaSegmentReporter, "_measure", measure)
    return asked


def test_block_range_matches_reference_for_every_range():
    jcfg, tcfg, jg, tg = _graphs(layers=None)     # the smoke graph
    jrep = jxla.XlaSegmentReporter(jcfg, jg, 1 << 30, seq=SEQ)
    trep = CudaSegmentReporter(tcfg, tg, 1 << 30, seq=SEQ, device="cpu")
    n = len(tg.levels())
    pairs = [(lo, hi) for lo in range(n) for hi in range(lo, n)]
    assert [trep._block_range(*p) for p in pairs] == \
        [jrep._block_range(*p) for p in pairs]
    assert trep._block_range(0, 0) == (0, 0)                # embed only
    assert trep._block_range(0, n - 1) == (0, tcfg.n_layers)
    assert [trep.depth_bytes(d) for d in range(n)] == \
        [jrep.depth_bytes(d) for d in range(n)]
    assert trep.compilations == 0


def test_segment_report_raises_on_the_cpu():
    _, tcfg, _, tg = _graphs()
    rep = CudaSegmentReporter(tcfg, tg, 1 << 30, seq=SEQ, device="cpu")
    with pytest.raises(ValueError, match="measures on the card"):
        rep.segment_report(1, 3)
    assert rep.compilations == 0


def test_refuses_a_family_without_block_nodes():
    cfg = tconfigs.get("rwkv6-1.6b").smoke_config()
    g = tlm_graph.lm_layer_graph(cfg, seq_len=SEQ)
    with pytest.raises(ValueError, match="repro_torch.models.api"):
        CudaSegmentReporter(cfg, g, 1 << 30)


def test_report_arithmetic_and_one_run_per_range(fixed_bytes):
    _, tcfg, _, tg = _graphs()
    budget = _bytes(3)
    rep = CudaSegmentReporter(tcfg, tg, budget, seq=SEQ, device="cpu")
    # depths 1..3 hold block_0..block_2: within the budget
    assert rep.segment_report(1, 3) == (_bytes(3), 0)
    # depths 1..5: five blocks, two blocks' bytes over
    assert rep.segment_report(1, 5) == (budget, 2 * _per_block())
    # the embedding alone has no block: one block's run, as the reference
    assert rep.segment_report(0, 0) == (_bytes(1), 0)
    assert rep.compilations == 3 and fixed_bytes == [3, 5, 1]
    for _ in range(2):                          # cached, no further run
        assert rep.segment_report(1, 5) == (budget, 2 * _per_block())
    assert rep.compilations == 3 and fixed_bytes == [3, 5, 1]


@pytest.mark.parametrize("blocks_budget", [2, 3, 4])
def test_refine_cuts_matches_reference(fixed_bytes, blocks_budget):
    jcfg, tcfg, jg, tg = _graphs()
    budget = _bytes(blocks_budget)
    jpl = jfront.plan(jfront.DeploymentSpec(stages=4,
                                            strategy="balanced_norefine"),
                      graph=jg)
    tpl = tfront.plan(tfront.DeploymentSpec(stages=4,
                                            strategy="balanced_norefine"),
                      graph=tg)
    assert tpl.cuts == jpl.cuts
    assert [sum(n.startswith("block_") for n in s)
            for s in tpl.stage_layers] == [1, 4, 4, 3]
    jrep = jxla.XlaSegmentReporter(jcfg, jg, budget, seq=SEQ)
    trep = CudaSegmentReporter(tcfg, tg, budget, seq=SEQ, device="cpu")
    n = len(tg.levels())
    jres = jrefine_cuts(jpl.cuts, n, jrep)
    tres = trefine_cuts(tpl.cuts, n, trep)
    assert dataclasses.asdict(tres) == dataclasses.asdict(jres)
    assert trep.compilations == jrep.compilations > 0
    # the balanced cuts spill below 4 blocks; 12 blocks fit 4 stages of 3
    assert (tres.moves > 0) == (blocks_budget < 4)
    assert tres.converged == (blocks_budget >= 3)


@pytest.mark.parametrize("blocks_budget", [3, 4])
def test_plan_with_the_reporter_matches_reference(fixed_bytes,
                                                  blocks_budget):
    """The reporter plugged into the front door's refinement pass."""
    jcfg, tcfg, jg, tg = _graphs()
    budget = _bytes(blocks_budget)
    spec = dict(stages=4, strategy="balanced")
    jpl = jfront.plan(jfront.DeploymentSpec(**spec), graph=jg,
                      reporter=jxla.XlaSegmentReporter(jcfg, jg, budget,
                                                       seq=SEQ))
    tpl = tfront.plan(tfront.DeploymentSpec(**spec), graph=tg,
                      reporter=CudaSegmentReporter(tcfg, tg, budget,
                                                   seq=SEQ, device="cpu"))
    assert tpl.cuts == jpl.cuts
    assert dataclasses.asdict(tpl.refinement) == \
        dataclasses.asdict(jpl.refinement)
    assert tpl.refinement.converged
