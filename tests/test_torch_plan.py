"""The port's LM layer graph and plans against the JAX reference's.

The graph must equal the reference node by node (exact integers); then
every plan over it is the reference's plan, which the plan tests pin for
the strategies the serve entry point offers.
"""
import pytest

pytest.importorskip("torch")

from repro import api as japi
from repro import configs as jconfigs
from repro.models import lm_graph as jlm_graph
from repro_torch import api as tapi
from repro_torch import configs as tconfigs
from repro_torch.models import lm_graph as tlm_graph

ARCH = "qwen3-1.7b"


def _nodes(g):
    return [(n.name, n.params, n.macs, n.out_bytes, n.weight_bytes, n.kind,
             tuple(g.predecessors(n.name))) for n in g.nodes.values()]


def _graphs(which, seq):
    jg = jlm_graph.lm_layer_graph(getattr(jconfigs.get(ARCH), which)(),
                                  seq_len=seq)
    tg = tlm_graph.lm_layer_graph(getattr(tconfigs.get(ARCH), which)(),
                                  seq_len=seq)
    return jg, tg


@pytest.mark.parametrize("which", ["config", "smoke_config"])
@pytest.mark.parametrize("seq", [64, 4096])
def test_lm_layer_graph_equals_reference(which, seq):
    jg, tg = _graphs(which, seq)
    assert tg.name == jg.name
    assert _nodes(tg) == _nodes(jg)
    assert tg.depth == jg.depth


def test_full_width_param_count():
    _, tg = _graphs("config", 1024)
    # qwen3-1.7b with tied embeddings: ~1.72 B parameters
    assert 1.70e9 < tg.total_params < 1.75e9


@pytest.mark.parametrize("strategy", ["balanced", "balanced_norefine",
                                      "comp"])
@pytest.mark.parametrize("stages", [2, 3, 4])
def test_plan_equals_reference(strategy, stages):
    jg, tg = _graphs("config", 1024)
    jpl = japi.plan(japi.DeploymentSpec(stages=stages, strategy=strategy),
                    graph=jg)
    tpl = tapi.plan(tapi.DeploymentSpec(stages=stages, strategy=strategy),
                    graph=tg)
    assert tpl.cuts == jpl.cuts
    assert tpl.stage_layers == jpl.stage_layers
    assert tpl.report.to_dict() == jpl.report.to_dict()


def test_model_ref_resolves_to_reference_graph():
    ref = "lm:qwen3-1.7b:seq=128"
    assert (_nodes(tapi.resolve_model_graph(ref))
            == _nodes(japi.resolve_model_graph(ref)))
    spec = tapi.DeploymentSpec(model=ref, stages=3)
    assert tapi.plan(spec).cuts == japi.plan(
        japi.DeploymentSpec(model=ref, stages=3)).cuts


def test_spec_json_interchangeable_with_reference():
    spec = tapi.DeploymentSpec(model="lm:qwen3-1.7b:seq=1024", stages=4,
                               strategy="balanced")
    assert japi.DeploymentSpec.from_json(spec.to_json()).to_dict() \
        == spec.to_dict()
