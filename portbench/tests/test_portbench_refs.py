"""The references against the port's CPU forward, and the frozen counts
and configurations against the port's, at the cells' shapes."""
import json

import pytest
import torch

from portbench import arith
from portbench.reference import moe_decoder, resnet50
from portbench.systems import lm_spmd
from repro_torch import configs
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import cnn, lm

from .cells import PHI, RESNET, ROOT, small


def test_resnet50_reference_matches_the_port_forward():
    cell = small(RESNET)
    model = cell.config["model"]
    net = cnn.REAL_CNNS[model["zoo_name"]]()
    resnet50.check_names(model, net._order)
    params = resnet50.make_params(model, 2 ** 31 + 9, "cpu")
    x = torch.randn((2,) + tuple(model["input_shape"]),
                    generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        got = net.apply(params, x)
        ref = resnet50.forward(model, params, x)
    assert got.shape == ref.shape == (2, model["classes"])
    assert float((got - ref).abs().max() / ref.abs().max()) < 1e-5


def test_resnet50_counts_are_the_port_layer_graph():
    model = small(RESNET).config["model"]
    graph = cnn.REAL_CNNS[model["zoo_name"]]().to_layer_graph()
    macs = resnet50.macs_per_image(model)
    port = {name: node.macs for name, node in graph.nodes.items()
            if node.macs}
    assert macs == port
    assert resnet50.model_flops_per_image(model) == 2 * sum(port.values())
    # a convolution call's FLOPs are its MACs over the images, twice
    mb = 32
    convs = resnet50.conv_costs(model, mb)
    conv_macs = [m for n, m in macs.items() if n != "predictions"]
    assert [f for f, _ in convs] == [2 * mb * m for m in conv_macs]


@pytest.mark.parametrize("capacity", [1.25, 8.0])
def test_moe_reference_matches_the_port_forward(capacity):
    m = {**small(PHI).config["model"], "capacity_factor": capacity}
    cfg = lm_spmd.lm_config(m)
    seed = 2 ** 32 + 5
    params = {**moe_decoder.make_outer(m, seed, "cpu"), "blocks": [
        moe_decoder.make_block(m, seed, i, "cpu")
        for i in range(m["n_layers"])]}
    tokens = torch.randint(0, m["vocab"], (3, 32),
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = lm.forward(cfg, moe_decoder.cast(params), {"tokens": tokens})
        ref = torch.stack(list(moe_decoder.logits_rows(m, seed, tokens,
                                                       "cpu")))
    assert float((got - ref).abs().max() / ref.abs().max()) < 1e-5


def test_phi_configuration_is_the_port_config():
    full = json.loads((ROOT / "portbench" / "configs" / "phi35moe-42b.json")
                      .read_text())["model"]
    assert lm_spmd.lm_config(full) == configs.get(
        "phi3.5-moe-42b-a6.6b").config()


@pytest.mark.parametrize("b,hq,hkv,s,d", [(2, 32, 8, 1024, 128),
                                          (1, 4, 2, 32, 16)])
def test_attention_cost_is_the_port_cost(b, hq, hkv, s, d):
    q = torch.empty((b, hq, s, d), device="meta")
    k = torch.empty((b, hkv, s, d), device="meta")
    assert arith.attention_cost(b, hq, hkv, s, s, d, 4) == \
        fa.attention_cost(q, k, causal=True)


def test_lm_model_flops_count_each_term():
    m = dict(n_layers=2, d_model=8, head_dim=2, n_heads=4, n_kv_heads=2,
             d_ff=16, top_k=2, n_experts=4, vocab=10)
    s = 4
    proj = 2 * 8 * (2 * 8 + 2 * 4)
    experts = 2 * 3 * 2 * 8 * 16 + 2 * 8 * 4
    scores = 4 * 2 * 4 * (10 / 4)      # 10 causal pairs over 4 tokens
    assert arith.lm_model_flops_per_token(m, s) == pytest.approx(
        2 * (proj + experts + scores) + 2 * 8 * 10)
