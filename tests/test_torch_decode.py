"""The port's decode tier on the CPU against the JAX package: costing and
``decode_placement`` plans (exact), ``forward_decode`` logits, the
``PipelineDecodeEngine``'s greedy tokens (exact, as
``tests/test_decode.py`` pins for the reference), the front door's decode
server, the continuous-batching scheduler over a scripted engine, and the
serve CLI's decode workload.

Weights: the reference's init, converted with ``params_from_numpy``;
prompts: numpy from a seed.  fp32 throughout, so greedy tokens must be
equal and logits agree within 1e-5 (summation order over four layers).
No assertion reads a wall clock.
"""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as japi
from repro import configs as jconfigs
from repro.core.edge_tpu_model import EdgeTPUSpec as JEdgeTPUSpec
from repro.decode import costing as jcosting
from repro.decode import placement as jplacement
from repro.decode.engine import PipelineDecodeEngine as JEngine
from repro.models import lm as jlm
from repro.models import lm_graph as jlm_graph
from repro_torch import api as tapi
from repro_torch import configs as tconfigs
from repro_torch.core.edge_tpu_model import EdgeTPUSpec as TEdgeTPUSpec
from repro_torch.core.pipeline import PipelineStopped
from repro_torch.decode import costing as tcosting
from repro_torch.decode.engine import (PipelineDecodeEngine,
                                       build_decode_server)
from repro_torch.decode.scheduler import DecodeScheduler
from repro_torch.launch import serve as tserve
from repro_torch.models import lm as tlm
from repro_torch.models import lm_graph as tlm_graph
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.server import Overloaded

ARCH = "qwen3-1.7b"
CPU = torch.device("cpu")
DECODE_SPEC = dict(model=f"lm:{ARCH}", strategy="decode_placement",
                   workload="decode")


@pytest.fixture(scope="module")
def weights():
    """fp32 smoke config of both packages and one set of weights."""
    jcfg = jconfigs.get(ARCH).smoke_config()
    tcfg = tconfigs.get(ARCH).smoke_config()
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jcfg, tcfg, jparams, tparams


def _reference_greedy(cfg, params, prompt, n_new, max_context):
    """The reference's sequential oracle (tests/test_decode.py): the
    prompt teacher-forced through forward_decode one token at a time,
    then greedy decode."""
    cache = jlm.init_cache(cfg, 1, max_context)
    logits = None
    for tok in prompt:
        logits, cache = jlm.forward_decode(
            cfg, params, jnp.asarray([[tok]], jnp.int32), cache)
    out = []
    tok = int(jnp.argmax(logits[0, -1]))
    for _ in range(n_new):
        out.append(tok)
        logits, cache = jlm.forward_decode(
            cfg, params, jnp.asarray([[tok]], jnp.int32), cache)
        tok = int(jnp.argmax(logits[0, -1]))
    return out


# ---------------------------------------------------------------------------
# costing
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("smoke", [True, False])
def test_decode_costs_equal_the_reference(smoke):
    jmod, tmod = jconfigs.get(ARCH), tconfigs.get(ARCH)
    jcfg = jmod.smoke_config() if smoke else jmod.config()
    tcfg = tmod.smoke_config() if smoke else tmod.config()
    # fp32 smoke rows are priced at 4 bytes, bf16 at 2, as numpy does
    assert tcosting._itemsize(tcfg.dtype) == (4 if smoke else 2)
    point_j = jcosting.DecodeOperatingPoint(8, 2048)
    point_t = tcosting.DecodeOperatingPoint(8, 2048)
    assert (tcosting.decode_depth_costs(
        tcfg, tlm_graph.lm_layer_graph(tcfg, seq_len=64), point_t)
        == jcosting.decode_depth_costs(
            jcfg, jlm_graph.lm_layer_graph(jcfg, seq_len=64), point_j))


def test_decode_cost_source_point_queries_equal_the_reference():
    """``DecodeCostSource`` is a ``CostSource``: its per-depth point
    queries (derived by the base class from ``materialize``) equal the
    reference's on qwen3-1.7b smoke at ``DecodeOperatingPoint(2, 64)``."""
    from repro.profiling.sources import CostSource as JCostSource
    from repro_torch.profiling.sources import CostSource, DepthCosts
    jcfg = jconfigs.get(ARCH).smoke_config()
    tcfg = tconfigs.get(ARCH).smoke_config()
    jg = jlm_graph.lm_layer_graph(jcfg, seq_len=64)
    tg = tlm_graph.lm_layer_graph(tcfg, seq_len=64)
    jsrc = jcosting.DecodeCostSource(jcfg, jcosting.DecodeOperatingPoint(2, 64))
    tsrc = tcosting.DecodeCostSource(tcfg, tcosting.DecodeOperatingPoint(2, 64))
    assert isinstance(jsrc, JCostSource) and isinstance(tsrc, CostSource)
    jspec, tspec = JEdgeTPUSpec(), TEdgeTPUSpec()
    jdc, tdc = jsrc.materialize(jg, jspec), tsrc.materialize(tg, tspec)
    assert type(tdc) is DepthCosts
    assert dataclasses.asdict(tdc) == dataclasses.asdict(jdc)
    assert tsrc.layer_time_s(1, tg, tspec) == pytest.approx(4.9410549e-05,
                                                           rel=1e-7)
    depth = len(tg.levels())
    for d in range(depth):
        assert tsrc.layer_time_s(d, tg, tspec) == jsrc.layer_time_s(d, jg,
                                                                    jspec)
        assert tsrc.layer_params(d, tg) == jsrc.layer_params(d, jg)
        assert (tsrc.layer_weight_bytes(d, tg)
                == jsrc.layer_weight_bytes(d, jg))
        assert tsrc.activation_bytes(d, tg) == jsrc.activation_bytes(d, jg)
    assert tsrc.describe() == jsrc.describe()


# ---------------------------------------------------------------------------
# decode_placement plans
# ---------------------------------------------------------------------------
def _plan_pair(**over):
    jpl = japi.plan(japi.DeploymentSpec(**DECODE_SPEC, **over))
    tpl = tapi.plan(tapi.DeploymentSpec(**DECODE_SPEC, **over))
    return jpl, tpl


@pytest.mark.parametrize("stages,c,ctx", [(2, 4, 256), (4, 8, 512),
                                          (None, 8, 2048)])
def test_decode_plans_equal_the_reference(stages, c, ctx):
    jpl, tpl = _plan_pair(stages=stages, max_context=ctx,
                          decode_concurrency=c)
    assert tpl.cuts == jpl.cuts and tpl.n_stages == jpl.n_stages
    assert tpl.decode_info == jpl.decode_info
    for key in ("decode_tokens_per_s", "stage_kv_bytes",
                "stage_kv_cap_bytes", "kv_headroom_pct"):
        assert getattr(tpl.report, key) == getattr(jpl.report, key)


def test_infeasible_point_raises_the_reference_message():
    over = dict(stages=2, max_context=4096, decode_concurrency=64)
    with pytest.raises(ValueError) as jerr:
        japi.plan(japi.DeploymentSpec(**DECODE_SPEC, **over))
    with pytest.raises(ValueError) as terr:
        tapi.plan(tapi.DeploymentSpec(**DECODE_SPEC, **over))
    assert "no feasible decode placement" in str(terr.value)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("onchip,c,ctx", [
    (16 * 2 ** 30, 8, 2048),          # a card-sized planning device
    (2 ** 30, 8, 2048),
    (None, 2, 128),                   # the reference's 8 MiB Edge TPU
])
def test_full_width_plan_equals_the_reference(monkeypatch, onchip, c, ctx):
    # the reference strategy prices its spec's smoke config; give it the
    # full one, as the port's plan(cfg=) does, and compare on one device
    jfull, tfull = jconfigs.get(ARCH).config(), tconfigs.get(ARCH).config()
    monkeypatch.setattr(jplacement, "decode_config_for", lambda _: jfull)
    over = dict(stages=4, max_context=ctx, decode_concurrency=c)
    jpl = japi.plan(japi.DeploymentSpec(**DECODE_SPEC, **over),
                    graph=jlm_graph.lm_layer_graph(jfull, seq_len=64),
                    base_spec=None if onchip is None
                    else JEdgeTPUSpec(onchip_bytes=onchip))
    tpl = tapi.plan(tapi.DeploymentSpec(**DECODE_SPEC, **over),
                    graph=tlm_graph.lm_layer_graph(tfull, seq_len=64),
                    cfg=tfull, base_spec=None if onchip is None
                    else TEdgeTPUSpec(onchip_bytes=onchip))
    assert tpl.cuts == jpl.cuts
    assert tpl.decode_info == jpl.decode_info
    # priced with the full config's rows, not the smoke config's
    blocks = tserve.stage_block_counts(tpl, tfull.n_layers)
    row = c * ctx * 2 * tfull.n_kv_heads * tfull.hd * 2
    assert tpl.decode_info["stage_kv_bytes"] == tuple(n * row
                                                      for n in blocks)


def test_full_width_at_the_reference_defaults_is_infeasible():
    # concurrency 4, context 128: 2 MiB of KV a layer on an 8 MiB device
    tfull = tconfigs.get(ARCH).config()
    with pytest.raises(ValueError, match="no feasible decode placement"):
        tapi.plan(tapi.DeploymentSpec(**DECODE_SPEC, stages=4,
                                      max_context=128,
                                      decode_concurrency=4),
                  graph=tlm_graph.lm_layer_graph(tfull, seq_len=64),
                  cfg=tfull)


def test_cfg_needs_its_graph():
    spec = tapi.DeploymentSpec(**DECODE_SPEC, stages=2)
    full = tconfigs.get(ARCH).config()
    with pytest.raises(ValueError, match="pass graph="):
        tapi.plan(spec, cfg=full)
    with pytest.raises(ValueError, match="pass graph="):
        tapi.deploy(spec, cfg=full)


# ---------------------------------------------------------------------------
# the model's decode step
# ---------------------------------------------------------------------------
def test_forward_decode_matches_reference(weights):
    jcfg, tcfg, jparams, tparams = weights
    tokens = np.random.default_rng(3).integers(0, jcfg.vocab, (2, 12))
    jcache = jlm.init_cache(jcfg, 2, 16)
    tcache = tlm.init_cache(tcfg, 2, 16, CPU)
    for i in range(tokens.shape[1]):
        tok = tokens[:, i:i + 1]
        jlogits, jcache = jlm.forward_decode(
            jcfg, jparams, jnp.asarray(tok, jnp.int32), jcache)
        tlogits, tcache = tlm.forward_decode(
            tcfg, tparams, torch.from_numpy(tok), tcache)
        assert tlogits.shape == (2, 1, tcfg.vocab)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   rtol=1e-5, atol=1e-5)
    assert tcache["len"] == int(jcache["len"]) == tokens.shape[1]
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the engine: exact greedy tokens
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("stage_blocks", [None, [2, 2]])
def test_engine_matches_reference_forward_decode_exactly(weights,
                                                         stage_blocks):
    jcfg, tcfg, jparams, tparams = weights
    max_context, n_new = 32, 5
    prompt = np.asarray([3, 1, 4, 1, 5, 9], np.int32)
    expect = _reference_greedy(jcfg, jparams, prompt, n_new, max_context)
    engine = PipelineDecodeEngine(tcfg, tparams, n_slots=2,
                                  max_context=max_context,
                                  stage_blocks=stage_blocks)
    with engine:
        # slot 1 of 2: slot 0 stays inactive (ctx 0: its cache rows are
        # never written and its lanes must not perturb the live one)
        tok = engine.prefill(1, prompt)
        got = [tok]
        ctx = prompt.size + 1
        while len(got) < n_new:
            tok = engine.step([1], [ctx], [tok])[0]
            ctx += 1
            got.append(tok)
    assert got == expect
    assert engine.kv_bytes_per_token == tcfg.n_layers * 2 * 2 * 16 * 4


def test_engine_rejects_bad_shapes(weights):
    _, tcfg, _, tparams = weights
    with pytest.raises(ValueError, match="sum"):
        PipelineDecodeEngine(tcfg, tparams, n_slots=1, max_context=8,
                             stage_blocks=[1])
    eng = PipelineDecodeEngine(tcfg, tparams, n_slots=1, max_context=8)
    with pytest.raises(ValueError, match="out of range"):
        eng.prefill(2, np.asarray([1, 2], np.int32))
    with pytest.raises(ValueError, match="leaves no room"):
        eng.prefill(0, np.arange(8, dtype=np.int32))


def test_front_door_decode_server_matches_reference(weights):
    """spec -> deploy -> serve(params=) in both packages, same weights and
    prompts: the same plan and the same token streams."""
    jcfg, tcfg, jparams, tparams = weights
    over = dict(stages=2, max_context=16, decode_concurrency=2)
    jdep = japi.deploy(japi.DeploymentSpec(**DECODE_SPEC, **over))
    tdep = tapi.deploy(tapi.DeploymentSpec(**DECODE_SPEC, **over))
    assert tdep.plan.cuts == jdep.plan.cuts
    prompts = [np.asarray(p, np.int32) for p in ([2, 7, 1], [5, 5], [9])]

    def stream(dep, params):
        with dep.serve(start=True, params=params) as srv:
            reqs = [srv.submit(p, max_new_tokens=4) for p in prompts]
            return [r.result(timeout=300) for r in reqs], srv

    touts, tsrv = stream(tdep, tparams)
    jouts, _ = stream(jdep, jparams)
    assert touts == jouts
    assert tsrv.engine.stage_blocks == [2, 2]


def test_build_decode_server_draws_weights_only_for_smoke(monkeypatch):
    spec = tapi.DeploymentSpec(**DECODE_SPEC, stages=1, max_context=16,
                               decode_concurrency=2)
    with pytest.raises(ValueError, match="needs its weights"):
        build_decode_server(spec, cfg=tconfigs.get(ARCH).config())
    # smoke weights are drawn on the card: without one this raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_decode_server(spec)


# ---------------------------------------------------------------------------
# the scheduler over a scripted engine
# ---------------------------------------------------------------------------
class ScriptedEngine:
    """The first token is ``prompt[0] * 1000`` and every step increments
    the last token: each stream is a function of its prompt alone.
    ``gate`` (optional) holds every step until set."""

    def __init__(self, n_slots, gate=None):
        self.n_slots = n_slots
        self.kv_bytes_per_token = 10
        self.gate = gate
        self.stepping = threading.Event()
        self.step_batches = []

    def prefill(self, slot, prompt):
        return int(prompt[0]) * 1000

    def step(self, slots, ctx_lens, last_tokens):
        self.stepping.set()
        if self.gate is not None:
            assert self.gate.wait(timeout=60)
        self.step_batches.append(list(slots))
        return [t + 1 for t in last_tokens]


def _expected(prompt, n):
    return [int(prompt[0]) * 1000 + i for i in range(n)]


def test_scheduler_joins_keep_each_stream_in_order():
    eng = ScriptedEngine(n_slots=2)
    sched = DecodeScheduler(eng, max_context=64, queue_size=16)
    prompts = [np.asarray([i + 1, 7], np.int32) for i in range(5)]
    with sched:
        reqs = [sched.submit(p, max_new_tokens=4) for p in prompts]
        outs = [r.result(timeout=60) for r in reqs]
    for req, prompt, out in zip(reqs, prompts, outs):
        assert out == _expected(prompt, 4)
        pairs = [req.stream.get_nowait() for _ in range(4)]
        assert pairs == list(enumerate(out))
    assert all(len(b) <= 2 for b in eng.step_batches)
    snap = sched.snapshot()
    assert snap["admitted"] == snap["completed"] == 5
    assert snap["tokens"] == 20


def test_scheduler_sheds_at_the_kv_cap():
    sched = DecodeScheduler(ScriptedEngine(n_slots=1), max_context=64,
                            queue_size=2, backoff_seed=0)
    ok = [sched.submit(np.asarray([1], np.int32)) for _ in range(2)]
    shed = [sched.submit(np.asarray([2], np.int32)) for _ in range(2)]
    for req in shed:
        with pytest.raises(Overloaded) as err:
            req.result(timeout=1)
        assert err.value.retry_after_s > 0
    assert shed[1].error.retry_after_s > shed[0].error.retry_after_s
    sched.stop()
    for req in ok:
        with pytest.raises(PipelineStopped):
            req.result(timeout=1)


def test_scheduler_drains_admitted_streams_on_stop():
    gate = threading.Event()
    eng = ScriptedEngine(n_slots=2, gate=gate)
    sched = DecodeScheduler(eng, max_context=64, queue_size=16)
    running = [sched.submit(np.asarray([i + 1], np.int32), max_new_tokens=6)
               for i in range(2)]
    queued = sched.submit(np.asarray([9], np.int32), max_new_tokens=3)
    sched.start()
    assert eng.stepping.wait(timeout=60)        # both admitted, mid-stream
    stopper = threading.Thread(target=sched.stop, kwargs={"drain": True})
    stopper.start()
    while not sched._stopping:                  # stop() has taken effect
        stopper.join(timeout=0.01)
    gate.set()
    stopper.join(timeout=60)
    for i, req in enumerate(running):
        assert req.result(timeout=1) == _expected([i + 1], 6)
    with pytest.raises(PipelineStopped):
        queued.result(timeout=1)


# ---------------------------------------------------------------------------
# the serve CLI's decode workload
# ---------------------------------------------------------------------------
def test_serve_cli_decode_end_to_end():
    argv = ["--smoke", "--device", "cpu", "--workload", "decode",
            "--stages", "2", "--requests", "3", "--max-new-tokens", "5",
            "--prompt-len", "6", "--max-context", "32",
            "--decode-concurrency", "2"]
    res = tserve.main(argv)
    args = tserve.parse_args(argv)
    # the plan is the reference CLI's plan for the same flags
    jspec = japi.DeploymentSpec(**{**DECODE_SPEC, "model": f"lm:{ARCH}"},
                                stages=2, max_context=32,
                                decode_concurrency=2)
    assert res["plan"].cuts == japi.plan(jspec).cuts
    assert tserve.spec_from_args(args).workload == "decode"
    assert [len(o) for o in res["outs"]] == [5, 5, 5]
    snap = res["snapshot"]
    assert snap["tokens"] == 15 and snap["admitted"] == 3
    assert res["warmup"]["steps"] == 1 and res["warmup"]["admitted"] == 1
    # each served stream is the model's own sequential greedy decode
    cfg, params = res["cfg"], res["params"]
    for prompt, out in zip(res["prompts"], res["outs"]):
        cache = tlm.init_cache(cfg, 1, 32, CPU)
        for tok in prompt:
            logits, cache = tlm.forward_decode(
                cfg, params, torch.tensor([[int(tok)]]), cache)
        seq = []
        for _ in range(5):
            seq.append(int(logits[0, -1].argmax()))
            logits, cache = tlm.forward_decode(
                cfg, params, torch.tensor([[seq[-1]]]), cache)
        assert out == seq
