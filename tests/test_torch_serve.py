"""The port's serving path on the CPU against the JAX reference.

One plan (smoke config, 3 balanced stages), one set of weights (the
reference's init, converted), four streamed requests through each
package's ``deploy(...).serve()`` -- as ``launch/serve.py``'s batch
workload does.  fp32 throughout; outputs within 1e-4 of the reference's
``api.forward`` (summation order over four layers).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as japi
from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.launch.pipeline_spmd import stage_block_counts as j_counts
from repro.models import api as jmodels
from repro_torch import api as tapi
from repro_torch import configs as tconfigs
from repro_torch.launch import serve as tserve
from repro_torch.models import api as tmodels
from repro_torch.models import lm as tlm
from repro_torch.models.convert import params_from_numpy

ARCH = "qwen3-1.7b"
SEQ = 32
N_REQ = 4
SPEC = dict(model=f"lm:{ARCH}:seq={SEQ}", strategy="balanced", stages=3,
            max_batch=N_REQ, max_wait_s=0.005)
CPU = torch.device("cpu")


def _serve(dep, reqs):
    with dep.serve() as server:
        server.serve_batch(reqs[:1])            # warm-up
        server.start()
        server.snapshot()
        pending = [server.submit(r) for r in reqs]
        for req in pending:
            assert req.event.wait(120), f"request {req.rid} timed out"
        snap = server.snapshot()
    assert all(r.error is None for r in pending)
    return pending, snap


@pytest.fixture(scope="module")
def served():
    jcfg = jconfigs.get(ARCH).smoke_config()
    tcfg = tconfigs.get(ARCH).smoke_config()
    jparams = jmodels.init(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                device="cpu")
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab,
                                               (N_REQ, 1, SEQ))

    def tbuild(p):
        return tserve.make_stage_fns(
            tcfg, tparams, tserve.stage_block_counts(p, tcfg.n_layers), CPU)

    tdep = tapi.deploy(tapi.DeploymentSpec(**SPEC), stage_fn_builder=tbuild)
    jdep = japi.deploy(japi.DeploymentSpec(**SPEC), stage_fn_builder=(
        lambda p: jserve.make_stage_fns(jcfg, jparams,
                                        j_counts(p, jcfg.n_layers))))
    port = _serve(tdep, [torch.from_numpy(t) for t in tokens])
    ref = _serve(jdep, [jnp.asarray(t, jnp.int32) for t in tokens])
    direct = [np.asarray(jmodels.forward(
        jcfg, jparams, {"tokens": jnp.asarray(t, jnp.int32)},
        last_token_only=True)) for t in tokens]
    return dict(tdep=tdep, jdep=jdep, port=port, ref=ref, direct=direct,
                tokens=tokens, tcfg=tcfg, tbuild=tbuild)


def test_same_plan_as_reference(served):
    assert served["tdep"].plan.cuts == served["jdep"].plan.cuts
    assert (tserve.stage_block_counts(served["tdep"].plan, 4)
            == j_counts(served["jdep"].plan, 4))


def test_outputs_match_reference_forward(served):
    pending, _ = served["port"]
    assert len(pending) == N_REQ
    for req, expect in zip(pending, served["direct"]):
        assert req.result.shape == (1, 1, served["tcfg"].vocab)
        np.testing.assert_allclose(req.result.numpy(), expect,
                                   rtol=1e-4, atol=1e-4)


def test_request_order_matches_reference_server(served):
    (tpend, _), (jpend, _) = served["port"], served["ref"]
    assert [r.rid for r in tpend] == sorted(r.rid for r in tpend)
    for t, j in zip(tpend, jpend):
        np.testing.assert_allclose(t.result.numpy(), np.asarray(j.result),
                                   rtol=1e-4, atol=1e-4)


def test_snapshot_fields_match_reference_server(served):
    (_, tsnap), (_, jsnap) = served["port"], served["ref"]
    assert set(tsnap) == set(jsnap)
    assert set(tsnap["latency"]) == set(jsnap["latency"])
    for key in ("requests", "completed", "failed", "retried", "shed",
                "deadline_exceeded"):
        assert tsnap[key] == jsnap[key], key
    assert tsnap["requests"] == N_REQ
    assert len(tsnap["stage_busy_s"]) == 3
    assert tsnap["stage_items"] == jsnap["stage_items"] == [N_REQ] * 3


def test_microbatched_stages_stack_tensors(served):
    spec = tapi.DeploymentSpec(**{**SPEC, "microbatch": N_REQ,
                                  "microbatch_wait_s": 0.2})
    dep = tapi.deploy(spec, stage_fn_builder=served["tbuild"])
    reqs = [torch.from_numpy(t) for t in served["tokens"]]
    with dep.executor(start=True) as ex:
        outs, _ = ex.run_batch(reqs)
        mb = ex.microbatch_snapshot()
    assert sum(mb["items"]) > 0                 # torch payloads did stack
    for out, expect in zip(outs, served["direct"]):
        np.testing.assert_allclose(out.numpy(), expect, rtol=1e-4, atol=1e-4)


def test_serve_entry_point_on_cpu():
    res = tserve.main(["--smoke", "--device", "cpu", "--stages", "3",
                       "--requests", "3", "--seq", "24"])
    assert len(res["outs"]) == 3
    assert res["snapshot"]["requests"] == 3
    assert res["max_err"] < 1e-5


def test_serve_entry_point_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(["--smoke", "--requests", "1"])


@pytest.mark.parametrize("call", [
    lambda dep: dep.executor(backend="spmd"),
    # the encoder-decoder family (whisper) is not ported
    lambda dep: tmodels.forward(dataclasses.replace(
        tconfigs.get(ARCH).smoke_config(), family="encdec"), {}, {}),
    # decode serves the dense family; the MoE/VLM decode path is not
    # ported yet
    lambda dep: tapi.Deployment(
        tapi.DeploymentSpec(**{**SPEC, "workload": "decode"}), dep.plan,
        cfg=dataclasses.replace(tconfigs.get(ARCH).smoke_config(),
                                family="moe", n_experts=4, top_k=2)
    ).serve(params={}),
    # a CNN plans and serves on the host tier; its SPMD tier is not ported
    lambda dep: tapi.deploy(tapi.DeploymentSpec(model="cnn:ResNet50",
                                                stages=2, backend="spmd"),
                            stage_fns=[None, None]).executor(),
    # the dense variants with relu^2 MLPs (minitron) are not ported
    lambda dep: tlm.require_ported(dataclasses.replace(
        tconfigs.get(ARCH).smoke_config(), mlp_kind="relu2")),
], ids=["spmd", "encdec_family", "decode", "cnn", "relu2_mlp"])
def test_unported_paths_raise(served, call):
    with pytest.raises(NotImplementedError, match="repro_torch"):
        call(served["tdep"])


@pytest.mark.parametrize("argv", [
    [],
    ["--device-budget", "6"],
    ["--hedge-after-ms", "12.5", "--device-budget", "5"],
    ["--stage-loss-retries", "2"],
    ["--deadline-ms", "250", "--shed-policy", "deadline"],
    ["--cost-source", "trace:build/profile/ResNet50.json"],
    ["--cost-source", "calibrated:trace.json", "--stages", "3"],
    ["--drift-threshold", "0.3", "--canary-requests", "2"],
    ["--microbatch", "4", "--microbatch-wait-ms", "1.5", "--requests", "9"],
    ["--workload", "decode", "--max-context", "256",
     "--decode-concurrency", "8", "--hedge-after-ms", "3"],
], ids=["defaults", "device_budget", "hedge", "stage_loss_retries",
        "deadline_shed", "trace_source", "calibrated_source",
        "drift_threshold", "microbatch", "decode"])
def test_spec_from_args_matches_reference(argv):
    """The port's flags give the reference's ``DeploymentSpec`` field by
    field (the reference parses inside ``main``, so its builder gets the
    port's parsed namespace)."""
    args = tserve.parse_args(["--seq", "32", *argv])
    got = tserve.spec_from_args(args).to_dict()
    want = jserve.spec_from_args(args).to_dict()
    assert got == want
