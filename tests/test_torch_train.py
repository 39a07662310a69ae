"""The port's training path against the JAX reference: the synthetic data
stream, AdamW with its schedule and clipping, the losses, the chunked loss,
remat, one train step of five families, and the fault-tolerant
``launch/train.py``.

Inputs are drawn with numpy and handed to both packages; weights come from
the reference's init (``params_from_numpy``) and optimizer states through
``opt_state_from_numpy``.  Tolerances: 1e-6 relative for the optimizer and
the losses (fp32 arithmetic in another order); bf16 parameters equal or
one bf16 step apart (a rounding of the same fp32 value may land on either
side); the train step's loss within 1e-5 relative and each gradient leaf
within 1e-4 relative L2 (fp32 models; XLA and torch sum in other orders),
three steps' losses within 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLMDataset as JSyntheticLMDataset
from repro.launch import steps as jsteps
from repro.models import api as japi
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro_torch import configs as tconfigs
from repro_torch.checkpoint.store import tree_flatten, tree_unflatten
from repro_torch.data import DataConfig, SyntheticLMDataset
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import api as tapi
from repro_torch.models import lm as tlm
from repro_torch.models import rglru as trglru
from repro_torch.models import rwkv6 as trwkv6
from repro_torch.models.convert import (opt_state_from_numpy,
                                        params_from_numpy, tensor_from_numpy)
from repro_torch.optim import adamw as tadamw

CPU = torch.device("cpu")
TRAIN_ARCHS = ["qwen3-1.7b", "granite-moe-1b-a400m", "whisper-tiny",
               "rwkv6-1.6b", "recurrentgemma-9b"]


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _t(a):
    return tensor_from_numpy(np.asarray(a), CPU)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("hosts,host_id", [(1, 0), (2, 0), (2, 1), (4, 3)])
def test_dataset_batches_equal_reference(hosts, host_id):
    kw = dict(seed=3, global_batch=8, seq_len=24, vocab=97,
              num_hosts=hosts, host_id=host_id)
    ours = SyntheticLMDataset(DataConfig(**kw))
    ref = JSyntheticLMDataset(JDataConfig(**kw))
    for step in (0, 1, 7, 123):
        a, b = ours.batch_at(step), ref.batch_at(step)
        assert sorted(a) == sorted(b) == ["labels", "tokens"]
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
OPT = dict(lr=3e-3, warmup_steps=3, total_steps=9, grad_clip=0.5)
SHAPES = {"a": (4, 8), "b": {"c": (16,), "d": (3, 5)}, "e": (2, 2, 3)}


def _tree(shapes, fn):
    if isinstance(shapes, dict):
        return {k: _tree(v, fn) for k, v in shapes.items()}
    return fn(shapes)


@pytest.mark.parametrize("step", [0, 1, 2, 3, 4, 8, 9, 20])
def test_schedule_matches_reference(step):
    cfg = tadamw.AdamWConfig(**OPT)
    got = tadamw.cosine_warmup_schedule(
        cfg, torch.tensor(step, dtype=torch.int32))
    expect = jadamw.cosine_warmup_schedule(jadamw.AdamWConfig(**OPT),
                                           jnp.asarray(step, jnp.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np32(got), np.asarray(expect), rtol=1e-6)


def _np_tree(rng, dtype, scale=1.0):
    return _tree(SHAPES, lambda s: (rng.normal(size=s) * scale
                                    ).astype(dtype))


def _to_torch(tree):
    return _tree_map(tree, _t)


def _tree_map(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree_map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree):
    return tree_flatten(tree)[0]


def _assert_bf16_close(got, expect):
    """Equal, or one bf16 step apart (the same fp32 value rounded to
    either side)."""
    g = _np32(got)
    e = np.asarray(expect, np.float32)
    ulp = np.abs(e) * 2.0 ** -7 + 1e-30
    assert np.all(np.abs(g - e) <= ulp), np.max(np.abs(g - e) / ulp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_reference(dtype, max_norm):
    np_dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    grads = _np_tree(np.random.default_rng(0), np_dt)
    got, gnorm = tadamw.clip_by_global_norm(_to_torch(grads), max_norm)
    expect, jnorm = jadamw.clip_by_global_norm(
        jax.tree.map(jnp.asarray, grads), max_norm)
    np.testing.assert_allclose(_np32(gnorm), np.asarray(jnorm), rtol=1e-6)
    for g, e in zip(_leaves(got), jax.tree.leaves(expect)):
        assert str(g.dtype).endswith(dtype)
        if dtype == "float32":
            np.testing.assert_allclose(_np32(g), np.asarray(e), rtol=1e-6,
                                       atol=1e-7)
        else:
            _assert_bf16_close(g, e)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_five_adamw_steps_match_reference(dtype):
    np_dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    rng = np.random.default_rng(1)
    params = _np_tree(rng, np_dt)
    grads = [_np_tree(rng, np_dt, scale=0.3) for _ in range(5)]
    tcfg, jcfg = tadamw.AdamWConfig(**OPT), jadamw.AdamWConfig(**OPT)
    tp = _to_torch(params)
    ts = tadamw.adamw_init(tp)
    jp = jax.tree.map(jnp.asarray, params)
    js = jadamw.adamw_init(jp)
    for g in grads:
        before = [x.clone() for x in _leaves(tp)]
        tp2, ts, tm = tadamw.adamw_update(tcfg, tp, _to_torch(g), ts)
        # functional: the inputs are not written
        for x, y in zip(_leaves(tp), before):
            assert torch.equal(x, y)
        tp = tp2
        jp, js, jm = jadamw.adamw_update(jcfg, jp, jax.tree.map(
            jnp.asarray, g), js)
        for key in ("lr", "grad_norm"):
            np.testing.assert_allclose(_np32(tm[key]), np.asarray(jm[key]),
                                       rtol=1e-6)
        assert int(ts["step"]) == int(js["step"])
        assert ts["step"].dtype == torch.int32
        for moment in ("mu", "nu"):
            for a, b in zip(_leaves(ts[moment]), jax.tree.leaves(js[moment])):
                assert a.dtype == torch.float32
                np.testing.assert_allclose(_np32(a), np.asarray(b),
                                           rtol=1e-6, atol=1e-9)
        for a, b in zip(_leaves(tp), jax.tree.leaves(jp)):
            if dtype == "float32":
                np.testing.assert_allclose(_np32(a), np.asarray(b),
                                           rtol=1e-6, atol=1e-8)
            else:
                _assert_bf16_close(a, b)


def test_adamw_update_decays_every_leaf():
    # zero grads: the update is the decoupled decay alone, on every leaf
    cfg = tadamw.AdamWConfig(lr=0.1, warmup_steps=0, total_steps=10,
                             weight_decay=0.5)
    params = {"w": torch.ones(3), "norm": {"scale": torch.full((2,), 2.0)}}
    new, state, m = tadamw.adamw_update(
        cfg, params, {"w": torch.zeros(3), "norm": {"scale": torch.zeros(2)}},
        tadamw.adamw_init(params))
    lr = float(m["lr"])
    torch.testing.assert_close(new["w"], torch.full((3,), 1 - lr * 0.5))
    torch.testing.assert_close(new["norm"]["scale"],
                               torch.full((2,), 2 - lr * 0.5 * 2))
    assert int(state["step"]) == 1


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("masked", [False, True])
def test_lm_loss_matches_reference(masked):
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(3, 7, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32) if masked else None
    got = tlm.lm_loss(_t(logits), _t(labels),
                      None if mask is None else _t(mask))
    expect = jlm.lm_loss(jnp.asarray(logits), jnp.asarray(labels),
                         None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(_np32(got), np.asarray(expect), rtol=1e-6)


def test_lm_loss_all_masked_is_zero():
    got = tlm.lm_loss(torch.randn(2, 3, 5),
                      torch.zeros(2, 3, dtype=torch.long), torch.zeros(2, 3))
    assert float(got) == 0.0


def test_moe_aux_loss_matches_reference():
    cfg = jconfigs.get("granite-moe-1b-a400m").smoke_config()
    tcfg = tconfigs.get("granite-moe-1b-a400m").smoke_config()
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(2, 9, cfg.n_experts)).astype(np.float32)
    gate_idx = rng.integers(0, cfg.n_experts, (2, 9, cfg.top_k)
                            ).astype(np.int32)
    got = tlm.moe_aux_loss(tcfg, _t(logits), _t(gate_idx))
    expect = jlm.moe_aux_loss(cfg, jnp.asarray(logits), jnp.asarray(gate_idx))
    np.testing.assert_allclose(_np32(got), np.asarray(expect), rtol=1e-6)


# ---------------------------------------------------------------------------
# models: chunked loss, remat, the train step
# ---------------------------------------------------------------------------
def _models(arch, seed=0, **over):
    jcfg = dataclasses.replace(jconfigs.get(arch).smoke_config(), **over)
    tcfg = dataclasses.replace(tconfigs.get(arch).smoke_config(), **over)
    jp = japi.init(jcfg, jax.random.PRNGKey(seed))
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), CPU)
    return jcfg, tcfg, jp, tp


def _batch(cfg, seq, batch=2, seed=0):
    """numpy tokens, labels and (encdec) stub frames."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (batch, seq)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab, (batch, seq)).astype(np.int32)}
    if cfg.family == "encdec":
        out["frames"] = rng.normal(size=(batch, cfg.n_frames, cfg.d_model)
                                   ).astype(np.float32)
    return out


def _tbatch(b):
    return {k: _t(v) for k, v in b.items()}


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def test_chunked_loss_equals_lm_loss_values_and_grads():
    """As the reference's tests/test_hlo_and_losses.py holds its chunked
    loss to the direct one."""
    _, cfg, _, params = _models("qwen3-1.7b")
    b = _tbatch(_batch(cfg, 32))
    direct = tlm.lm_loss(tapi.forward(cfg, params, b), b["labels"])
    with torch.no_grad():
        hidden = tapi.forward_hidden(cfg, params, b)
    for chunk in (8, 16, 32):
        chunked = tsteps.chunked_lm_loss(cfg, params, hidden, b["labels"],
                                         chunk=chunk)
        np.testing.assert_allclose(float(chunked), float(direct), rtol=1e-6)

    leaves, treedef = tree_flatten(params)

    def grads(loss_fn):
        live = [p.detach().requires_grad_() for p in leaves]
        loss = loss_fn(tree_unflatten(treedef, live))
        return torch.autograd.grad(loss, live)

    g1 = grads(lambda p: tlm.lm_loss(tapi.forward(cfg, p, b), b["labels"]))
    g2 = grads(lambda p: tsteps.chunked_lm_loss(
        cfg, p, tapi.forward_hidden(cfg, p, b), b["labels"], chunk=8))
    for a, c in zip(g1, g2):
        torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-7)


def test_chunked_loss_needs_a_dividing_chunk():
    _, cfg, _, params = _models("qwen3-1.7b")
    with pytest.raises(AssertionError):
        tsteps.chunked_lm_loss(cfg, params, torch.zeros(1, 12, cfg.d_model),
                               torch.zeros(1, 12, dtype=torch.long), chunk=8)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-moe-1b-a400m",
                                  "rwkv6-1.6b", "recurrentgemma-9b"])
def test_remat_gives_the_same_loss_and_grads(arch):
    _, cfg, _, params = _models(arch)
    b = _tbatch(_batch(cfg, 16))
    plain, g_plain = tsteps.loss_and_grads(cfg, params, b, 8)
    remat, g_remat = tsteps.loss_and_grads(
        dataclasses.replace(cfg, remat=True), params, b, 8)
    torch.testing.assert_close(remat, plain, rtol=1e-6, atol=0)
    for a, c in zip(_leaves(g_remat), _leaves(g_plain)):
        torch.testing.assert_close(a, c, rtol=1e-6, atol=1e-9)


def test_remat_recomputes_each_block_in_the_backward(monkeypatch):
    calls = []
    block = tlm.block
    monkeypatch.setattr(tlm, "block", lambda *a, **k: (calls.append(1),
                                                       block(*a, **k))[1])
    _, cfg, _, params = _models("qwen3-1.7b")
    b = _tbatch(_batch(cfg, 16))
    tsteps.loss_and_grads(dataclasses.replace(cfg, remat=True), params, b, 8)
    assert len(calls) == 2 * cfg.n_layers
    calls.clear()
    tsteps.loss_and_grads(cfg, params, b, 8)
    assert len(calls) == cfg.n_layers


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "recurrentgemma-9b"])
def test_recurrent_remat_recomputes_each_block_in_the_backward(monkeypatch,
                                                               arch):
    """rwkv6 checkpoints each block, recurrentgemma each (rec1, rec2, attn)
    super-block and each tail layer, as the reference's scan bodies: each
    runs once forward and once in the backward under remat, once without."""
    calls = []

    def counted(mod, name):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, **k: (calls.append(name),
                                                        fn(*a, **k))[1])
    if arch == "rwkv6-1.6b":
        counted(trwkv6, "block")
    else:
        counted(trglru, "super_block")
        counted(trglru, "tail_layer")
    _, cfg, _, params = _models(arch)
    units = (cfg.n_layers if arch == "rwkv6-1.6b"
             else len(params["super"]) + len(params["tail"]))
    assert units >= 3
    b = _tbatch(_batch(cfg, 16))
    tsteps.loss_and_grads(dataclasses.replace(cfg, remat=True), params, b, 8)
    assert len(calls) == 2 * units
    calls.clear()
    tsteps.loss_and_grads(cfg, params, b, 8)
    assert len(calls) == units


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "recurrentgemma-9b"])
def test_recurrent_remat_leaves_serving_alone(monkeypatch, arch):
    """No checkpoint on a forward whose weights require no grad, nor on a
    prefill into a cache."""
    calls = []
    mod = trwkv6 if arch == "rwkv6-1.6b" else trglru
    monkeypatch.setattr(mod, "checkpoint", lambda *a, **k: calls.append(1))
    _, cfg, _, params = _models(arch)
    cfg = dataclasses.replace(cfg, remat=True)
    frozen = [x.detach() for x in _leaves(params)]
    params = tree_unflatten(tree_flatten(params)[1], frozen)
    b = _tbatch(_batch(cfg, 16))
    logits = tapi.forward(cfg, params, {"tokens": b["tokens"]})
    assert torch.is_grad_enabled() and not logits.requires_grad
    if arch == "rwkv6-1.6b":
        live = tree_unflatten(tree_flatten(params)[1],
                              [x.requires_grad_() for x in
                               [y.clone() for y in frozen]])
        cache = tapi.init_cache(cfg, 2, 16, CPU)
        logits, _ = trwkv6.forward(cfg, live, {"tokens": b["tokens"]},
                                   cache=cache)
        assert logits.requires_grad
    assert calls == []


def test_remat_leaves_a_forward_without_grads_alone(monkeypatch):
    """Grad mode on but no weight requiring grad (the serving paths): no
    block goes through the checkpoint."""
    calls = []
    monkeypatch.setattr(tlm, "checkpoint", lambda *a, **k: calls.append(1))
    _, cfg, _, params = _models("qwen3-1.7b")
    frozen = [x.detach() for x in _leaves(params)]
    params = tree_unflatten(tree_flatten(params)[1], frozen)
    b = _tbatch(_batch(cfg, 16))
    logits = tlm.forward(dataclasses.replace(cfg, remat=True), params, b)
    assert torch.is_grad_enabled() and not logits.requires_grad
    assert calls == []


def test_prefill_and_decode_steps_match_reference():
    jcfg, tcfg, jp, tp = _models("qwen3-1.7b")
    b = _batch(jcfg, 12)
    tokens = {"tokens": b["tokens"]}
    got = tsteps.make_prefill_step(tcfg)(tp, _tbatch(tokens))
    expect = jsteps.make_prefill_step(jcfg)(jp, _jbatch(tokens))
    np.testing.assert_allclose(_np32(got), np.asarray(expect), rtol=1e-4,
                               atol=1e-4)
    tcache = tapi.init_cache(tcfg, 2, 4, CPU)
    jcache = japi.init_cache(jcfg, 2, 4)
    tstep = tsteps.make_decode_step(tcfg)
    jstep = jsteps.make_decode_step(jcfg)
    for i in range(3):
        tok = b["tokens"][:, i:i + 1]
        got, tcache = tstep(tp, tcache, _t(tok))
        expect, jcache = jstep(jp, jcache, jnp.asarray(tok))
        assert got.shape == (2, tcfg.vocab)
        np.testing.assert_allclose(_np32(got), np.asarray(expect),
                                   rtol=1e-4, atol=1e-4)


def _rel_l2(got, expect):
    g, e = _np32(got), np.asarray(expect, np.float32)
    return float(np.linalg.norm(g - e) / max(np.linalg.norm(e), 1e-30))


def _opt_state(jp, seed):
    """A nonzero AdamW state of the reference's tree: moments from numpy,
    step 3."""
    rng = np.random.default_rng(seed)
    mu = jax.tree.map(lambda p: rng.normal(size=p.shape).astype(np.float32)
                      * 1e-2, jp)
    nu = jax.tree.map(lambda p: rng.random(size=p.shape).astype(np.float32)
                      * 1e-4, jp)
    return {"mu": mu, "nu": nu, "step": np.asarray(3, np.int32)}


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_matches_reference(arch):
    jcfg, tcfg, jp, tp = _models(arch)
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    seq, chunk = 16, 8
    state = _opt_state(jp, 5)
    ts = opt_state_from_numpy(tcfg, state, CPU)
    js = jax.tree.map(jnp.asarray, state)
    batches = [_batch(jcfg, seq, seed=s) for s in range(3)]

    # the gradients of the first step, leaf by leaf
    def jloss(p):
        h = japi.forward_hidden(jcfg, p, _jbatch(batches[0]))
        return jsteps.chunked_lm_loss(jcfg, p, h, jnp.asarray(
            batches[0]["labels"]), chunk=chunk)

    jl, jg = jax.value_and_grad(jloss)(jp)
    tl, tg = tsteps.loss_and_grads(tcfg, tp, _tbatch(batches[0]), chunk)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    tg_np = params_from_numpy(tcfg, jax.tree.map(np.asarray, jg), CPU)
    worst = max(_rel_l2(a, b) for a, b in zip(_leaves(tg), _leaves(tg_np)))
    assert worst < 1e-4, worst

    # three steps of the train step against the reference's jitted one
    jstep = jax.jit(jsteps.make_train_step(jcfg, jadamw.AdamWConfig(**opt),
                                           loss_chunk=chunk))
    tstep = tsteps.make_train_step(tcfg, tadamw.AdamWConfig(**opt),
                                   loss_chunk=chunk)
    for i, b in enumerate(batches):
        jp, js, jm = jstep(jp, js, _jbatch(b))
        tp, ts, tm = tstep(tp, ts, _tbatch(b))
        tol = 1e-5 if i == 0 else 1e-4
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=tol)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        assert int(ts["step"]) == int(js["step"]) == 4 + i


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------
def _run(tmp_path, name, fail_at):
    cfg = tconfigs.get("qwen3-1.7b").smoke_config()
    return ttrain.train(cfg, steps=24, batch=2, seq=16,
                        opt_cfg=tadamw.AdamWConfig(lr=3e-3, warmup_steps=4,
                                                   total_steps=24),
                        ckpt_dir=str(tmp_path / name), ckpt_every=10,
                        fail_at=fail_at, device="cpu")


def test_driver_restart_replays_the_uninterrupted_run(tmp_path):
    _, report, _ = _run(tmp_path, "failed", [15])
    _, clean, _ = _run(tmp_path, "clean", [])
    assert report.restarts == 1 and clean.restarts == 0
    steps = [s for s, _ in report.history]
    # steps 0..14, the failure at 15, then from the checkpoint at 10 on
    assert steps == list(range(15)) + list(range(10, 24))
    ref = {s: m for s, m in clean.history}
    for s, m in report.history:
        assert m == ref[s], s        # bit for bit: loss, lr, grad_norm
    assert report.history[-1][0] == 23


def test_driver_cli_on_cpu(tmp_path, capsys):
    ttrain.main(["--arch", "qwen3-1.7b", "--steps", "12", "--batch", "2",
                 "--seq", "16", "--ckpt-dir", str(tmp_path / "ck"),
                 "--ckpt-every", "5", "--fail-at", "7", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "training qwen3-1.7b-smoke (dense) for 12 steps" in out
    assert "restarts=1" in out
    assert "loss decreased" in out


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "recurrentgemma-9b"])
def test_train_cli_on_cpu_trains_the_recurrent_families(tmp_path, capsys,
                                                        arch):
    """30 steps at lr 1e-2: the last batch's loss below the first's (12
    steps at the default lr leave rwkv6's within one batch's noise)."""
    ttrain.main(["--arch", arch, "--steps", "30", "--lr", "1e-2",
                 "--batch", "2", "--seq", "16", "--ckpt-dir",
                 str(tmp_path / "ck"), "--ckpt-every", "5", "--fail-at", "7",
                 "--device", "cpu"])
    out = capsys.readouterr().out
    family = "ssm" if arch == "rwkv6-1.6b" else "hybrid"
    assert f"training {arch}-smoke ({family}) for 30 steps" in out
    assert "restarts=1" in out
    assert "loss decreased" in out


def test_driver_batches_follow_the_reference():
    """vlm and encdec batches come from concrete_batch with the step as
    the numpy seed; the rest from the dataset."""
    cfg = tconfigs.get("whisper-tiny").smoke_config()
    data = SyntheticLMDataset(DataConfig(global_batch=2, seq_len=8,
                                         vocab=cfg.vocab))
    b = ttrain.step_batch(cfg, data, 5, 2, 8, CPU)
    ref = JSyntheticLMDataset(JDataConfig(global_batch=2, seq_len=8,
                                          vocab=cfg.vocab)).batch_at(5)
    np.testing.assert_array_equal(b["tokens"].numpy(), ref["tokens"])
    np.testing.assert_array_equal(b["labels"].numpy(), ref["labels"])
    assert b["frames"].shape == (2, cfg.n_frames, cfg.d_model)
