"""vlm training in the port against the JAX reference, and the loss chunk
of ``launch/train.py`` (fault C6).

The vlm smoke config's train step (fp32; weights from the reference's
init, AdamW state converted by ``opt_state_from_numpy``) on one numpy
batch of 4 patch embeddings and 60 text tokens, against the reference's
jitted ``make_train_step``: the loss within 1e-5 relative, each gradient
leaf and each updated parameter within 1e-4 relative L2 (XLA and torch
sum in other orders).  The donated update (``donate=True``) equals the
functional one bit for bit.

C6: the reference's ``launch/train.py`` passes ``loss_chunk = min(512,
seq)``, which does not divide the vlm's ``seq + n_patches``; its chunked
loss asserts.  The port's takes :func:`repro_torch.launch.train.loss_chunk`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs
from repro.launch import steps as jsteps
from repro.models import api as japi
from repro.optim import adamw as jadamw
from repro_torch import configs as tconfigs
from repro_torch.checkpoint.store import tree_flatten
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models.convert import (opt_state_from_numpy,
                                        params_from_numpy, tensor_from_numpy)
from repro_torch.optim import adamw as tadamw

CPU = torch.device("cpu")
ARCH = "qwen2-vl-72b"
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
TOKENS, CHUNK = 64, 32          # patches + text; the loss chunk


def _rel_l2(got, expect):
    g = got.detach().float().numpy()
    e = np.asarray(expect, np.float32)
    return float(np.linalg.norm(g - e) / max(np.linalg.norm(e), 1e-30))


def _leaves(tree):
    return tree_flatten(tree)[0]


@pytest.fixture(scope="module")
def vlm():
    """The reference's vlm smoke weights and a nonzero AdamW state (numpy
    moments, step 3), the port's from them, and one numpy batch."""
    jcfg = jconfigs.get(ARCH).smoke_config()
    tcfg = tconfigs.get(ARCH).smoke_config()
    jp = japi.init(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    state = {"mu": jax.tree.map(lambda p: rng.normal(size=p.shape).astype(
                 np.float32) * 1e-2, jp),
             "nu": jax.tree.map(lambda p: rng.random(size=p.shape).astype(
                 np.float32) * 1e-4, jp),
             "step": np.asarray(3, np.int32)}
    p = jcfg.n_patches
    batch = {"tokens": rng.integers(0, jcfg.vocab, (2, TOKENS - p)),
             "embeds": rng.normal(size=(2, p, jcfg.d_model)),
             "positions": np.broadcast_to(np.arange(TOKENS)[None, None],
                                          (3, 2, TOKENS)),
             "labels": rng.integers(0, jcfg.vocab, (2, TOKENS))}
    batch = {k: np.ascontiguousarray(v, np.float32 if k == "embeds"
                                     else np.int32)
             for k, v in batch.items()}
    jstep = jax.jit(jsteps.make_train_step(jcfg, jadamw.AdamWConfig(**OPT),
                                           loss_chunk=CHUNK))
    jout = jstep(jp, jax.tree.map(jnp.asarray, state),
                 {k: jnp.asarray(v) for k, v in batch.items()})
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, state=state, batch=batch,
                jout=jout)


def _tbatch(batch):
    return {k: tensor_from_numpy(v, CPU).long() if v.dtype == np.int32
            else tensor_from_numpy(v, CPU) for k, v in batch.items()}


def _tstate(vlm):
    tcfg = vlm["tcfg"]
    return (params_from_numpy(tcfg, jax.tree.map(np.asarray, vlm["jp"]), CPU),
            opt_state_from_numpy(tcfg, vlm["state"], CPU))


def test_vlm_gradients_match_reference(vlm):
    jcfg, tcfg, batch = vlm["jcfg"], vlm["tcfg"], vlm["batch"]

    def jloss(p):
        b = {k: jnp.asarray(v) for k, v in batch.items()}
        h = japi.forward_hidden(jcfg, p, b)
        return jsteps.chunked_lm_loss(jcfg, p, h, b["labels"], chunk=CHUNK)

    jl, jg = jax.value_and_grad(jloss)(vlm["jp"])
    tp, _ = _tstate(vlm)
    tl, tg = tsteps.loss_and_grads(tcfg, tp, _tbatch(batch), CHUNK)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    expect = params_from_numpy(tcfg, jax.tree.map(np.asarray, jg), CPU)
    worst = max(_rel_l2(a, b.numpy())
                for a, b in zip(_leaves(tg), _leaves(expect)))
    assert worst < 1e-4, worst


def _check_step(vlm, out):
    tcfg = vlm["tcfg"]
    jp, js, jm = vlm["jout"]
    tp, ts, tm = out
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4)
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    assert int(ts["step"]) == int(js["step"]) == 4
    expect = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), CPU)
    worst = max(_rel_l2(a, b.numpy())
                for a, b in zip(_leaves(tp), _leaves(expect)))
    assert worst < 1e-4, worst


@pytest.mark.parametrize("chunk", [CHUNK, 16, 64])
def test_vlm_train_step_matches_reference(vlm, chunk):
    """The port's step at the reference's chunk and at two other divisors
    of the 64 tokens, each against the reference's step at chunk 32: the
    chunk does not change the step."""
    tp, ts = _tstate(vlm)
    step = tsteps.make_train_step(vlm["tcfg"], tadamw.AdamWConfig(**OPT),
                                  loss_chunk=chunk)
    _check_step(vlm, step(tp, ts, _tbatch(vlm["batch"])))


def test_vlm_donated_train_step_equals_functional(vlm):
    tp, ts = _tstate(vlm)
    cfg = tadamw.AdamWConfig(**OPT)
    b = _tbatch(vlm["batch"])
    plain = tsteps.make_train_step(vlm["tcfg"], cfg, CHUNK)(tp, ts, b)
    donated = tsteps.make_train_step(vlm["tcfg"], cfg, CHUNK, donate=True)(
        tp, ts, b)
    assert donated[0] is tp and donated[1]["mu"] is ts["mu"]
    for key in ("loss", "grad_norm", "lr"):
        assert torch.equal(donated[2][key], plain[2][key])
    for a, e in zip(_leaves(donated[:2]), _leaves(plain[:2])):
        assert torch.equal(a, e)
    _check_step(vlm, donated)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_donated_update_equals_functional(monkeypatch, dtype):
    """In pieces of 7 elements (the leaves of 40, 16 and 1 element split
    unevenly), written into the inputs, the same bits; both as the
    reference's update up to its order of summing the norm (fp32 within
    1e-6 relative and 1e-8 absolute, a bf16 parameter within its
    rounding)."""
    monkeypatch.setattr(tadamw, "PIECE", 7)
    np_dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    rng = np.random.default_rng(1)

    def tree(scale=1.0):
        return {"a": (rng.normal(size=(5, 8)) * scale).astype(np_dt),
                "b": [(rng.normal(size=(16,)) * scale).astype(np_dt),
                      (rng.normal(size=()) * scale).astype(np_dt)]}

    def torch_tree(t):
        return {"a": tensor_from_numpy(t["a"], CPU),
                "b": [tensor_from_numpy(x, CPU) for x in t["b"]]}

    cfg = tadamw.AdamWConfig(lr=3e-3, warmup_steps=3, total_steps=9,
                             grad_clip=0.5)
    params = tree()
    grads = [tree(0.3) for _ in range(4)]
    fp = torch_tree(params)
    fs = tadamw.adamw_init(fp)
    dp = torch_tree(params)
    ds = tadamw.adamw_init(dp)
    jcfg = jadamw.AdamWConfig(lr=3e-3, warmup_steps=3, total_steps=9,
                              grad_clip=0.5)
    jp = jax.tree.map(jnp.asarray, params)
    js = jadamw.adamw_init(jp)
    for g in grads:
        fp, fs, fm = tadamw.adamw_update(cfg, fp, torch_tree(g), fs)
        jp, js, _ = jadamw.adamw_update(jcfg, jp, jax.tree.map(jnp.asarray, g),
                                        js)
        for a, e in zip(_leaves((fp, fs["mu"], fs["nu"])),
                        jax.tree.leaves((jp, js["mu"], js["nu"]))):
            np.testing.assert_allclose(
                a.float().numpy(), np.asarray(e).astype(np.float32),
                rtol=1e-6 if a.dtype == torch.float32 else 2 ** -8,
                atol=1e-8)
        out = tadamw.adamw_update(cfg, dp, torch_tree(g), ds, donate=True)
        assert out[0] is dp and out[1]["nu"] is ds["nu"]
        ds = out[1]
        assert torch.equal(out[2]["grad_norm"], fm["grad_norm"])
        for a, e in zip(_leaves((dp, ds)), _leaves((fp, fs))):
            assert a.dtype == e.dtype and torch.equal(a, e)


# ---------------------------------------------------------------------------
# C6: launch/train.py's loss chunk
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,smoke,seq,chunk", [
    ("qwen3-1.7b", True, 64, 64), ("qwen3-1.7b", False, 1024, 512),
    ("qwen3-1.7b", True, 1000, 500), ("qwen3-1.7b", True, 521, None),
    ("qwen3-1.7b", True, 1054, None), ("qwen3-1.7b", True, 5, 5),
    ("qwen2-vl-72b", True, 64, 68), ("qwen2-vl-72b", True, 60, 64),
    ("qwen2-vl-72b", False, 1024, 512), ("qwen2-vl-72b", True, 1020, 512),
    ("whisper-tiny", True, 448, 448)])
def test_loss_chunk_divides_the_trained_sequence(arch, smoke, seq, chunk):
    """``chunk`` None: no divisor from 64 to 512 (521 is prime; 1054's
    largest is 62), and the length is refused."""
    mod = tconfigs.get(arch)
    cfg = mod.smoke_config() if smoke else mod.config()
    if chunk is None:
        with pytest.raises(ValueError, match="no divisor"):
            ttrain.loss_chunk(cfg, seq)
        return
    got = ttrain.loss_chunk(cfg, seq)
    n = seq + cfg.n_patches if cfg.family == "vlm" else seq
    assert got == chunk and n % got == 0 and got <= 512


def test_the_reference_loss_chunk_does_not_divide_the_vlm_sequence():
    """The reference's ``launch/train.py`` on the vlm smoke config at its
    default seq 64: chunk min(512, 64) = 64 against 64 + 4 tokens, and
    its chunked loss asserts (the reference is not changed)."""
    cfg = jconfigs.get(ARCH).smoke_config()
    params = japi.init(cfg, jax.random.PRNGKey(0))
    n = 64 + cfg.n_patches
    with pytest.raises(AssertionError):
        jsteps.chunked_lm_loss(cfg, params, jnp.zeros((1, n, cfg.d_model)),
                               jnp.zeros((1, n), jnp.int32),
                               chunk=min(512, 64))


def _run(tmp_path, name, fail_at):
    cfg = tconfigs.get(ARCH).smoke_config()
    return ttrain.train(cfg, steps=12, batch=2, seq=60,
                        opt_cfg=tadamw.AdamWConfig(lr=1e-3, warmup_steps=10,
                                                   total_steps=12),
                        ckpt_dir=str(tmp_path / name), ckpt_every=5,
                        fail_at=fail_at, device="cpu")


def test_vlm_restart_replays_the_uninterrupted_run(tmp_path):
    _, report, _ = _run(tmp_path, "failed", [7])
    _, clean, _ = _run(tmp_path, "clean", [])
    assert report.restarts == 1 and clean.restarts == 0
    steps = [s for s, _ in report.history]
    assert steps == list(range(7)) + list(range(5, 12))
    ref = {s: m for s, m in clean.history}
    for s, m in report.history:
        assert m == ref[s], s        # bit for bit: loss, lr, grad_norm
    assert all(np.isfinite(m["loss"]) for _, m in report.history)


def test_vlm_train_cli_on_cpu(tmp_path, capsys):
    """The acceptance command of C6 (8 rows of 64 text tokens after 4
    patches; chunk 68)."""
    ttrain.main(["--arch", ARCH, "--device", "cpu", "--steps", "12",
                 "--ckpt-every", "5", "--fail-at", "7", "--ckpt-dir",
                 str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert "training qwen2-vl-72b-smoke (vlm) for 12 steps" in out
    assert "restarts=1" in out
    last = float(out.split("last=")[1].split()[0])
    assert np.isfinite(last)


@pytest.mark.parametrize("arch,layers,donate", [
    ("qwen3-1.7b", None, False), ("rwkv6-1.6b", None, False),
    ("recurrentgemma-9b", 6, False), ("qwen2-vl-72b", 1, False),
    ("qwen2-vl-72b", 3, True)])
def test_donate_update_only_where_the_functional_update_does_not_fit(
        arch, layers, donate):
    """On an 80 GB card, twice the parameters and AdamW state plus the
    gradients: qwen2-vl-72b at 3 layers (113 GB) donates; at 1 layer
    (74 GB) and the other trained configurations it does not."""
    cfg = tconfigs.get(arch).config()
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    assert tsteps.donate_update(cfg, 80 * 10 ** 9) is donate
