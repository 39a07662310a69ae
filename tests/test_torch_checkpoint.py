"""The port's checkpoint store (``repro_torch.checkpoint``) against the
reference's (``repro.checkpoint``).

The store's contract on the port's tensors (round trip, retention, async
save, fallback from a corrupted CRC, an empty directory), the leaf order
of its pytree walk against ``jax.tree.flatten``, and the on-disk format:
a tree of fp32, int32 and bf16 leaves in nested dicts and lists written by
either package is restored by the other bit for bit, and the leaf files
of the same arrays are byte-equal (bf16 under the ``'<V2'`` header).
Inputs are drawn from a seed with numpy.  Exact throughout.
"""
import gc
import json
import os
import weakref

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import CheckpointStore as JStore
from repro_torch.checkpoint import CheckpointStore
from repro_torch.checkpoint.store import tree_flatten, tree_unflatten

SEED = 0


def _arrays(seed=SEED):
    """numpy leaves: fp32, int32, bf16 (as ml_dtypes), 0-d, empty."""
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((3, 4)).astype(np.float32),
        "b": rng.integers(-9, 9, (5,)).astype(np.int32),
        "h": rng.standard_normal((2, 3)).astype(ml_dtypes.bfloat16),
        "s": np.array(7, np.int32),
        "e": np.zeros((0, 2), np.float32),
        "g": rng.standard_normal((4,)).astype(ml_dtypes.bfloat16),
    }


def _nested(leaf):
    """One nested tree of dicts, lists, a tuple and a None over the
    leaves ``leaf(name)`` (keys out of sorted order on purpose)."""
    return {"opt": {"mu": [leaf("w"), leaf("h")], "step": leaf("s")},
            "blocks": [{"z": leaf("b"), "a": leaf("g")}, None,
                       (leaf("e"),)],
            "alpha": leaf("w")}


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(x):
    """A leaf's dtype name, shape and bytes (bf16 as its 16 bits)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        name = str(t.dtype).replace("torch.", "")
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return name, tuple(x.shape), t.numpy().tobytes()
    a = np.asarray(x)
    return str(a.dtype), a.shape, a.tobytes()


def _ttree(seed=SEED):
    arrs = _arrays(seed)
    return _nested(lambda k: _torch(arrs[k]))


def _jtree(seed=SEED):
    arrs = _arrays(seed)
    return _nested(lambda k: jnp.asarray(arrs[k]))


def _zeros_like(tree):
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [torch.zeros_like(t) for t in leaves])


def test_leaf_order_is_jax_tree_flatten_order():
    t_leaves, _ = tree_flatten(_ttree())
    j_leaves = jax.tree.leaves(_jtree())
    assert [_bits(t) for t in t_leaves] == \
        [_bits(np.asarray(j)) if j.dtype != jnp.bfloat16 else
         ("bfloat16", j.shape, np.asarray(j).view(np.int16).tobytes())
         for j in j_leaves]


def test_unflatten_inverts_flatten():
    tree = _ttree()
    leaves, treedef = tree_flatten(tree)
    again = tree_unflatten(treedef, leaves)
    assert again["blocks"][1] is None
    assert isinstance(again["blocks"][2], tuple)
    assert [_bits(x) for x in tree_flatten(again)[0]] == \
        [_bits(x) for x in leaves]


def test_tree_walks_hold_no_leaf_once_they_return():
    """A tree's leaves are freed as soon as no caller holds them: the
    walks leave no reference cycle for the cyclic collector to break (the
    SPMD schedule hands each microbatch's tensors on through ``tree_map``,
    and a cycle kept them on the card past the call)."""
    from repro_torch.checkpoint.store import tree_map
    tree = _ttree()
    refs = [weakref.ref(t) for t in tree_flatten(tree)[0]]
    was_on = gc.isenabled()
    gc.disable()
    try:
        again = tree_unflatten(*reversed(tree_flatten(tree)))
        doubled = tree_map(lambda t: t * 2, again)
        del tree, again
        assert [r() for r in refs] == [None] * len(refs)
        assert len(tree_flatten(doubled)[0]) == len(refs)
    finally:
        if was_on:
            gc.enable()


def test_checkpoint_roundtrip(tmp_path):
    store = CheckpointStore(str(tmp_path), keep=2)
    tree = _ttree()
    store.save(10, tree)
    step, restored = store.restore(_zeros_like(tree))
    assert step == 10
    assert [_bits(x) for x in tree_flatten(restored)[0]] == \
        [_bits(x) for x in tree_flatten(tree)[0]]


def test_restore_lands_on_the_template_dtype(tmp_path):
    store = CheckpointStore(str(tmp_path))
    store.save(1, {"x": torch.arange(6, dtype=torch.float32)})
    _, out = store.restore({"x": torch.zeros(2, 3, dtype=torch.float64)})
    assert out["x"].dtype == torch.float64 and out["x"].shape == (2, 3)
    assert out["x"].flatten().tolist() == list(range(6))


def test_save_snapshots_before_in_place_updates(tmp_path):
    """An async save writes the tree as it was at the call, not as later
    in-place updates leave it."""
    store = CheckpointStore(str(tmp_path))
    x = torch.ones(1000)
    store.save(1, {"x": x}, blocking=False)
    x.add_(1)
    _, out = store.restore({"x": torch.zeros(1000)})
    assert bool((out["x"] == 1).all())


def test_checkpoint_retention_and_latest(tmp_path):
    store = CheckpointStore(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        store.save(s, _ttree())
    assert store.steps() == [3, 4]
    assert store.latest_step() == 4
    assert store.has_checkpoint()


def test_checkpoint_async(tmp_path):
    store = CheckpointStore(str(tmp_path), keep=2)
    store.save(5, _ttree(), blocking=False)
    store.wait()
    assert store.latest_step() == 5


def test_corrupted_checkpoint_falls_back(tmp_path):
    store = CheckpointStore(str(tmp_path), keep=3)
    store.save(1, _ttree(1))
    store.save(2, _ttree(2))
    path = os.path.join(str(tmp_path), "step_0000000002", "leaf_00000.npy")
    with open(path, "r+b") as f:
        f.seek(60)
        f.write(b"\xff\xff\xff\xff")
    step, out = store.restore(_zeros_like(_ttree()))
    assert step == 1                      # fell back to the verified one
    assert [_bits(x) for x in tree_flatten(out)[0]] == \
        [_bits(x) for x in tree_flatten(_ttree(1))[0]]


def test_restore_empty_dir(tmp_path):
    store = CheckpointStore(str(tmp_path))
    template = _ttree()
    step, tree = store.restore(template)
    assert step is None and tree is template
    assert not store.has_checkpoint()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reference_checkpoint_restores_bit_equal(tmp_path, seed):
    JStore(str(tmp_path)).save(3, _jtree(seed))
    step, out = CheckpointStore(str(tmp_path)).restore(_zeros_like(
        _ttree(seed)))
    assert step == 3
    assert [_bits(x) for x in tree_flatten(out)[0]] == \
        [_bits(x) for x in tree_flatten(_ttree(seed))[0]]
    assert out["opt"]["mu"][1].dtype == torch.bfloat16


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_port_checkpoint_restores_bit_equal_in_reference(tmp_path, seed):
    CheckpointStore(str(tmp_path)).save(4, _ttree(seed))
    step, out = JStore(str(tmp_path)).restore(
        jax.tree.map(jnp.zeros_like, _jtree(seed)))
    assert step == 4
    want = jax.tree.leaves(_jtree(seed))
    got = jax.tree.leaves(out)
    assert [(g.dtype, g.shape) for g in got] == \
        [(w.dtype, w.shape) for w in want]
    for g, w in zip(got, want):
        assert np.asarray(g).tobytes() == np.asarray(w).tobytes()


def test_leaf_files_are_byte_equal_to_the_reference(tmp_path):
    """The same tree written by both packages gives the same leaf files
    and CRCs (bf16 headers read ``'<V2'`` in both); only metadata.json's
    treedef string differs."""
    JStore(str(tmp_path / "ref")).save(1, _jtree())
    CheckpointStore(str(tmp_path / "port")).save(1, _ttree())
    ref = tmp_path / "ref" / "step_0000000001"
    port = tmp_path / "port" / "step_0000000001"
    names = sorted(p.name for p in ref.iterdir() if p.suffix == ".npy")
    assert names == sorted(p.name for p in port.iterdir()
                           if p.suffix == ".npy")
    for name in names:
        assert (ref / name).read_bytes() == (port / name).read_bytes(), name
    jm = json.loads((ref / "metadata.json").read_text())
    tm = json.loads((port / "metadata.json").read_text())
    assert (jm["step"], jm["n_leaves"], jm["crc"]) == \
        (tm["step"], tm["n_leaves"], tm["crc"])
