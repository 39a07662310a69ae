"""The port's dry-run cell table against the JAX reference: the shapes,
the cells and their skips, the input specs, the meta-device train state
and caches, the partition rules, and each cell's analytic record
(``launch/dryrun.py``) on the one-card, one-pod and two-pod grids.

The reference's per-device state bytes need a real mesh of 256 or 512
devices; a subprocess builds them with forced host devices (its dry-run
module sets the flag on import), as ``tests/test_spmd_subprocess.py``
does.  Its activation model reads only ``mesh.shape`` and
``mesh.axis_names``, so the port's grids stand in for its meshes.  Every
comparison is exact: the fields are integer byte counts (sums below 2^53)
and the same float expressions in the same order.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs
from repro.configs import common as jcommon

# the reference's dry-run module forces 512 host devices through XLA_FLAGS
# on import; this process (and what it spawns) keeps its own flags
_FLAGS = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as jdryrun  # noqa: E402
if _FLAGS is None:
    os.environ.pop("XLA_FLAGS")
else:
    os.environ["XLA_FLAGS"] = _FLAGS
from repro.launch import sharding as jshd  # noqa: E402
from repro.launch import steps as jsteps
from repro_torch import configs as tconfigs
from repro_torch.checkpoint.store import tree_flatten
from repro_torch.launch import dryrun, mesh, sharding
from repro_torch.launch import steps as tsteps
from repro_torch.models.convert import _stacks

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = jconfigs.arch_ids()
GRIDS = sorted(mesh.GRIDS)
ALL_CELLS = [(a, s) for a in ARCHS for s in jcommon.SHAPES]


# ---------------------------------------------------------------------------
# the cell table
# ---------------------------------------------------------------------------
def test_shapes_equal_reference():
    assert list(tconfigs.SHAPES) == list(jcommon.SHAPES)
    for name, spec in tconfigs.SHAPES.items():
        assert dataclasses.asdict(spec) == dataclasses.asdict(
            jcommon.SHAPES[name])


@pytest.mark.parametrize("include_skipped", [False, True])
def test_cells_equal_reference(include_skipped):
    assert (tconfigs.cells(include_skipped)
            == jconfigs.cells(include_skipped))


@pytest.mark.parametrize("arch", ARCHS)
def test_skip_shapes_equal_reference(arch):
    assert (tconfigs.get(arch).SKIP_SHAPES
            == jconfigs.get(arch).SKIP_SHAPES)


def test_configs_export_the_cell_table():
    for name in ("SHAPES", "ShapeSpec", "input_specs", "cells"):
        assert name in tconfigs.__all__


@pytest.mark.parametrize("arch,shape", ALL_CELLS)
def test_input_specs_equal_reference(arch, shape):
    cfg = tconfigs.get(arch).config()
    got = tconfigs.input_specs(cfg, tconfigs.SHAPES[shape])
    expect = jcommon.input_specs(jconfigs.get(arch).config(),
                                 jcommon.SHAPES[shape])
    assert list(got) == list(expect)
    for key, t in got.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == expect[key].shape, key
        assert t.dtype == (cfg.dtype if key in ("embeds", "frames")
                           else torch.int64), key


# ---------------------------------------------------------------------------
# meta-device state against the reference's eval_shape trees
# ---------------------------------------------------------------------------
def _ref_leaves(cfg, tree, stacks):
    """(names, shape, dtype name) of each leaf of the reference's tree,
    a stacked subtree's leaves split into one per layer, in the port's
    walk order (dict keys in insertion order, layers in order)."""
    out = []

    def walk(node, names, split):
        if isinstance(node, dict):
            for key in node:
                walk(node[key], names + (key,),
                     split if split is not None else stacks.get(key))
            return
        out.append((names, tuple(node.shape), np.dtype(node.dtype).name,
                    split))
    walk(tree, (), None)
    return out


def _expand(leaves):
    """Each stacked (names, shape) as its per-layer leaves."""
    out = []
    for names, shape, dtype, split in leaves:
        if split is None:
            out.append((names, shape, dtype))
        else:
            assert shape[0] == split, (names, shape)
            out.extend([(names, shape[1:], dtype)] * split)
    return out


def _port_leaves(tree):
    return sorted((sharding._names(path), tuple(leaf.shape),
                   str(leaf.dtype).replace("torch.", ""))
                  for path, leaf, _ in sharding._walk(tree))


def _bytes(tree):
    return sum(x.numel() * x.element_size() for x in tree_flatten(tree)[0])


def _jbytes(tree):
    return sum(int(np.prod(x.shape)) * np.dtype(x.dtype).itemsize
               for x in jax.tree.leaves(tree))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_shapes_equal_reference(arch):
    cfg = tconfigs.get(arch).config()
    params, opt = tsteps.train_state_shapes(cfg)
    jparams, jopt = jsteps.train_state_shapes(jconfigs.get(arch).config())
    for leaf in tree_flatten((params, opt))[0]:
        assert leaf.device.type == "meta"
    stacks = _stacks(cfg)
    assert _port_leaves(params) == sorted(_expand(_ref_leaves(
        cfg, jparams, stacks)))
    assert _port_leaves(opt) == sorted(_expand(_ref_leaves(
        cfg, jopt, stacks)))
    assert _bytes((params, opt)) == _jbytes((jparams, jopt))


# per-layer lists of the port's caches (the reference stacks them)
CACHE_LISTS = {"layers", "rec1", "rec2", "tail"}


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_shapes_equal_reference(arch):
    cfg = tconfigs.get(arch).config()
    spec = tconfigs.SHAPES["decode_32k"]
    cache = tsteps.cache_shapes(cfg, spec.global_batch, spec.seq_len)
    jcache = jsteps.cache_shapes(jconfigs.get(arch).config(),
                                 spec.global_batch, spec.seq_len)
    lists = {key: len(val) for key, val in cache.items()
             if isinstance(val, list)}
    assert set(lists) <= CACHE_LISTS
    assert _port_leaves(cache) == sorted(_expand(_ref_leaves(
        cfg, jcache, lists)))
    assert _bytes(cache) == _jbytes(jcache)


# ---------------------------------------------------------------------------
# FLOPs, activations, partition rules
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ref_flops():
    """The reference's ``model_flops`` of every (arch, shape), its
    parameter count taken once an arch."""
    count = jdryrun.api.active_param_count
    counts = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdryrun.api, "active_param_count", lambda cfg: (
            counts[cfg] if cfg in counts
            else counts.setdefault(cfg, count(cfg))))
        return {cell: jdryrun.model_flops(*cell) for cell in ALL_CELLS}


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal_reference(ref_flops, arch):
    for shape in jcommon.SHAPES:
        assert dryrun.model_flops(arch, shape) == ref_flops[arch, shape]


@pytest.mark.parametrize("grid", GRIDS)
def test_activation_bytes_equal_reference(grid):
    """The port's grid stands in for the reference's mesh: the model reads
    ``shape`` and ``axis_names`` alone."""
    g = mesh.GRIDS[grid]
    for arch, shape in ALL_CELLS:
        got = dryrun.analytic_activation_bytes(
            tconfigs.get(arch).config(), tconfigs.SHAPES[shape], g)
        expect = jdryrun.analytic_activation_bytes(
            jconfigs.get(arch).config(), jcommon.SHAPES[shape], g)
        assert got == expect, (arch, shape)


def _normalized(spec, nd):
    return tuple(spec) + (None,) * (nd - len(spec))


@pytest.mark.parametrize("msize", [1, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference_rule(arch, msize):
    """Each leaf's spec equals the reference's ``_spec_for_param`` of the
    stacked leaf with its layer axis removed."""
    cfg = tconfigs.get(arch).config()
    params, _ = tsteps.train_state_shapes(cfg)
    placed = sharding.param_specs(mesh.Grid(data=1, model=msize), params)
    assert len(placed) == len(tree_flatten(params)[0])
    for path, leaf, spec in placed:
        names = sharding._names(path)
        stacked = any(isinstance(p, int) for p in path)
        shape = ((2,) if stacked else ()) + tuple(leaf.shape)
        expect = _normalized(jshd._spec_for_param(names, shape, msize,
                                                  True), len(shape))
        assert spec == (expect[1:] if stacked else expect), path
        assert expect[0] is None or not stacked


# the reference's state bytes of every unskipped cell on each grid, from a
# subprocess with 512 forced host devices
REF_STATE = r"""
import json
from repro.launch import dryrun as D     # sets the forced device count
import jax
from repro import configs
from repro.configs.common import SHAPES
from repro.launch import sharding as shd, steps as steps_lib
from repro.launch.mesh import make_mesh
from repro.models import api
meshes = {"1x1": make_mesh((1, 1), ("data", "model")),
          "16x16": make_mesh((16, 16), ("data", "model")),
          "2x16x16": make_mesh((2, 16, 16), ("pod", "data", "model"))}
out = {}
for arch, sname, _ in configs.cells():
    cfg = configs.get(arch).config()
    spec = SHAPES[sname]
    if spec.kind == "train":
        params, opt = steps_lib.train_state_shapes(cfg)
    else:
        params = jax.eval_shape(lambda k: api.init(cfg, k),
                                jax.ShapeDtypeStruct((2,), "uint32"))
    if spec.kind == "decode":
        cache = steps_lib.cache_shapes(cfg, spec.global_batch, spec.seq_len)
    for name, m in meshes.items():
        if spec.kind == "train":
            pairs = [(params, shd.param_shardings(m, params, fsdp="blocks")),
                     (opt, shd.opt_state_shardings(m, opt))]
        elif spec.kind == "prefill":
            pairs = [(params, shd.param_shardings(m, params))]
        else:
            mode = "seq" if cfg.family in ("dense", "moe", "vlm") else "hd"
            pairs = [(params, shd.param_shardings(m, params)),
                     (cache, shd.cache_shardings(m, cache, mode=mode))]
        out[f"{arch}|{sname}|{name}"] = D.analytic_state_bytes(pairs, m)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_state_bytes():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", REF_STATE], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("grid", GRIDS)
def test_records_equal_reference(ref_state_bytes, ref_flops, grid):
    """Every cell's record: the state bytes of the reference's shardings
    (fsdp="blocks" and ZeRO-1 for train, the sequence-sharded cache of the
    attention families for decode), its activation model and FLOPs; fits
    against one H100's 80 GB; compute at its bf16 peak; skipped cells
    with the reference's reason.  The analytic fields only (``count=False``:
    counting every cell takes minutes; ``tests/test_torch_op_analysis.py``
    holds the counted ones)."""
    g = mesh.GRIDS[grid]
    for arch, shape, skip in jconfigs.cells(include_skipped=True):
        rec = dryrun.dryrun_cell(arch, shape, g, verbose=False, count=False)
        assert rec["arch"] == arch and rec["shape"] == shape
        assert rec["mesh"] == grid and rec["n_devices"] == g.n_devices
        if skip:
            assert rec["status"] == "skipped"
            assert rec["skip_reason"] == skip
            continue
        assert rec["status"] == "ok"
        state = ref_state_bytes[f"{arch}|{shape}|{grid}"]
        act = jdryrun.analytic_activation_bytes(
            jconfigs.get(arch).config(), jcommon.SHAPES[shape], g)
        flops = ref_flops[arch, shape]
        assert rec["state_bytes_per_device"] == state, (arch, shape)
        assert rec["activation_bytes_per_device"] == act
        assert rec["device_bytes"] == state + act
        assert rec["fits_hbm"] == (state + act <= 80e9)
        assert rec["model_flops_global"] == flops
        assert rec["compute_s"] == flops / (g.n_devices * 989e12)


def test_main_writes_a_record_a_cell(tmp_path, capsys):
    records = dryrun.main(["--all", "--mesh", "1x1", "--no-count", "--out",
                           str(tmp_path)])
    assert len(records) == len(jconfigs.cells(include_skipped=True))
    files = sorted(p.name for p in tmp_path.iterdir())
    assert len(files) == len(records)
    rec = json.loads((tmp_path / "qwen3-1.7b_train_4k_1x1.json").read_text())
    assert rec["status"] == "ok" and rec["n_devices"] == 1
    assert "all dry-run cells green" in capsys.readouterr().out


def test_grids_and_the_cards_constants():
    assert GRIDS == ["16x16", "1x1", "2x16x16"]
    assert mesh.GRIDS["2x16x16"].axis_names == ("pod", "data", "model")
    assert mesh.GRIDS["16x16"].shape == {"data": 16, "model": 16}
    assert [mesh.GRIDS[g].n_devices for g in GRIDS] == [256, 1, 512]
    assert mesh.data_parallel_size(mesh.GRIDS["2x16x16"]) == 32
    assert (mesh.PEAK_FLOPS_BF16, mesh.HBM_BW, mesh.HBM_BYTES) == (
        989e12, 3.35e12, 80e9)


@pytest.mark.parametrize("constant", ["197e12", "819e9", "50e9",
                                      "16 * 1024**3", "1024**3 * 16"])
def test_no_tpu_constant_in_the_port(constant):
    pkg = ROOT / "src" / "repro_torch"
    assert [f.name for f in pkg.rglob("*.py")
            if constant in f.read_text()] == []


def test_a_per_layer_cache_cannot_shard_its_layer_axis():
    """The reference's cache rule falls back to the layer axis where the
    batch does not divide; a per-layer list cannot show that, so the port
    refuses it."""
    cache = {"layers": [{"wkv": torch.empty(3, 4, device="meta")}] * 16}
    with pytest.raises(ValueError, match="layer axis"):
        sharding.cache_specs(mesh.GRIDS["16x16"], cache)
