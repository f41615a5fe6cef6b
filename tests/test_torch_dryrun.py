"""The port's dry run (`repro_torch.launch.dryrun`) and the registry
pieces it reads, held to the JAX package's.

  * `SHAPES` and `cell_is_runnable` equal the reference's for the 10
    archs x 4 shapes (the skip strings included);
  * `input_specs` without a mesh gives `meta` tensors of the shapes and
    dtypes of the reference's ShapeDtypeStructs, cache trees included;
  * each entry's parameter block on the production mesh (16 x 16 and 2 x
    16 x 16, both policies, FSDP on and off) holds the bytes of the
    reference's spec tree split by the reference's `mesh_rules` /
    `logical_to_pspec` (on a shape-only mesh stand-in, as
    tests/test_torch_mesh_rules.py does);
  * `python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k
    --mesh single` runs in a fresh process with no JAX module loaded,
    writes the reference's result keys (read from the reference's source,
    whose `lower_cell` needs 512 host devices and a TPU-sized compile)
    and takes its constants from the port's H100 `DeviceSpec`; the
    expert-parallel and sequence-parallel cells are priced.
"""
import ast
import dataclasses
import json
import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import cell_is_runnable as jcell  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.models import param as jP  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.models.model import input_specs as jinput_specs  # noqa: E402
from repro_torch.configs import (ARCH_IDS, SHAPES, cell_is_runnable,  # noqa: E402
                                 get_config)
from repro_torch.distributed import sharding as tsh  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.launch.roofline import DeviceSpec  # noqa: E402
from repro_torch.models.model import build_model, input_specs  # noqa: E402
from repro_torch.models.param import tree_leaves  # noqa: E402

ROOT = pathlib.Path(__file__).parents[1]


class FakeMesh:
    """Just enough mesh for the reference's mesh_rules: its shape dict."""

    def __init__(self, shape):
        self.shape = shape


def test_shapes_and_runnable_cells_equal_the_reference():
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JSHAPES.items()}
    for arch in ARCH_IDS:
        for shape in SHAPES:
            assert cell_is_runnable(get_config(arch), shape) == \
                jcell(jget_config(arch), shape), (arch, shape)


def _sorted_leaves(tree):
    """Leaves in JAX's flattening order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _sorted_leaves(v)]
    return [tree]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for shape in SHAPES:
        if shape != "train_4k" and cell_is_runnable(cfg, shape) != "ok":
            continue
        got, want = input_specs(cfg, shape), jinput_specs(jcfg, shape)
        assert sorted(got) == sorted(want), (arch, shape)
        for key in got:
            g, w = _sorted_leaves(got[key]), jax.tree.leaves(want[key])
            assert len(g) == len(w), (arch, shape, key)
            for a, b in zip(g, w):
                assert a.device.type == "meta"
                assert tuple(a.shape) == tuple(b.shape), (arch, shape, key)
                assert str(a.dtype).split(".")[-1] == str(b.dtype), \
                    (arch, shape, key)


def _ways(entry, shape):
    if entry is None:
        return 1
    return math.prod(shape[a] for a in
                     (entry if isinstance(entry, tuple) else (entry,)))


@pytest.mark.parametrize("multi_pod", [False, True])
def test_parameter_blocks_equal_the_reference_rules(multi_pod):
    n = 512 if multi_pod else 256
    mesh = make_production_mesh(multi_pod,
                                devices=[torch.device("meta")] * n)
    jmesh = FakeMesh(dict(mesh.shape))
    for arch in ARCH_IDS:
        cfg, jcfg = get_config(arch), jget_config(arch)
        for policy in ("tp", "zero"):
            for fsdp in (True, False):
                rules = tsh.mesh_rules(mesh, cfg, fsdp=fsdp, policy=policy)
                assert rules == jsh.mesh_rules(jmesh, jcfg, fsdp=fsdp,
                                               policy=policy)
                tp = mesh.shape["model"] if rules["heads"] else 1
                model = build_model(cfg, ep=mesh.shape["model"], tp=tp)
                got = sum(t.numel() * t.element_size() for t in
                          tree_leaves(model.abstract_params(mesh, rules)))
                want = 0
                for s in jax.tree.leaves(
                        jT.build_spec(jcfg, ep=mesh.shape["model"], tp=tp),
                        is_leaf=jP.is_spec):
                    pspec = tuple(jP.logical_to_pspec(s.axes, rules))
                    want += 4 * math.prod(
                        -(-d // _ways(e, jmesh.shape))
                        for d, e in zip(s.shape, pspec))
                assert got == want, (arch, policy, fsdp)


def _reference_result_keys():
    """The keys of `lower_cell`'s result dict, its memory dict and
    `collective_bytes`' dict, read from the reference's source."""
    tree = ast.parse((ROOT / "src" / "repro" / "launch" /
                      "dryrun.py").read_text())
    keys = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id in ("res", "out"):
            keys[node.targets[0].id] = [k.value for k in node.value.keys]
            for k, v in zip(node.value.keys, node.value.values):
                if k.value == "memory":
                    keys["memory"] = [m.value for m in v.keys]
    return keys


def test_dryrun_cli_runs_without_jax_and_writes_the_reference_keys(
        tmp_path):
    out = tmp_path / "dryrun.json"
    code = (
        "import sys, json\n"
        "from repro_torch.launch import dryrun\n"
        f"dryrun.main(['--arch', 'olmo-1b', '--shape', 'train_4k', "
        f"'--mesh', 'single', '--out', {str(out)!r}])\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))"
        " or m == 'repro' for m in sys.modules), 'jax or repro imported'\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=tmp_path, timeout=300)
    (r,) = json.loads(out.read_text())
    keys = _reference_result_keys()
    assert r["status"] == "ok"
    assert list(r) == keys["res"]
    assert list(r["memory"]) == keys["memory"]
    assert list(r["collective_bytes_per_device"]) == keys["out"]
    h100 = DeviceSpec()
    assert (dryrun.PEAK_FLOPS, dryrun.HBM_BW, dryrun.LINK_BW) == \
        (h100.peak_flops_bf16, h100.hbm_bw, h100.link_bw)
    terms = r["roofline"]
    assert terms["compute_s"] == pytest.approx(
        r["flops_per_device"] / h100.peak_flops_bf16)
    assert terms["memory_s"] == pytest.approx(
        r["bytes_per_device"] / h100.hbm_bw)
    assert r["remat"] == "full" and r["flops_per_device"] > \
        r["model_flops_per_chip"]          # the recompute costs a forward
    assert np.isfinite(r["step_time_bound_s"]) and \
        r["memory"]["peak_estimate_bytes"] > 0
    # resumable: a second run finds the cell done and adds nothing
    dryrun.main(["--arch", "olmo-1b", "--shape", "train_4k", "--mesh",
                 "single", "--out", str(out)])
    assert len(json.loads(out.read_text())) == 1


def test_skip_cells_and_expert_parallel_cells_are_priced():
    r = dryrun.lower_cell("hubert-xlarge", "decode_32k", multi_pod=False)
    assert r["status"] == jcell(jget_config("hubert-xlarge"), "decode_32k")
    ep = dryrun.lower_cell("qwen2-moe-a2.7b", "decode_32k", multi_pod=False)
    assert ep["status"] == "ok" and ep["moe_impl"] == "ep"
    assert ep["collective_bytes_per_device"]["all-to-all"] > 0
    assert [c["kind"] for c in ep["per_layer_costs"]] == ["block"]
    assert ep["per_layer_costs"][0]["count"] == 24
