"""The port's sharding rules against the reference's.

For every published config, on the reference's own ``AbstractMesh``es
(16, 16) over ("data", "model") and (2, 16, 16) over ("pod", "data",
"model"), and the port's abstract meshes of the same shapes: every leaf
of the parameter specs (train and serve), the optimizer state specs, the
cache specs and the input specs of every applicable shape equals the
reference's ``PartitionSpec`` as a tuple. Then ``to_placements`` maps
specs onto DTensor placements, and the one-card mesh shards nothing.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import input_specs as jax_input_specs  # noqa: E402
from repro.distributed import sharding as JSH  # noqa: E402
from repro.launch.steps import eval_param_shapes as jax_param_shapes  # noqa: E402
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, input_specs  # noqa: E402
from repro_torch.configs import shape_applicable  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch.steps import eval_param_shapes  # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _jax_mesh(shape, axes):
    try:  # jax >= 0.5: AbstractMesh(axis_sizes, axis_names)
        return jax.sharding.AbstractMesh(shape, axes)
    except TypeError:  # jax 0.4.x: AbstractMesh(((name, size), ...))
        return jax.sharding.AbstractMesh(tuple(zip(axes, shape)))


def _as_tuples(tree):
    """A spec tree of PartitionSpecs (reference) or tuples (port) as
    tuples, keyed alike."""
    if isinstance(tree, dict):
        return {k: _as_tuples(v) for k, v in tree.items()}
    return tuple(tree)


def _jax_specs(tree):
    return jax.tree_util.tree_map(tuple, tree, is_leaf=lambda x: isinstance(x, P))


@pytest.fixture(scope="module")
def param_shapes():
    return {a: (eval_param_shapes(get_config(a)), jax_param_shapes(jax_config(a)))
            for a in ARCH_IDS}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_opt_specs_equal_reference(arch, mesh_name, param_shapes):
    shape, axes = MESHES[mesh_name]
    jmesh, mesh = _jax_mesh(shape, axes), M.MESHES[mesh_name]()
    assert mesh.axis_names == axes and mesh.shape == dict(zip(axes, shape))
    cfg, jcfg = get_config(arch), jax_config(arch)
    port, ref = param_shapes[arch]
    for mode in ("train", "serve"):
        got = SH.param_spec_tree(cfg, mesh, mode, port)
        want = JSH.param_spec_tree(jcfg, jmesh, mode, ref)
        assert _as_tuples(got) == _jax_specs(want), (arch, mode)
        assert _as_tuples(SH.opt_state_specs(got)) == _jax_specs(JSH.opt_state_specs(want))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_and_input_specs_equal_reference(arch, mesh_name):
    shape, axes = MESHES[mesh_name]
    jmesh, mesh = _jax_mesh(shape, axes), M.MESHES[mesh_name]()
    cfg, jcfg = get_config(arch), jax_config(arch)
    for name, sc in SHAPES.items():
        if not shape_applicable(cfg, sc):
            continue
        specs, jspecs = input_specs(cfg, sc), jax_input_specs(jcfg, JSHAPES[name])
        got = SH.input_spec_tree(cfg, mesh, sc, specs)
        want = JSH.input_spec_tree(jcfg, jmesh, JSHAPES[name], jspecs)
        assert _as_tuples(got) == _jax_specs(want), (arch, name)
        if "cache" in specs:
            assert (_as_tuples(SH.cache_spec_tree(cfg, mesh, specs["cache"]))
                    == _jax_specs(JSH.cache_spec_tree(jcfg, jmesh, jspecs["cache"])))


@pytest.mark.parametrize("spec,placements", [
    (("data", "model"), ["S(0)", "S(1)"]),
    ((None, "model"), ["R", "S(1)"]),
    (("model", None, None), ["R", "S(0)"]),
    ((None, None), ["R", "R"]),
    ((), ["R", "R"]),
])
def test_to_placements_on_the_production_mesh(spec, placements):
    got = SH.to_placements(spec, M.make_production_mesh())
    assert [str(p) for p in got] == placements


def test_to_placements_for_the_pod_and_data_axes_together():
    """A dim over ("pod", "data") shards over both mesh dims."""
    mesh = M.make_production_mesh(multi_pod=True)
    got = SH.to_placements((("pod", "data"), None, "model"), mesh)
    assert [str(p) for p in got] == ["S(0)", "S(0)", "S(2)"]
    assert SH.shard_count((("pod", "data"), None, "model"), mesh) == 512


def test_one_card_mesh_shards_nothing():
    """On (1, 1) every rule holds (a size-1 axis divides anything), and each
    tensor is one piece: the plan's per-device bytes are the whole."""
    mesh = M.one_gpu_mesh()
    cfg = get_config("qwen2.5-3b")
    specs = SH.param_spec_tree(cfg, mesh, "train", eval_param_shapes(cfg))
    assert specs["blocks"]["attn"]["wq"] == (None, "data", "model")
    leaves = []

    def walk(t):
        for v in t.values():
            walk(v) if isinstance(v, dict) else leaves.append(v)

    walk(specs)
    assert {SH.shard_count(s, mesh) for s in leaves} == {1}
    assert np.all([all(str(p) in ("S(0)", "S(1)", "S(2)", "R") for p in SH.to_placements(s, mesh))
                   for s in leaves])
