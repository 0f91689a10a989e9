"""repro_torch.dist.sharding: tests/test_sharding.py's cases on a mock
mesh, and the port's specs held equal to the reference's (a
``PartitionSpec`` read as a tuple) for all ten configurations on the
production meshes and several small mock meshes. Exact comparisons."""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import repro.configs as RC
from repro.dist import sharding as RS
from repro.models import cache_spec as ref_cache_spec
from repro.models import init_params as ref_init_params

import repro_torch.configs as TC
from repro_torch.dist.sharding import (ShardingRules, _leaf_spec,
                                       batch_specs, cache_specs, dp_axes,
                                       param_specs)
from repro_torch.launch.mesh import (make_data_mesh, make_local_mesh,
                                     make_production_mesh)


class MockMesh:
    def __init__(self, shape: dict):
        self._shape = shape

    @property
    def shape(self):
        return self._shape

    @property
    def axis_names(self):
        return tuple(self._shape)


MESH = MockMesh({"data": 16, "model": 16})
MESH_POD = MockMesh({"pod": 2, "data": 16, "model": 16})


def test_embed_spec_tp_on_vocab():
    rules = ShardingRules(TC.get_config("llama3-405b"), MESH)
    assert _leaf_spec(rules, "embed", (128256, 16384)) == ("model", "data")


def test_fsdp_uses_pod_and_data():
    rules = ShardingRules(TC.get_config("llama3-405b"), MESH_POD)
    spec = _leaf_spec(rules, "blocks/0/attn/wq", (126, 16384, 16384))
    assert spec == (None, ("pod", "data"), "model")


def test_nondivisible_dim_falls_back_to_replication():
    cfg = TC.get_config("granite-moe-3b-a800m")
    rules = ShardingRules(cfg, MESH)
    spec = _leaf_spec(rules, "blocks/0/ffn/w_up", (32, 40, 1536, 512))
    assert spec[1] is None                  # E not sharded
    assert "model" in (spec[2], spec[3])    # hidden dim takes TP instead


def test_divisible_experts_use_expert_parallel():
    cfg = TC.get_config("deepseek-moe-16b")
    rules = ShardingRules(cfg, MESH)
    spec = _leaf_spec(rules, "blocks/0/ffn/w_up", (28, 64, 2048, 1408))
    assert spec == (None, "model", "data", None)


def test_small_vector_replicated():
    rules = ShardingRules(TC.get_config("granite-3-2b"), MESH)
    assert _leaf_spec(rules, "blocks/0/ln1/scale", (40, 2048)) == (None,
                                                                   None)


def test_batch_specs_degrade_for_tiny_batch():
    specs = batch_specs(TC.get_config("mamba2-1.3b"),
                        make_local_mesh(data=1, model=1, device="cpu"),
                        global_batch=1)
    assert specs["tokens"] in ((None, None), ("data", None))


# ------------------------------ parity --------------------------------------

MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16},
          "d1m1": {"data": 1, "model": 1}, "d2m4": {"data": 2, "model": 4},
          "d8m2": {"data": 8, "model": 2},
          "p3d2m3": {"pod": 3, "data": 2, "model": 3},
          "d4": {"data": 4}}


def _norm(spec):
    """A reference PartitionSpec as a plain tuple of its entries."""
    assert isinstance(spec, P)
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e
                 for e in spec)


def _ref_flat(tree, prefix=""):
    """(path, leaf) pairs; lists are tree nodes, tuples (the port's
    specs) and PartitionSpecs leaves."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _ref_flat(tree[k], f"{prefix}/{k}" if prefix else k)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _ref_flat(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _shapes(arch):
    cfg = RC.get_config(arch)
    return jax.eval_shape(lambda: ref_init_params(cfg, jax.random.PRNGKey(0)))


@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_param_specs_match_reference(arch):
    shapes = _shapes(arch)
    rcfg, tcfg = RC.get_config(arch), TC.get_config(arch)
    tshapes = jax.tree.map(lambda s: torch.empty(s.shape, device="meta"),
                           shapes)
    for name, shape in MESHES.items():
        mesh = MockMesh(shape)
        want = dict(_ref_flat(RS.param_specs(rcfg, mesh, shapes)))
        got = dict(_ref_flat(param_specs(tcfg, mesh, tshapes)))
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k] == _norm(want[k]), (name, k, got[k], want[k])
        assert dp_axes(mesh) == RS.dp_axes(mesh)


@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_batch_and_cache_specs_match_reference(arch):
    rcfg, tcfg = RC.get_config(arch), TC.get_config(arch)
    caches = jax.eval_shape(lambda: ref_cache_spec(rcfg.reduced(), 8, 64))
    tcaches = jax.tree.map(lambda s: torch.empty(s.shape, device="meta"),
                           caches)
    for name, shape in MESHES.items():
        mesh = MockMesh(shape)
        for gb in (None, 1, 2, 6, 32, 512):
            want = RS.batch_specs(rcfg, mesh, gb)
            got = batch_specs(tcfg, mesh, gb)
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k] == _norm(want[k]), (name, gb, k)
                assert isinstance(got[k], tuple)
        want = dict(_ref_flat(RS.cache_specs(rcfg.reduced(), mesh, caches)))
        got = dict(_ref_flat(cache_specs(tcfg.reduced(), mesh, tcaches)))
        assert {k: _norm(v) for k, v in want.items()} == got, name


def test_production_meshes_describe_the_reference_shapes():
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    m = make_production_mesh(multi_pod=True)
    assert m.shape == {"pod": 2, "data": 16, "model": 16}
    assert m.axis_names == ("pod", "data", "model") and m.devices is None
    assert m.size == 512


def test_local_mesh_on_the_cpu_and_its_limits():
    m = make_local_mesh(device="cpu")
    assert m.shape == {"data": 1, "model": 1}
    assert m.devices == (torch.device("cpu"),)
    assert make_local_mesh(pod=1, device="cpu").axis_names == (
        "pod", "data", "model")
    with pytest.raises(ValueError):
        make_local_mesh(data=2, device="cpu")
    with pytest.raises(ValueError):
        make_local_mesh(data=0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_local_mesh()
    assert make_data_mesh(3, device="cpu").shape == {"data": 3}
    assert np.prod(list(make_local_mesh(device="cpu").shape.values())) == 1
