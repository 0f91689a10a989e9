"""The port's numpy Designer and format packer against the reference.

The same matrix and the same Operator Graph (carried between the two
packages as graph JSON, since their ``OpSpec`` classes differ) must give
bit-identical MetadataSet layouts, the same design space, an identical
kernel spec (``json.dumps`` equal) and bit-identical format arrays, and
the golden anneal walk must replay candidate for candidate.
"""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import kernel_builder as ref_kb
from repro.core.graph import run_graph as ref_run_graph
from repro.core.matrices import make_suite
from repro.core.search import SearchConfig as RefSearchConfig
from repro.core.search import _graph_to_jsonable
from repro.design.registry import OpSpec as RefOpSpec
from repro.core.graph import OperatorGraph as RefGraph

from repro_torch.core import kernel_builder as kb
from repro_torch.core import matrices as tm
from repro_torch.core.graph import run_graph
from repro_torch.core.search import (AlphaSparseSearch, SearchConfig,
                                     _graph_from_jsonable)
from repro_torch.design.space import DesignSpace

DATA = Path(__file__).parent / "data"


def _port_matrix(m):
    return tm.SparseMatrix(m.n_rows, m.n_cols, m.rows, m.cols, m.vals)


def _chain(*ops):
    return RefGraph.chain(*(RefOpSpec.make(n, **p) for n, p in ops))


# reference graphs covering every built-in operator
GRAPHS = {
    "ell": _chain(("COMPRESS", {}), ("LANE_ROW_BLOCK", {}),
                  ("LANE_TOTAL_RED", {})),
    "ell_tiled_grid": _chain(("COMPRESS", {}), ("TILE_ROW_BLOCK", {"rows": 16}),
                             ("LANE_ROW_BLOCK", {}),
                             ("LANE_TOTAL_RED", {"combine": "grid_acc"})),
    "sell_pad": _chain(("COMPRESS", {}), ("SORT", {}),
                       ("TILE_ROW_BLOCK", {"rows": 32}),
                       ("SORT_TILE", {"window": 4}),
                       ("LANE_PAD", {"pad_to": 8}), ("LANE_ROW_BLOCK", {}),
                       ("LANE_TOTAL_RED", {})),
    "seg_scan": _chain(("COMPRESS", {}),
                       ("LANE_NNZ_BLOCK", {"chunk": 64, "lanes": 8}),
                       ("SEG_SCAN_RED", {})),
    "onehot_knobs": _chain(("COMPRESS", {}),
                           ("SET_RESOURCES", {"tiles_per_step": 4,
                                              "dtype": "bfloat16"}),
                           ("LANE_NNZ_BLOCK", {"chunk": 128}),
                           ("ONEHOT_MXU_RED", {})),
    "gmem_atom": _chain(("COMPRESS", {}), ("SORT", {}),
                        ("LANE_NNZ_BLOCK", {"chunk": 64, "lanes": 8}),
                        ("GMEM_ATOM_RED", {})),
    "bin_branches": RefGraph(
        converting=(RefOpSpec.make("COMPRESS"),
                    RefOpSpec.make("BIN", n_bins=2)),
        branch_chains=(
            (RefOpSpec.make("TILE_ROW_BLOCK", rows=8),
             RefOpSpec.make("LANE_ROW_BLOCK"),
             RefOpSpec.make("LANE_TOTAL_RED")),
            (RefOpSpec.make("LANE_NNZ_BLOCK", chunk=64, lanes=8),
             RefOpSpec.make("SEG_SCAN_RED"))),
        shared=False),
    "row_div_hyb": _chain(("COMPRESS", {}),
                          ("ROW_DIV", {"strategy": "even_nnz", "parts": 2}),
                          ("SORT_SUB", {}), ("LANE_ROW_BLOCK", {}),
                          ("LANE_TOTAL_RED", {})),
    "hyb_split": _chain(("COMPRESS", {}), ("HYB_SPLIT", {"q": 0.9}),
                        ("LANE_NNZ_BLOCK", {"chunk": 128}),
                        ("SEG_SCAN_RED", {})),
    "col_div": _chain(("COMPRESS", {}), ("COL_DIV", {"parts": 2}),
                      ("TILE_ROW_BLOCK", {"rows": 8}), ("LANE_ROW_BLOCK", {}),
                      ("LANE_TOTAL_RED", {})),
}

MATRICES = ("powerlaw_mid", "banded", "hyb_like", "wide")


@pytest.fixture(scope="module")
def suite():
    return make_suite("small")


def _assert_same(a, b, where="meta"):
    """Recursive equality: dataclasses field by field (by class name, the
    two packages' classes differ), arrays bit for bit with their dtype."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name),
                         f"{where}.{f.name}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (u, v) in enumerate(zip(a, b)):
            _assert_same(u, v, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a, b), where
    else:
        assert a == b, where


def _bits(a) -> np.ndarray:
    """An array's raw bits (bf16 as uint16) from either package."""
    if isinstance(a, torch.Tensor):
        a = a.cpu()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(a)
    if a.dtype == np.dtype(jnp.bfloat16):
        return a.view(np.uint16)
    return a


@pytest.mark.parametrize("mname", MATRICES)
@pytest.mark.parametrize("gname", sorted(GRAPHS))
def test_run_graph_bit_identical(suite, gname, mname):
    m = suite[mname]
    g_ref = GRAPHS[gname]
    g = _graph_from_jsonable(json.loads(json.dumps(_graph_to_jsonable(g_ref))))
    assert g.label() == g_ref.label()
    try:
        meta_ref = ref_run_graph(m, g_ref)
    except ValueError:            # GraphError: an inapplicable design
        with pytest.raises(ValueError):
            run_graph(_port_matrix(m), g)
        return
    meta = run_graph(_port_matrix(m), g)
    _assert_same(meta_ref, meta)


def test_multi_width_ell_layout_bit_identical():
    """The port routes each nonzero to its width bucket in one pass; the
    reference rescans all nonzeros once per width. On a power-law matrix
    under ``capacity_graph()`` (8-row tiles sorted by length, widths padded
    to 8) the buckets are many, and every array must still match."""
    from repro.core.matrices import powerlaw_matrix
    from repro_torch.train.dynamic import capacity_graph
    g = capacity_graph()
    g_ref = _chain(
        ("COMPRESS", {}), ("TILE_ROW_BLOCK", {"rows": 8}),
        ("SORT_TILE", {"window": 8}), ("LANE_PAD", {"pad_to": 8}),
        ("LANE_ROW_BLOCK", {}), ("LANE_TOTAL_RED", {"combine": "scatter"}))
    assert g_ref.label() == g.label()
    m = powerlaw_matrix(4096, 4096, 8.0, 1.5, seed=0)
    meta_ref = ref_run_graph(m, g_ref)
    meta = run_graph(_port_matrix(m), g)
    assert len(meta.blocks[0].layout.buckets) >= 13
    _assert_same(meta_ref, meta)


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("tiles", [1, 3])
def test_plan_format_spec_and_arrays_identical(suite, storage, fuse, tiles):
    for mname in ("powerlaw_mid", "banded"):
        m = suite[mname]
        for gname, g_ref in GRAPHS.items():
            g = _graph_from_jsonable(_graph_to_jsonable(g_ref))
            try:
                meta_ref = ref_run_graph(m, g_ref)
            except ValueError:
                continue
            meta = run_graph(_port_matrix(m), g)
            fmt_r, spec_r = ref_kb.plan_format(
                meta_ref, storage_dtype=storage, tiles_per_step=tiles,
                fuse_combine=fuse)
            fmt_p, spec_p = kb.plan_format(
                meta, storage_dtype=storage, tiles_per_step=tiles,
                fuse_combine=fuse, device="cpu")
            where = f"{mname}/{gname}"
            assert json.dumps(spec_p) == json.dumps(spec_r), where
            assert sorted(fmt_p) == sorted(fmt_r), where
            for k in fmt_r:
                a, b = _bits(fmt_r[k]), _bits(fmt_p[k])
                assert a.dtype == b.dtype and a.shape == b.shape, (where, k)
                assert np.array_equal(a, b), (where, k)


def test_design_space_identical(suite):
    from repro.design.space import DesignSpace as RefDesignSpace
    for mname in MATRICES:
        m = suite[mname]
        ref = RefDesignSpace(m, RefSearchConfig())
        port = DesignSpace(_port_matrix(m), SearchConfig(backend="torch"))
        assert ([s.label() for s in port.structures()]
                == [s.label() for s in ref.structures()]), mname
        assert port.pruned_ops == ref.pruned_ops
        s_ref, s_port = ref.structures()[0], port.structures()[0]
        assert ([g.label() for g in port.bind(s_port, "coarse")]
                == [g.label() for g in ref.bind(s_ref, "coarse")])


GOLDEN_FAMILIES = {
    "banded": lambda: tm.banded_matrix(300, 3, seed=12),
    "uniform": lambda: tm.random_uniform_matrix(256, 256, 0.02, seed=13),
    "powerlaw": lambda: tm.powerlaw_matrix(400, 350, 6.0, 1.0, seed=11),
    "hyb_like": lambda: tm.hyb_friendly_matrix(256, 4, 8, 64, seed=7),
}


@pytest.mark.parametrize("family", sorted(GOLDEN_FAMILIES))
def test_golden_anneal_walk_replays_in_port(family):
    """As tests/test_design.py::test_anneal_parity_with_prerefactor_walk,
    on the port's torch backend."""
    golden = json.loads(
        (DATA / "golden_anneal_walk_small.json").read_text())[family]
    s = AlphaSparseSearch(
        GOLDEN_FAMILIES[family](),
        SearchConfig(max_structures=2, max_seconds=600.0, coarse_samples=100,
                     use_cost_model=False, timing_repeats=1, seed=0,
                     backend="torch"))
    res = s.run()
    assert [g.label() for g in s._memo] == golden["sequence"]
    assert res.n_structures == golden["n_structures"]
    assert res.n_evaluations == golden["n_evaluations"]
    assert res.best_graph.label() in golden["sequence"]
