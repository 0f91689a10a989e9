"""The port has the reference's public surface: every public name of every
module of ``src/repro/`` is public in the same module of
``src/repro_torch/`` (read with ``ast``, so that a later gap shows), apart
from the Pallas layer and the jax shims; and the two deprecated shims,
``core.search.search`` and ``core.kernel_builder.build_spmv``, work as
the reference's do."""
import ast
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
REF, PORT = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"

# not ported, by design: jax's AOT cost-analysis shim (the port's counts
# are dicts from the start), the Pallas wrappers (``*_pallas``; the CUDA
# wrappers keep the public names of ``kernels/ops.py``), the kernels
# package's own re-exports of those jitted wrappers (its submodules are
# the port's wrapper modules), and the ``Array = jax.Array`` type alias
SKIP_MODULES = {"launch/compat.py", "kernels/__init__.py"}
SKIP_NAMES = {"Array"}


def public_names(path: Path) -> set:
    """A module's public names: its ``__all__`` where it has a literal
    one, else the names it binds at top level (def, class, assignment;
    in a package's ``__init__`` also ``from ... import``), with the keys
    of a lazy package's ``_EXPORTS``; without the private ones."""
    names, listed = set(), None
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if not isinstance(t, ast.Name):
                    continue
                names.add(t.id)
                if t.id in ("__all__", "_EXPORTS"):
                    try:
                        value = set(ast.literal_eval(node.value))
                    except ValueError:        # computed: sorted(_EXPORTS)
                        continue
                    if t.id == "__all__":
                        listed = value
                    else:
                        names |= value
        elif isinstance(node, ast.ImportFrom) and path.name == "__init__.py":
            names.update(a.asname or a.name for a in node.names)
    if listed is not None:
        names = listed
    return {n for n in names if not n.startswith("_")}


MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py")
                 if str(p.relative_to(REF)) not in SKIP_MODULES)


@pytest.mark.parametrize("rel", MODULES)
def test_module_has_reference_public_names(rel):
    port = PORT / rel
    assert port.is_file(), f"{rel} has no counterpart in the port"
    ref = public_names(REF / rel)
    missing = {n for n in ref - public_names(port)
               if not n.endswith("_pallas") and n not in SKIP_NAMES}
    assert not missing, f"{rel}: the port lacks {sorted(missing)}"


def test_skipped_modules_are_the_documented_ones():
    assert not (PORT / "launch" / "compat.py").exists()
    assert (PORT / "launch" / "dryrun.py").is_file()


@pytest.fixture
def small_uniform():
    from repro_torch.core.matrices import random_uniform_matrix
    return random_uniform_matrix(256, 256, 0.02, seed=13)


def test_program_features_shape(small_uniform):
    """tests/test_search.py's case through the port's build_spmv."""
    from repro_torch.core.cost_model import FEATURE_NAMES, program_features
    from repro_torch.core.graph import OperatorGraph, run_graph
    from repro_torch.core.kernel_builder import build_spmv
    from repro_torch.core.operators import OpSpec
    g = OperatorGraph.chain(OpSpec.make("COMPRESS"),
                            OpSpec.make("LANE_ROW_BLOCK"),
                            OpSpec.make("LANE_TOTAL_RED"))
    meta = run_graph(small_uniform, g)
    prog = build_spmv(meta, backend="torch")
    f = program_features(meta, prog)
    assert f.shape == (len(FEATURE_NAMES),)
    assert np.all(np.isfinite(f))


def test_shims_warn_once_and_match_the_new_surface(small_uniform):
    import repro_torch
    from repro_torch.core import build_program, build_spmv, search
    from repro_torch.core.deprecation import reset_warnings
    from repro_torch.core.graph import OperatorGraph, run_graph
    from repro_torch.core.operators import OpSpec
    from repro_torch.core.search import SearchConfig
    reset_warnings()
    meta = run_graph(small_uniform, OperatorGraph.chain(
        OpSpec.make("COMPRESS"), OpSpec.make("LANE_ROW_BLOCK"),
        OpSpec.make("LANE_TOTAL_RED")))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        prog = build_spmv(meta, backend="torch")
        build_spmv(meta, backend="torch")
    assert sum(issubclass(x.category, DeprecationWarning) for x in w) == 1
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        256).astype(np.float32))
    want = build_program(meta, backend="torch")
    assert np.array_equal(prog(x).numpy(), want(x).numpy())

    cfg = SearchConfig(backend="torch", max_seconds=5, max_structures=1,
                       coarse_samples=1, timing_repeats=1)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        res = search(small_uniform, cfg)
    assert any(issubclass(x.category, DeprecationWarning) for x in w)
    assert callable(repro_torch.core.search)    # the shim, not its module
    assert isinstance(res, type(repro_torch.compile(
        small_uniform, repro_torch.Target(backend="torch"),
        budget=cfg).search_result))
    assert res.n_evaluations > 0
    o = small_uniform.spmv_dense_oracle(x.numpy())
    assert np.abs(res.best_program(x).numpy() - o).max() <= \
        1e-4 * np.abs(o).max()
