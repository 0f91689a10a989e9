"""AlphaSparse on PyTorch and CUDA: machine-designed SpMV formats with
hand-written Hopper kernels.

This package is the port of ``repro`` (JAX/Pallas, kept beside it as the
reference). It imports ``torch`` and never ``jax``. Public surface::

    import repro_torch
    plan = repro_torch.compile(matrix, repro_torch.Target())   # on the GPU
    y = plan(x)                       # x: (n_cols,) -> (n_rows,)
    Y = plan(X)                       # X: (n_cols, B) -> (n_rows, B)
    plan.save("matrix.plan.npz")
    plan2 = repro_torch.SpmvPlan.load("matrix.plan.npz")

``Target(backend="cuda")`` (the default) runs the CUDA kernels and raises
when no GPU is present; ``Target(backend="torch")`` runs their plain
PyTorch versions on the CPU. ``Target(mesh=repro_torch.dist.
make_data_mesh(n, device="cuda:0"))`` compiles a ``ShardedSpmvPlan`` of n
shards.

Attribute access is lazy (PEP 562): ``import repro_torch`` imports
neither torch nor numpy until a name is used.
"""

_EXPORTS = {
    # the compile API
    "compile": "repro_torch.api",
    "Target": "repro_torch.api",
    "SpmvPlan": "repro_torch.api",
    "ShardedSpmvPlan": "repro_torch.api",
    "PlanIntegrityError": "repro_torch.api",
    "PlanStore": "repro_torch.api",
    "PlanWatch": "repro_torch.api",
    "load_plan": "repro_torch.api",
    # core containers & search surface
    "SparseMatrix": "repro_torch.core.matrices",
    "read_matrix_market": "repro_torch.core.matrices",
    "make_suite": "repro_torch.core.matrices",
    "OperatorGraph": "repro_torch.core.graph",
    "SearchConfig": "repro_torch.core.search",
    "SearchResult": "repro_torch.core.search",
    "ProgramCache": "repro_torch.core.search",
    "run_search": "repro_torch.core.search",
    # submodules, imported lazily: the pluggable design space, the matvec
    # serving plane, the fault-tolerance manager and sharded SpMV
    "design": None,
    "dist": None,
    "serve": None,
    "ft": None,
    "register_operator": "repro_torch.design.registry",
    "unregister_operator": "repro_torch.design.registry",
    "Operator": "repro_torch.design.registry",
    "OpSpec": "repro_torch.design.registry",
    "DesignSpace": "repro_torch.design.space",
    "SearchStrategy": "repro_torch.design.strategies",
    "AnnealStrategy": "repro_torch.design.strategies",
    "GridStrategy": "repro_torch.design.strategies",
    "CostModelGuidedStrategy": "repro_torch.design.strategies",
    "LearnedStrategy": "repro_torch.design.strategies",
    "register_strategy": "repro_torch.design.strategies",
    # dynamic sparsity (repro_torch.dyn): patch-in-place plans + drift
    # re-search
    "dyn": None,                        # submodule, imported lazily
    "PatternDelta": "repro_torch.dyn",
    "DriftPolicy": "repro_torch.dyn",
    "DynamicSparsityManager": "repro_torch.dyn",
    "CapacityError": "repro_torch.dyn",
    # fleet corpus harness + learned/portfolio compilation
    "corpus": None,                     # submodule, imported lazily
    "CorpusModel": "repro_torch.corpus.model",
    "PortfolioStrategy": "repro_torch.corpus.portfolio",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(
            f"module 'repro_torch' has no attribute {name!r}")
    import importlib
    module = _EXPORTS[name]
    if module is None:                  # submodule export
        return importlib.import_module(f"repro_torch.{name}")
    return getattr(importlib.import_module(module), name)


def __dir__():
    return __all__
