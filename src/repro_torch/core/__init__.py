"""AlphaSparse core on PyTorch: Operator Graph, Designer, Format & Kernel
Generator, Search Engine (paper sections IV-VI).

The entry point is ``repro_torch.compile(matrix, target)`` (see
``repro_torch.api``). The historical one-off entry points (``search``,
``build_spmv``) remain as deprecated shims over that surface. Attribute
access is lazy, except for ``search``: the shim shares its name with its
module, so it is bound when the package is imported (as the reference
binds it), and the name is the function, not the module.
"""

_EXPORTS = {
    "SparseMatrix": "matrices", "make_suite": "matrices",
    "read_matrix_market": "matrices",
    "MetadataSet": "metadata", "from_matrix": "metadata",
    "OPERATORS": "operators", "OpSpec": "operators",
    "OperatorGraph": "graph", "GraphError": "graph", "run_graph": "graph",
    "SpmvProgram": "kernel_builder", "build_program": "kernel_builder",
    "build_spmv": "kernel_builder",
    "build_kernel": "kernel_builder", "plan_format": "kernel_builder",
    "AlphaSparseSearch": "search", "ProgramCache": "search",
    "SearchConfig": "search", "SearchResult": "search",
    "run_search": "search", "search": "search",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(
            f"module 'repro_torch.core' has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(
        f"repro_torch.core.{_EXPORTS[name]}"), name)


def __dir__():
    return __all__


from .search import search  # noqa: E402,F401
