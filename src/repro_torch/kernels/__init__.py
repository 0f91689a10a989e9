"""Hand-written Hopper (sm_90a) CUDA kernels for AlphaSparse formats.

Each kernel family has: the CUDA C++ sources (``csrc/ell_spmv.cu`` and
``seg_spmv.cu`` for the SpMV kernels K1-K6, ``csrc/ell_spmm.cu`` and
``seg_spmm.cu`` for the multi-RHS SpMM kernels K7-K11, each built by
``build.py`` with nvcc and loaded with ctypes), Python wrappers
(``ell_spmv.py``, ``seg_spmv.py``, re-exported by ``ops.py``) and plain
PyTorch versions (``ref.py``); ``csrc/rowmap_combine.cu`` (``combine.py``)
is the ordered combine of the plans. The grouped K1 and K7
(``ell_spmv.py``: ``TileGroup``, ``ell_spmv_grouped``,
``ell_spmm_grouped``) run all of a plan's ELL width buckets in one launch.
Submodules import lazily; nothing is built until a kernel first runs on
a GPU tensor.
"""

__all__ = ["build", "combine", "ell_spmv", "ops", "ref", "seg_spmv"]


def __getattr__(name):
    if name not in __all__:
        raise AttributeError(
            f"module 'repro_torch.kernels' has no attribute {name!r}")
    import importlib
    return importlib.import_module(f"repro_torch.kernels.{name}")
