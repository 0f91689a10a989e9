"""Hand-written Hopper (sm_90a) CUDA kernels for AlphaSparse formats.

Each kernel family has: the CUDA C++ source (``csrc/*.cu``, built by
``build.py`` with nvcc and loaded with ctypes), a Python wrapper
(``ell_spmv.py``, ``seg_spmv.py``, re-exported by ``ops.py``) and a plain
PyTorch version (``ref.py``). Submodules import lazily; nothing is built
until a kernel first runs on a GPU tensor.
"""

__all__ = ["build", "ell_spmv", "ops", "ref", "seg_spmv"]


def __getattr__(name):
    if name not in __all__:
        raise AttributeError(
            f"module 'repro_torch.kernels' has no attribute {name!r}")
    import importlib
    return importlib.import_module(f"repro_torch.kernels.{name}")
