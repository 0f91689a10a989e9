"""Public wrappers of the 1-RHS SpMV kernels K1-K6 (the port of
``repro.kernels.ops``).

The kernel builder (``core/kernel_builder.py`` with ``backend='cuda'``)
calls these. Each runs its CUDA kernel on GPU tensors and its plain
PyTorch version (``ref.py``) on CPU tensors. All accept mixed-precision
storage (bfloat16 vals, int16 cols), upcast in registers and return
float32. The ``*_fused`` variants own the cross-tile combine and add the
finished rows into y.
"""
from .ell_spmv import ell_spmv, ell_spmv_direct, ell_spmv_fused  # noqa: F401
from .seg_spmv import seg_spmv, seg_spmv_fused  # noqa: F401

__all__ = ["ell_spmv", "ell_spmv_direct", "ell_spmv_fused", "seg_spmv",
           "seg_spmv_fused"]
