"""Public wrappers of the SpMV kernels K1-K6 and the multi-RHS (SpMM)
kernels K7-K11 (the port of ``repro.kernels.ops``).

The kernel builder (``core/kernel_builder.py`` with ``backend='cuda'``)
calls these: a 1-D x goes to the SpMV kernels, an (n_cols, B) x to the
SpMM ones. Each runs its CUDA kernel on GPU tensors and its plain PyTorch
version (``ref.py``) on CPU tensors. All accept mixed-precision storage
(bfloat16 vals, int16 cols), upcast in registers and return float32. The
``*_fused`` variants own the cross-tile combine and add the finished rows
into y.
"""
from .ell_spmv import (ell_spmm, ell_spmm_direct,  # noqa: F401
                       ell_spmm_fused, ell_spmv, ell_spmv_direct,
                       ell_spmv_fused)
from .seg_spmv import (seg_spmm, seg_spmm_fused, seg_spmv,  # noqa: F401
                       seg_spmv_fused)

__all__ = ["ell_spmv", "ell_spmv_direct", "ell_spmv_fused", "seg_spmv",
           "seg_spmv_fused", "ell_spmm", "ell_spmm_direct", "ell_spmm_fused",
           "seg_spmm", "seg_spmm_fused"]
