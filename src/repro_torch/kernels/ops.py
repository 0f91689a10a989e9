"""Public wrappers of the SpMV kernels K1-K6 and the multi-RHS (SpMM)
kernels K7-K11 (the port of ``repro.kernels.ops``).

The kernel builder (``core/kernel_builder.py`` with ``backend='cuda'``)
calls these: a 1-D x goes to the SpMV kernels, an (n_cols, B) x to the
SpMM ones. Each runs its CUDA kernel on GPU tensors and its plain PyTorch
version (``ref.py``) on CPU tensors. All accept mixed-precision storage
(bfloat16 vals, int16 cols), upcast in registers and return float32. The
``*_fused`` variants own the cross-tile combine and add the finished rows
into y. ``rowmap_combine`` adds tile partials into y in an order fixed
when a sharded plan is placed (``combine_order``). ``launch_counts``
reads every wrapper's launch counter by kernel ID.
"""
from .ell_spmv import (ell_spmm, ell_spmm_direct,  # noqa: F401
                       ell_spmm_fused, ell_spmv, ell_spmv_direct,
                       ell_spmv_fused)
from .seg_spmv import (seg_spmm, seg_spmm_fused, seg_spmv,  # noqa: F401
                       seg_spmv_fused)
from .combine import combine_order, rowmap_combine  # noqa: F401

__all__ = ["ell_spmv", "ell_spmv_direct", "ell_spmv_fused", "seg_spmv",
           "seg_spmv_fused", "ell_spmm", "ell_spmm_direct", "ell_spmm_fused",
           "seg_spmm", "seg_spmm_fused", "combine_order", "rowmap_combine",
           "launch_counts"]


def launch_counts() -> dict:
    """This process's kernel launches so far, by kernel ID (K1-K11, K3/K4
    and K10a/K10b by mode, K6 and K11 in either mode) and the ordered
    combine; all 0 where only the plain versions ran (CPU tensors)."""
    return {"K1": ell_spmv.launches, "K2": ell_spmv_direct.launches,
            "K3": seg_spmv.launches["seg_scan"],
            "K4": seg_spmv.launches["onehot_mxu"],
            "K5": ell_spmv_fused.launches, "K6": seg_spmv_fused.launches,
            "K7": ell_spmm.launches, "K8": ell_spmm_direct.launches,
            "K9": ell_spmm_fused.launches,
            "K10a": seg_spmm.launches["seg_scan"],
            "K10b": seg_spmm.launches["onehot_mxu"],
            "K11": seg_spmm_fused.launches,
            "rowmap_combine": rowmap_combine.launches}

