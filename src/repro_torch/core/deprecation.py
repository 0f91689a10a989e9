"""Warn-once plumbing for the legacy entrypoints superseded by
``repro_torch.compile`` (search / build_spmv / sparsify_linear*).

Each deprecated entrypoint fires a single ``DeprecationWarning`` per
process — the old surfaces are called in tight loops (search evaluates
thousands of candidate programs), so per-call warnings would drown real
diagnostics.
"""
from __future__ import annotations

import warnings

__all__ = ["warn_once", "reset_warnings"]

_WARNED: set[str] = set()


def warn_once(key: str, message: str, stacklevel: int = 3) -> None:
    if key in _WARNED:
        return
    _WARNED.add(key)
    warnings.warn(message, DeprecationWarning, stacklevel=stacklevel)


def reset_warnings() -> None:
    """Forget which deprecations already fired (test hook)."""
    _WARNED.clear()
