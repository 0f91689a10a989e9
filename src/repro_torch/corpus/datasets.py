"""Corpus registry: deterministic synthetic sweeps + cached SuiteSparse.

Port of ``repro.corpus.datasets``: the families, entry names, seeds and
fingerprints are the reference's, so both packages build bit-identical
matrices from one corpus definition. A corpus is a list of
:class:`CorpusEntry` values — (family, params, seed) triples that build a
:class:`~repro_torch.core.matrices.SparseMatrix` on demand, so a corpus
definition is a few hundred bytes and fully deterministic, while the
matrices themselves are never pickled or shipped.

Two sources:

* ``synthetic_corpus(scale)`` — sweeps the benchmark families
  (banded / uniform / power-law / blocked / hyb) over size x density x
  skew.  Same ``(scale, seed)`` -> same corpus, forever.
* ``suitesparse_entry(group, name)`` — a real ``.mtx`` from the SuiteSparse
  collection, read from a local cache directory. This package never
  fetches: a matrix missing from the cache makes ``build()`` warn and
  return ``None`` (what the reference does offline), so sweeps degrade to
  the synthetic slice.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import warnings
from pathlib import Path
from typing import Callable, Optional

from repro_torch.core.matrices import (
    SparseMatrix,
    banded_matrix,
    blocked_matrix,
    hyb_friendly_matrix,
    powerlaw_matrix,
    random_uniform_matrix,
    read_matrix_market,
)

__all__ = [
    "CorpusEntry", "CORPUS_FAMILIES", "register_family",
    "synthetic_corpus", "holdout_corpus",
    "suitesparse_entry", "load_suitesparse",
]

# family name -> generator taking (seed=..., **params) -> SparseMatrix|None
CORPUS_FAMILIES: dict[str, Callable[..., Optional[SparseMatrix]]] = {}


def register_family(name: str):
    """Register a corpus generator under ``name`` (decorator)."""
    def deco(fn):
        CORPUS_FAMILIES[name] = fn
        return fn
    return deco


@dataclasses.dataclass(frozen=True)
class CorpusEntry:
    """One corpus member; ``build()`` is deterministic in (family, params, seed)."""
    name: str
    family: str
    params: tuple[tuple[str, object], ...]
    seed: int = 0

    def build(self) -> Optional[SparseMatrix]:
        """Materialise the matrix (``None`` if the source is unavailable,
        e.g. a SuiteSparse entry while offline)."""
        fn = CORPUS_FAMILIES[self.family]
        return fn(seed=self.seed, **dict(self.params))

    def fingerprint(self) -> str:
        """Stable identity for sweep-resume journals: a short hash of the
        full (name, family, params, seed) tuple, so renaming a family or
        re-parameterising an entry never aliases an old journal line."""
        payload = json.dumps(
            {"name": self.name, "family": self.family,
             "params": list(self.params), "seed": self.seed},
            sort_keys=True, default=repr)
        return hashlib.sha1(payload.encode()).hexdigest()[:16]


@register_family("banded")
def _banded(n: int, bandwidth: int, seed: int) -> SparseMatrix:
    return banded_matrix(n, bandwidth, seed)


@register_family("uniform")
def _uniform(n: int, avg_row: float, seed: int) -> SparseMatrix:
    return random_uniform_matrix(n, n, avg_row / n, seed)


@register_family("powerlaw")
def _powerlaw(n: int, avg_row: float, alpha: float, seed: int) -> SparseMatrix:
    return powerlaw_matrix(n, n, avg_row, alpha, seed)


@register_family("blocked")
def _blocked(n: int, block: int, blocks_per_row: int, seed: int) -> SparseMatrix:
    return blocked_matrix(n, block, blocks_per_row, seed)


@register_family("hyb")
def _hyb(n: int, base_len: int, n_long: int, long_len: int,
         seed: int) -> SparseMatrix:
    return hyb_friendly_matrix(n, base_len, n_long, long_len, seed)


def _entry(family: str, seed: int, **params) -> CorpusEntry:
    tag = "_".join(f"{k}{v}" for k, v in sorted(params.items()))
    return CorpusEntry(name=f"{family}_{tag}_s{seed}", family=family,
                       params=tuple(sorted(params.items())), seed=seed)


# Per-scale size grids: "smoke" is CI-speed (sub-second searches), "small"
# matches benchmarks/common.scaled_families, "medium" is nightly material.
_SCALE_SIZES = {"smoke": (96, 192), "small": (256, 512), "medium": (1024, 2048)}


def synthetic_corpus(scale: str = "smoke", seed: int = 0) -> list[CorpusEntry]:
    """Deterministic family x size x density x skew sweep.

    Every family from the benchmark suite appears at each size in the
    scale grid, with a second skew/density variant so the learned model
    sees within-family variation, not just family identity."""
    if scale not in _SCALE_SIZES:
        raise ValueError(f"unknown corpus scale {scale!r}; "
                         f"choose from {sorted(_SCALE_SIZES)}")
    lo, hi = _SCALE_SIZES[scale]
    out: list[CorpusEntry] = []
    for i, n in enumerate((lo, hi)):
        s = seed + i
        out.append(_entry("banded", s, n=n, bandwidth=2 + 2 * i))
        out.append(_entry("uniform", s, n=n, avg_row=4.0 * (i + 1)))
        out.append(_entry("powerlaw", s, n=n, avg_row=6.0, alpha=1.0 - 0.2 * i))
        out.append(_entry("blocked", s, n=n, block=4 * (i + 1), blocks_per_row=2))
        out.append(_entry("hyb", s, n=n, base_len=4 + 2 * i,
                          n_long=max(2, n // 48), long_len=max(16, n // 4)))
    return out


def holdout_corpus(scale: str = "smoke", seed: int = 100) -> list[CorpusEntry]:
    """Held-out slice: same families, *different* sizes and seeds than
    ``synthetic_corpus`` — nothing here collides with a training key."""
    lo, hi = _SCALE_SIZES[scale]
    mid = (lo + hi) // 2
    return [
        _entry("banded", seed, n=mid, bandwidth=3),
        _entry("uniform", seed + 1, n=mid, avg_row=6.0),
        _entry("powerlaw", seed + 2, n=mid + lo // 2, avg_row=6.0, alpha=1.2),
        _entry("hyb", seed + 3, n=mid, base_len=5, n_long=max(2, mid // 40),
               long_len=max(16, mid // 4)),
    ]


# ---------------------------------------------------------------- SuiteSparse

def _suitesparse_cache_dir() -> Path:
    env = os.environ.get("REPRO_SUITESPARSE_CACHE")
    if env:
        return Path(env)
    # inside the checkout (results/ is not tracked by git)
    return Path(__file__).resolve().parents[3] / "results" / "suitesparse"


def load_suitesparse(group: str, name: str,
                     cache_dir=None) -> Optional[SparseMatrix]:
    """Read ``group/name`` of the SuiteSparse collection from the cache
    (``<cache>/<group>/<name>.mtx``).

    Returns ``None`` — with a warning — when the file is missing or
    unreadable, so corpora containing real matrices degrade gracefully.
    Nothing is fetched."""
    cache = Path(cache_dir) if cache_dir else _suitesparse_cache_dir()
    mtx = cache / group / f"{name}.mtx"
    try:
        return read_matrix_market(str(mtx))
    except (OSError, ValueError, IndexError) as e:
        warnings.warn(f"suitesparse {group}/{name} unavailable ({e}); "
                      "skipping", stacklevel=2)
        return None


@register_family("suitesparse")
def _suitesparse(group: str, name: str, seed: int = 0,
                 cache_dir: Optional[str] = None) -> Optional[SparseMatrix]:
    del seed  # real matrices have no seed; kept for the CorpusEntry contract
    return load_suitesparse(group, name, cache_dir=cache_dir)


def suitesparse_entry(group: str, name: str,
                      cache_dir: Optional[str] = None) -> CorpusEntry:
    params: dict[str, object] = {"group": group, "name": name}
    if cache_dir:
        params["cache_dir"] = str(cache_dir)
    return CorpusEntry(name=f"ss_{group}_{name}", family="suitesparse",
                       params=tuple(sorted(params.items())), seed=0)
