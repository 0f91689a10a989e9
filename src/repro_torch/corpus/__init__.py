"""``repro_torch.corpus``: the corpus harness (port of ``repro.corpus``).

Only the feature vectors are ported so far: ``PlanStore.put`` writes them
into its ``.stats.json`` sidecars, as the reference does. The datasets,
sweeps, the corpus model and the ``"learned"`` / ``"portfolio"``
strategies are ROADMAP queue 1, item 11.
"""

_EXPORTS = {
    "CORPUS_FEATURE_NAMES": "repro_torch.corpus.features",
    "matrix_features": "repro_torch.corpus.features",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(
            f"module 'repro_torch.corpus' has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(_EXPORTS[name]), name)


def __dir__():
    return __all__
