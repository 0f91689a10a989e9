"""``repro_torch.corpus``: fleet-scale corpus harness + learned compilation.

Port of ``repro.corpus``. The paper validates over 843 SuiteSparse
matrices; a fleet compiles millions. This package amortizes search cost
across a *corpus*:

* **datasets** — deterministic synthetic sweeps (size x density x skew
  over the benchmark families) plus a SuiteSparse loader that reads a
  local cache and degrades to ``None`` without it;
* **sweep** — budgeted ``repro_torch.compile`` runs over a corpus slice,
  filling a shared ``PlanStore`` and appending per-matrix training
  records;
* **features / model** — fixed sparsity feature vectors and the
  :class:`CorpusModel` (GBT label ranking + nearest-exemplar parameter
  transfer) trained from store sidecars + sweep records, saved as npz
  next to the store;
* **portfolio** — the ``"portfolio"`` SearchStrategy racing store reuse
  -> learned predictions -> anneal refinement under one
  ``compile(deadline_s=...)`` budget.

Lazy exports (PEP 562): importing ``repro_torch.corpus`` pulls in
neither torch nor numpy.
"""

_EXPORTS = {
    "CorpusEntry": "repro_torch.corpus.datasets",
    "CORPUS_FAMILIES": "repro_torch.corpus.datasets",
    "register_family": "repro_torch.corpus.datasets",
    "synthetic_corpus": "repro_torch.corpus.datasets",
    "holdout_corpus": "repro_torch.corpus.datasets",
    "suitesparse_entry": "repro_torch.corpus.datasets",
    "load_suitesparse": "repro_torch.corpus.datasets",
    "CORPUS_FEATURE_NAMES": "repro_torch.corpus.features",
    "matrix_features": "repro_torch.corpus.features",
    "SweepRecord": "repro_torch.corpus.sweep",
    "run_sweep": "repro_torch.corpus.sweep",
    "load_records": "repro_torch.corpus.sweep",
    "training_rows": "repro_torch.corpus.sweep",
    "CorpusModel": "repro_torch.corpus.model",
    "train_from_store": "repro_torch.corpus.model",
    "default_model_path": "repro_torch.corpus.model",
    "PortfolioStrategy": "repro_torch.corpus.portfolio",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(
            f"module 'repro_torch.corpus' has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(module), name)


def __dir__():
    return __all__
