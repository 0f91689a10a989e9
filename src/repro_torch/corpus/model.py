"""The learned corpus model: sparsity features -> ranked designs.

Port of ``repro.corpus.model`` (numpy only). The npz layout and the
content fingerprint are the reference's, so a model trained by either
package on the same store has the same fingerprint. Training data comes
from two artifacts a warm :class:`~repro_torch.api.PlanStore` already
has lying around:

* ``*.stats.json`` sidecars — one **exemplar** per stored plan: the
  matrix's feature vector plus the winning graph (exact parameter
  bindings included).
* ``sweep_records.jsonl`` (written by :mod:`repro_torch.corpus.sweep`) — per
  candidate-structure **relative slowdowns**: for each swept matrix, every
  structure label's best measured time over the matrix's overall best.

The model has two cooperating parts:

* a GBT regressor (the same dependency-free ensemble the §VI-A level-3
  cost model uses, ``repro_torch.core.cost_model.GBTRegressor``) on
  ``[features, onehot(structure label)]`` -> log relative slowdown, used
  to *rank structure labels* for an unseen matrix;
* a nearest-exemplar lookup in normalized feature space, used to attach
  *concrete parameter bindings* (the stored winning graph of the most
  similar matrix) to each predicted label.

With too few sweep rows to fit trees the model degrades to pure
nearest-exemplar ranking, so a sidecar-only store is already usable.
Artifacts round-trip via npz (:meth:`CorpusModel.save` /
:meth:`CorpusModel.load`) and carry a content :meth:`fingerprint` that
strategies fold into their cache keys.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

from repro_torch.core.cost_model import (GBTRegressor, gbt_from_arrays,
                                         gbt_to_arrays)
from repro_torch.corpus.features import CORPUS_FEATURE_NAMES

__all__ = ["CorpusModel", "train_from_store", "default_model_path",
           "MODEL_FILENAME"]

MODEL_FILENAME = "corpus_model.npz"

# pseudo structure labels that never name a real design-space structure
PSEUDO_LABELS = frozenset({"warm", "fine", "model", "learned", "reuse",
                           "baseline"})

# below this many (matrix, label) rows the GBT would memorise noise;
# degrade to nearest-exemplar ranking instead
_MIN_GBT_ROWS = 8


def default_model_path(store_dir) -> Path:
    """Where the trained model lives: next to the PlanStore entries."""
    return Path(store_dir) / MODEL_FILENAME


class CorpusModel:
    """Feature->design ranking model (see module docstring)."""

    def __init__(self, labels, exemplar_X, exemplar_labels, exemplar_graphs,
                 exemplar_gflops, norm_mean, norm_std,
                 gbt: Optional[GBTRegressor] = None, n_train: int = 0,
                 mad: Optional[float] = None,
                 feature_names=tuple(CORPUS_FEATURE_NAMES)):
        self.labels = tuple(labels)                   # structure-label vocab
        self.exemplar_X = np.asarray(exemplar_X, np.float64)
        self.exemplar_labels = list(exemplar_labels)
        self.exemplar_graphs = list(exemplar_graphs)  # jsonable graph dicts
        self.exemplar_gflops = list(exemplar_gflops)
        self.norm_mean = np.asarray(norm_mean, np.float64)
        self.norm_std = np.asarray(norm_std, np.float64)
        self.gbt = gbt
        self.n_train = int(n_train)
        self.mad = mad
        self.feature_names = tuple(feature_names)

    # ------------------------------------------------------------- training

    @classmethod
    def fit(cls, sweep_rows, exemplars) -> "CorpusModel":
        """Train from sweep rows + exemplars.

        ``sweep_rows``: iterable of ``(features, label, rel_slowdown)``
        with ``rel_slowdown = best_seconds(label) / best_seconds(matrix)``
        (>= 1.0). ``exemplars``: iterable of ``(features, label,
        graph_dict, gflops)`` — the per-matrix winners."""
        exemplars = list(exemplars)
        if not exemplars:
            raise ValueError("cannot fit a corpus model with no exemplars "
                             "(empty store?)")
        ex_X = np.stack([np.asarray(f, np.float64) for f, *_ in exemplars])
        norm_mean = ex_X.mean(axis=0)
        norm_std = np.maximum(ex_X.std(axis=0), 1e-9)

        rows = [(np.asarray(f, np.float64), lab, max(float(r), 1.0))
                for f, lab, r in sweep_rows if lab not in PSEUDO_LABELS]
        labels = sorted({lab for _, lab, _ in rows}
                        | {lab for _, lab, *_ in exemplars
                           if lab not in PSEUDO_LABELS})
        gbt, mad = None, None
        if len(rows) >= _MIN_GBT_ROWS and len(labels) >= 2:
            lab_idx = {lab: i for i, lab in enumerate(labels)}
            X = np.zeros((len(rows), ex_X.shape[1] + len(labels)))
            y = np.empty(len(rows))
            for i, (f, lab, r) in enumerate(rows):
                X[i, :ex_X.shape[1]] = (f - norm_mean) / norm_std
                X[i, ex_X.shape[1] + lab_idx[lab]] = 1.0
                y[i] = np.log(r)
            gbt = GBTRegressor(n_trees=40, max_depth=3).fit(X, y)
            # plain MAE in log-slowdown space: the winner rows have y=0,
            # so the cost model's *relative* MAD would divide by ~zero
            mad = float(np.mean(np.abs(gbt.predict(X) - y)))
        return cls(labels=labels, exemplar_X=ex_X,
                   exemplar_labels=[lab for _, lab, *_ in exemplars],
                   exemplar_graphs=[g for _, _, g, _ in exemplars],
                   exemplar_gflops=[gf for *_, gf in exemplars],
                   norm_mean=norm_mean, norm_std=norm_std, gbt=gbt,
                   n_train=len(rows), mad=mad)

    # ------------------------------------------------------------ inference

    def _norm(self, phi: np.ndarray) -> np.ndarray:
        return (np.asarray(phi, np.float64) - self.norm_mean) / self.norm_std

    def _exemplar_order(self, phi: np.ndarray) -> np.ndarray:
        # distances in normalized space (exemplar_X is stored raw)
        zn = (self.exemplar_X - self.norm_mean) / self.norm_std
        d = np.linalg.norm(zn - self._norm(phi), axis=1)
        return np.argsort(d, kind="stable")

    def rank_labels(self, phi) -> list[tuple[float, str]]:
        """Structure labels for ``phi``, best first, with predicted scores.

        GBT path: predicted log relative slowdown per label (lower =
        better). Fallback path: nearest-exemplar rank (score = rank
        index)."""
        if not self.labels:
            return []
        if self.gbt is not None:
            z = self._norm(phi)
            X = np.zeros((len(self.labels), z.size + len(self.labels)))
            X[:, :z.size] = z
            X[:, z.size:] = np.eye(len(self.labels))
            scores = self.gbt.predict(X)
            order = np.argsort(scores, kind="stable")
            return [(float(scores[i]), self.labels[i]) for i in order]
        ranked, seen = [], set()
        for i in self._exemplar_order(phi):
            lab = self.exemplar_labels[i]
            if lab in PSEUDO_LABELS or lab in seen:
                continue
            seen.add(lab)
            ranked.append((float(len(ranked)), lab))
        for lab in self.labels:          # vocab members with no exemplar
            if lab not in seen:
                ranked.append((float(len(ranked)), lab))
        return ranked

    def suggest_graphs(self, phi, k: int = 3) -> list[tuple[str, dict]]:
        """Up to ``k`` concrete graphs (exact stored parameter bindings),
        nearest-exemplar first, at most one per structure label."""
        out, seen = [], set()
        for i in self._exemplar_order(phi):
            lab = self.exemplar_labels[i]
            if lab in seen:
                continue
            seen.add(lab)
            out.append((lab, self.exemplar_graphs[i]))
            if len(out) >= k:
                break
        return out

    # ---------------------------------------------------------- persistence

    def _arrays(self) -> dict:
        header = {
            "labels": list(self.labels),
            "feature_names": list(self.feature_names),
            "exemplar_labels": self.exemplar_labels,
            "exemplar_graphs": self.exemplar_graphs,
            "exemplar_gflops": self.exemplar_gflops,
            "n_train": self.n_train,
            "mad": self.mad,
        }
        arrays = {"header": np.frombuffer(
                      json.dumps(header).encode(), np.uint8).copy(),
                  "exemplar_X": self.exemplar_X,
                  "norm_mean": self.norm_mean,
                  "norm_std": self.norm_std}
        if self.gbt is not None:
            arrays.update(gbt_to_arrays(self.gbt))
        return arrays

    def fingerprint(self) -> str:
        """Content hash folded into strategy cache keys: two searches with
        different models must not share cached results."""
        h = hashlib.sha1()
        for name, arr in sorted(self._arrays().items()):
            h.update(name.encode())
            h.update(np.ascontiguousarray(arr).tobytes())
        return h.hexdigest()[:12]

    def save(self, path) -> Path:
        """Atomic npz write (temp file + rename, like plan artifacts)."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".npz.tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, **self._arrays())
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        return path

    @classmethod
    def load(cls, path) -> "CorpusModel":
        with np.load(Path(path), allow_pickle=False) as z:
            header = json.loads(bytes(z["header"]).decode())
            if header["feature_names"] != list(CORPUS_FEATURE_NAMES):
                raise ValueError(
                    "corpus model feature layout mismatch: model was "
                    f"trained on {header['feature_names']}, this build "
                    f"expects {CORPUS_FEATURE_NAMES}")
            gbt = gbt_from_arrays(z) if "gbt_nodes" in z.files else None
            return cls(labels=header["labels"],
                       exemplar_X=z["exemplar_X"],
                       exemplar_labels=header["exemplar_labels"],
                       exemplar_graphs=header["exemplar_graphs"],
                       exemplar_gflops=header["exemplar_gflops"],
                       norm_mean=z["norm_mean"], norm_std=z["norm_std"],
                       gbt=gbt, n_train=header["n_train"],
                       mad=header["mad"],
                       feature_names=header["feature_names"])


def train_from_store(store_dir, records_path=None) -> CorpusModel:
    """Train a :class:`CorpusModel` from a PlanStore directory.

    Reads every ``*.stats.json`` sidecar carrying a ``features`` vector
    (exemplars) and, when present, the sweep's ``sweep_records.jsonl``
    (relative-slowdown training rows). Raises ``ValueError`` on an empty
    store."""
    from repro_torch.corpus.sweep import load_records, training_rows

    store_dir = Path(store_dir)
    exemplars = []
    for sidecar in sorted(store_dir.glob("*.stats.json")):
        try:
            payload = json.loads(sidecar.read_text())
            feats = payload["features"]
            graph = payload["graph"]
        except (OSError, ValueError, KeyError):
            continue   # corrupt or pre-features sidecar: skip
        label = _winning_label(graph)
        if label is None:
            continue
        exemplars.append((np.asarray(feats, np.float64), label, graph,
                          payload.get("gflops")))
    rec_path = (Path(records_path) if records_path
                else store_dir / "sweep_records.jsonl")
    rows = training_rows(load_records(rec_path)) if rec_path.is_file() else []
    return CorpusModel.fit(rows, exemplars)


def structure_label_of(graph) -> str:
    """``Structure.label()`` of the structure a bound graph came from.

    Inverse of ``DesignSpace.bind`` at the naming level: drop parameters
    and the woven-in SET_RESOURCES knob op, keep op-name chains. This is
    the vocabulary the model ranks in — it must match the labels the
    strategies' ``Proposal``s carry."""
    conv = "+".join(s.name for s in graph.converting) or "-"
    chains = (graph.branch_chains[:1] if graph.shared
              else graph.branch_chains)
    body = " | ".join(
        "+".join(s.name for s in c if s.name != "SET_RESOURCES")
        for c in chains)
    return f"{conv} => {body}"


def _winning_label(graph_dict) -> Optional[str]:
    """Structure label of a stored winning graph (sidecars store bound
    graphs, not structure labels): rebuild the graph and strip it back."""
    from repro_torch.core.search import _graph_from_jsonable

    try:
        return structure_label_of(_graph_from_jsonable(graph_dict))
    except Exception:
        return None
