"""Lightweight ML cost model (paper §VI-A level 3).

The paper uses XGBoost to interpolate measured coarse-grid timings onto a
fine parameter grid ("mean absolute deviation of 5%, less than GPU
volatility"). We implement a dependency-free gradient-boosted regression
tree ensemble in numpy with the same role; the paper's rationale applies
unchanged: memory-bound programs have piecewise-linear cost boundaries,
which tree ensembles fit well.

Features are derived from the *structural* properties of a generated
program (padding ratio, stored bytes, tile geometry, reduce kind) plus
matrix statistics — all available without running the kernel.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["GBTRegressor", "program_features", "fit_cost_model",
           "FEATURE_NAMES", "gbt_to_arrays", "gbt_from_arrays"]


# ----------------------------- tree ensemble ------------------------------

@dataclasses.dataclass
class _Node:
    feature: int = -1
    threshold: float = 0.0
    left: int = -1
    right: int = -1
    value: float = 0.0


class _Tree:
    def __init__(self, max_depth: int, min_leaf: int):
        self.max_depth = max_depth
        self.min_leaf = min_leaf
        self.nodes: list[_Node] = []

    def fit(self, X: np.ndarray, g: np.ndarray) -> "_Tree":
        self._build(X, g, np.arange(X.shape[0]), 0)
        return self

    def _build(self, X, g, idx, depth) -> int:
        node_id = len(self.nodes)
        self.nodes.append(_Node(value=float(g[idx].mean())))
        if depth >= self.max_depth or idx.size < 2 * self.min_leaf:
            return node_id
        best = None  # (gain, feature, threshold, left_idx, right_idx)
        base = g[idx].sum() ** 2 / idx.size
        for f in range(X.shape[1]):
            xs = X[idx, f]
            order = np.argsort(xs, kind="stable")
            xs_s, g_s = xs[order], g[idx][order]
            csum = np.cumsum(g_s)
            total = csum[-1]
            n = idx.size
            ks = np.arange(self.min_leaf, n - self.min_leaf)
            if ks.size == 0:
                continue
            valid = xs_s[ks - 1] < xs_s[ks]  # only split between distinct values
            if not valid.any():
                continue
            ks = ks[valid]
            left = csum[ks - 1]
            gain = left**2 / ks + (total - left) ** 2 / (n - ks) - base
            k = ks[np.argmax(gain)]
            gn = float(gain.max())
            if best is None or gn > best[0]:
                thr = 0.5 * (xs_s[k - 1] + xs_s[k])
                mask = X[idx, f] <= thr
                # huge feature values can round thr onto xs_s[k], leaving
                # one side empty — not a usable split for this feature
                if not mask.any() or mask.all():
                    continue
                best = (gn, f, thr, idx[mask], idx[~mask])
        if best is None or best[0] <= 1e-12:
            return node_id
        _, f, thr, li, ri = best
        node = self.nodes[node_id]
        node.feature, node.threshold = f, thr
        node.left = self._build(X, g, li, depth + 1)
        node.right = self._build(X, g, ri, depth + 1)
        return node_id

    def predict(self, X: np.ndarray) -> np.ndarray:
        out = np.empty(X.shape[0])
        for i, x in enumerate(X):
            n = 0
            while self.nodes[n].feature >= 0:
                node = self.nodes[n]
                n = node.left if x[node.feature] <= node.threshold else node.right
            out[i] = self.nodes[n].value
        return out


class GBTRegressor:
    """Least-squares gradient boosting on log-time targets."""

    def __init__(self, n_trees: int = 60, lr: float = 0.15, max_depth: int = 3,
                 min_leaf: int = 2):
        self.n_trees, self.lr = n_trees, lr
        self.max_depth, self.min_leaf = max_depth, min_leaf
        self.trees: list[_Tree] = []
        self.base = 0.0

    def fit(self, X: np.ndarray, y: np.ndarray) -> "GBTRegressor":
        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.float64)
        self.base = float(y.mean())
        pred = np.full_like(y, self.base)
        self.trees = []
        for _ in range(self.n_trees):
            resid = y - pred
            t = _Tree(self.max_depth, self.min_leaf).fit(X, resid)
            pred = pred + self.lr * t.predict(X)
            self.trees.append(t)
        return self

    def predict(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, np.float64)
        pred = np.full(X.shape[0], self.base)
        for t in self.trees:
            pred = pred + self.lr * t.predict(X)
        return pred

    def mad(self, X, y) -> float:
        """Mean absolute deviation in relative terms (paper reports 5%)."""
        p = self.predict(X)
        return float(np.mean(np.abs(p - y) / np.maximum(np.abs(y), 1e-12)))


def gbt_to_arrays(model: GBTRegressor) -> dict[str, np.ndarray]:
    """Flatten a fitted ensemble to plain arrays (npz-serialisable).

    Node tables of all trees are concatenated; ``gbt_offsets[t]`` is the
    first row of tree ``t``. Used by ``repro_torch.corpus`` to persist the
    learned corpus model next to a PlanStore."""
    rows = []
    offsets = [0]
    for t in model.trees:
        for n in t.nodes:
            rows.append((n.feature, n.threshold, n.left, n.right, n.value))
        offsets.append(len(rows))
    nodes = (np.array(rows, np.float64) if rows
             else np.zeros((0, 5), np.float64))
    return {
        "gbt_nodes": nodes,
        "gbt_offsets": np.array(offsets, np.int64),
        "gbt_scalars": np.array([model.base, model.lr, model.n_trees,
                                 model.max_depth, model.min_leaf], np.float64),
    }


def gbt_from_arrays(arrays) -> GBTRegressor:
    """Inverse of :func:`gbt_to_arrays`; predictions are bit-identical."""
    base, lr, n_trees, max_depth, min_leaf = (
        np.asarray(arrays["gbt_scalars"], np.float64).tolist())
    model = GBTRegressor(n_trees=int(n_trees), lr=lr,
                         max_depth=int(max_depth), min_leaf=int(min_leaf))
    model.base = float(base)
    nodes = np.asarray(arrays["gbt_nodes"], np.float64)
    offsets = np.asarray(arrays["gbt_offsets"], np.int64)
    model.trees = []
    for t in range(offsets.size - 1):
        tree = _Tree(model.max_depth, model.min_leaf)
        for f, thr, left, right, value in nodes[offsets[t]:offsets[t + 1]]:
            tree.nodes.append(_Node(int(f), float(thr), int(left),
                                    int(right), float(value)))
        model.trees.append(tree)
    return model


def fit_cost_model(feature_rows, seconds) -> tuple["GBTRegressor", float]:
    """Fit the level-3 model on measured candidates: log-time targets.

    Shared by every model-using ``repro_torch.design`` strategy (AnnealStrategy's
    fine stage, CostModelGuidedStrategy's ranking rounds). Returns
    (model, MAD on the training set — the paper reports ~5%)."""
    X = np.stack(feature_rows)
    y = np.log(np.asarray(seconds, np.float64))
    model = GBTRegressor().fit(X, y)
    return model, model.mad(X, y)


# ------------------------------- features ---------------------------------

FEATURE_NAMES = [
    "log_nnz", "log_rows", "log_cols", "avg_row_len", "log_row_var",
    "pad_ratio", "bytes_per_nnz", "n_blocks", "n_buckets", "tile_rows",
    "mean_width", "chunk", "seg_rows", "red_lane", "red_seg", "red_onehot",
    "red_atom", "comb_grid_acc", "sorted_any", "binned", "coldiv",
    # multi-RHS (SpMM) terms: when the program serves B right-hand sides,
    # format traffic is amortised 1/B over the output flops and the
    # irregular reductions become MXU contractions — the model needs both
    # to rank designs differently at different batch sizes.
    "batch_size", "bytes_per_out_flop", "mxu_mac_ratio",
    # fused-combine / mixed-precision terms: bytes of post-hoc combine
    # traffic the fused in-kernel combine eliminates (per output flop),
    # and stored bytes relative to the all-fp32/int32 baseline (0.5-ish
    # for bf16 vals + int16 cols) — the knobs SET_RESOURCES binds.
    "combine_bytes_saved", "storage_bytes_ratio",
]

_REDUCE_ONE_HOT = {"lane_total": (1, 0, 0, 0), "seg_scan": (0, 1, 0, 0),
                   "onehot_mxu": (0, 0, 1, 0), "gmem_atom": (0, 0, 0, 1)}


def program_features(meta, program, batch_size: int = 1) -> np.ndarray:
    """Structural feature vector for the cost model (no execution needed).

    ``batch_size`` is the number of right-hand sides the program will serve
    (1 = classic SpMV). It enters through three terms:

    * ``batch_size`` itself;
    * ``bytes_per_out_flop`` — stored format bytes over useful output
      flops ``2*nnz*B``: streaming the format once for B columns amortises
      its traffic 1/B, which is the whole point of the fused SpMM path;
    * ``mxu_mac_ratio`` — MACs routed through the MXU per useful flop.
      ELL reductions only hit the MXU when batched (the (R,W)x(W,B)
      contraction); ONEHOT_MXU_RED always does (C*M one-hot MACs, times B
      when batched). High ratios mean compute-bound-on-MXU designs whose
      relative cost *drops* as B grows.

    Two fused-combine / mixed-precision terms (read off the generated
    program's kernel spec, no execution needed):

    * ``combine_bytes_saved`` — fp32 partial-slab bytes (read + write)
      the fused in-kernel combine eliminates, per useful output flop: a
      step marked ``fused`` no longer round-trips its (tiles x rows)
      partials through the ``jnp`` scatter pass;
    * ``storage_bytes_ratio`` — stored format bytes over the all-fp32/
      int32 baseline for the same element counts (1.0 for fp32 storage,
      about 0.5 for bf16 vals + int16 cols).
    """
    from .metadata import EllTileLayout, SegTileLayout  # local import (cycle)

    nnz = max(meta.nnz, 1)
    bsz = max(int(batch_size), 1)
    lengths = np.concatenate([b.row_lengths() for b in meta.blocks])
    row_var = float(np.var(lengths)) if lengths.size else 0.0
    n_buckets, tile_rows, widths, chunk, seg_rows = 0, [], [], 0, 0
    red = np.zeros(4)
    comb_acc = 0
    mxu_macs = 0.0
    for b in meta.blocks:
        if isinstance(b.layout, EllTileLayout):
            n_buckets += len(b.layout.buckets)
            tile_rows.append(b.layout.tile_rows)
            widths.extend(bk.width for bk in b.layout.buckets)
            if bsz > 1:   # batched ELL contracts padded slots on the MXU
                mxu_macs += sum(bk.vals.size for bk in b.layout.buckets) * bsz
        elif isinstance(b.layout, SegTileLayout):
            chunk = max(chunk, int(np.prod(b.layout.vals.shape[1:])))
            seg_rows = max(seg_rows, b.layout.seg_rows)
            if b.reduce is not None and b.reduce.kind == "onehot_mxu":
                mxu_macs += b.layout.vals.size * b.layout.seg_rows * bsz
        if b.reduce is not None:
            red = red + np.array(_REDUCE_ONE_HOT[b.reduce.kind])
            comb_acc += int(b.reduce.combine == "grid_acc")
    # fused-combine savings + storage narrowing, from the kernel spec/fmt
    spec = getattr(program, "spec", None) or {}
    fmt = getattr(program, "fmt", None) or {}
    fused_partials = 0
    for st in spec.get("steps", ()):
        if not st.get("fused"):
            continue
        v = fmt.get(f"{st['key']}_vals")
        if v is None:
            continue
        if st["kind"] == "ell":
            fused_partials += int(v.shape[0]) * int(v.shape[1])  # T * R
        else:
            fused_partials += int(v.shape[0]) * int(st["seg_rows"])
    combine_saved = 2.0 * 4.0 * fused_partials * bsz   # read+write, fp32
    n_elems = sum(int(np.prod(np.shape(a))) for a in fmt.values())
    storage_ratio = (program.stored_bytes / (4.0 * n_elems)
                     if n_elems else 1.0)
    hist = " ".join(meta.history)
    return np.array([
        np.log10(nnz), np.log10(max(meta.n_rows, 1)),
        np.log10(max(meta.n_cols, 1)), nnz / max(meta.n_rows, 1),
        np.log10(1.0 + row_var),
        meta.padded_nnz() / nnz,
        program.stored_bytes / nnz,
        len(meta.blocks), n_buckets,
        float(np.mean(tile_rows)) if tile_rows else 0.0,
        float(np.mean(widths)) if widths else 0.0,
        float(chunk), float(seg_rows),
        *(red > 0).astype(float), float(comb_acc > 0),
        float("SORT" in hist), float("BIN" in hist), float("COL_DIV" in hist),
        float(bsz),
        program.stored_bytes / (2.0 * nnz * bsz),
        mxu_macs / (2.0 * nnz * bsz),
        combine_saved / (2.0 * nnz * bsz),
        float(storage_ratio),
    ], dtype=np.float64)
