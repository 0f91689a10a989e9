"""repro_torch's sharded train step on meshes of processes, on the CPU.

The ranks are processes of a gloo group (``tests/_torch_ranks.py``, a
file rendezvous under ``tmp_path``), one a position of a (data, model)
mesh ((2, 2), (4, 1), (1, 4)) or a (pod, data, model) one ((2, 1, 2):
FSDP over the group of two axes); each holds its slices of the state (``dist.sharding.shard_leaf``
of the parameter specs) and trains on its rows of the global batch. The
whole leaves put back together (``unshard_leaf``, which also checks that
replicas agree) are held to the port's one-device step and to the
reference's mesh-less jitted step, on the same weights (the reference's,
``params_from_numpy``) and the same global batches.

The leaves that the specs split over ``model`` are used split: attention
heads, dense MLP columns, MoE experts (or, where the expert count does
not divide, the expert hidden dim), Mamba heads and the vocabulary of
the embedding and head. The (1, 4) run holds each of those model splits
to both steps (MoE in both dispatches, the hidden-dim fallback, Mamba, a
tied and an untied vocabulary) and records on each rank how many
experts, SSD heads and logit columns it ran, which matching numbers
alone cannot tell from a duplicated step. A (1, 2) run checks the two
autograd Functions of the split alone in float64 (the vocab-parallel
log-sum-exp with a z-loss, the sum whose backward is a sum) against
``torch.logsumexp`` and a plain sum on one process, within 1e-10 (only
the order of float64 sums differs).

Sequence parallelism (``seq_shard=True`` with ``act_dp`` the data axes:
the residual stream's sequence split over ``model``) runs in the same
spawns: granite, a MoE and a Mamba model, grad_accum and phi-3-vision's
prefix on (2, 2), granite, every model split, phi-3-vision and a
sequence that does not divide over ``model`` (30 tokens on 4) on
(1, 4), granite and a MoE model on (2, 1, 2), each held to the
one-device step and the reference's step. The (1, 2) run checks the
two gather/scatter pairs in float64 within 1e-10, and a split MoE
layer's input, router and expert gradients under the split against one
process's (its router runs in float32, as the reference's does: within
1e-6 of the largest gradient, where counting the router's path once a
position would miss by the path's whole size).

Tolerances, each with its reason:
* loss and grad_norm of every step: 1e-5 relative (only the order of
  float32 sums differs: a product's columns split over ``model``, the
  batch over ``data``).
* parameters after three steps, the first step's gradients, m and v:
  each leaf within 2e-4 * max |leaf| + 1e-6, the limit
  tests/test_torch_train.py holds the port's gradients to.
* compression: the quantisation of the same gradients is bit for bit the
  one device's (the chunks of the whole leaf, their max reduced over the
  mesh); in a step, where the gradients differ in their last bits, a
  value may round to the neighbouring int8 level (1/127 of its chunk's
  max), so m and v are held within 2e-2 of their max |.| as in
  tests/test_torch_train.py, and the residuals within one level.
* ``cast_params_bf16``: the gradients of the bfloat16 weights are
  rounded to bfloat16 (8 bits) once, from sums in another order, so a
  value may land one bfloat16 step (2^-8 relative) away: loss and
  grad_norm within 1e-3 relative, parameters within 2 lr per step (the
  most an AdamW step moves one).
* the restart contract of the reference's driver tests (restarts == 1,
  n_steps_run >= 8, a finite loss), and its final loss within 1e-5 of a
  one-device driver's.
* checkpoints: bit for bit.
"""
import ast
import dataclasses
import hashlib
import os
import types
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.ckpt.checkpoint import CheckpointManager as RefManager
from repro.data.pipeline import DataConfig as RDataConfig
from repro.data.pipeline import SyntheticTokenPipeline as RPipeline
from repro.models import init_params as ref_init_params
from repro.train import optimizer as ROPT
from repro.train import step as RSTEP

import repro_torch.configs as TC
from repro_torch.ckpt import CheckpointManager
from repro_torch.dist.sharding import (expert_range, head_range,
                                       map_specs, mesh_coords,
                                       mesh_positions, param_specs,
                                       shard_batch, shard_leaf, shard_slices,
                                       spec_leaves, unshard_leaf,
                                       vocab_range)
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.train import DriverConfig, TrainDriver
from repro_torch.models.weights import params_from_numpy
from repro_torch.train.compression import (CompressionConfig,
                                           compress_decompress)
from repro_torch.train.optimizer import tree_leaves
from repro_torch.train.step import init_state, make_grad_fn, make_train_step

sys.path.insert(0, str(Path(__file__).parent))
import _torch_ranks as RANKS  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
GRANITE = "granite-3-2b"
DEEPSEEK, MAMBA, GMOE = ("deepseek-moe-16b", "mamba2-1.3b",
                         "granite-moe-3b-a800m")
LR = 3e-4
OPT = dict(lr=LR, total_steps=10, warmup_steps=1)
FP32 = dict(opt=OPT, compute_dtype="float32")
MESHES = {"2x2": dict(data=2, model=2), "4x1": dict(data=4, model=1),
          "1x4": dict(data=1, model=4),
          # FSDP over the group ("pod", "data"), TP over model
          "2x1x2": dict(pod=2, data=1, model=2)}


# --------------------------- slices, no processes ---------------------------

class MockMesh:
    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


MOCKS = {"2x2": MockMesh({"data": 2, "model": 2}),
         "4x1": MockMesh({"data": 4, "model": 1}),
         "1x4": MockMesh({"data": 1, "model": 4}),
         "3x2": MockMesh({"data": 3, "model": 2}),      # 64 % 3: fallback
         "pod": MockMesh({"pod": 2, "data": 2, "model": 2}),
         "16x16": MockMesh({"data": 16, "model": 16})}


def _configs(arch, moe=None):
    """The reference's and the port's reduced config of ``arch``, with
    the ``MoECfg`` fields ``moe``."""
    out = []
    for reg in (RC, TC):
        cfg = reg.get_config(arch).reduced()
        if moe:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, **moe))
        out.append(cfg)
    return out


def _ref_params(arch, moe=None):
    p = ref_init_params(_configs(arch, moe)[0], jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, p)


@pytest.mark.parametrize("mesh", sorted(MOCKS))
@pytest.mark.parametrize("arch", [GRANITE, "deepseek-moe-16b",
                                  "mamba2-1.3b"])
def test_shard_then_unshard_gives_the_leaf(arch, mesh):
    m = MOCKS[mesh]
    params = _ref_params(arch)
    specs = param_specs(TC.get_config(arch).reduced(), m, params)
    for leaf, sp in zip(tree_leaves(params), spec_leaves(specs)):
        parts = {}
        for pos in mesh_positions(m):
            part = shard_leaf(leaf, sp, m, pos)
            for d, (n, e) in enumerate(zip(leaf.shape, sp)):
                k = int(np.prod([m.shape[a] for a in
                                 ((e,) if isinstance(e, str) else e or ())]))
                assert part.shape[d] * k == n
            parts[tuple(pos[a] for a in m.axis_names)] = part
        assert np.array_equal(unshard_leaf(parts, sp, m), leaf)
        t = torch.from_numpy(leaf.copy())
        tparts = {c: torch.from_numpy(p.copy()) for c, p in parts.items()}
        assert torch.equal(unshard_leaf(tparts, sp, m), t)
        assert torch.equal(shard_leaf(t, sp, m, mesh_positions(m)[-1]),
                           tparts[tuple(mesh_positions(m)[-1][a]
                                        for a in m.axis_names)])


def test_a_group_splits_a_dim_row_major():
    m = MOCKS["pod"]
    sp = (("pod", "data"), "model")
    assert [mesh_coords(m, r) for r in (0, 5)] == [
        {"pod": 0, "data": 0, "model": 0}, {"pod": 1, "data": 0, "model": 1}]
    leaf = np.arange(8 * 4).reshape(8, 4)
    for pos in mesh_positions(m):
        i = pos["pod"] * 2 + pos["data"]
        sl = shard_slices(leaf.shape, sp, m, pos)
        assert sl == (slice(2 * i, 2 * i + 2),
                      slice(2 * pos["model"], 2 * pos["model"] + 2))


def test_uneven_splits_and_differing_replicas_are_refused():
    m = MOCKS["2x2"]
    with pytest.raises(ValueError, match="does not split"):
        shard_leaf(np.zeros((3, 4)), ("data", None), m,
                   {"data": 0, "model": 0})
    parts = {(d, t): np.full((1, 2), float(t)) for d in range(2)
             for t in range(2)}
    with pytest.raises(ValueError, match="replicas"):
        unshard_leaf(parts, ("data", None), m)


def test_shard_batch_gives_each_data_position_its_rows():
    cfg = TC.get_config(GRANITE).reduced()
    m = MOCKS["2x2"]
    batch = {"tokens": np.arange(4 * 3).reshape(4, 3),
             "labels": -np.arange(4 * 3).reshape(4, 3)}
    for pos in mesh_positions(m):
        got = shard_batch(batch, cfg, m, pos)
        rows = slice(2 * pos["data"], 2 * pos["data"] + 2)
        for k in batch:
            assert np.array_equal(got[k], batch[k][rows])
    with pytest.raises(ValueError, match="does not split"):
        shard_batch({k: v[:1] for k, v in batch.items()}, cfg, m,
                    mesh_positions(m)[0])


def test_without_a_process_group_specs_are_refused():
    cfg = TC.get_config(GRANITE).reduced()
    with pytest.raises(NotImplementedError, match="mesh of processes"):
        make_train_step(cfg, RANKS._train_config(FP32), grad_specs={},
                        mesh=Mesh(("data", "model"), (1, 1)))


# ------------------------- the ranks' runs (fixtures) -----------------------

def _batches(cfg, n=3, gb=4, seq=32, seed=0):
    pipe = RPipeline(RDataConfig(vocab=cfg.vocab, seq_len=seq,
                                 global_batch=gb, seed=seed))
    return [pipe.batch_at(s) for s in range(n)]


def _masked(batches):
    """Every label of rows 0-1 (data position 0 on a (2, 2) mesh) masked,
    and a few elsewhere."""
    out = []
    for b in batches:
        b = {k: v.copy() for k, v in b.items()}
        b["labels"][:2] = -1
        b["labels"][3, :5] = -1
        out.append(b)
    return out


@pytest.fixture(scope="module")
def granite():
    return _ref_params(GRANITE)


def _steps(arch, params, batches, tc=FP32, **kw):
    return dict(kind="steps", arch=arch, params=params, batches=batches,
                tc=tc, **kw)


def _compress_case(granite):
    rng = np.random.default_rng(5)
    grads = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), granite)
    err = jax.tree.map(
        lambda a: 1e-3 * rng.standard_normal(a.shape).astype(np.float32),
        granite)
    return dict(kind="compress", arch=GRANITE, grads=grads, err=err,
                compression=dict(enabled=True))


CASES_2X2 = ["fp32", "accum", "compress_step", "bf16", "moe", "mamba",
             "masked", "compress", "knobs"]
PHI = "phi-3-vision-4.2b"
# sequence parallelism, by mesh: name -> (arch, MoECfg fields, extra
# TrainConfig fields, tokens a row); each mesh's cases follow its own
SEQ = {"2x2": {"granite": (GRANITE, None, {}, 32),
               "accum": (GRANITE, None, {"grad_accum": 2}, 32),
               "moe": (DEEPSEEK, None, {}, 32),
               "mamba": (MAMBA, None, {}, 32),
               "phi": (PHI, None, {}, 32)},
       "1x4": {"granite": (GRANITE, None, {}, 32),
               # 30 tokens on 4 positions: 8 rows each, 2 of them pad
               "uneven": (GRANITE, None, {}, 30),
               "phi": (PHI, None, {}, 32),
               "moe_onehot": (DEEPSEEK, {}, {}, 32),
               "moe_sorted": (DEEPSEEK, {"impl": "sorted"}, {}, 32),
               "moe_hidden": (DEEPSEEK, {"n_experts": 6}, {}, 32),
               "mamba": (MAMBA, {}, {}, 32),
               "granite_moe": (GMOE, {}, {}, 32)},
       "2x1x2": {"granite": (GRANITE, None, {}, 32),
                 "moe": (DEEPSEEK, None, {}, 32)}}


def _prefixed(batches, cfg, seed=3):
    """``batches`` with the stubbed modality prefix of ``cfg``."""
    if not cfg.n_prefix:
        return batches
    rng = np.random.default_rng(seed)
    return [dict(b, prefix_embeds=rng.standard_normal(
        (b["tokens"].shape[0], cfg.n_prefix, cfg.d_model)).astype(
            np.float32)) for b in batches]


def _seq_cases(mesh: str) -> dict:
    """The ``steps`` cases of ``SEQ[mesh]``, with ``seq_shard`` and
    ``act_dp`` the mesh's data axes."""
    dp = tuple(a for a in ("pod", "data") if a in MESHES[mesh])
    out = {}
    for name, (arch, moe, tc, seq) in SEQ[mesh].items():
        cfg = _configs(arch, moe)[0]
        b = _prefixed(_batches(cfg, seq=seq), cfg)
        out[name] = _steps(arch, _ref_params(arch, moe), b,
                           dict(FP32, seq_shard=True, act_dp=dp, **tc),
                           **({"moe": moe} if moe else {}))
    return out


@pytest.fixture(scope="module")
def cases_2x2(granite, tmp_path_factory):
    cfg = RC.get_config(GRANITE).reduced()
    work = tmp_path_factory.mktemp("r2x2")
    b = _batches(cfg)
    cases = {
        "fp32": _steps(GRANITE, granite, b, ckpt=str(work / "ckpt")),
        "accum": _steps(GRANITE, granite, b,
                        dict(FP32, grad_accum=2)),
        "compress_step": _steps(GRANITE, granite, b,
                                dict(FP32, compression=dict(enabled=True))),
        "bf16": _steps(GRANITE, granite, b,
                       dict(FP32, cast_params_bf16=True)),
        "moe": _steps("deepseek-moe-16b", _ref_params("deepseek-moe-16b"), b),
        "mamba": _steps("mamba2-1.3b", _ref_params("mamba2-1.3b"), b),
        "masked": _steps(GRANITE, granite, _masked(b)),
        "compress": _compress_case(granite),
        "knobs": dict(kind="knobs", arch=GRANITE, params=granite,
                      batches=b[:1]),
    }
    seq = _seq_cases("2x2")
    res = RANKS.run({"mesh": MESHES["2x2"],
                     "cases": [cases[k] for k in CASES_2X2]
                     + list(seq.values())}, 4, work)
    return {"cases": cases, "ranks": res, "mesh": MESHES["2x2"],
            "ckpt": work / "ckpt", "seq": seq, "seq_at": len(CASES_2X2)}


@pytest.fixture(scope="module")
def ref_ckpt(granite, tmp_path_factory):
    """The reference's CheckpointManager's save of a one-device state
    after three steps (the reference's own step), and that state."""
    rcfg = RC.get_config(GRANITE).reduced()
    rtc = RSTEP.TrainConfig(opt=ROPT.AdamWConfig(**OPT),
                            compute_dtype="float32")
    st = RSTEP.init_state(rcfg, rtc, jax.tree.map(jnp.asarray, granite))
    step = jax.jit(RSTEP.make_train_step(rcfg, rtc))
    for b in _batches(rcfg):
        st, _ = step(st, b)
    d = tmp_path_factory.mktemp("refckpt")
    RefManager(str(d)).save(2, st, blocking=True)
    return d, jax.tree.map(np.asarray, st)


def _run_one(name, granite, tmp_path_factory, extra=()):
    """One spawn on mesh ``name``: granite's steps (case 0), ``extra``,
    then the mesh's ``SEQ`` cases."""
    cfg = RC.get_config(GRANITE).reduced()
    mesh = MESHES[name]
    seq = _seq_cases(name) if name in SEQ else {}
    res = RANKS.run({"mesh": mesh, "cases": [
        _steps(GRANITE, granite, _batches(cfg)), *extra, *seq.values()]},
        _mesh(mesh).size, tmp_path_factory.mktemp("r" + name))
    return {"ranks": res, "mesh": mesh, "seq": seq,
            "seq_at": 1 + len(extra)}


# the model splits on (1, 4): name -> (arch, MoECfg fields)
SPLITS = {"moe_onehot": (DEEPSEEK, {}),
          "moe_sorted": (DEEPSEEK, {"impl": "sorted"}),
          # 6 experts do not divide over 4: the expert hidden dim does
          "moe_hidden": (DEEPSEEK, {"n_experts": 6}),
          "mamba": (MAMBA, {}),
          "granite_moe": (GMOE, {})}               # a tied vocabulary


@pytest.fixture(scope="module")
def cases_1x4(granite, tmp_path_factory):
    """One (1, 4) spawn: granite's steps (case 0), each of ``SPLITS``'s
    steps (cases 1-5) and its ``split`` record (cases 6-10)."""
    b = _batches(RC.get_config(GRANITE).reduced())
    params = {n: _ref_params(a, moe) for n, (a, moe) in SPLITS.items()}
    steps = {n: _steps(a, params[n], b, moe=moe)
             for n, (a, moe) in SPLITS.items()}
    splits = {n: dict(kind="split", arch=a, moe=moe, params=params[n],
                      batches=b[:1]) for n, (a, moe) in SPLITS.items()}
    seq = _seq_cases("1x4")
    res = RANKS.run({"mesh": MESHES["1x4"], "cases": [
        _steps(GRANITE, granite, b), *steps.values(), *splits.values(),
        *seq.values()]}, 4, tmp_path_factory.mktemp("r1x4"))
    return {"ranks": res, "mesh": MESHES["1x4"], "steps": steps,
            "splits": splits, "seq": seq,
            "seq_at": 1 + 2 * len(SPLITS)}


@pytest.fixture(scope="module")
def runs(granite, cases_2x2, cases_1x4, ref_ckpt, tmp_path_factory):
    restore = [dict(kind="restore", arch=GRANITE, params=granite, tc=FP32,
                    ckpt=str(d), step=2)
               for d in (cases_2x2["ckpt"], ref_ckpt[0])]
    first = lambda run: {"ranks": [  # noqa: E731
        {"coords": r["coords"], "cases": r["cases"][:1]}
        for r in run["ranks"]], "mesh": run["mesh"]}
    return {"2x2": first(cases_2x2), "1x4": first(cases_1x4),
            "4x1": _run_one("4x1", granite, tmp_path_factory, restore),
            "2x1x2": _run_one("2x1x2", granite, tmp_path_factory),
            "seq": {"2x2": cases_2x2, "1x4": cases_1x4}}


# ------------------------------ comparisons ---------------------------------

def _mesh(sizes: dict) -> Mesh:
    axes = tuple(a for a in ("pod", "data", "model") if a in sizes)
    return Mesh(axes, tuple(sizes[a] for a in axes))


def _whole(run, i, part, params):
    """Case i's ``part`` tree (e.g. the state's params) of every rank put
    back together, laid out by the parameter specs (of the whole
    ``params``) on the run's mesh."""
    m = _mesh(run["mesh"])
    ranks = run["ranks"]
    coords = [tuple(r["coords"][a] for a in m.axis_names) for r in ranks]
    trees = [r["cases"][i] for r in ranks]
    for key in part:
        trees = [t[key] for t in trees]
    specs = param_specs(TC.get_config(run.get("arch", GRANITE)).reduced(),
                        m, params)
    return map_specs(lambda sp, *parts: unshard_leaf(
        dict(zip(coords, parts)), sp, m), specs, *trees)


_MEMO = {}


def _key(*parts, batches):
    h = hashlib.sha1(repr(parts).encode())
    for b in batches:
        for k in sorted(b):
            h.update(np.ascontiguousarray(b[k]).tobytes())
    return h.hexdigest()


def _one_device(arch, params, batches, tc=FP32, moe=None):
    """The port's one-device step: (metrics, first gradients, state),
    computed once a (config, weights' arch, batches). The step updates
    its state in place: it runs on a copy of ``params``."""
    key = _key("port", arch, moe, tc, batches=batches)
    if key not in _MEMO:
        _MEMO[key] = _one_device_run(arch, params, batches, tc, moe)
    return _MEMO[key]


def _one_device_run(arch, params, batches, tc, moe):
    params = jax.tree.map(np.array, params)
    cfg = _configs(arch, moe)[1]
    tcfg = RANKS._train_config(tc)
    p = params_from_numpy(params, CPU)
    (_, _), grads = make_grad_fn(cfg, tcfg)(p, {
        k: torch.from_numpy(v) for k, v in batches[0].items()})
    state = init_state(cfg, tcfg, params_from_numpy(params, CPU))
    step = make_train_step(cfg, tcfg)
    mets = []
    for b in batches:
        state, met = step(state, b)
        mets.append({k: float(v) for k, v in met.items()})
    return mets, grads, state


@pytest.fixture(scope="module")
def one_device(granite):
    cfg = TC.get_config(GRANITE).reduced()
    return _one_device(GRANITE, granite, _batches(cfg))


def _reference(arch, params, batches, moe=None, extra=None):
    """The reference's mesh-less jitted fp32 step (``extra``: more of its
    ``TrainConfig``'s fields): metrics and final state, computed once a
    (config, batches)."""
    key = _key("ref", arch, moe, *([extra] if extra else []),
               batches=batches)
    if key not in _MEMO:
        rcfg = _configs(arch, moe)[0]
        rtc = RSTEP.TrainConfig(opt=ROPT.AdamWConfig(**OPT),
                                compute_dtype="float32", **(extra or {}))
        st = RSTEP.init_state(rcfg, rtc, jax.tree.map(jnp.asarray, params))
        step = jax.jit(RSTEP.make_train_step(rcfg, rtc))
        mets = []
        for b in batches:
            st, m = step(st, b)
            mets.append({k: float(v) for k, v in m.items()})
        _MEMO[key] = mets, jax.tree.map(np.asarray, st)
    return _MEMO[key]


@pytest.fixture(scope="module")
def reference(granite):
    """The reference's mesh-less jitted step: metrics and final state."""
    return _reference(GRANITE, granite,
                      _batches(RC.get_config(GRANITE).reduced()))


def _close_metrics(got, want, keys=("loss", "grad_norm"), rel=1e-5):
    assert len(got) == len(want)
    for s, (g, w) in enumerate(zip(got, want)):
        for k in keys:
            assert abs(g[k] - w[k]) <= rel * abs(w[k]), (s, k, g[k], w[k])


def _close_trees(got, want, rel=2e-4, atol=1e-6):
    g, w = tree_leaves(got), tree_leaves(want)
    assert len(g) == len(w)
    for i, (a, b) in enumerate(zip(g, w)):
        a = np.asarray(a, np.float64)
        b = np.asarray(b.detach().numpy() if torch.is_tensor(b) else b,
                       np.float64)
        assert a.shape == b.shape and np.isfinite(a).all()
        tol = rel * np.abs(b).max() + atol
        assert np.abs(a - b).max() <= tol, (i, np.abs(a - b).max(), tol)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sharded_steps_match_one_device_and_reference(mesh, runs, granite,
                                                      one_device, reference):
    run = runs[mesh]
    got = run["ranks"][0]["cases"][0]
    mets, grads, state = one_device
    # every rank reports the global metrics
    for r in run["ranks"]:
        assert r["cases"][0]["metrics"] == got["metrics"]
    _close_metrics(got["metrics"], mets)
    _close_metrics(got["metrics"], reference[0])
    for k in ("lr",):
        assert [m[k] for m in got["metrics"]] == [m[k] for m in mets]
    _close_trees(_whole(run, 0, ("grads",), granite), grads)
    params = _whole(run, 0, ("state", "params"), granite)
    _close_trees(params, state["params"])
    _close_trees(params, reference[1]["params"])
    for name in ("m", "v"):
        _close_trees(_whole(run, 0, ("state", "opt", name), granite),
                     state["opt"][name])
    assert all(int(r["cases"][0]["state"]["opt"]["count"]) == 3
               for r in run["ranks"])


def _case(cases_2x2, name):
    i = CASES_2X2.index(name)
    run = {"ranks": cases_2x2["ranks"], "mesh": cases_2x2["mesh"],
           "arch": cases_2x2["cases"][name]["arch"]}
    return run, i, cases_2x2["cases"][name]


@pytest.mark.parametrize("name", ["accum", "moe", "mamba", "masked"])
def test_sharded_step_cases_match_one_device(name, cases_2x2):
    """grad_accum 2 (each rank splits its rows), one MoE and one Mamba
    architecture (the aux loss over the global batch; two experts and
    four SSD heads a model position, the vocabulary split; these two also
    against the reference's step), and a mask that empties data position
    0's rows (the global masked mean)."""
    run, i, case = _case(cases_2x2, name)
    mets, _, state = _one_device(case["arch"], case["params"],
                                 case["batches"], case["tc"])
    got = run["ranks"][0]["cases"][i]
    _close_metrics(got["metrics"], mets)
    if name in ("moe",):
        _close_metrics(got["metrics"], mets, keys=("aux", "ce", "z"))
    params = _whole(run, i, ("state", "params"), case["params"])
    _close_trees(params, state["params"])
    if name in ("moe", "mamba"):
        ref_mets, ref_state = _reference(case["arch"], case["params"],
                                         case["batches"])
        _close_metrics(got["metrics"], ref_mets)
        _close_trees(params, ref_state["params"])
    if name == "masked":
        assert all(b["labels"][:2].max() < 0 for b in case["batches"])


@pytest.mark.parametrize("name", sorted(SPLITS))
def test_model_splits_on_1x4_match_one_device_and_reference(name,
                                                            cases_1x4):
    """Each model split on (1, 4) (one expert a position in both
    dispatches, the hidden-dim fallback, two SSD heads a position, a
    tied vocabulary split) against the port's one-device step and the
    reference's: metrics of every step, the first gradients and the
    parameters after three."""
    arch, moe = SPLITS[name]
    case = cases_1x4["steps"][name]
    i = 1 + list(SPLITS).index(name)
    run = {"ranks": cases_1x4["ranks"], "mesh": cases_1x4["mesh"],
           "arch": arch}
    got = run["ranks"][0]["cases"][i]
    for r in run["ranks"]:
        assert r["cases"][i]["metrics"] == got["metrics"]
    mets, grads, state = _one_device(arch, case["params"], case["batches"],
                                     moe=moe)
    ref_mets, ref_state = _reference(arch, case["params"], case["batches"],
                                     moe)
    keys = ("loss", "grad_norm", "ce", "z") + (("aux",) if arch != MAMBA
                                               else ())
    _close_metrics(got["metrics"], mets, keys=keys)
    _close_metrics(got["metrics"], ref_mets)
    _close_trees(_whole(run, i, ("grads",), case["params"]), grads)
    params = _whole(run, i, ("state", "params"), case["params"])
    _close_trees(params, state["params"])
    _close_trees(params, ref_state["params"])


@pytest.mark.parametrize("mesh,name", [(m, n) for m in SEQ
                                       for n in SEQ[m]])
def test_seq_shard_steps_match_one_device_and_reference(mesh, name, runs):
    """``seq_shard=True`` with ``act_dp`` the data axes: the sharded
    step with the residual stream's sequence split over ``model``, held
    to the port's one-device step (without ``seq_shard``, which has no
    meaning there) and the reference's mesh-less step: metrics of every
    step (MoE's parts too), the first gradients and the parameters after
    three steps."""
    spawn = runs["seq"].get(mesh) or runs[mesh]
    case = spawn["seq"][name]
    i = spawn["seq_at"] + list(SEQ[mesh]).index(name)
    arch, moe, extra, _ = SEQ[mesh][name]
    run = {"ranks": spawn["ranks"], "mesh": MESHES[mesh], "arch": arch}
    got = run["ranks"][0]["cases"][i]
    for r in run["ranks"]:
        assert r["cases"][i]["metrics"] == got["metrics"]
    mets, grads, state = _one_device(arch, case["params"], case["batches"],
                                     dict(FP32, **extra), moe=moe)
    parts = () if extra else ("ce", "z") + (
        ("aux",) if _configs(arch, moe)[1].moe else ())
    keys = ("loss", "grad_norm") + parts
    _close_metrics(got["metrics"], mets, keys=keys)
    _close_trees(_whole(run, i, ("grads",), case["params"]), grads)
    params = _whole(run, i, ("state", "params"), case["params"])
    _close_trees(params, state["params"])
    ref_mets, ref_state = _reference(arch, case["params"], case["batches"],
                                     moe, extra)
    _close_metrics(got["metrics"], ref_mets)
    _close_trees(params, ref_state["params"])


@pytest.mark.parametrize("name", sorted(SPLITS))
def test_each_model_position_runs_its_part_of_the_work(name, cases_1x4):
    """On (1, 4) each position's ``_expert_ffn`` runs E/4 experts (all E
    on d_expert/4 columns in the fallback), its ``ssd_chunked`` H/4
    heads and its head V_pad/4 logit columns; a whole-gather over
    ``model`` would give E, H and V_pad."""
    arch, moe = SPLITS[name]
    cfg = _configs(arch, moe)[1]
    n_layers = cfg.n_layers
    i = 1 + len(SPLITS) + list(SPLITS).index(name)
    for r in cases_1x4["ranks"]:
        got = r["cases"][i]
        assert got["vocab"] == [256 // 4] and got["vocab_tp"]
        # 2 kv heads do not divide over 4: attention stays whole
        assert not any(got["attn_tp"])
        if cfg.moe is None:
            assert got["experts"] == []
        elif cfg.moe.n_experts % 4:
            assert got["moe_tp"] == ["hidden"]
            assert got["experts"] == [cfg.moe.n_experts] * n_layers
            assert got["columns"] == [cfg.moe.d_expert // 4] * n_layers
        else:
            assert got["moe_tp"] == ["ep"]
            assert got["experts"] == [cfg.moe.n_experts // 4] * n_layers
            assert got["columns"] == [cfg.moe.d_expert] * n_layers
        if cfg.ssm is None:
            assert got["heads"] == []
        else:
            heads = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim
            assert got["ssm_tp"] == [True]
            assert got["heads"] == [heads // 4] * n_layers


@pytest.fixture(scope="module")
def functions_1x2(tmp_path_factory):
    """The two Functions on a (1, 2) mesh of gloo ranks: 16 logit columns
    (13 vocabulary, 3 padding), 8 a rank."""
    rng = np.random.default_rng(7)
    labels = rng.integers(0, 13, (2, 5))
    labels[0, :2] = [7, 8]         # each side of the split boundary
    labels[1, :2] = [-1, 14]       # masked: negative, and past the vocab
    # sequence pairs: 5 rows on 2 positions, 3 each, the last pad
    case = dict(kind="functions", vocab=13, labels=labels,
                logits=3 * rng.standard_normal((2, 5, 16)),
                x=rng.standard_normal((2, 3, 4)),
                w=rng.standard_normal((2, 3, 4)),
                sx=rng.standard_normal((2, 5, 4)),
                sxp=rng.standard_normal((2, 2, 5, 4)),
                sw=rng.standard_normal((2, 2, 3, 4)),
                su=rng.standard_normal((2, 5, 4)),
                sv=rng.standard_normal((2, 2, 5, 4)))
    res = RANKS.run({"mesh": dict(data=1, model=2), "cases": [
        case, _moe_seq_case()]}, 2, tmp_path_factory.mktemp("r1x2"))
    return case, [r["cases"][0] for r in res], [r["cases"][1] for r in res]


def _moe_seq_case():
    """A MoE layer of reduced deepseek (4 experts, top 2, one shared) in
    float64 on 7 tokens (4 rows a position, one pad)."""
    rng = np.random.default_rng(11)
    cfg = _configs(DEEPSEEK)[1]
    p = {k: a[0].astype(np.float64) for k, a in
         _ref_params(DEEPSEEK)["blocks"][0]["ffn"].items()}
    return dict(kind="moe_seq", arch=DEEPSEEK, p=p,
                x=rng.standard_normal((2, 7, cfg.d_model)),
                w=rng.standard_normal((2, 2, 4, cfg.d_model)), c=0.5)


def test_vocab_parallel_lse_with_z_loss_in_float64(functions_1x2):
    case, ranks, _ = functions_1x2
    logits = torch.from_numpy(case["logits"]).requires_grad_(True)
    labels = torch.from_numpy(case["labels"])
    mask = (labels >= 0) & (labels < case["vocab"])
    lse = torch.logsumexp(logits, -1)
    ll = torch.gather(logits, -1, torch.where(mask, labels, 0)[..., None])
    ll = ll[..., 0]
    denom = mask.sum()
    loss = ((lse - ll) * mask).sum() / denom \
        + 1e-4 * ((lse * mask) ** 2).sum() / denom
    g, = torch.autograd.grad(loss, [logits])
    got_g = np.concatenate([r["g_logits"] for r in ranks], -1)
    for r in ranks:
        assert np.abs(r["lse"] - lse.detach().numpy()).max() <= 1e-10
        assert np.abs(r["ll"] - ll.detach().numpy()).max() <= 1e-10
        assert abs(r["loss"] - loss.item()) <= 1e-10
    assert np.abs(got_g - g.numpy()).max() <= 1e-10
    # the label on each side of the boundary takes its -1 on its rank
    assert got_g[0, 0, 7] < 0 and got_g[0, 1, 8] < 0
    assert (got_g[1, :2] == 0).all()                # masked: no gradient


def test_sum_whose_backward_is_a_sum_in_float64(functions_1x2):
    case, ranks, _ = functions_1x2
    x = [torch.from_numpy(a).requires_grad_(True) for a in case["x"]]
    y = x[0] + x[1]
    w = torch.from_numpy(case["w"])
    loss = sum((y * w[r]).sum() for r in range(2))
    g = torch.autograd.grad(loss, x)
    for r, got in enumerate(ranks):
        assert np.abs(got["y"] - y.detach().numpy()).max() <= 1e-10
        assert np.abs(got["g_x"] - g[r].numpy()).max() <= 1e-10


def _rows(a, r, rows=3):
    """Rows ``r`` of ``a``'s sequence (dim 1) padded with zeros to a
    multiple of ``rows``."""
    pad = -a.shape[1] % rows
    return np.pad(a, ((0, 0), (0, pad), (0, 0)))[:, r * rows:(r + 1) * rows]


def _seq_plain(case):
    """Each pair's whole-sequence meaning on one process, as numpy:
    ``{name: (output on rank r, input gradient on rank r)}`` for r = 0,
    1. The positions' losses add up to one global loss: its gradient
    with respect to each rank's input is what the rank must hold."""
    x, xp, u = case["sx"], case["sxp"], case["su"]
    w = np.concatenate(list(case["sw"]), 1)[:, :x.shape[1]]
    v = case["sv"][0] + case["sv"][1]
    return {
        # the whole x on both ranks, each keeps its rows: d/dx = w
        "split": [(_rows(x, r), w) for r in range(2)],
        # partial wholes summed, each keeps its rows of the sum
        "scatter": [(_rows(xp[0] + xp[1], r), w) for r in range(2)],
        # replicated region: the loss counts once, each its rows of u
        "gather": [(x, _rows(u, r)) for r in range(2)],
        # split region: every rank's part of the loss reaches each row
        "gather_summed": [(x, _rows(v, r)) for r in range(2)],
        "gather_twice": [((x, x), _rows(u + v, r)) for r in range(2)]}


@pytest.mark.parametrize("pair", ["split", "scatter", "gather",
                                  "gather_summed", "gather_twice"])
def test_sequence_pairs_in_float64(pair, functions_1x2):
    """``SequenceParallel``'s pairs on (1, 2), 5 rows (3 a position, one
    pad): the rank's output and input gradient against the global loss's
    on one process, within 1e-10; pad rows take no gradient."""
    case, ranks, _ = functions_1x2
    want = _seq_plain(case)[pair]
    for r, got in enumerate(ranks):
        y, g = got["seq"][pair]
        wy, wg = want[r]
        for a, b in zip(y if isinstance(y, list) else [y],
                        wy if isinstance(wy, tuple) else [wy]):
            assert a.shape == b.shape
            assert np.abs(a - b).max() <= 1e-10
        assert g.shape == wg.shape and np.abs(g - wg).max() <= 1e-10
    if pair.startswith("gather"):
        assert (ranks[1]["seq"][pair][1][:, -1] == 0).all()    # the pad


def test_split_moe_gradients_under_seq_shard_in_float64(functions_1x2):
    """A MoE layer with its experts split over (1, 2) and the sequence
    split too, against the whole layer on one process: the output rows,
    the aux loss, the gradients of each rank's input rows, of the router
    (whole on each rank: "take one" must be exact) and of the rank's
    experts. The router runs in float32 as the reference's does, so the
    gradients hold within 1e-6 of their largest; a router fed from the
    gather whose backward sums would add its path's whole gradient of
    the input twice."""
    _, _, ranks = functions_1x2
    case = _moe_seq_case()
    cfg = _configs(DEEPSEEK)[1]
    from repro_torch.models.moe import apply_moe
    p = {k: torch.from_numpy(v).requires_grad_(True)
         for k, v in case["p"].items()}
    x = torch.from_numpy(case["x"]).requires_grad_(True)
    w = np.concatenate(list(case["w"]), 1)[:, :x.shape[1]]
    y, aux = apply_moe(cfg, p, x)
    loss = (y * torch.from_numpy(w)).sum() + case["c"] * aux
    names = ("router", "w_up", "w_gate", "w_down")
    g = dict(zip(("x",) + names, torch.autograd.grad(
        loss, [x] + [p[k] for k in names])))
    g = {k: v.numpy() for k, v in g.items()}
    ne = cfg.moe.n_experts // 2
    for r, got in enumerate(ranks):
        assert np.abs(got["y"] - _rows(y.detach().numpy(), r, 4)).max() \
            <= 1e-10
        assert abs(got["aux"] - aux.item()) <= 1e-10
        for k in ("x",) + names:
            want = _rows(g["x"], r, 4) if k == "x" else g[k]
            if k in ("w_up", "w_gate", "w_down"):
                want = want[r * ne:(r + 1) * ne]
            tol = 1e-6 * np.abs(want).max()
            assert np.abs(got[f"g_{k}"] - want).max() <= tol, k


def _shapes(cfg):
    """Stand-ins (``.shape`` only) for the leaves whose split over
    ``model`` the position ranges follow."""
    leaf = lambda *s: types.SimpleNamespace(shape=s)  # noqa: E731
    d, vp = cfg.d_model, int(np.ceil(cfg.vocab / 256) * 256)
    tree = {"embed": leaf(vp, d), "blocks": [{}]}
    if cfg.moe:
        tree["blocks"][0]["ffn"] = {"w_up": leaf(
            1, cfg.moe.n_experts, d, cfg.moe.d_expert)}
    if cfg.ssm:
        d_in = cfg.ssm.expand * d
        tree["blocks"][0]["mamba"] = {"out_proj": leaf(1, d_in, d)}
    return tree


def _part(spec_, shape, dim, m, pos):
    if spec_[dim] != "model":
        return 0, shape[dim]
    sl = shard_slices(shape, spec_, m, pos)[dim]
    return sl.start, sl.stop


@pytest.mark.parametrize("mesh", sorted(MOCKS))
def test_position_ranges_follow_the_specs(mesh):
    """``expert_range``, ``head_range`` and ``vocab_range`` give each
    position the experts, heads and vocabulary rows its slices of
    ``param_specs`` hold, and all of them in the fallbacks: an expert
    count that does not divide (the hidden dim is split instead), a head
    count that does not (reduced mamba's 8 heads on 16 x 16)."""
    m = MOCKS[mesh]
    tp = m.shape["model"]
    cfgs = [TC.get_config(a) for a in (DEEPSEEK, MAMBA, GMOE)]
    cfgs += [_configs(a, moe)[1] for a, moe in SPLITS.values()]
    for cfg in cfgs:
        tree = _shapes(cfg)
        specs = param_specs(cfg, m, tree)
        for pos in mesh_positions(m):
            emb = specs["embed"]
            assert vocab_range(cfg, m, pos) == _part(
                emb, tree["embed"].shape, 0, m, pos)
            if cfg.moe:
                sp, sh = (specs["blocks"][0]["ffn"]["w_up"],
                          tree["blocks"][0]["ffn"]["w_up"].shape)
                assert expert_range(cfg, m, pos) == _part(sp, sh, 1, m, pos)
                if cfg.moe.n_experts % tp:       # the hidden dim instead
                    assert sp[1] is None and sp[3] == ("model" if cfg.moe
                                                       .d_expert % tp == 0
                                                       else None)
            if cfg.ssm:
                sp, sh = (specs["blocks"][0]["mamba"]["out_proj"],
                          tree["blocks"][0]["mamba"]["out_proj"].shape)
                heads = sh[1] // cfg.ssm.head_dim
                rows = _part(sp, sh, 1, m, pos)
                want = ((rows[0] // cfg.ssm.head_dim,
                         rows[1] // cfg.ssm.head_dim)
                        if heads % tp == 0 else (0, heads))
                assert head_range(cfg, m, pos) == want
    last = mesh_positions(m)[-1]
    if mesh == "16x16":
        assert expert_range(TC.get_config(GMOE), m, last) == (0, 40)
        assert expert_range(TC.get_config(DEEPSEEK), m, last) == (60, 64)
        assert head_range(TC.get_config(MAMBA), m, last) == (60, 64)
        assert head_range(_configs(MAMBA)[1], m, last) == (0, 8)
    if mesh == "3x2":
        assert expert_range(_configs(DEEPSEEK, {"n_experts": 6})[1], m,
                            last) == (3, 6)
        assert vocab_range(TC.get_config(GMOE), m, last) == (24704, 49408)


def test_sharded_compression_is_the_one_device_quantisation(cases_2x2):
    """The same gradients and residuals quantised on (2, 2) slices and on
    whole leaves: bit for bit (the chunks of the whole leaf flattened, a
    slice cut along non-leading dims holding pieces of many)."""
    run, i, case = _case(cases_2x2, "compress")
    want_deq, want_err = compress_decompress(
        CompressionConfig(enabled=True), params_from_numpy(case["grads"],
                                                           CPU),
        params_from_numpy(case["err"], CPU))
    for part, want in (("deq", want_deq), ("err", want_err)):
        got = _whole(run, i, (part,), case["grads"])
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            assert np.array_equal(a, b.numpy())


def test_sharded_compression_step(cases_2x2):
    run, i, case = _case(cases_2x2, "compress_step")
    mets, _, state = _one_device(GRANITE, case["params"], case["batches"],
                                 case["tc"])
    _close_metrics(run["ranks"][0]["cases"][i]["metrics"], mets)
    for name in ("m", "v"):
        _close_trees(_whole(run, i, ("state", "opt", name), case["params"]),
                     state["opt"][name], rel=2e-2, atol=1e-9)
    g = tree_leaves(_whole(run, i, ("state", "err"), case["params"]))
    for a, b in zip(g, tree_leaves(state["err"])):
        b = b.numpy()
        assert np.abs(a - b).max() <= 2.01 * np.abs(b).max() + 1e-12


def test_sharded_cast_params_bf16(cases_2x2):
    """The float32 slices cast to bfloat16 before the gather: the state
    stays float32 and the step is the one device's."""
    run, i, case = _case(cases_2x2, "bf16")
    mets, _, state = _one_device(GRANITE, case["params"], case["batches"],
                                 case["tc"])
    _close_metrics(run["ranks"][0]["cases"][i]["metrics"], mets, rel=1e-3)
    got = _whole(run, i, ("state", "params"), case["params"])
    for a, b in zip(tree_leaves(got), tree_leaves(state["params"])):
        assert a.dtype == np.float32
        assert np.abs(a - b.numpy()).max() <= 2 * LR * 3


def test_sharded_loss_takes_act_dp_and_refuses_the_rest(cases_2x2):
    """On a sharded step ``act_dp`` naming the data axes gives the loss
    without it, and so does ``seq_shard`` without ``act_dp`` (bit for
    bit: it changes nothing, as in the reference); with ``act_dp`` the
    sequence is split over ``model`` and the loss is the one without it
    within 1e-5 (the order of the sums differs); ``act_dp`` naming
    ``model`` and ``unroll`` raise ``NotImplementedError``."""
    run, i, _ = _case(cases_2x2, "knobs")
    for r in run["ranks"]:
        got = r["cases"][i]
        assert got["raised"] == ["act_dp_model", "unroll"]
        assert got["act_dp_equal"] and got["seq_shard_equal"]
        assert abs(got["seq_shard_act_dp"] - got["loss"]) \
            <= 1e-5 * abs(got["loss"])


# ------------------------------- checkpoints --------------------------------

def test_a_2x2_checkpoint_restores_on_one_device_and_in_the_reference(
        cases_2x2, granite):
    """The (2, 2) ranks' save is whole leaves in the reference's layout:
    the port's one-device manager and the reference's restore it, bit for
    bit the ranks' slices put together."""
    run = {"ranks": cases_2x2["ranks"], "mesh": MESHES["2x2"]}
    want = _whole(run, 0, ("state", "params"), granite)
    d = cases_2x2["ckpt"]
    mgr = CheckpointManager(str(d))
    assert mgr.latest_step() == 2
    tcfg = TC.get_config(GRANITE).reduced()
    like = init_state(tcfg, RANKS._train_config(FP32),
                      params_from_numpy(granite, CPU))
    got = mgr.restore(2, like)
    for a, b in zip(tree_leaves(got["params"]), tree_leaves(want)):
        assert np.array_equal(a.numpy(), b)
    assert int(got["opt"]["count"]) == 3
    ref = RefManager(str(d)).restore(2, jax.tree.map(jnp.asarray, {
        "params": granite, "opt": {"m": granite, "v": granite,
                                   "count": np.int32(0)}}))
    for a, b in zip(jax.tree.leaves(ref["params"]), tree_leaves(want)):
        assert np.array_equal(np.asarray(a), b)


@pytest.mark.parametrize("which", [1, 2])
def test_checkpoints_restore_across_meshes(runs, cases_2x2, ref_ckpt, which,
                                           granite):
    """(4, 1) ranks restore, each its slices: the (2, 2) ranks' save
    (case 1) and the reference's (case 2), bit for bit."""
    if which == 1:
        want = _whole({"ranks": cases_2x2["ranks"], "mesh": MESHES["2x2"]},
                      0, ("state", "params"), granite)
    else:
        want = ref_ckpt[1]["params"]
    run = runs["4x1"]
    got = _whole(run, which, ("state", "params"), granite)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert np.array_equal(a, np.asarray(b))
    assert all(r["cases"][which]["latest"] == 2 for r in run["ranks"])


# ------------------------------ the driver ----------------------------------

def test_sharded_driver_meets_the_restart_contract(tmp_path):
    """``python -m repro_torch.launch.train`` under torchrun on a (2, 1)
    mesh of CPU processes with a failure injected at step 5: the
    contract of the reference's driver tests, and the final loss of a
    one-device driver's run."""
    args = ["--arch", GRANITE, "--reduced", "--steps", "8", "--batch", "2",
            "--seq", "32", "--ckpt_every", "3", "--fail_at_step", "5",
            "--log_every", "100", "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train", *args,
         "--data_mesh", "2", "--ckpt_dir", str(tmp_path / "sharded")],
        capture_output=True, text=True, timeout=240, env=env, cwd=tmp_path)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-4000:]
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1                      # rank 0 alone prints
    out = ast.literal_eval(lines[0])
    assert out["restarts"] == 1
    assert out["n_steps_run"] >= 8
    assert np.isfinite(out["final_loss"])
    one = TrainDriver(DriverConfig(
        arch=GRANITE, reduced=True, steps=8, batch=2, seq=32, ckpt_every=3,
        log_every=100, device="cpu", ckpt_dir=str(tmp_path / "one"))).run()
    assert abs(out["final_loss"] - one["final_loss"]) \
        <= 1e-5 * abs(one["final_loss"])
    assert (tmp_path / "sharded" / "step_00000007" / "COMMITTED").exists()
