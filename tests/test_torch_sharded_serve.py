"""repro_torch's sharded serving step (``prefill`` and ``decode_step``
with a ``Layout``) on meshes of processes, on the CPU.

The ranks are processes of a gloo group (``tests/_torch_ranks.py``'s
``serve`` case, one spawn a mesh: (2, 2), (4, 1), (1, 4) and (1, 2)).
Each holds its slices of the parameters (``param_specs``) and of the
caches (``cache_specs``: ``cache_spec(..., layout=)`` allocates only
those), prefills its rows of a global prompt of 4 x 12 tokens and decodes
4 steps on: the first at one scalar position, the others at per-row
positions with a subset of the rows live (``rows``), so the rows end at
different depths. The logits (each rank's rows over the whole
vocabulary) and every cache leaf, put back together by ``cache_specs``
(``unshard_leaf``, which also checks that replicas agree), are held to
the port's one-device calls and to the reference's mesh-less ``prefill``
/ ``decode_step`` (with the reference executor's live-row commit) on the
same weights (the reference's, ``params_from_numpy``).

The reduced configs cover each way the layout splits a model: qwen3-8b
(GQA, q/k-norm; 2 KV heads split over ``model`` on (1, 2) and (2, 2),
replicated on (1, 4), where every position computes every head),
granite-moe-3b-a800m (experts over ``model``; on (1, 4) also with 6
experts, which do not divide, so the expert hidden dim is split),
deepseek-moe-16b (a shared expert), mamba2-1.3b (SSM heads over
``model``, and the conv cache cut into chunks of channels that are not
the position's heads: gathered each step) and granite-3-2b with a
window of 8 below the prompt's 12 tokens (the ring buffer).

Tolerance: 1e-5 x max(1, max |want|) for logits and caches, float32
(only the order of float32 sums differs: products' columns split over
``model``, the conv state's new row from the chunk's own columns of
``in_proj``). Live rows are held to the reference; a row left out of
``rows`` keeps its caches, and its logits (for the caller to discard)
are held to the port's one-device call only.
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.models import cache_spec as ref_cache_spec
from repro.models import decode_step as ref_decode_step
from repro.models import init_params as ref_init_params
from repro.models import prefill as ref_prefill

import repro_torch.configs as TC
from repro_torch.dist.collectives import Layout
from repro_torch.dist.sharding import (batch_specs, cache_specs, conv_part,
                                       map_specs, mesh_positions,
                                       param_specs, shard_leaf, shard_serve,
                                       shard_slices, spec_axes, unshard_leaf)
from repro_torch.launch.mesh import Mesh
from repro_torch.models import (cache_spec, decode_step, fill_caches,
                                padded_vocab, prefill)
from repro_torch.models.weights import params_from_numpy

sys.path.insert(0, str(Path(__file__).parent))
import _torch_ranks as RANKS  # noqa: E402

CPU = torch.device("cpu")
B, S, S_CACHE = 4, 12, 16
TOL = 1e-5
GMOE = "granite-moe-3b-a800m"
MESHES = {"2x2": dict(data=2, model=2), "4x1": dict(data=4, model=1),
          "1x4": dict(data=1, model=4), "1x2": dict(data=1, model=2)}
# name -> (arch, MoECfg fields, window)
CONFIGS = {"qwen3": ("qwen3-8b", None, None),
           "granite_moe": (GMOE, None, None),
           "deepseek": ("deepseek-moe-16b", None, None),
           "mamba2": ("mamba2-1.3b", None, None),
           "window": ("granite-3-2b", None, 8)}
# 6 experts do not divide over 4: the expert hidden dim is split
EXTRA = {"1x4": {"moe_hidden": (GMOE, {"n_experts": 6}, None)}}
CASES = [(m, c) for m in MESHES for c in [*CONFIGS, *EXTRA.get(m, {})]]
# live rows of each decode step (None: all)
LIVE = [None, [0, 2, 3], [1, 3], None]


def _spec(name):
    return {**CONFIGS, **EXTRA.get("1x4", {})}[name]


def _configs(name):
    """The reference's and the port's reduced config of case ``name``."""
    arch, moe, window = _spec(name)
    out = []
    for reg in (RC, TC):
        cfg = reg.get_config(arch).reduced()
        if moe:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, **moe))
        if window:
            cfg = dataclasses.replace(cfg, window=window)
        out.append(cfg)
    return out


def _params(name):
    p = ref_init_params(_configs(name)[0], jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, p)


def _inputs(cfg):
    """The global prompt and the decode steps: step 0 at the scalar
    position S, the others at each row's own depth."""
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    depth, steps = np.full(B, S, np.int64), []
    for t, live in enumerate(LIVE):
        steps.append({
            "token": rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32),
            "pos": np.int64(S) if t == 0 else depth.copy(),
            "rows": None if live is None else np.asarray(live, np.int64)})
        depth = depth + _live(live)
    return prompt, steps


def _live(live):
    return np.ones(B, bool) if live is None else np.isin(np.arange(B), live)


def _case(name):
    arch, moe, window = _spec(name)
    prompt, steps = _inputs(_configs(name)[1])
    return dict(kind="serve", arch=arch, moe=moe, window=window,
                params=_params(name), prompt=prompt, steps=steps,
                s_cache=S_CACHE)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each mesh's ranks, started once, on all of its cases."""
    out = {}
    for mesh, sizes in MESHES.items():
        names = [*CONFIGS, *EXTRA.get(mesh, {})]
        res = RANKS.run({"mesh": sizes, "cases": [_case(n) for n in names]},
                        int(np.prod(list(sizes.values()))),
                        tmp_path_factory.mktemp("serve" + mesh))
        out[mesh] = {n: [{"coords": r["coords"], **r["cases"][i]}
                         for r in res] for i, n in enumerate(names)}
    return out


# ------------------------------ the baselines ------------------------------

def _one_device(name):
    cfg = _configs(name)[1]
    prompt, steps = _inputs(cfg)
    params = params_from_numpy(_params(name), CPU)
    t = lambda a: None if a is None else torch.as_tensor(a)  # noqa: E731
    with torch.no_grad():
        logits, pre = prefill(cfg, params, torch.from_numpy(prompt), None,
                              torch.float32)
        pre_np = [{k: v.numpy().copy() for k, v in c.items()} for c in pre]
        caches = cache_spec(cfg, B, S_CACHE, torch.float32, CPU)
        fill_caches(caches, pre)
        out = [decode_step(cfg, params, t(st["token"]), t(st["pos"]),
                           caches, torch.float32, rows=t(st["rows"]))[0]
               .numpy() for st in steps]
    return {"prefill": logits.numpy(), "prefill_caches": pre_np,
            "steps": out,
            "caches": [{k: v.numpy() for k, v in c.items()} for c in caches]}


def _reference(name):
    rcfg = _configs(name)[0]
    prompt, steps = _inputs(rcfg)
    jp = jax.tree.map(jnp.asarray, _params(name))
    logits, pre = ref_prefill(rcfg, jp, jnp.asarray(prompt),
                              compute_dtype=jnp.float32)
    caches = [{k: (c[k].at[:, :, :p[k].shape[2]].set(p[k])
                   if k in ("k", "v") else p[k]) for k in c}
              for c, p in zip(ref_cache_spec(rcfg, B, S_CACHE,
                                             dtype=jnp.float32), pre)]
    out = []
    for st in steps:
        lg, new = ref_decode_step(rcfg, jp, jnp.asarray(st["token"]),
                                  jnp.asarray(st["pos"]), caches,
                                  compute_dtype=jnp.float32)
        live = jnp.asarray(_live(None if st["rows"] is None
                                 else st["rows"].tolist()))
        caches = [{k: jnp.where(live.reshape((1, B) + (1,) * (
            n[k].ndim - 2)), n[k], c[k]) for k in c}
            for c, n in zip(caches, new)]
        out.append(np.asarray(lg))
    return {"prefill": np.asarray(logits),
            "prefill_caches": jax.tree.map(np.asarray, pre),
            "steps": out, "caches": jax.tree.map(np.asarray, caches)}


_MEMO = {}


def _baselines(name):
    if name not in _MEMO:
        _MEMO[name] = (_one_device(name), _reference(name))
    return _MEMO[name]


# ------------------------------ comparisons --------------------------------

def _mesh(sizes: dict) -> Mesh:
    axes = tuple(a for a in ("data", "model") if a in sizes)
    return Mesh(axes, tuple(sizes[a] for a in axes))


def _close(got, want, what, rows=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if rows is not None:
        got, want = got[rows], want[rows]
    assert np.isfinite(got).all(), what
    err = np.abs(got - want).max() if got.size else 0.0
    tol = TOL * max(1.0, np.abs(want).max() if want.size else 0.0)
    assert err <= tol, f"{what}: max abs err {err:.3e} > {tol:.3e}"


def _whole_rows(ranks, key, mesh, cfg, i=None):
    """The ranks' rows of ``key`` (step ``i``) put together over the
    batch (replicas must agree)."""
    m = _mesh(mesh)
    coords = [tuple(r["coords"][a] for a in m.axis_names) for r in ranks]
    parts = [r[key] if i is None else r[key][i] for r in ranks]
    sp = (batch_specs(cfg, m, B)["tokens"][0],) + (None,) * (
        parts[0].ndim - 1)
    return unshard_leaf(dict(zip(coords, parts)), sp, m)


def _whole_caches(ranks, key, mesh, cfg, like):
    m = _mesh(mesh)
    coords = [tuple(r["coords"][a] for a in m.axis_names) for r in ranks]
    return map_specs(lambda sp, *parts: unshard_leaf(
        dict(zip(coords, parts)), sp, m), cache_specs(cfg, m, like),
        *[r[key] for r in ranks])


def _close_caches(got, want, what, rows=None):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w)
        for k in w:
            _close(np.swapaxes(g[k], 0, 1), np.swapaxes(w[k], 0, 1),
                   f"{what} {i}/{k}", rows)


@pytest.mark.parametrize("mesh,name", CASES)
def test_sharded_serving_equals_one_device_and_reference(runs, mesh, name):
    cfg = _configs(name)[1]
    ranks = runs[mesh][name]
    one, ref = _baselines(name)
    got = _whole_rows(ranks, "prefill", MESHES[mesh], cfg)
    _close(got, one["prefill"], "prefill logits vs one device")
    _close(got, ref["prefill"], "prefill logits vs reference")
    pre = _whole_caches(ranks, "prefill_caches", MESHES[mesh], cfg,
                        one["prefill_caches"])
    _close_caches(pre, one["prefill_caches"], "prefill caches vs one device")
    _close_caches(pre, ref["prefill_caches"], "prefill caches vs reference")
    for t, live in enumerate(LIVE):
        got = _whole_rows(ranks, "steps", MESHES[mesh], cfg, t)
        _close(got, one["steps"][t], f"step {t} logits vs one device")
        _close(got, ref["steps"][t], f"step {t} logits vs reference",
               _live(live))
    caches = _whole_caches(ranks, "caches", MESHES[mesh], cfg,
                           one["caches"])
    _close_caches(caches, one["caches"], "caches vs one device")
    _close_caches(caches, ref["caches"], "caches vs reference")


def _shards(sp, sizes) -> int:
    return int(np.prod([sizes[a] for a in spec_axes(sp)]))


@pytest.mark.parametrize("mesh,name", CASES)
def test_each_rank_holds_only_its_cache_slices(runs, mesh, name):
    """A rank's cache bytes are the caches' bytes, leaf by leaf, over the
    number of shards of the leaf's ``cache_specs``; its logits are its
    rows over the whole padded vocabulary."""
    cfg = _configs(name)[1]
    whole = cache_spec(cfg, B, S_CACHE, torch.float32, "meta")
    sizes = MESHES[mesh]
    want = sum(int(np.prod(t.shape)) * 4 // _shards(sp, sizes)
               for c, sc in zip(whole, cache_specs(cfg, _mesh(sizes),
                                                   whole))
               for t, sp in ((c[k], sc[k]) for k in c))
    n_data = _shards(batch_specs(cfg, _mesh(sizes), B)["tokens"][0], sizes)
    for r in runs[mesh][name]:
        assert r["cache_bytes"] == want
        assert r["prefill"].shape == (B // n_data, 1, padded_vocab(cfg))


# which splits the layouts run, by (mesh, case): a wrong flag would run
# the one-device arithmetic on every rank and still match
SPLITS = {
    ("1x2", "qwen3"): ("attn_tp", [True]),
    ("2x2", "qwen3"): ("attn_tp", [True]),
    ("1x4", "qwen3"): ("attn_tp", [False]),
    ("1x4", "granite_moe"): ("moe_tp", ["ep"]),
    ("1x4", "moe_hidden"): ("moe_tp", ["hidden"]),
    ("1x4", "mamba2"): ("ssm_tp", [True]),
    ("1x2", "mamba2"): ("ssm_tp", [True]),
}


@pytest.mark.parametrize("mesh,name", sorted(SPLITS))
def test_the_layouts_split_the_model(runs, mesh, name):
    flag, want = SPLITS[(mesh, name)]
    for r in runs[mesh][name]:
        assert r["layout"][flag] == want
        assert r["layout"]["vocab_tp"]
    if name == "mamba2":
        m = MESHES[mesh]["model"]
        ch = 160 // m                 # d_in 128 + B 16 + C 16 channels
        parts = sorted(tuple(r["layout"]["conv_part"])
                       for r in runs[mesh][name])
        assert parts == [(i * ch, (i + 1) * ch) for i in range(m)]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_act_dp_is_the_data_axes_or_refused(runs, mesh):
    for name in CONFIGS:
        for r in runs[mesh][name]:
            assert r["act_dp_equal"]
            assert r["raised"] == ["prefill", "decode"]


# ---------------------------- no processes ---------------------------------

class MockMesh:
    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


def test_shard_serve_gives_each_position_its_rows():
    cfg = TC.get_config("qwen3-8b").reduced()
    m = MockMesh({"data": 2, "model": 2})
    ins = {"token": np.arange(4)[:, None], "pos": np.arange(10, 14),
           "rows": np.array([0, 2, 3])}
    for pos in mesh_positions(m):
        got = shard_serve(ins, cfg, m, pos)
        lo = 2 * pos["data"]
        assert np.array_equal(got["token"], ins["token"][lo:lo + 2])
        assert np.array_equal(got["pos"], ins["pos"][lo:lo + 2])
        assert np.array_equal(got["rows"], [0] if lo == 0 else [0, 1])
    scalar = shard_serve({"token": ins["token"], "pos": np.int64(7),
                          "rows": None}, cfg, m, mesh_positions(m)[3])
    assert scalar["pos"] == 7 and scalar["rows"] is None
    # 3 rows do not split over 2 data positions: both hold them all
    three = shard_serve({"tokens": np.zeros((3, 5))}, cfg, m,
                        mesh_positions(m)[3])
    assert three["tokens"].shape == (3, 5)


def _shard_caches(caches, cfg, mesh, coords):
    """The slices of a whole cache tree that the position at ``coords``
    holds under ``cache_specs``."""
    return map_specs(lambda sp, c: shard_leaf(c, sp, mesh, coords),
                     cache_specs(cfg, mesh, caches), caches)


def test_shard_caches_then_unshard_gives_the_caches():
    cfg = TC.get_config("mamba2-1.3b").reduced()
    m = MockMesh({"data": 2, "model": 4})
    whole = [{k: torch.randn(v.shape) for k, v in c.items()}
             for c in cache_spec(cfg, 4, 8, torch.float32, CPU)]
    specs = cache_specs(cfg, m, whole)
    parts = {tuple(p[a] for a in m.axis_names): _shard_caches(whole, cfg, m,
                                                              p)
             for p in mesh_positions(m)}
    for i, c in enumerate(whole):
        for k in c:
            assert specs[i][k][3 if k == "conv" else 2] == "model"
            got = unshard_leaf({q: v[i][k] for q, v in parts.items()},
                               specs[i][k], m)
            assert torch.equal(got, c[k])


@pytest.mark.parametrize("arch,model", [("mamba2-1.3b", 4),
                                        ("mamba2-1.3b", 2),
                                        ("mamba2-1.3b", 1),
                                        ("qwen3-8b", 4)])
def test_conv_part_is_the_chunk_cache_specs_cuts(arch, model):
    """``conv_part`` is the conv cache's channel slice that ``cache_specs``
    gives each position, or None where the position holds them all."""
    cfg = TC.get_config(arch).reduced()
    m = MockMesh({"data": 2, "model": model})
    whole = cache_spec(cfg, 4, 8, torch.float32, "meta")
    convs = [(c["conv"], sp["conv"])
             for c, sp in zip(whole, cache_specs(cfg, m, whole))
             if "conv" in c]
    for pos in mesh_positions(m):
        got = conv_part(cfg, m, pos)
        if not convs:
            assert got is None
            continue
        for leaf, sp in convs:
            sl = shard_slices(leaf.shape, sp, m, pos)[3]
            if sl.stop - sl.start == leaf.shape[3]:
                assert got is None and model == 1
            else:
                assert got == (sl.start, sl.stop)
                assert got[1] - got[0] == leaf.shape[3] // model


def test_without_a_process_group_serving_is_refused():
    cfg = TC.get_config("qwen3-8b").reduced()
    mesh = Mesh(("data", "model"), (1, 1))
    params = params_from_numpy(_params("qwen3"), CPU)
    with pytest.raises(ValueError, match="mesh of processes"):
        Layout(cfg, mesh, param_specs(cfg, mesh, params))
    with pytest.raises(NotImplementedError, match="act_dp"):
        prefill(cfg, params, torch.zeros((1, 4), dtype=torch.int64),
                act_dp=("data",))
