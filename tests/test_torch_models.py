"""repro_torch's configs and models against the reference's, on the CPU.

The same inputs, made with numpy from a seed, go through the reference's
JAX functions and the port's; the reference's ``init_params`` output is
carried across with ``params_from_numpy``, so both compute on the same
weights. Per module (norms, RoPE, attention train and decode, MLP, MoE in
both dispatch implementations, SSD, mamba train and decode,
``routing_matrix``) and per architecture (all ten ``reduced()`` configs:
forward logits, loss value, prefill logits and caches, eight decode steps
with their caches), plus tests/test_models.py case for case on the port
alone and the port's own ``init_params`` against the reference's.

Tolerance: floats within ``2e-4 * max|ref| + 1e-5`` in float32 and
``2e-2 * max|ref| + 1e-5`` with bfloat16 compute; integers (top-k indices,
capacity drops, ``padded_vocab``, ``n_params``) and ``routing_matrix``'s
arrays exact.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.models import cache_spec as ref_cache_spec
from repro.models import decode_step as ref_decode_step
from repro.models import forward as ref_forward
from repro.models import init_params as ref_init_params
from repro.models import layers as RL
from repro.models import loss_fn as ref_loss_fn
from repro.models import moe as RMOE
from repro.models import padded_vocab as ref_padded_vocab
from repro.models import prefill as ref_prefill
from repro.models import ssm as RSSM

import repro_torch.configs as TC
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.weights import (caches_from_numpy, caches_to_numpy,
                                        params_from_numpy, params_to_numpy)

KEY = jax.random.PRNGKey(0)
CPU = torch.device("cpu")
RTOL = {"float32": 2e-4, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# the jamba pattern block is 8 layers: by far the heaviest reference runs
_SLOW_ARCHS = {"jamba-v0.1-52b"}


def _arch_params(ids):
    return [pytest.param(a, marks=pytest.mark.slow) if a in _SLOW_ARCHS
            else a for a in ids]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy().astype(np.float64)
    return np.asarray(jnp.asarray(x, jnp.float32), np.float64)


def _close(got, want, dtype="float32", what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    tol = RTOL[dtype] * np.abs(want).max() + 1e-5
    err = np.abs(got - want).max()
    assert err <= tol, f"{what}: max abs err {err:.3e} > tol {tol:.3e}"


def _close_tree(got, want, dtype="float32", what=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _close_tree(got[k], want[k], dtype, f"{what}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _close_tree(g, w, dtype, f"{what}[{i}]")
    else:
        _close(got, want, dtype, what)


def _cfgs(arch):
    return RC.get_config(arch).reduced(), TC.get_config(arch).reduced()


def _same(ref_cfg, **kw):
    """The port's copy of a (replaced) reference config."""
    port = TC.get_config(ref_cfg.name)
    fields = {f.name: getattr(ref_cfg, f.name)
              for f in dataclasses.fields(ref_cfg)}
    for sub, cls in (("moe", TC.MoECfg), ("ssm", TC.SSMCfg)):
        if fields[sub] is not None:
            fields[sub] = cls(**dataclasses.asdict(fields[sub]))
    fields.update(kw)
    return dataclasses.replace(port, **fields)


@functools.lru_cache(maxsize=None)
def _ref_params_np(ref_cfg, seed=0):
    p = ref_init_params(ref_cfg, jax.random.PRNGKey(seed))
    return jax.tree.map(np.asarray, p)


def _both_params(ref_cfg, dtype=None):
    pn = _ref_params_np(ref_cfg)
    return (jax.tree.map(jnp.asarray, pn),
            params_from_numpy(pn, CPU, dtype))


def _rng_normal(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


# ------------------------------- configs ----------------------------------

@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_configs_match_reference(arch):
    ref, port = RC.get_config(arch), TC.get_config(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.n_params() == ref.n_params()
    assert port.active_params_per_token() == ref.active_params_per_token()
    assert dataclasses.asdict(port.reduced()) == \
        dataclasses.asdict(ref.reduced())
    assert port.reduced().n_params() == ref.reduced().n_params()
    assert M.padded_vocab(port) == ref_padded_vocab(ref)
    assert [dataclasses.asdict(c) for c in TC.cells_for(port)] == \
        [dataclasses.asdict(c) for c in RC.cells_for(ref)]
    assert port.layer_kinds() == ref.layer_kinds()


def test_registry_matches_reference():
    assert TC.ARCH_IDS == RC.ARCH_IDS
    assert sorted(TC.REGISTRY) == sorted(RC.REGISTRY)
    with pytest.raises(KeyError, match="unknown arch"):
        TC.get_config("no-such-arch")


def test_param_counts_close_to_names():
    """tests/test_models.py's rule on the port's configs."""
    expected = {"granite-3-2b": 2.5e9, "starcoder2-7b": 7e9,
                "llama3-405b": 405e9, "qwen3-8b": 8e9,
                "jamba-v0.1-52b": 52e9, "mamba2-1.3b": 1.3e9,
                "deepseek-moe-16b": 16e9, "granite-moe-3b-a800m": 3e9}
    for name, want in expected.items():
        got = TC.REGISTRY[name].n_params()
        assert 0.8 * want < got < 1.35 * want, (name, got, want)


def test_cells_for_skips_long_for_full_attention():
    for arch in TC.ARCH_IDS:
        cfg = TC.get_config(arch)
        names = [c.name for c in TC.cells_for(cfg)]
        if cfg.family in ("ssm", "hybrid"):
            assert "long_500k" in names, arch
        else:
            assert "long_500k" not in names, arch
        assert {"train_4k", "prefill_32k", "decode_32k"} <= set(names)


# ------------------------------- layers -----------------------------------

@pytest.mark.parametrize("norm", ["rms", "layer"])
def test_apply_norm(norm):
    x = _rng_normal(0, (2, 5, 64), 3.0)
    p = {"scale": _rng_normal(1, (64,)) + 1.0}
    if norm == "layer":
        p["bias"] = _rng_normal(2, (64,))
    want = RL.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x))
    got = L.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x))
    _close(got, want)
    scale = _rng_normal(3, (16,)) + 1.0
    x4 = _rng_normal(4, (2, 5, 4, 16))
    _close(L.rms_head_norm(torch.from_numpy(scale), torch.from_numpy(x4)),
           RL.rms_head_norm(jnp.asarray(scale), jnp.asarray(x4)))


@pytest.mark.parametrize("per_row", [False, True])
def test_apply_rope(per_row):
    x = _rng_normal(0, (2, 7, 4, 16))
    pos = np.arange(7)[None].repeat(2, 0) + np.array([[0], [300]]) \
        if per_row else np.arange(7) + 1000
    want = RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    _close(got, want)


def _attn_params(ref_cfg, seed=0):
    pn = jax.tree.map(np.asarray,
                      RL.init_attention(ref_cfg, jax.random.PRNGKey(seed)))
    if "q_norm" in pn:   # non-trivial qk-norm scales
        pn["q_norm"] = pn["q_norm"] + _rng_normal(7, pn["q_norm"].shape, .1)
        pn["k_norm"] = pn["k_norm"] + _rng_normal(8, pn["k_norm"].shape, .1)
    return (jax.tree.map(jnp.asarray, pn), params_from_numpy(pn, CPU))


@pytest.mark.parametrize("arch,window", [("qwen3-8b", None),
                                         ("granite-3-2b", 8)])
@pytest.mark.parametrize("block_kv", [None, 8])
def test_attention_train(arch, window, block_kv):
    ref_cfg = dataclasses.replace(RC.get_config(arch).reduced(),
                                  window=window)
    cfg = _same(ref_cfg)
    jp, tp = _attn_params(ref_cfg)
    x = _rng_normal(1, (2, 32, ref_cfg.d_model))
    pos = np.arange(32)[None]
    want = RL.attention_train(ref_cfg, jp, jnp.asarray(x), jnp.asarray(pos),
                              block_kv=block_kv)
    got = L.attention_train(cfg, tp, torch.from_numpy(x),
                            torch.from_numpy(pos), block_kv=block_kv)
    _close(got, want)


@pytest.mark.parametrize("per_slot", [False, True])
@pytest.mark.parametrize("window", [None, 4])
def test_attention_decode(per_slot, window):
    """Scalar and per-slot positions, with and without a ring buffer: the
    output and both caches after every step."""
    ref_cfg = dataclasses.replace(RC.get_config("qwen3-8b").reduced(),
                                  window=window)
    cfg = _same(ref_cfg)
    jp, tp = _attn_params(ref_cfg, seed=3)
    b, s_c = 3, (window or 8)
    shape = (b, s_c, ref_cfg.n_kv_heads, ref_cfg.hd)
    kc, vc = jnp.zeros(shape), jnp.zeros(shape)
    tk, tv = torch.zeros(shape), torch.zeros(shape)
    for t in range(11):       # past s_c: the clamp, or the ring's wrap
        x = _rng_normal(10 + t, (b, 1, ref_cfg.d_model))
        pos = np.array([t, t + 2, 2 * t], np.int32) if per_slot \
            else np.int32(t)
        out, kc, vc = RL.attention_decode(ref_cfg, jp, jnp.asarray(x),
                                          jnp.asarray(pos), kc, vc)
        got, tk, tv = L.attention_decode(cfg, tp, torch.from_numpy(x),
                                         torch.from_numpy(np.asarray(pos)),
                                         tk, tv)
        _close(got, out, what=f"out t={t}")
        _close(tk, kc, what=f"k t={t}")
        _close(tv, vc, what=f"v t={t}")


@pytest.mark.parametrize("arch", ["granite-3-2b", "starcoder2-7b"])
def test_apply_mlp(arch):
    ref_cfg, cfg = _cfgs(arch)
    assert cfg.mlp_kind == ("swiglu" if arch == "granite-3-2b" else "gelu")
    pn = jax.tree.map(np.asarray, RL.init_mlp(ref_cfg, KEY))
    x = _rng_normal(0, (2, 9, ref_cfg.d_model), 2.0)
    _close(L.apply_mlp(cfg, params_from_numpy(pn, CPU), torch.from_numpy(x)),
           RL.apply_mlp(ref_cfg, jax.tree.map(jnp.asarray, pn),
                        jnp.asarray(x)))


def _drops(idx, cfg, s):
    """(token, k) pairs past their expert's capacity, by batch row."""
    cap = MOE._capacity(cfg, s)
    out = []
    for row in np.asarray(idx).reshape(idx.shape[0], -1):
        seen = np.zeros(cfg.moe.n_experts, int)
        n = 0
        for e in row:
            n += seen[e] >= cap
            seen[e] += 1
        out.append(n)
    return out


@pytest.mark.parametrize("impl", ["onehot", "sorted"])
@pytest.mark.parametrize("cf", [1.25, 8.0])
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "granite-moe-3b-a800m"])
def test_apply_moe(arch, impl, cf):
    base = RC.get_config(arch).reduced()
    ref_cfg = dataclasses.replace(
        base, moe=dataclasses.replace(base.moe, impl=impl,
                                      capacity_factor=cf))
    cfg = _same(ref_cfg)
    pn = jax.tree.map(np.asarray, RMOE.init_moe(ref_cfg, KEY))
    jp, tp = jax.tree.map(jnp.asarray, pn), params_from_numpy(pn, CPU)
    x = _rng_normal(1, (2, 16, ref_cfg.d_model))
    g_ref, i_ref, a_ref = RMOE._router(ref_cfg, jp, jnp.asarray(x))
    g, i, a = MOE._router(cfg, tp, torch.from_numpy(x))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    _close(g, g_ref)
    _close(a, a_ref)
    assert MOE._capacity(cfg, 16) == RMOE._capacity(ref_cfg, 16)
    drops = _drops(i.numpy(), cfg, 16)
    assert drops == _drops(np.asarray(i_ref), ref_cfg, 16)
    if cf == 1.25:       # the case covers capacity drops
        assert sum(drops) > 0
    y_ref, aux_ref = RMOE.apply_moe(ref_cfg, jp, jnp.asarray(x))
    y, aux = MOE.apply_moe(cfg, tp, torch.from_numpy(x))
    _close(y, y_ref)
    _close(aux, aux_ref)


def test_moe_sorted_matches_onehot():
    """tests/test_models.py's case on the port: the sorted dispatch agrees
    with the one-hot dispatch (same routing, same capacity drops)."""
    base = TC.get_config("deepseek-moe-16b").reduced()
    cfg_oh = dataclasses.replace(
        base, moe=dataclasses.replace(base.moe, impl="onehot",
                                      capacity_factor=8.0))
    cfg_so = dataclasses.replace(
        base, moe=dataclasses.replace(base.moe, impl="sorted",
                                      capacity_factor=8.0))
    gen = torch.Generator().manual_seed(0)
    p = MOE.init_moe(cfg_oh, gen)
    x = torch.from_numpy(_rng_normal(1, (2, 16, base.d_model)))
    y1, a1 = MOE.apply_moe(cfg_oh, p, x)
    y2, a2 = MOE.apply_moe(cfg_so, p, x)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(float(a1), float(a2), rtol=1e-5)


def test_routing_matrix_bit_identical():
    rng = np.random.default_rng(0)
    idx = np.stack([rng.permutation(16)[:2] for _ in range(2 * 24)])
    gates = rng.random((2 * 24, 2)).astype(np.float32)
    gates[3, 1] = 0.0                     # a zero gate is dropped
    want = RMOE.routing_matrix(idx.reshape(2, 24, 2),
                               gates.reshape(2, 24, 2), 16)
    for i, g in ((idx.reshape(2, 24, 2), gates.reshape(2, 24, 2)),
                 (torch.from_numpy(idx), torch.from_numpy(gates))):
        got = MOE.routing_matrix(i, g, 16)
        assert (got.n_rows, got.n_cols, got.nnz) == \
            (want.n_rows, want.n_cols, want.nnz)
        for name in ("rows", "cols", "vals"):
            a, b = getattr(got, name), np.asarray(getattr(want, name))
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)


# --------------------------------- SSM ------------------------------------

def _mamba_params(ref_cfg):
    pn = jax.tree.map(np.asarray, RSSM.init_mamba(ref_cfg, KEY))
    # non-trivial D, biases and gate scales
    pn["D"] = pn["D"] + _rng_normal(5, pn["D"].shape, .2)
    pn["conv_b"] = _rng_normal(6, pn["conv_b"].shape, .1)
    pn["gate_norm"] = pn["gate_norm"] + _rng_normal(7, pn["gate_norm"].shape,
                                                    .1)
    return jax.tree.map(jnp.asarray, pn), params_from_numpy(pn, CPU)


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked(with_state):
    b, s, h, p, n = 2, 32, 4, 8, 16
    xdt = _rng_normal(0, (b, s, h, p))
    dA = -np.abs(_rng_normal(1, (b, s, h), 0.3))
    B_, C_ = _rng_normal(2, (b, s, n)), _rng_normal(3, (b, s, n))
    init = _rng_normal(4, (b, h, p, n)) if with_state else None
    y_ref, st_ref = RSSM.ssd_chunked(
        *map(jnp.asarray, (xdt, dA, B_, C_)), 8,
        None if init is None else jnp.asarray(init))
    y, st = SSM.ssd_chunked(*map(torch.from_numpy, (xdt, dA, B_, C_)), 8,
                            None if init is None else torch.from_numpy(init))
    _close(y, y_ref)
    _close(st, st_ref)


def test_mamba_train_and_decode():
    """mamba_train (with return_state) over 16 tokens, then mamba_decode
    from its states for 6 more, each output and state against the
    reference's."""
    ref_cfg, cfg = _cfgs("mamba2-1.3b")
    jp, tp = _mamba_params(ref_cfg)
    x = _rng_normal(0, (2, 16, ref_cfg.d_model))
    out_ref, (conv_ref, st_ref) = RSSM.mamba_train(ref_cfg, jp,
                                                   jnp.asarray(x),
                                                   return_state=True)
    out, (conv, st) = SSM.mamba_train(cfg, tp, torch.from_numpy(x),
                                      return_state=True)
    _close(out, out_ref, what="train out")
    _close(conv, conv_ref, what="conv state")
    _close(st, st_ref, what="ssm state")
    _close(SSM.mamba_train(cfg, tp, torch.from_numpy(x)), out_ref)
    for t in range(6):
        xt = _rng_normal(10 + t, (2, 1, ref_cfg.d_model))
        o_ref, conv_ref, st_ref = RSSM.mamba_decode(ref_cfg, jp,
                                                    jnp.asarray(xt),
                                                    conv_ref, st_ref)
        o, conv, st = SSM.mamba_decode(cfg, tp, torch.from_numpy(xt), conv,
                                       st)
        _close(o, o_ref, what=f"decode out t={t}")
        _close(conv, conv_ref, what=f"conv t={t}")
        _close(st, st_ref, what=f"ssm t={t}")


# --------------------------- whole architectures ---------------------------

def _batch(cfg, b=2, s=16, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    batch["labels"][0, :3] = -1           # masked labels
    if cfg.n_prefix:
        batch["prefix_embeds"] = _rng_normal(seed + 1,
                                             (b, cfg.n_prefix, cfg.d_model),
                                             0.02)
    return batch


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", _arch_params(RC.ARCH_IDS))
def test_arch_forward_and_loss(arch):
    ref_cfg, cfg = _cfgs(arch)
    jp, tp = _both_params(ref_cfg)
    batch = _batch(ref_cfg)
    lr, ar = ref_forward(ref_cfg, jp, jnp.asarray(batch["tokens"]),
                         _jb(batch).get("prefix_embeds"),
                         compute_dtype=jnp.float32, remat=False)
    lt, at = M.forward(cfg, tp, torch.from_numpy(batch["tokens"]),
                       _tb(batch).get("prefix_embeds"),
                       compute_dtype=torch.float32)
    assert tuple(lt.shape) == (2, 16, M.padded_vocab(cfg))
    _close(lt, lr, what="logits")
    _close(at, ar, what="aux")
    loss_ref, parts_ref = ref_loss_fn(ref_cfg, jp, _jb(batch),
                                      compute_dtype=jnp.float32, remat=False)
    loss, parts = M.loss_fn(cfg, tp, _tb(batch), compute_dtype=torch.float32)
    _close(loss, loss_ref, what="loss")
    for k in ("ce", "aux", "z"):
        _close(parts[k], parts_ref[k], what=k)


@pytest.mark.parametrize("arch", _arch_params(RC.ARCH_IDS))
def test_arch_prefill(arch):
    ref_cfg, cfg = _cfgs(arch)
    jp, tp = _both_params(ref_cfg)
    batch = _batch(ref_cfg, s=12, seed=3)
    lr, cr = ref_prefill(ref_cfg, jp, jnp.asarray(batch["tokens"]),
                         _jb(batch).get("prefix_embeds"),
                         compute_dtype=jnp.float32)
    lt, ct = M.prefill(cfg, tp, torch.from_numpy(batch["tokens"]),
                       _tb(batch).get("prefix_embeds"),
                       compute_dtype=torch.float32)
    _close(lt, lr, what="logits")
    _close_tree(caches_to_numpy(ct), jax.tree.map(np.asarray, cr),
                what="caches")


@pytest.mark.parametrize("arch", _arch_params(RC.ARCH_IDS))
def test_arch_decode_steps(arch):
    """Eight decode steps at per-slot positions (the rows 3 apart), the
    logits and every cache leaf after each step."""
    ref_cfg, cfg = _cfgs(arch)
    jp, tp = _both_params(ref_cfg)
    cr = ref_cache_spec(ref_cfg, 2, 32, dtype=jnp.float32)
    ct = M.cache_spec(cfg, 2, 32, torch.float32, CPU)
    assert caches_to_numpy(ct)[0].keys() == cr[0].keys()
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (2, 8))
    start = np.array([0, 3], np.int32)
    for t in range(8):
        tok = toks[:, t: t + 1].astype(np.int32)
        lr, cr = ref_decode_step(ref_cfg, jp, jnp.asarray(tok),
                                 jnp.asarray(start + t), cr,
                                 compute_dtype=jnp.float32)
        lt, ct2 = M.decode_step(cfg, tp, torch.from_numpy(tok),
                                torch.from_numpy(start + t), ct,
                                compute_dtype=torch.float32)
        assert ct2 is ct                 # updated in place
        assert tuple(lt.shape) == (2, 1, M.padded_vocab(cfg))
        assert lt.dtype == torch.float32
        _close(lt, lr, what=f"logits t={t}")
        _close_tree(caches_to_numpy(ct), jax.tree.map(np.asarray, cr),
                    what=f"caches t={t}")


# one bf16 case per family (jamba is the hybrid one)
BF16_ARCHS = ["granite-3-2b", "phi-3-vision-4.2b", "jamba-v0.1-52b",
              "mamba2-1.3b", "deepseek-moe-16b", "musicgen-large"]


@pytest.mark.parametrize("arch", _arch_params(BF16_ARCHS))
def test_arch_bf16_compute(arch):
    """bfloat16 compute: the reference casts its float32 parameters at each
    use, the port holds them cast once (``cast_params``); forward logits
    and two decode steps with bf16 caches."""
    ref_cfg, cfg = _cfgs(arch)
    jp, tp = _both_params(ref_cfg, dtype=torch.bfloat16)
    assert tp["blocks"][0]["ln1"]["scale"].dtype == torch.float32
    assert tp["embed"].dtype == torch.bfloat16
    batch = _batch(ref_cfg, s=8, seed=5)
    lr, _ = ref_forward(ref_cfg, jp, jnp.asarray(batch["tokens"]),
                        _jb(batch).get("prefix_embeds"),
                        compute_dtype=jnp.bfloat16, remat=False)
    lt, _ = M.forward(cfg, tp, torch.from_numpy(batch["tokens"]),
                      _tb(batch).get("prefix_embeds"),
                      compute_dtype=torch.bfloat16)
    assert lt.dtype == torch.bfloat16
    _close(lt, lr, "bfloat16", "logits")
    cr = ref_cache_spec(ref_cfg, 2, 16, dtype=jnp.bfloat16)
    ct = M.cache_spec(cfg, 2, 16, torch.bfloat16, CPU)
    for t in range(2):
        tok = batch["tokens"][:, t: t + 1]
        lr, cr = ref_decode_step(ref_cfg, jp, jnp.asarray(tok),
                                 jnp.int32(t), cr,
                                 compute_dtype=jnp.bfloat16)
        lt, ct = M.decode_step(cfg, tp, torch.from_numpy(tok),
                               torch.tensor(t), ct,
                               compute_dtype=torch.bfloat16)
        _close(lt, lr, "bfloat16", f"decode logits t={t}")
        _close_tree(caches_to_numpy(ct), jax.tree.map(np.asarray, cr),
                    "bfloat16", f"caches t={t}")


def test_weights_round_trip():
    ref_cfg, _ = _cfgs("jamba-v0.1-52b")
    pn = _ref_params_np(ref_cfg)
    back = params_to_numpy(params_from_numpy(pn, CPU))
    jax.tree.map(np.testing.assert_array_equal, back, pn)
    cn = jax.tree.map(np.asarray, ref_cache_spec(ref_cfg, 2, 8,
                                                 dtype=jnp.bfloat16))
    ct = caches_from_numpy(cn, CPU)
    assert ct[0]["conv"].dtype == torch.bfloat16
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        a, np.asarray(b, np.float32)), caches_to_numpy(ct), cn)


# ------------------- tests/test_models.py, case for case -------------------

@pytest.mark.parametrize("arch", _arch_params(["granite-3-2b", "mamba2-1.3b",
                                               "jamba-v0.1-52b"]))
def test_decode_matches_forward(arch):
    """Stepwise decode reproduces the train-path logits (KV-cache and
    SSM-state correctness), covering attention, SSD and the hybrid mix."""
    cfg = TC.get_config(arch).reduced()
    if cfg.ssm is not None:
        cfg = dataclasses.replace(
            cfg, ssm=dataclasses.replace(cfg.ssm, chunk=4))
    if cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    params = M.init_params(cfg, 0, CPU)
    b, s = 2, 8
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab, (b, s)))
    full, _ = M.forward(cfg, params, tokens, compute_dtype=torch.float32)
    caches = M.cache_spec(cfg, b, 16, torch.float32, CPU)
    for t in range(s):
        step, caches = M.decode_step(cfg, params, tokens[:, t: t + 1],
                                     torch.tensor(t), caches,
                                     compute_dtype=torch.float32)
        np.testing.assert_allclose(step[:, 0].numpy(), full[:, t].numpy(),
                                   rtol=2e-3, atol=2e-3)


def test_blockwise_attention_matches_full():
    cfg = TC.get_config("qwen3-8b").reduced()
    p = L.init_attention(cfg, torch.Generator().manual_seed(0))
    x = torch.from_numpy(_rng_normal(2, (2, 32, cfg.d_model)))
    pos = torch.arange(32)[None]
    full = L.attention_train(cfg, p, x, pos)
    blk = L.attention_train(cfg, p, x, pos, block_kv=8)
    np.testing.assert_allclose(full.numpy(), blk.numpy(), rtol=2e-3,
                               atol=2e-4)


def test_sliding_window_decode_ring_buffer():
    """Window attention: ring-buffer decode == full-cache decode restricted
    to the window."""
    cfg = dataclasses.replace(TC.get_config("granite-3-2b").reduced(),
                              window=8)
    params = M.init_params(cfg, 0, CPU)
    b, s = 1, 20
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab, (b, s)))
    full, _ = M.forward(cfg, params, tokens, compute_dtype=torch.float32)
    caches = M.cache_spec(cfg, b, 64, torch.float32, CPU)  # -> ring size 8
    assert caches[0]["k"].shape[2] == 8
    for t in range(s):
        step, caches = M.decode_step(cfg, params, tokens[:, t: t + 1],
                                     torch.tensor(t), caches,
                                     compute_dtype=torch.float32)
    np.testing.assert_allclose(step[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=2e-3, atol=2e-3)


def test_prefill_matches_forward_and_windowed_decode():
    """The port's prefill (ring-buffer caches past the window) against its
    forward, and decoding on from the prefilled ring against forward."""
    cfg = dataclasses.replace(TC.get_config("qwen3-8b").reduced(), window=8)
    params = M.init_params(cfg, 1, CPU)
    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab, (2, 14)))
    full, _ = M.forward(cfg, params, tokens, compute_dtype=torch.float32)
    last, caches = M.prefill(cfg, params, tokens[:, :11],
                             compute_dtype=torch.float32)
    np.testing.assert_allclose(last[:, 0].numpy(), full[:, 10].numpy(),
                               rtol=2e-3, atol=2e-3)
    for t in range(11, 14):
        step, caches = M.decode_step(cfg, params, tokens[:, t: t + 1],
                                     torch.tensor(t), caches,
                                     compute_dtype=torch.float32)
        np.testing.assert_allclose(step[:, 0].numpy(), full[:, t].numpy(),
                                   rtol=2e-3, atol=2e-3)


# ---------------------------- the port's init ------------------------------

def _leaf_paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaf_paths(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaf_paths(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_init_params_tree_matches_reference(arch):
    """Leaf names, shapes and dtypes identical to the reference's, and the
    ``CausalLM`` holds them under the same names."""
    ref_cfg, cfg = _cfgs(arch)
    want = {k: (v.shape, str(v.dtype))
            for k, v in _leaf_paths(_ref_params_np(ref_cfg)).items()}
    params = M.init_params(cfg, 0, CPU)
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in _leaf_paths(params).items()}
    assert got == want
    model = M.CausalLM(cfg, params, device=CPU)
    names = {n.replace(".", "/") for n, _ in model.named_parameters()}
    assert names == {k.lstrip("/") for k in want}


def _wide(arch):
    """A widened reduced config whose random leaves all hold 8192 or more
    values (n_blocks = 2), so that a 5 % check on their standard deviation
    is far beyond sampling noise (about 1.1 % for two estimates)."""
    cfg = RC.get_config(arch).reduced()
    kw = dict(n_layers=2 * len(cfg.pattern or ("A",)), d_model=512,
              n_heads=8, head_dim=64, d_ff=1024 if cfg.d_ff else 0,
              vocab=2048)
    if cfg.moe:
        kw["moe"] = dataclasses.replace(cfg.moe, n_experts=8, d_expert=128)
    if cfg.ssm:
        kw["ssm"] = dataclasses.replace(cfg.ssm, d_state=64, head_dim=64)
    return dataclasses.replace(cfg, **kw)


@pytest.mark.parametrize("arch", _arch_params(RC.ARCH_IDS))
def test_init_params_scales_match_reference(arch):
    """The port draws from a ``torch.Generator``, not ``jax.random``: its
    leaves have the reference's per-leaf standard deviation within 5 %,
    and its constant leaves the reference's values."""
    ref_cfg = _wide(arch)
    want = _leaf_paths(_ref_params_np(ref_cfg))
    got = _leaf_paths(M.init_params(_same(ref_cfg), 0, CPU))
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k].numpy()
        if np.std(w) == 0 or k.endswith(("A_log", "dt_bias")):
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=k)
            continue
        assert w.size >= 8192, (k, w.size)
        assert abs(np.std(g) / np.std(w) - 1) < 0.05, (k, np.std(g),
                                                       np.std(w))
        assert abs(np.mean(g)) < 5 * np.std(w) / np.sqrt(w.size), k
    # another seed draws other bits
    again = _leaf_paths(M.init_params(_same(ref_cfg), 1, CPU))
    assert not torch.equal(again["/embed"], got["/embed"])


def test_default_device_is_the_gpu(monkeypatch):
    """Without a device the model goes to the GPU, and raises without one:
    nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TC.get_config("granite-3-2b").reduced()
    with pytest.raises(RuntimeError, match="CUDA device"):
        M.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA device"):
        M.CausalLM(cfg)
    with pytest.raises(RuntimeError, match="CUDA device"):
        M.cache_spec(cfg, 1, 8)


def test_causal_lm_delegates_to_the_functions():
    ref_cfg, cfg = _cfgs("granite-moe-3b-a800m")
    pn = _ref_params_np(ref_cfg)
    model = M.CausalLM(cfg, pn, device=CPU)
    assert model.embed.dtype == torch.float32
    assert not any(p.requires_grad for p in model.parameters())
    batch = _batch(ref_cfg, s=8)
    tokens = torch.from_numpy(batch["tokens"])
    tp = params_from_numpy(pn, CPU)
    want, _ = M.forward(cfg, tp, tokens, compute_dtype=torch.float32)
    got, _ = model(tokens)
    assert torch.equal(got, want)
    loss, _ = model.loss(_tb(batch))
    assert torch.equal(loss, M.loss_fn(cfg, tp, _tb(batch),
                                       compute_dtype=torch.float32)[0])
    last, caches = model.prefill(tokens)
    assert torch.equal(last, M.prefill(cfg, tp, tokens,
                                       compute_dtype=torch.float32)[0])
    c = model.cache_spec(2, 16)
    step, _ = model.decode_step(tokens[:, :1], torch.tensor(0), c)
    assert torch.equal(step, M.decode_step(
        cfg, tp, tokens[:, :1], torch.tensor(0),
        M.cache_spec(cfg, 2, 16, torch.float32, CPU),
        compute_dtype=torch.float32)[0])
    half = M.CausalLM(cfg, pn, device=CPU, dtype=torch.bfloat16)
    assert half.embed.dtype == torch.bfloat16
    assert half.blocks[0].ffn.router.dtype == torch.float32
