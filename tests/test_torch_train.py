"""repro_torch's training path against the reference's, on the CPU.

tests/test_train_ft.py's optimizer, compression and data cases run case
for case on the port; then the same inputs, made with numpy from a seed,
go through the reference's functions and the port's, on the reference's
weights (``params_from_numpy``).

Tolerances, each with its reason:
* ``batch_at`` and ``compress_decompress``: bit-identical (numpy's
  generator; IEEE division, round-half-even and max are exact).
* ``lr_schedule``: 2e-7 relative (float32 ``cos`` of XLA and of torch may
  differ in the last bit).
* ``adamw_update`` on identical gradients and state: 1e-6 relative on
  every leaf (the same float32 operations; XLA may fuse a multiply-add).
* train step (granite-3-2b reduced, fp32, batch 2 x 32, three steps):
  loss and grad_norm within 1e-5 relative, gradients within 1e-4 of their
  max |.|. Parameters after three steps: 99.9 % of elements within 1e-5,
  and every element within 2 * lr per step (AdamW's first steps move a
  parameter by about lr * g / |g|, so a gradient near 0 whose float32
  sign differs between XLA and torch moves it by up to 2 * lr); m and v
  within 1e-4 of their max |.| (2e-2 with compression, where a gradient
  may round to the neighbouring int8 level, 1/127 of its chunk's max);
  the compression residuals within one quantisation step (2 max
  |residual|).
* ``loss_fn`` gradients of all ten reduced architectures: each leaf
  within 2e-4 * max|ref leaf| + 1e-6 (summation order of fp32 matmuls).
* ``remat=True`` against ``remat=False``: bit-identical gradients (the
  same ops recomputed).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.data.pipeline import DataConfig as RDataConfig
from repro.data.pipeline import SyntheticTokenPipeline as RPipeline
from repro.models import init_params as ref_init_params
from repro.models import loss_fn as ref_loss_fn
from repro.train import compression as RCOMP
from repro.train import optimizer as ROPT
from repro.train import step as RSTEP

import repro_torch.configs as TC
from repro_torch.data.pipeline import DataConfig, SyntheticTokenPipeline
from repro_torch.models import loss_fn
from repro_torch.models.weights import params_from_numpy
from repro_torch.train.compression import (CompressionConfig,
                                           compress_decompress,
                                           init_error_state)
from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                         adamw_update, lr_schedule,
                                         tree_leaves)
from repro_torch.train.step import (TrainConfig, _rebuild, init_state,
                                   make_grad_fn, make_train_step)

CPU = torch.device("cpu")
_SLOW_ARCHS = {"jamba-v0.1-52b"}


def _arch_params(ids):
    return [pytest.param(a, marks=pytest.mark.slow) if a in _SLOW_ARCHS
            else a for a in ids]


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------- tests/test_train_ft.py, on the port --------------------

def test_adamw_reduces_quadratic():
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                      total_steps=200)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = adamw_init(params)
    for _ in range(100):
        g = {"w": 2 * params["w"]}
        params, state, _ = adamw_update(cfg, g, params, state)
    assert float(params["w"].abs().max()) < 0.5


def test_lr_schedule_shape():
    cfg = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    lrs = [float(lr_schedule(cfg, torch.tensor(s, dtype=torch.int32)))
           for s in (0, 5, 10, 50, 100)]
    assert lrs[0] < lrs[1] < lrs[2]          # warmup rises
    assert lrs[2] >= lrs[3] >= lrs[4]        # cosine decays
    assert lrs[4] >= 0.1 * cfg.lr * 0.99     # floor at 10%


def test_grad_clip_applied():
    cfg = AdamWConfig(lr=1.0, grad_clip=1e-3, weight_decay=0.0,
                      warmup_steps=0)
    params = {"w": torch.zeros(4)}
    state = adamw_init(params)
    huge = {"w": torch.full((4,), 1e6)}
    new, _, metrics = adamw_update(cfg, huge, params, state)
    assert float(metrics["grad_norm"]) > 1e5
    assert float(new["w"].abs().max()) < 10.0


def test_compression_error_feedback_unbiased():
    cfg = CompressionConfig(enabled=True, chunk=64, bits=8)
    rng = np.random.default_rng(0)
    g = {"w": torch.from_numpy(rng.standard_normal(1000).astype(np.float32))}
    err = {"w": torch.zeros(1000)}
    total_sent = torch.zeros(1000)
    for _ in range(30):
        sent, err = compress_decompress(cfg, g, err)
        total_sent = total_sent + sent["w"]
    # with error feedback, the mean transmitted gradient converges to g
    np.testing.assert_allclose(total_sent.numpy() / 30, g["w"].numpy(),
                               atol=2e-2)


def test_compression_quantisation_bounded():
    cfg = CompressionConfig(enabled=True, chunk=32, bits=8)
    g = {"w": torch.from_numpy(np.linspace(-3, 3, 256, dtype=np.float32))}
    err = {"w": torch.zeros(256)}
    sent, _ = compress_decompress(cfg, g, err)
    scale = 3.0 / 127
    assert float((sent["w"] - g["w"]).abs().max()) <= scale * 1.01


def test_data_restart_idempotent():
    cfg = DataConfig(vocab=1000, seq_len=32, global_batch=4, seed=7)
    p1 = SyntheticTokenPipeline(cfg)
    p2 = SyntheticTokenPipeline(cfg)
    for step in (0, 3, 17):
        b1, b2 = p1.batch_at(step), p2.batch_at(step)
        assert np.array_equal(b1["tokens"], b2["tokens"])
    assert not np.array_equal(p1.batch_at(0)["tokens"],
                              p1.batch_at(1)["tokens"])


def test_data_sharding_disjoint():
    cfg = DataConfig(vocab=1000, seq_len=16, global_batch=8, seed=7)
    shards = [SyntheticTokenPipeline(cfg, i, 4).batch_at(5)["tokens"]
              for i in range(4)]
    assert all(s.shape == (2, 16) for s in shards)
    flat = np.stack([s.ravel() for s in shards])
    assert len({tuple(r) for r in flat}) == 4  # shards differ


def test_data_prefetch_iterator():
    cfg = DataConfig(vocab=100, seq_len=8, global_batch=2, seed=1,
                     prefetch=2)
    p = SyntheticTokenPipeline(cfg)
    it = p.iterate(start_step=3)
    steps = [next(it)[0] for _ in range(4)]
    p.close()
    assert steps == [3, 4, 5, 6]


# ------------------------------ parity --------------------------------------

@pytest.mark.parametrize("seed,step,shard,n_shards",
                         [(0, 0, 0, 1), (7, 5, 1, 4), (3, 123, 3, 4),
                          (11, 2, 0, 2)])
def test_batch_at_bit_identical(seed, step, shard, n_shards):
    kw = dict(vocab=49155, seq_len=33, global_batch=8, seed=seed)
    want = RPipeline(RDataConfig(**kw), shard, n_shards).batch_at(step)
    got = SyntheticTokenPipeline(DataConfig(**kw), shard,
                                 n_shards).batch_at(step)
    for k in ("tokens", "labels"):
        assert got[k].dtype == want[k].dtype
        assert np.array_equal(got[k], want[k])


def test_lr_schedule_matches_reference():
    for kw in (dict(), dict(lr=1e-3, warmup_steps=10, total_steps=100),
               dict(warmup_steps=0, total_steps=7)):
        rc, tc = ROPT.AdamWConfig(**kw), AdamWConfig(**kw)
        for s in (0, 1, 5, 10, 50, 99, 100, 5000, 10_000, 20_000):
            want = float(ROPT.lr_schedule(rc, jnp.int32(s)))
            got = float(lr_schedule(tc, torch.tensor(s, dtype=torch.int32)))
            assert abs(got - want) <= 2e-7 * abs(want), (kw, s, got, want)


def _tree(rng, shapes, scale=1.0):
    return {k: (scale * rng.standard_normal(s)).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("clip", [1.0, 1e-2])
def test_adamw_update_matches_reference(clip):
    rng = np.random.default_rng(0)
    shapes = {"b": (7, 5), "a": (300,), "c": (2, 3, 4)}
    p, m = _tree(rng, shapes), _tree(rng, shapes, 0.1)
    v = {k: np.abs(a) for k, a in _tree(rng, shapes, 0.01).items()}
    g = _tree(rng, shapes)
    kw = dict(warmup_steps=3, total_steps=50, grad_clip=clip)
    rstate = {"m": jax.tree.map(jnp.asarray, m),
              "v": jax.tree.map(jnp.asarray, v), "count": jnp.int32(4)}
    rp, rs, rmet = ROPT.adamw_update(ROPT.AdamWConfig(**kw),
                                     jax.tree.map(jnp.asarray, g),
                                     jax.tree.map(jnp.asarray, p), rstate)
    tstate = {"m": {k: _t(a) for k, a in m.items()},
              "v": {k: _t(a) for k, a in v.items()},
              "count": torch.tensor(4, dtype=torch.int32)}
    tp, ts, tmet = adamw_update(AdamWConfig(**kw),
                                {k: _t(a) for k, a in g.items()},
                                {k: _t(a) for k, a in p.items()}, tstate)
    assert int(ts["count"]) == int(rs["count"]) == 5
    assert ts["count"].dtype == torch.int32
    for name in ("lr", "grad_norm"):
        want = float(rmet[name])
        assert abs(float(tmet[name]) - want) <= 1e-6 * abs(want)
    for got, want in ((tp, rp), (ts["m"], rs["m"]), (ts["v"], rs["v"])):
        for k in shapes:
            w = np.asarray(want[k])
            err = np.abs(got[k].numpy() - w)
            assert (err <= 1e-6 * np.abs(w) + 1e-12).all(), (k, err.max())


@pytest.mark.parametrize("chunk,bits", [(256, 8), (64, 8), (32, 4)])
def test_compress_decompress_bit_identical(chunk, bits):
    rng = np.random.default_rng(1)
    shapes = {"w": (37, 11), "v": (1000,), "s": (3,)}
    g, e = _tree(rng, shapes), _tree(rng, shapes, 1e-3)
    rc = RCOMP.CompressionConfig(enabled=True, chunk=chunk, bits=bits)
    tc = CompressionConfig(enabled=True, chunk=chunk, bits=bits)
    rd, re = RCOMP.compress_decompress(rc, jax.tree.map(jnp.asarray, g),
                                       jax.tree.map(jnp.asarray, e))
    td, te = compress_decompress(tc, {k: _t(a) for k, a in g.items()},
                                 {k: _t(a) for k, a in e.items()})
    for k in shapes:
        assert np.array_equal(td[k].numpy(), np.asarray(rd[k])), k
        assert np.array_equal(te[k].numpy(), np.asarray(re[k])), k
    off = CompressionConfig()
    same, err = compress_decompress(off, td, te)
    assert same is td and err is te


# ------------------------- the train step, end to end -----------------------

ARCH = "granite-3-2b"
LR = 3e-4


def _ref_params(arch):
    p = ref_init_params(RC.get_config(arch).reduced(), jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, p)


@pytest.fixture(scope="module")
def granite_params():
    return _ref_params(ARCH)


def _leaves_np(tree):
    return [np.asarray(a, np.float64) for a in jax.tree.leaves(tree)]


def _tleaves_np(tree):
    return [t.detach().double().numpy() for t in tree_leaves(tree)]


@pytest.mark.parametrize("grad_accum,compress",
                         [(1, False), (2, False), (1, True)])
def test_train_step_matches_reference(granite_params, grad_accum, compress):
    rcfg = RC.get_config(ARCH).reduced()
    tcfg = TC.get_config(ARCH).reduced()
    opt = dict(lr=LR, total_steps=10, warmup_steps=1)
    rtc = RSTEP.TrainConfig(
        opt=ROPT.AdamWConfig(**opt), compute_dtype="float32",
        grad_accum=grad_accum,
        compression=RCOMP.CompressionConfig(enabled=compress))
    ttc = TrainConfig(opt=AdamWConfig(**opt), compute_dtype="float32",
                      grad_accum=grad_accum,
                      compression=CompressionConfig(enabled=compress))
    rstate = RSTEP.init_state(rcfg, rtc,
                              jax.tree.map(jnp.asarray, granite_params))
    tstate = init_state(tcfg, ttc, params_from_numpy(granite_params, CPU))
    rstep = jax.jit(RSTEP.make_train_step(rcfg, rtc))
    tstep = make_train_step(tcfg, ttc)
    pipe = RPipeline(RDataConfig(vocab=rcfg.vocab, seq_len=32,
                                 global_batch=2, seed=0))
    for s in range(3):
        batch = pipe.batch_at(s)
        rstate, rm = rstep(rstate, batch)
        tstate, tm = tstep(tstate, batch)
        assert sorted(tm) == sorted(rm)
        for k in ("loss", "grad_norm", "lr"):
            want = float(rm[k])
            assert abs(float(tm[k]) - want) <= 1e-5 * abs(want), (s, k)
    got, want = _tleaves_np(tstate["params"]), _leaves_np(rstate["params"])
    err = np.concatenate([np.abs(g - w).ravel() for g, w in zip(got, want)])
    assert (err <= 1e-5).mean() >= 0.999, np.quantile(err, 0.999)
    assert err.max() <= 2 * LR * 3, err.max()
    # with compression a gradient may round to the neighbouring level
    # (1/127 of its chunk's max), which m and v take in
    rel = 2e-2 if compress else 1e-4
    for name in ("m", "v"):
        g = _tleaves_np(tstate["opt"][name])
        w = _leaves_np(rstate["opt"][name])
        for a, b in zip(g, w):
            assert np.abs(a - b).max() <= rel * np.abs(b).max() + 1e-9
    assert int(tstate["opt"]["count"]) == 3
    if compress:
        # a residual is within half a quantisation step of 0; a gradient
        # within float32 noise of a rounding boundary rounds the other
        # way and moves its residual by one step, about 2 max|residual|
        g, w = _tleaves_np(tstate["err"]), _leaves_np(rstate["err"])
        for a, b in zip(g, w):
            assert np.abs(a - b).max() <= 2.01 * np.abs(b).max() + 1e-12


def test_train_step_gradients_match_reference(granite_params):
    """The step's first gradients: identical updates from identical state
    make the first step's parameter change a function of them."""
    rcfg = RC.get_config(ARCH).reduced()
    tcfg = TC.get_config(ARCH).reduced()
    batch = RPipeline(RDataConfig(vocab=rcfg.vocab, seq_len=32,
                                  global_batch=2, seed=0)).batch_at(0)
    want = jax.grad(lambda p: ref_loss_fn(
        rcfg, p, {k: jnp.asarray(v) for k, v in batch.items()},
        compute_dtype=jnp.float32)[0])(
        jax.tree.map(jnp.asarray, granite_params))
    got = _grads(tcfg, params_from_numpy(granite_params, CPU),
                 {k: torch.from_numpy(v) for k, v in batch.items()})
    w = _leaves_np(want)
    g = _tleaves_np(got)
    scale = max(np.abs(a).max() for a in w)
    assert max(np.abs(a - b).max() for a, b in zip(g, w)) <= 1e-4 * scale


def test_grad_accum_two_equals_mean_of_halves(granite_params):
    """grad_accum=2 sums the halves' gradients from zeros and halves
    them: its update is the one computed from that mean."""
    tcfg = TC.get_config(ARCH).reduced()
    batch = SyntheticTokenPipeline(DataConfig(
        vocab=tcfg.vocab, seq_len=16, global_batch=4, seed=3)).batch_at(0)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    halves = [_grads(tcfg, params_from_numpy(granite_params, CPU),
                     {k: v[i * 2:(i + 1) * 2] for k, v in tb.items()})
              for i in range(2)]
    mean = [(torch.zeros_like(a) + a + b) / 2
            for a, b in zip(tree_leaves(halves[0]), tree_leaves(halves[1]))]
    tc = TrainConfig(opt=AdamWConfig(total_steps=10, warmup_steps=1),
                     compute_dtype="float32", grad_accum=2)
    state = init_state(tcfg, tc, params_from_numpy(granite_params, CPU))
    state, met = make_train_step(tcfg, tc)(state, batch)
    assert set(met) == {"loss", "lr", "grad_norm"}
    p0 = params_from_numpy(granite_params, CPU)
    ref_state = init_state(tcfg, tc, p0)
    gtree = _rebuild(p0, iter(mean))
    want, _, wmet = adamw_update(tc.opt, gtree, ref_state["params"],
                                 ref_state["opt"])
    assert float(met["grad_norm"]) == float(wmet["grad_norm"])
    for a, b in zip(tree_leaves(state["params"]), tree_leaves(want)):
        assert torch.equal(a, b)


def _grads(cfg, params, batch, remat=True, seq_shard=False):
    """loss_fn's float32 gradients, through the step's own grad_fn."""
    tc = TrainConfig(compute_dtype="float32", remat=remat,
                     seq_shard=seq_shard)
    return make_grad_fn(cfg, tc)(params, batch)[1]


def _batch(cfg, b=2, s=16, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    batch["labels"][0, :3] = -1           # masked labels
    if cfg.n_prefix:
        batch["prefix_embeds"] = (0.02 * rng.standard_normal(
            (b, cfg.n_prefix, cfg.d_model))).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch", _arch_params(RC.ARCH_IDS))
def test_loss_gradients_match_reference(arch):
    rcfg = RC.get_config(arch).reduced()
    tcfg = TC.get_config(arch).reduced()
    pn = _ref_params(arch)
    batch = _batch(rcfg)
    want = jax.grad(lambda p: ref_loss_fn(
        rcfg, p, {k: jnp.asarray(v) for k, v in batch.items()},
        compute_dtype=jnp.float32)[0])(jax.tree.map(jnp.asarray, pn))
    got = _grads(tcfg, params_from_numpy(pn, CPU),
                 {k: torch.from_numpy(v) for k, v in batch.items()})
    w, g = _leaves_np(want), _tleaves_np(got)
    assert len(w) == len(g)
    for i, (a, b) in enumerate(zip(g, w)):
        assert a.shape == b.shape
        assert np.isfinite(a).all()
        tol = 2e-4 * np.abs(b).max() + 1e-6
        assert np.abs(a - b).max() <= tol, (arch, i, np.abs(a - b).max(),
                                            tol)


@pytest.mark.parametrize("arch", ["granite-3-2b", "deepseek-moe-16b",
                                  "mamba2-1.3b"])
def test_remat_gives_the_same_gradients(arch):
    tcfg = TC.get_config(arch).reduced()
    pn = _ref_params(arch)
    batch = {k: torch.from_numpy(v) for k, v in _batch(tcfg).items()}
    on = _grads(tcfg, params_from_numpy(pn, CPU), batch, remat=True)
    off = _grads(tcfg, params_from_numpy(pn, CPU), batch, remat=False)
    for a, b in zip(tree_leaves(on), tree_leaves(off)):
        assert torch.equal(a, b)


def test_knobs_without_meaning_on_one_card_raise():
    """``unroll`` and ``act_dp`` raise without a mesh; ``seq_shard``
    without ``act_dp`` changes nothing, as in the reference: the same
    loss and gradients, bit for bit."""
    tcfg = TC.get_config(ARCH).reduced()
    from repro_torch.models.model import init_params
    p = init_params(tcfg, 0, CPU)
    batch = {k: torch.from_numpy(v) for k, v in _batch(tcfg).items()}
    for kw in (dict(unroll=2), dict(act_dp=("data",))):
        with pytest.raises(NotImplementedError):
            loss_fn(tcfg, p, batch, torch.float32, **kw)
    on = _grads(tcfg, p, batch, remat=True, seq_shard=True)
    off = _grads(tcfg, p, batch, remat=True)
    for a, b in zip(tree_leaves(on), tree_leaves(off)):
        assert torch.equal(a, b)
    assert torch.equal(loss_fn(tcfg, p, batch, torch.float32,
                               seq_shard=True)[0],
                       loss_fn(tcfg, p, batch, torch.float32)[0])
    with pytest.raises(NotImplementedError):
        make_train_step(tcfg, TrainConfig(), grad_specs={})


def test_train_step_bf16_and_cast_params_run():
    """bf16 compute (the reference's default) and cast_params_bf16: a
    finite loss, float32 state, the loss falls on a repeated batch."""
    tcfg = TC.get_config(ARCH).reduced()
    from repro_torch.models.model import init_params
    for cast in (False, True):
        tc = TrainConfig(opt=AdamWConfig(lr=1e-2, warmup_steps=1,
                                         total_steps=20),
                         cast_params_bf16=cast)
        state = init_state(tcfg, tc, init_params(tcfg, 0, CPU))
        step = make_train_step(tcfg, tc)
        batch = _batch(tcfg, s=16)
        losses = []
        for _ in range(4):
            state, met = step(state, batch)
            losses.append(float(met["loss"]))
        assert np.isfinite(losses).all() and losses[-1] < losses[0]
        assert all(t.dtype == torch.float32
                   for t in tree_leaves(state["params"]))


def test_error_state_init_matches_params():
    p = {"a": torch.ones(3, 2), "b": [torch.ones(4)]}
    e = init_error_state(p)
    assert e["a"].shape == (3, 2) and e["b"][0].shape == (4,)
    assert all(float(t.abs().sum()) == 0 for t in tree_leaves(e))
