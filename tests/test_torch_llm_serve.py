"""repro_torch's token serving (``ModelExecutor``, ``ServingEngine``) on the
CPU, against the reference's.

The engine cases of tests/test_serve.py (serving every request, greedy
determinism, the mid-flight join with bit-identical slot caches, the empty
prompt and the slot leak) and of tests/test_faults.py (a failed prefill
closes its request and frees its slot; the run guards), case for case on
``device="cpu"``. Parity: the reference's weights (``params_from_numpy``)
and the same ragged requests through the reference's ``ServingEngine`` and
the port's give the same greedy tokens, and the same caches after the run
within ``2e-4 * max|ref| + 1e-5``; one executor step with a partial live
mask commits the same caches.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.models import init_params as ref_init_params
from repro.serve import ModelExecutor as RefExecutor
from repro.serve import Request as RefRequest
from repro.serve import ServeConfig as RefServeConfig
from repro.serve import ServingEngine as RefEngine

import repro_torch.configs as TC
from repro_torch.models.weights import caches_to_numpy, params_from_numpy
from repro_torch.serve import (ModelExecutor, Request, ServeConfig,
                               ServingEngine)

CPU = "cpu"


def _close(got, want, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    tol = 2e-4 * np.abs(want).max() + 1e-5
    assert np.abs(got - want).max() <= tol, what


def _engine(sc, arch="granite-3-2b"):
    return ServingEngine(TC.get_config(arch).reduced(), sc, device=CPU)


def test_engine_serves_all_requests():
    eng = _engine(ServeConfig(max_batch=2, max_seq=64, max_new_tokens=6))
    reqs = [Request(i, np.arange(4) + i) for i in range(5)]
    out = eng.run(reqs)
    assert out["requests"] == 5
    assert all(r.done for r in reqs)
    assert all(len(r.out_tokens) == 6 for r in reqs)
    assert len(out["latency_per_request_s"]) == 5
    assert out["latency_p50_s"] > 0
    assert out["latency_p99_s"] >= out["latency_p50_s"]
    assert out["tokens"] == 30 and out["decode_steps"] > 0
    assert eng.executor.caches[0]["k"].device.type == "cpu"


def test_engine_greedy_deterministic():
    outs = []
    for _ in range(2):
        eng = _engine(ServeConfig(max_batch=1, max_seq=64,
                                  max_new_tokens=5))
        req = Request(0, np.array([1, 2, 3]))
        eng.run([req])
        outs.append(tuple(req.out_tokens))
    assert outs[0] == outs[1]


def test_mid_flight_join_matches_solo():
    """A request that joins mid-flight produces the same token stream,
    and the same cache content at its slot bit for bit, as when it runs
    alone."""
    sc = ServeConfig(max_batch=2, max_seq=64, max_new_tokens=6)

    def solo(prompt):
        eng = _engine(sc)
        r = Request(0, np.asarray(prompt))
        eng.run([r])
        return tuple(r.out_tokens), eng, r._slot

    a_tokens, a_eng, a_slot = solo([1, 2, 3])
    b_tokens, b_eng, b_slot = solo([7, 8, 9, 10, 11])

    eng = _engine(sc)
    ra = Request(0, np.array([1, 2, 3]))
    rb = Request(1, np.array([7, 8, 9, 10, 11]))
    assert eng.submit(ra)
    eng.step()
    eng.step()
    assert eng.submit(rb)   # joins mid-flight, 2 tokens behind
    steps = 0
    while eng.active or eng.queue:
        eng.step()
        steps += 1
        assert steps < 100
    assert tuple(ra.out_tokens) == a_tokens
    assert tuple(rb.out_tokens) == b_tokens
    for solo_eng, solo_slot, req in ((a_eng, a_slot, ra), (b_eng, b_slot, rb)):
        for c_solo, c_stag in zip(solo_eng.executor.caches,
                                  eng.executor.caches):
            for k in c_solo:
                assert torch.equal(c_solo[k][:, solo_slot],
                                   c_stag[k][:, req._slot]), k


def test_empty_prompt_and_slot_leak():
    eng = _engine(ServeConfig(max_batch=2, max_seq=32, max_new_tokens=2))
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit(Request(0, np.array([], np.int32)))
    assert len(eng.free) == 2 and not eng.active
    orig = eng.executor.decode

    def boom(*a, **k):
        raise RuntimeError("prefill boom")

    eng.executor.decode = boom
    with pytest.raises(RuntimeError, match="prefill boom"):
        eng.submit(Request(1, np.array([1, 2])))
    assert len(eng.free) == 2 and not eng.active
    eng.executor.decode = orig
    req = Request(2, np.array([1, 2, 3]))
    out = eng.run([req])
    assert req.done and out["requests"] == 1


def test_prefill_failure_marks_request_and_frees_slot():
    eng = _engine(ServeConfig(max_batch=2, max_seq=64, max_new_tokens=4))
    orig = eng.executor.decode

    def boom(*a, **kw):
        raise RuntimeError("injected prefill failure")

    eng.executor.decode = boom
    req = Request(0, np.array([1, 2, 3]))
    with pytest.raises(RuntimeError, match="injected prefill"):
        eng.submit(req)
    assert req.failed and "injected prefill" in req.error
    assert req.t_done is not None and not eng.active
    assert sorted(eng.free) == [0, 1]
    eng.executor.decode = orig
    ok = Request(1, np.array([1, 2, 3]))
    assert eng.submit(ok)
    eng.run([])
    assert ok.done and not ok.failed


def test_serving_run_guards_configurable():
    eng = _engine(ServeConfig(max_batch=1, max_seq=64, max_new_tokens=8,
                              max_steps=2))
    with pytest.raises(RuntimeError, match="did not terminate within "
                                           "2 steps"):
        eng.run([Request(0, np.array([1, 2, 3]))])
    eng2 = _engine(ServeConfig(max_batch=1, max_seq=64, max_new_tokens=8,
                               max_wall_s=0.0))
    with pytest.raises(RuntimeError, match="did not terminate within"):
        eng2.run([Request(0, np.array([1, 2, 3]))])


def test_engine_without_a_device_needs_a_gpu(monkeypatch):
    """With no ``device`` the engine runs on the GPU: without one it
    raises, and nothing runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TC.get_config("granite-3-2b").reduced()
    with pytest.raises(RuntimeError, match="CUDA device"):
        ServingEngine(cfg, ServeConfig(max_batch=1, max_seq=16))
    with pytest.raises(RuntimeError, match="CUDA device"):
        ModelExecutor(cfg, 1, 16)


def test_bf16_engine_holds_cast_weights():
    eng = _engine(ServeConfig(max_batch=2, max_seq=32, max_new_tokens=3,
                              compute_dtype="bfloat16"))
    p = eng.params
    assert p["embed"].dtype == torch.bfloat16
    assert p["blocks"][0]["attn"]["wq"].dtype == torch.bfloat16
    assert p["blocks"][0]["ln1"]["scale"].dtype == torch.float32
    assert eng.executor.caches[0]["k"].dtype == torch.bfloat16
    reqs = [Request(i, np.array([1 + i, 2, 3])) for i in range(3)]
    assert eng.run(reqs)["tokens"] == 9


# --------------------------- parity with repro ----------------------------

def _ref_weights(arch, **moe):
    ref_cfg = RC.get_config(arch).reduced()
    if moe:
        ref_cfg = dataclasses.replace(
            ref_cfg, moe=dataclasses.replace(ref_cfg.moe, **moe))
    port_cfg = TC.get_config(arch).reduced()
    if moe:
        port_cfg = dataclasses.replace(
            port_cfg, moe=dataclasses.replace(port_cfg.moe, **moe))
    pn = jax.tree.map(np.asarray, ref_init_params(ref_cfg,
                                                  jax.random.PRNGKey(0)))
    return ref_cfg, port_cfg, pn


# ragged prompts; with 2 slots, requests 2 and 3 join mid-flight
PROMPTS = [[5, 1, 9], [3, 3, 4, 8, 2], [7, 6], [11, 12, 13, 14]]


@pytest.mark.parametrize("arch,moe", [
    ("granite-3-2b", {}), ("qwen3-8b", {}), ("mamba2-1.3b", {}),
    ("deepseek-moe-16b", {"impl": "sorted"}),
    ("granite-moe-3b-a800m", {"impl": "onehot"}),
    ("phi-3-vision-4.2b", {})])
def test_serving_matches_reference(arch, moe):
    ref_cfg, cfg, pn = _ref_weights(arch, **moe)
    kw = dict(max_batch=2, max_seq=32, max_new_tokens=5)
    ref = RefEngine(ref_cfg, RefServeConfig(**kw),
                    params=jax.tree.map(jax.numpy.asarray, pn))
    port = ServingEngine(cfg, ServeConfig(**kw),
                         params=params_from_numpy(pn, CPU), device=CPU)
    ref_reqs = [RefRequest(i, np.array(p)) for i, p in enumerate(PROMPTS)]
    reqs = [Request(i, np.array(p)) for i, p in enumerate(PROMPTS)]
    ref_out = ref.run(ref_reqs)
    out = port.run(reqs)
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in ref_reqs]
    assert [r._slot for r in reqs] == [r._slot for r in ref_reqs]
    assert out["decode_steps"] == ref_out["decode_steps"]
    assert out["tokens"] == ref_out["tokens"] == 4 * 5
    np.testing.assert_array_equal(port.positions, ref.positions)
    want = jax.tree.map(np.asarray, ref.executor.caches)
    for i, (g, w) in enumerate(zip(caches_to_numpy(port.executor.caches),
                                   want)):
        for k in w:
            _close(g[k], w[k], f"cache {i}.{k}")


@pytest.mark.parametrize("arch", ["qwen3-8b", "mamba2-1.3b"])
def test_executor_live_commit_matches_reference(arch):
    """One executor step at per-slot positions with one row not live: the
    live rows' logits and every cache leaf equal the reference's (its
    ``where`` commit, the port's in-place writes)."""
    ref_cfg, cfg, pn = _ref_weights(arch)
    ref = RefExecutor(ref_cfg, 3, 16, params=jax.tree.map(jax.numpy.asarray,
                                                          pn))
    port = ModelExecutor(cfg, 3, 16, params=params_from_numpy(pn, CPU),
                         device=CPU)
    rng = np.random.default_rng(0)
    for t in range(5):
        tok = rng.integers(0, cfg.vocab, (3, 1)).astype(np.int32)
        pos = np.array([t, t + 4, 2 * t], np.int32)
        live = np.array([True, t % 2 == 0, True])
        lr = ref.decode(tok, pos, live)
        lt = port.decode(tok, pos, live)
        assert lt.dtype == np.float32 and lt.shape == lr.shape
        _close(lt[live], lr[live], f"logits t={t}")
        want = jax.tree.map(np.asarray, ref.caches)
        for g, w in zip(caches_to_numpy(port.caches), want):
            for k in w:
                _close(g[k], w[k], f"{k} t={t}")
    port.reset()
    assert all(float(t.abs().max()) == 0 for c in port.caches
               for t in c.values())


def test_serving_in_a_fresh_process_never_loads_jax():
    """The token-serving path imports neither jax nor the reference."""
    import subprocess
    import sys
    from pathlib import Path
    code = """
import sys
import numpy as np
from repro_torch.configs import get_config
from repro_torch.serve import Request, ServeConfig, ServingEngine
cfg = get_config("jamba-v0.1-52b").reduced()
eng = ServingEngine(cfg, ServeConfig(max_batch=2, max_seq=16,
                                     max_new_tokens=2), device="cpu")
reqs = [Request(i, np.array([1, 2 + i])) for i in range(3)]
assert eng.run(reqs)["tokens"] == 6
leaked = sorted(k for k in sys.modules
                if k.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not leaked, leaked
print("ok")
"""
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={"PYTHONPATH": str(root / "src"),
                              "PATH": "/usr/bin:/bin",
                              "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")
