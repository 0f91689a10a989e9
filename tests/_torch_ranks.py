"""The rank side of tests/test_torch_sharded_train.py.

``python tests/_torch_ranks.py RANK WORLD RDZV JOB OUT`` joins a gloo
process group of WORLD processes through the file ``RDZV``, lays the
mesh of the pickled ``JOB`` over it (``make_local_mesh``'s keywords:
``data``, ``model`` and maybe ``pod``), runs the job's cases
in order and saves their results to ``OUT.<RANK>.pt``. It imports torch,
numpy and repro_torch only; ``run`` starts the ranks from a test.

Cases (dicts with a ``kind``):

* ``steps``: ``n`` train steps of ``arch`` from the numpy parameter tree
  ``params`` on the global ``batches``, ``tc`` the ``TrainConfig``'s
  fields (``opt`` and ``compression`` as dicts); returns each step's
  metrics, the first step's gradients and the final state, as this
  rank's slices. With ``ckpt`` the final state is saved there (step n-1)
  in the reference's layout.
* ``compress``: ``compress_decompress`` of the numpy trees ``grads`` and
  ``err`` (shaped like ``arch``'s parameters), each rank on its slices.
* ``restore``: the slices of the checkpoint ``step`` in ``ckpt``, laid
  out by ``arch``'s parameter specs (``tc`` as in ``steps``).
* ``knobs``: ``loss_fn`` on the first batch with ``act_dp`` the data
  axes (equal to the loss without it?), with ``seq_shard=True`` alone
  (equal?) and with ``seq_shard=True`` and ``act_dp`` (its value, beside
  the loss without either), and which of ``act_dp=("model",)``,
  ``seq_shard=True`` and ``unroll=2`` raise ``NotImplementedError``.
* ``count``: one sharded step of ``arch`` (``tc`` as in ``steps``) on
  the global batch ``batches[0]``, with ``dist.collectives``' three
  primitives wrapped to record each call's kind, group size and bytes
  of its result.
* ``split``: one ``loss_fn`` on the first batch with the expert FFN, the
  SSD scan and the head wrapped to record, on this rank, the experts
  and expert hidden columns each ``_expert_ffn`` runs, the heads each
  ``ssd_chunked`` runs and the logits' last dim; and the ``Layout``'s
  flags.
* ``functions``: ``TensorParallel.vocab_lse`` (with a z-loss) and
  ``TensorParallel.sum`` in float64 on this rank's part of the whole
  ``logits``/``x``: values and gradients; and ``SequenceParallel``'s
  ``split``, ``scatter``, ``gather`` (both backwards) and
  ``gather_twice`` in float64 on a sequence of ``sx``'s length:
  outputs and input gradients.
* ``moe_seq``: a split MoE layer (float64, the experts and shared
  columns of this rank) on this rank's rows of ``x`` under sequence
  parallelism: the output, aux loss and the gradients of ``x``'s rows,
  the router and this rank's expert leaves.

* ``serve``: the sharded serving step (tests/test_torch_sharded_serve.py)
  of ``arch`` from the numpy ``params``: ``prefill`` of the global
  ``prompt`` on this rank's rows, its caches copied into the first slots
  of ``cache_spec(..., layout=)``'s slices (``s_cache`` slots), then the
  decode ``steps`` (each ``token``, ``pos``, ``rows`` global, the rank's
  part by ``shard_serve``); returns the logits of each call (this rank's
  rows, the whole vocabulary), the prefill's and the final caches (its
  slices), its cache bytes, the ``Layout``'s flags, whether a prefill
  with ``act_dp`` the data axes gave the same logits and which of
  ``act_dp=("model",)`` on prefill and on decode raised
  ``NotImplementedError``. ``dtype``: the compute and cache dtype
  (float32 by default). With ``count`` the calls run with
  ``dist.collectives``' primitives wrapped, as in ``count``, and return
  the prefill's and the first decode's calls instead. With ``act_dp``
  the calls take ``act_dp=layout.dp`` (the dry run's ``opt`` variant).
* ``live``: the peak of live bytes beyond this rank's arguments
  (``launch.dryrun._LiveBytes``, the dry run's counter, on real
  tensors) of one sharded step of ``arch`` (``tc`` as in ``steps``) on
  the global batch ``batches[0]``, and of a ``prefill`` of the global
  ``prompt`` in bfloat16 with ``act_dp=layout.dp``.

A case's ``moe`` (a dict) replaces fields of the reduced config's
``MoECfg``; a ``window`` sets the config's sliding window.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]


def run(job: dict, world: int, work: Path, timeout: float = 300) -> list:
    """Start ``world`` ranks on ``job`` and return each rank's results
    (rank order); raises with the ranks' output if one fails."""
    work.mkdir(parents=True, exist_ok=True)
    jobf, rdzv = work / "job.pkl", work / "rdzv"
    jobf.write_bytes(pickle.dumps(job))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")]
                               if p]), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(world), str(rdzv), str(jobf),
         str(work / "out")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, env=env, text=True)
        for r in range(world)]
    deadline, logs = time.monotonic() + timeout, []
    try:
        for p in procs:
            left = max(deadline - time.monotonic(), 1)
            logs.append(p.communicate(timeout=left)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        raise RuntimeError("\n".join(
            f"--- rank {r} rc {p.returncode}\n{log[-4000:]}"
            for r, (p, log) in enumerate(zip(procs, logs))))
    return [torch.load(work / f"out.{r}.pt", weights_only=False)
            for r in range(world)]


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np(v) for v in tree]
    return tree.detach().cpu().numpy() if torch.is_tensor(tree) else tree


def _train_config(tc: dict):
    from repro_torch.train.compression import CompressionConfig
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import TrainConfig
    tc = dict(tc)
    tc["opt"] = AdamWConfig(**tc.get("opt", {}))
    tc["compression"] = CompressionConfig(**tc.get("compression", {}))
    return TrainConfig(**tc)


def _state_specs(pspecs, compression: bool) -> dict:
    specs = {"params": pspecs, "opt": {"m": pspecs, "v": pspecs,
                                       "count": ()}}
    if compression:
        specs["err"] = pspecs
    return specs


def _case(case: dict, mesh) -> dict:
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.dist.collectives import Layout
    from repro_torch.dist.sharding import (map_specs, param_specs,
                                           shard_batch, shard_leaf)
    from repro_torch.models.weights import params_from_numpy
    from repro_torch.train.compression import compress_decompress
    from repro_torch.train.step import (init_state, make_grad_fn,
                                        make_train_step)
    if case["kind"] == "functions":
        return _functions(case, mesh)
    if case["kind"] == "moe_seq":
        return _moe_seq(case, mesh)
    cfg = _reduced_config(case)
    cpu, coords = torch.device("cpu"), mesh.coords
    # a copy: the step updates the state in place
    shard = lambda sp, a: np.array(shard_leaf(a, sp, mesh, coords))  # noqa: E731
    if case["kind"] == "compress":
        pspecs = param_specs(cfg, mesh, case["grads"])
        layout = Layout(cfg, mesh, pspecs)
        g = params_from_numpy(map_specs(shard, pspecs, case["grads"]), cpu)
        e = params_from_numpy(map_specs(shard, pspecs, case["err"]), cpu)
        cc = _train_config({"compression": case["compression"]}).compression
        deq, err = compress_decompress(cc, g, e, layout)
        return {"deq": _np(deq), "err": _np(err)}
    if case["kind"] == "knobs":
        return _knobs(case, cfg, mesh, shard)
    if case["kind"] == "split":
        return _split(case, cfg, mesh, shard)
    if case["kind"] == "count":
        return _count(case, cfg, mesh, shard)
    if case["kind"] == "serve":
        return _serve(case, cfg, mesh, shard)
    if case["kind"] == "live":
        return _live(case, cfg, mesh, shard)
    tc = _train_config(case["tc"])
    pspecs = param_specs(cfg, mesh, case["params"])
    if case["kind"] == "restore":
        like = init_state(cfg, tc, params_from_numpy(
            map_specs(shard, pspecs, case["params"]), cpu))
        mgr = CheckpointManager(case["ckpt"], mesh=mesh)
        got = mgr.restore(case["step"], like, specs=_state_specs(
            pspecs, tc.compression.enabled))
        return {"state": _np(got), "latest": mgr.latest_step()}
    params = params_from_numpy(map_specs(shard, pspecs, case["params"]), cpu)
    state = init_state(cfg, tc, params)
    layout = Layout(cfg, mesh, pspecs)
    first = shard_batch(case["batches"][0], cfg, mesh, coords)
    (_, _), grads = make_grad_fn(cfg, tc, layout)(
        params, {k: torch.from_numpy(v) for k, v in first.items()})
    step = make_train_step(cfg, tc, grad_specs=pspecs, mesh=mesh)
    metrics = []
    for b in case["batches"]:
        state, met = step(state, shard_batch(b, cfg, mesh, coords))
        metrics.append({k: float(v) for k, v in met.items()})
    if case.get("ckpt"):
        CheckpointManager(case["ckpt"], mesh=mesh).save(
            len(case["batches"]) - 1, state, blocking=True,
            specs=_state_specs(pspecs, tc.compression.enabled))
    return {"metrics": metrics, "grads": _np(grads), "state": _np(state)}


def _reduced_config(case: dict):
    """``case``'s architecture reduced, with its ``moe`` fields."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(case["arch"]).reduced()
    if case.get("moe"):
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, **case["moe"]))
    if case.get("window"):
        cfg = dataclasses.replace(cfg, window=case["window"])
    return cfg


def _split(case, cfg, mesh, shard) -> dict:
    from repro_torch.dist.collectives import Layout
    from repro_torch.dist.sharding import map_specs, param_specs, \
        shard_batch
    from repro_torch.models import loss_fn
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE
    from repro_torch.models import ssm as SSM
    from repro_torch.models.weights import params_from_numpy
    pspecs = param_specs(cfg, mesh, case["params"])
    layout = Layout(cfg, mesh, pspecs)
    params = params_from_numpy(map_specs(shard, pspecs, case["params"]),
                               torch.device("cpu"))
    batch = {k: torch.from_numpy(v) for k, v in shard_batch(
        case["batches"][0], cfg, mesh, mesh.coords).items()}
    seen = {"experts": [], "columns": [], "heads": [], "vocab": []}
    ffn, ssd, head = MOE._expert_ffn, SSM.ssd_chunked, M._logits

    def ffn_rec(cfg_, p, h):
        seen["experts"].append(h.shape[-3])
        seen["columns"].append(p["w_up"].shape[-1])
        return ffn(cfg_, p, h)

    def ssd_rec(xdt, *a, **kw):
        seen["heads"].append(xdt.shape[2])
        return ssd(xdt, *a, **kw)

    def head_rec(*a, **kw):
        out = head(*a, **kw)
        seen["vocab"].append(out.shape[-1])
        return out

    MOE._expert_ffn, SSM.ssd_chunked, M._logits = ffn_rec, ssd_rec, head_rec
    try:
        loss = loss_fn(cfg, params, batch, torch.float32,
                       layout=layout)[0]
    finally:
        MOE._expert_ffn, SSM.ssd_chunked, M._logits = ffn, ssd, head
    return {**seen, "loss": float(loss), "moe_tp": layout.moe_tp,
            "ssm_tp": layout.ssm_tp, "attn_tp": layout.attn_tp,
            "vocab_tp": layout.vocab_tp}


def _functions(case, mesh) -> dict:
    from repro_torch.dist.collectives import TensorParallel
    tp = TensorParallel(mesh)
    n = case["logits"].shape[-1] // tp.size
    logits = torch.from_numpy(case["logits"][..., tp.rank * n:
                                             (tp.rank + 1) * n].copy())
    logits.requires_grad_(True)
    labels = torch.from_numpy(case["labels"])
    mask = (labels >= 0) & (labels < case["vocab"])
    lse, ll = tp.vocab_lse(logits, torch.where(mask, labels, 0))
    denom = mask.sum()
    loss = ((lse - ll) * mask).sum() / denom \
        + 1e-4 * ((lse * mask) ** 2).sum() / denom
    g_logits, = torch.autograd.grad(loss, [logits])
    x = torch.from_numpy(case["x"][tp.rank].copy()).requires_grad_(True)
    y = tp.sum(x)
    w = torch.from_numpy(case["w"][tp.rank])
    g_x, = torch.autograd.grad((y * w).sum(), [x])
    return {"lse": lse.detach().numpy(), "ll": ll.detach().numpy(),
            "loss": float(loss), "g_logits": g_logits.numpy(),
            "y": y.detach().numpy(), "g_x": g_x.numpy(),
            **_seq_pairs(case, mesh)}


def _seq_pairs(case, mesh) -> dict:
    """Each ``SequenceParallel`` pair on this rank: ``sw[r]`` weighs its
    rows, ``su`` (the same on every rank) and ``sv[r]`` the whole
    sequence."""
    from repro_torch.dist.collectives import SequenceParallel
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    seq = SequenceParallel(mesh, case["sx"].shape[1])
    r, rows = seq.rank, seq.rows
    pad = rows * seq.size - seq.length
    own = np.pad(case["sx"], ((0, 0), (0, pad), (0, 0)))[
        :, r * rows:(r + 1) * rows]
    w, u, v = t(case["sw"][r]), t(case["su"]), t(case["sv"][r])
    out = {}

    def run(name, x, f, loss):
        x = t(x).requires_grad_(True)
        y = f(x)
        g, = torch.autograd.grad(loss(y), [x])
        out[name] = ([a.detach().numpy() for a in y]
                     if isinstance(y, tuple) else y.detach().numpy(),
                     g.numpy())

    run("split", case["sx"], seq.split, lambda y: (y * w).sum())
    run("scatter", case["sxp"][r], seq.scatter, lambda y: (y * w).sum())
    run("gather", own, seq.gather, lambda y: (y * u).sum())
    run("gather_summed", own, lambda x: seq.gather(x, summed=True),
        lambda y: (y * v).sum())
    run("gather_twice", own, seq.gather_twice,
        lambda y: (y[0] * u).sum() + (y[1] * v).sum())
    return {"seq": out}


def _moe_seq(case, mesh) -> dict:
    from repro_torch.dist.collectives import (SequenceParallel,
                                              TensorParallel)
    from repro_torch.models.moe import apply_moe
    cfg = _reduced_config(case)
    p = {k: torch.from_numpy(v) for k, v in case["p"].items()}
    tp = TensorParallel(mesh)
    seq = SequenceParallel(mesh, case["x"].shape[1])
    r, n = tp.rank, tp.size
    ne, fs = p["w_up"].shape[0] // n, p["sh_up"].shape[-1] // n
    local = dict(p)
    for k in ("w_up", "w_gate", "w_down"):
        local[k] = p[k][r * ne:(r + 1) * ne]
    for k in ("sh_up", "sh_gate"):
        local[k] = p[k][:, r * fs:(r + 1) * fs]
    local["sh_down"] = p["sh_down"][r * fs:(r + 1) * fs]
    local = {k: v.clone().requires_grad_(True) for k, v in local.items()}
    pad = seq.rows * n - seq.length
    x = torch.from_numpy(np.pad(case["x"], ((0, 0), (0, pad), (0, 0)))[
        :, r * seq.rows:(r + 1) * seq.rows].copy()).requires_grad_(True)
    y, aux = apply_moe(cfg, local, x, tp=tp.over(seq))
    loss = (y * torch.from_numpy(case["w"][r])).sum() + case["c"] * aux
    names = ("router", "w_up", "w_gate", "w_down")
    g = torch.autograd.grad(loss, [x] + [local[k] for k in names])
    return {"y": y.detach().numpy(), "aux": float(aux),
            "g_x": g[0].numpy(),
            **{f"g_{k}": a.numpy() for k, a in zip(names, g[1:])}}


def _serve(case, cfg, mesh, shard) -> dict:
    from repro_torch.dist.collectives import Layout
    from repro_torch.dist.sharding import map_specs, param_specs, \
        shard_serve
    from repro_torch.models import (cache_spec, decode_step, fill_caches,
                                    prefill)
    from repro_torch.models.weights import params_from_numpy
    cpu = torch.device("cpu")
    # the compute and cache dtype
    f32 = getattr(torch, case.get("dtype", "float32"))
    pspecs = param_specs(cfg, mesh, case["params"])
    layout = Layout(cfg, mesh, pspecs)
    params = params_from_numpy(map_specs(shard, pspecs, case["params"]),
                               cpu)
    t = lambda a: None if a is None else torch.as_tensor(a)  # noqa: E731
    mine = lambda ins: {k: t(v) for k, v in shard_serve(  # noqa: E731
        ins, cfg, mesh, mesh.coords).items()}
    tokens = mine({"tokens": case["prompt"]})["tokens"]
    act_dp = layout.dp if case.get("act_dp") else None
    B = case["prompt"].shape[0]
    out = {"layout": {"attn_tp": layout.attn_tp, "ssm_tp": layout.ssm_tp,
                      "moe_tp": layout.moe_tp, "vocab_tp": layout.vocab_tp,
                      "conv_part": layout.conv_part}}
    calls = []
    with torch.no_grad(), _wrapped(calls if case.get("count") else None):
        logits, pre = prefill(cfg, params, tokens, None, f32,
                              act_dp=act_dp, layout=layout)
        n_pre = len(calls)
        caches = cache_spec(cfg, B, case["s_cache"], f32, cpu,
                            layout=layout)
        fill_caches(caches, pre)
        steps = []
        for st in case["steps"]:
            ins = mine(st)
            lg, _ = decode_step(cfg, params, ins["token"], ins["pos"],
                                caches, f32, rows=ins["rows"],
                                act_dp=act_dp, layout=layout)
            steps.append(lg.float().numpy())
            if case.get("count"):
                return {"prefill": calls[:n_pre], "decode": calls[n_pre:]}
        same = prefill(cfg, params, tokens, None, f32, act_dp=layout.dp,
                       layout=layout)[0]
        raised = []
        for name, call in (
                ("prefill", lambda: prefill(cfg, params, tokens, None, f32,
                                            act_dp=("model",),
                                            layout=layout)),
                ("decode", lambda: decode_step(
                    cfg, params, tokens[:, :1], 0, caches, f32,
                    act_dp=("model",), layout=layout))):
            try:
                call()
            except NotImplementedError:
                raised.append(name)
    return {**out, "prefill": logits.numpy(), "prefill_caches": _np(pre),
            "steps": steps, "caches": _np(caches),
            "cache_bytes": sum(x.numel() * x.element_size()
                               for c in caches for x in c.values()),
            "act_dp_equal": bool(torch.equal(same, logits)),
            "raised": raised}


class _wrapped:
    """While open, ``dist.collectives``' three primitives append each
    call's ``(kind, group size, bytes of the result)`` to ``calls``
    (nothing is wrapped where ``calls`` is None)."""

    PRIMS = {"all-gather": "_all_gather", "reduce-scatter":
             "_reduce_scatter", "all-reduce": "_all_reduce"}

    def __init__(self, calls):
        self.calls = calls

    def __enter__(self):
        import repro_torch.dist.collectives as C
        import torch.distributed as dist
        if self.calls is None:
            return self
        self.saved = {k: getattr(C, n) for k, n in self.PRIMS.items()}

        def wrap(kind, fn):
            def call(x, *a, **kw):
                out = fn(x, *a, **kw)
                group = a[1] if kind != "all-reduce" else a[0]
                self.calls.append((kind, dist.get_world_size(group),
                                   out.numel() * out.element_size()))
                return out
            return call

        for kind, name in self.PRIMS.items():
            setattr(C, name, wrap(kind, self.saved[kind]))
        return self

    def __exit__(self, *exc):
        import repro_torch.dist.collectives as C
        if self.calls is not None:
            for kind, name in self.PRIMS.items():
                setattr(C, name, self.saved[kind])
        return False


def _count(case, cfg, mesh, shard) -> dict:
    """One sharded step with the three primitives wrapped: the calls'
    ``(kind, group size, bytes)``."""
    from repro_torch.dist.sharding import map_specs, param_specs, \
        shard_batch
    from repro_torch.models.weights import params_from_numpy
    from repro_torch.train.step import init_state, make_train_step
    tc = _train_config(case["tc"])
    pspecs = param_specs(cfg, mesh, case["params"])
    params = params_from_numpy(map_specs(shard, pspecs, case["params"]),
                               torch.device("cpu"))
    step = make_train_step(cfg, tc, grad_specs=pspecs, mesh=mesh)
    calls = []
    with _wrapped(calls):
        step(init_state(cfg, tc, params),
             shard_batch(case["batches"][0], cfg, mesh, mesh.coords))
    return {"calls": calls}


def _live(case, cfg, mesh, shard) -> dict:
    """The dry run's live-bytes counter over one real sharded step and
    one prefill (``act_dp`` the data axes): each call's peak beyond the
    rank's arguments (the state, parameters and inputs, made before)."""
    from repro_torch.dist.collectives import Layout
    from repro_torch.dist.sharding import map_specs, param_specs, \
        shard_batch, shard_serve
    from repro_torch.launch.dryrun import _LiveBytes, _tensors
    from repro_torch.models import prefill
    from repro_torch.models.weights import params_from_numpy
    from repro_torch.train.step import init_state, make_train_step
    cpu = torch.device("cpu")
    tc = _train_config(case["tc"])
    pspecs = param_specs(cfg, mesh, case["params"])
    tensors = lambda d: {k: torch.from_numpy(np.ascontiguousarray(v))  # noqa: E731
                         for k, v in d.items()}
    state = init_state(cfg, tc, params_from_numpy(
        map_specs(shard, pspecs, case["params"]), cpu))
    batch = tensors(shard_batch(case["batches"][0], cfg, mesh, mesh.coords))
    step = make_train_step(cfg, tc, grad_specs=pspecs, mesh=mesh)
    with _LiveBytes(_tensors((state, batch))) as train:
        step(state, batch)
    params = params_from_numpy(map_specs(shard, pspecs, case["params"]), cpu)
    layout = Layout(cfg, mesh, pspecs)
    tokens = tensors(shard_serve({"tokens": case["prompt"]}, cfg, mesh,
                                 mesh.coords))["tokens"]
    with torch.no_grad(), _LiveBytes(_tensors((params, tokens))) as pre:
        prefill(cfg, params, tokens, None, torch.bfloat16,
                act_dp=layout.dp, layout=layout)
    return {"train": train.peak, "prefill": pre.peak}


def _knobs(case, cfg, mesh, shard) -> dict:
    from repro_torch.dist.collectives import Layout
    from repro_torch.dist.sharding import map_specs, param_specs, \
        shard_batch
    from repro_torch.models import loss_fn
    from repro_torch.models.weights import params_from_numpy
    pspecs = param_specs(cfg, mesh, case["params"])
    layout = Layout(cfg, mesh, pspecs)
    params = params_from_numpy(map_specs(shard, pspecs, case["params"]),
                               torch.device("cpu"))
    batch = {k: torch.from_numpy(v) for k, v in shard_batch(
        case["batches"][0], cfg, mesh, mesh.coords).items()}
    loss = lambda **kw: loss_fn(cfg, params, batch,  # noqa: E731
                                torch.float32, layout=layout, **kw)[0]
    raised = []
    for name, kw in (("act_dp_model", dict(act_dp=("model",))),
                     ("seq_shard", dict(seq_shard=True)),
                     ("unroll", dict(unroll=2))):
        try:
            loss(**kw)
        except NotImplementedError:
            raised.append(name)
    return {"act_dp_equal": bool(loss(act_dp=layout.dp) == loss()),
            "seq_shard_equal": bool(loss(seq_shard=True) == loss()),
            "seq_shard_act_dp": float(loss(seq_shard=True,
                                           act_dp=layout.dp)),
            "loss": float(loss()), "raised": raised}


def main(rank: int, world: int, rdzv: str, jobf: str, out: str) -> None:
    torch.set_num_threads(1)
    job = pickle.loads(Path(jobf).read_bytes())
    dist.init_process_group("gloo", init_method=f"file://{rdzv}",
                            rank=rank, world_size=world)
    try:
        from repro_torch.launch.mesh import make_local_mesh
        mesh = make_local_mesh(**job["mesh"], device="cpu")
        results = {"coords": mesh.coords, "cases": [
            _case(c, mesh) for c in job["cases"]]}
        torch.save(results, f"{out}.{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
         sys.argv[5])
