"""repro_torch.launch.dryrun: the port's input and parameter specs equal
the reference's (``repro.launch.dryrun``, run in one subprocess on an
8-device CPU mesh) for all ten reduced architectures x every cell on a
(2, 2, 2) and a (4, 2) mesh; argument bytes and the collectives a train
step issues against hand counts; the FLOP count of a prefill against
its closed form; a failing cell recorded, not raised; the CLI's records
carry the reference's keys. A train cell's collectives (counted in a
fake process group on fake tensors) equal, by kind, count and bytes,
what one real sharded step issues on a (2, 2) mesh of gloo processes
(``tests/_torch_ranks.py``), with and without ``seq_shard``, and so
do a prefill and a decode cell's (the sharded serving step); on a mesh
whose model axis is one position a serving cell's all-gathers equal the
rule's hand count (``collective_stats``); the count leaves no process
group behind, refuses to run inside one and allocates nothing. The slow
test holds argument bytes equal to the reference's compiled
``memory_analysis``."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import REGISTRY, cells_for, get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import Mesh
from repro_torch.models import init_params
from repro_torch.models.model import tree_map
from repro_torch.train.step import TrainConfig

sys.path.insert(0, str(Path(__file__).parent))
import _torch_ranks as RANKS  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"pod2x2x2": (("pod", "data", "model"), (2, 2, 2)),
          "data4x2": (("data", "model"), (4, 2))}
TINY_TRAIN = ShapeCell("tiny_train", 32, 8, "train")

REF_SPECS = r"""
import os
os.environ["REPRO_DRYRUN_DEVICES"] = "8"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, sys
import jax
from repro.configs import REGISTRY, cells_for
from repro.launch.dryrun import _param_structs, input_specs

MESHES = json.loads(sys.argv[1])

def flat(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flat(v, f"{path}/{k}" if path else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flat(v, f"{path}/{i}" if path else str(i))
    else:
        yield path, [list(tree.shape), str(tree.dtype),
                     list(tuple(tree.sharding.spec))]

out = {}
for name, (axes, sizes) in MESHES.items():
    mesh = jax.make_mesh(tuple(sizes), tuple(axes))
    for arch, full in REGISTRY.items():
        cfg = full.reduced()
        out[f"{arch}|params|{name}"] = dict(flat(_param_structs(cfg, mesh)[0]))
        for cell in cells_for(cfg):
            out[f"{arch}|{cell.name}|{name}"] = dict(
                flat(input_specs(cfg, cell, mesh)))
print(json.dumps(out))
"""


def _ref_env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                REPRO_DRYRUN_DEVICES="8")


@pytest.fixture(scope="module")
def ref_specs():
    out = subprocess.run([sys.executable, "-c", REF_SPECS,
                          json.dumps(MESHES)], capture_output=True,
                         text=True, timeout=420, env=_ref_env())
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _flat(tree) -> dict:
    """The port's TensorSpec tree as the reference side prints it."""
    return json.loads(json.dumps({
        p: [list(t.shape), str(t.dtype).removeprefix("torch."),
            list(t.spec)] for p, t in D._leaf_items(tree)}))


@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_specs_equal_reference(arch, ref_specs):
    cfg = get_config(arch).reduced()
    for name, (axes, sizes) in MESHES.items():
        mesh = Mesh(axes, sizes)
        params, _ = D._param_structs(cfg, mesh)
        assert _flat(params) == ref_specs[f"{arch}|params|{name}"], name
        for cell in cells_for(cfg):
            assert (_flat(D.input_specs(cfg, cell, mesh))
                    == ref_specs[f"{arch}|{cell.name}|{name}"]), \
                (name, cell.name)


def _pod_mesh():
    return Mesh(*MESHES["pod2x2x2"])


def test_argument_bytes_hand_count():
    """Reduced granite (d 64, 4/2 heads of 16, d_ff 128, vocab 256, 2
    layers, tied) on (pod 2, data 2, model 2): a weight sharded over
    (pod, data) and model keeps 1/8 of its float32 bytes a device, a norm
    scale all of them; the state is params, m and v and an int32 count;
    tokens and labels (8, 32) int32 split over pod x data."""
    f32 = 4
    embed = 256 * 64 * f32 // 8
    final_norm = 64 * f32
    block = (2 * 64 * f32                     # ln1
             + 2 * 64 * 64 * f32 // 8         # wq
             + 2 * (2 * 64 * 32 * f32 // 8)   # wk, wv
             + 2 * 64 * 64 * f32 // 8         # wo
             + 2 * 64 * f32                   # ln2
             + 3 * (2 * 64 * 128 * f32 // 8))  # w_up, w_down, w_gate
    params = embed + final_norm + block
    inputs = 2 * (8 * 32 * 4 // 4)
    comp = D.lower_cell(get_config("granite-3-2b").reduced(), TINY_TRAIN,
                        _pod_mesh()).compile()
    mem = comp.memory_analysis()
    assert mem["argument_bytes"] == 3 * params + 4 + inputs
    assert mem["alias_bytes"] == 3 * params + 4
    assert mem["code_bytes"] == 0 and mem["temp_bytes"] > 0


# (arch) -> hand count of what the sharded train step issues, per device,
# on the (2, 2, 2) mesh of tiny_train. FSDP gathers over (pod, data)
# (groups of 4) at float32 (no cast_params_bf16); a leaf split on
# ``model`` and used split keeps its model shard. Each of the 2 blocks
# gathers its leaves twice (the forward and remat's recompute) and
# reduce-scatters their float32 gradients once. Activations: local batch
# 2 x 32 tokens x d_model 64 in bf16 = ACT bytes; remat's recompute stops
# after the last tensor the backward needs (torch.utils.checkpoint's
# early stop), so it does not re-issue a block's last exit. The loss: a
# vocabulary split on ``model`` takes 3 all-reduces of (2, 32) float32
# (max, sum of exponentials, target logit), its sums one of 3 float32
# over the data axes, and the optimizer's global norm one of a float32
# per leaf over the mesh.
ACT = 2 * 32 * 64 * 2
LSE = 3 * 2 * 32 * 4
HAND = {
    # embed (128, 64) gathered over data; wq, wk, wv, wo, w_up, w_gate,
    # w_down; all-reduces: the embedding's exit, each block's two exits
    # and remat's attention exit, the head's enter and each block's two
    # enters backward (12 activations), LSE, the data sum, the three norm
    # scales' gradients (5 of (64,) float32) and 11 leaves' norms
    "granite-3-2b": {
        "all-gather": (1 + 2 * 2 * 7, 4 * (128 * 64 + 2 * 2 * (
            64 * 32 + 2 * 64 * 16 + 32 * 64 + 3 * 64 * 64))),
        "reduce-scatter": (1 + 2 * 7, 4 * (128 * 16 + 2 * (
            16 * 32 + 2 * 16 * 16 + 32 * 16 + 3 * 16 * 64))),
        "all-reduce": (12 + 3 + 1 + 5 + 1,
                       12 * ACT + LSE + 12 + 5 * 64 * 4 + 11 * 4),
        "all-to-all": (0, 0)},
    # + lm_head; the router (64, 4) float32 gathered whole over data; 2 of
    # the 4 experts (EP) and the shared expert's columns; all-reduces:
    # also the aux loss's expert sums (8 float32 over data, forward and
    # recompute), and backward the gates' (2, 32, 2) float32 enter; the
    # MoE exit is a block's last; 16 leaves' norms
    "deepseek-moe-16b": {
        "all-gather": (2 + 2 * 2 * 11, 4 * (2 * 128 * 64 + 2 * 2 * (
            64 * 32 + 2 * 64 * 16 + 32 * 64 + 64 * 4 + 3 * 2 * 64 * 32
            + 3 * 64 * 16))),
        "reduce-scatter": (2 + 2 * 11, 4 * (2 * 128 * 16 + 2 * (
            16 * 32 + 2 * 16 * 16 + 32 * 16 + 16 * 4 + 3 * 2 * 16 * 32
            + 3 * 16 * 16))),
        "all-reduce": (12 + 3 + 1 + 4 + 2 + 5 + 1,
                       12 * ACT + LSE + 12 + 4 * 8 * 4 + 2 * 2 * 32 * 2 * 4
                       + 5 * 64 * 4 + 16 * 4),
        "all-to-all": (0, 0)},
    # one Mamba block (+ the reduced MLP), both split: in_proj gathered
    # over data and then whole over model (it is used in part, and its
    # gradient summed over model: a reduce-scatter each way back),
    # conv_w whole over model; the gated norm's sum of squares (2, 32, 1)
    # float32 all-reduced forward, recompute and backward; the Mamba
    # exit is needed by ln2 (recomputed), the MLP's is the block's last;
    # backward all-reduces of conv_w over data (80, 4), of conv_b (160),
    # A_log, dt_bias, D (8 each) and gate_norm (128) over the mesh;
    # 16 leaves' norms
    "mamba2-1.3b": {
        "all-gather": (2 + 2 * 7, 4 * (2 * 128 * 64 + 2 * (
            64 * 148 + 64 * 296 + 160 * 4 + 64 * 64 + 3 * 64 * 64))),
        "reduce-scatter": (2 + 7, 4 * (2 * 128 * 16 + 64 * 148 + 16 * 148
                                       + 80 * 4 + 64 * 16 + 3 * 16 * 64)),
        "all-reduce": (7 + 3 + 1 + 3 + 3 + 6 + 1,
                       7 * ACT + LSE + 12 + 3 * 2 * 32 * 4
                       + 3 * 64 * 4 + 4 * (80 * 4 + 160 + 3 * 8 + 128)
                       + 16 * 4),
        "all-to-all": (0, 0)},
}
# granite with seq_shard (act_dp the data axes): the residual stream is
# 16 of the 32 rows a model position (HALF = ACT / 2). Each split
# region's enter all-gathers ACT and its exit reduce-scatters to HALF,
# and backward the other way; the embedding's exit is a reduce-scatter,
# the head's enter an all-gather; the norm scales' gradients are summed
# over the whole mesh, and no activation is all-reduced
HALF = ACT // 2
HAND_SEQ = {
    # + per block a forward's 2 enters (and remat's), the head's enter,
    # each block's 2 exits backward and the embedding's exit backward
    "all-gather": (1 + 2 * 2 * 9 + 1 + 4 + 1,
                   HAND["granite-3-2b"]["all-gather"][1]
                   + (2 * 2 * 2 + 1 + 4 + 1) * ACT),
    # the embedding's exit, the 4 exits, the head's enter backward,
    # remat's 2 attention exits, the 4 enters backward, the weights
    "reduce-scatter": (1 + 4 + 1 + 2 + 4 + 1 + 2 * 7,
                       (1 + 4 + 1 + 2 + 4) * HALF
                       + HAND["granite-3-2b"]["reduce-scatter"][1]),
    "all-reduce": (3 + 1 + 5 + 1, LSE + 12 + 5 * 64 * 4 + 11 * 4),
    "all-to-all": (0, 0)}


def _hand_check(got, hand):
    for kind, (count, nbytes) in hand.items():
        assert (got[kind]["count"], got[kind]["bytes"]) == (count, nbytes), \
            kind
    assert got["total_bytes"] == sum(b for _, b in hand.values())
    assert got["collective-permute"] == {"count": 0, "bytes": 0}
    assert got["depth2_raw_bytes"] == 0


@pytest.mark.parametrize("arch", sorted(HAND))
def test_collectives_hand_count(arch):
    comp = D.lower_cell(get_config(arch).reduced(), TINY_TRAIN,
                        _pod_mesh()).compile()
    assert comp.collectives_basis == "issued"
    _hand_check(comp.collectives(), HAND[arch])
    assert not dist.is_initialized()


def test_collectives_hand_count_seq_shard():
    tc = TrainConfig(seq_shard=True, act_dp=("pod", "data"))
    comp = D.lower_cell(get_config("granite-3-2b").reduced(), TINY_TRAIN,
                        _pod_mesh(), tc).compile()
    _hand_check(comp.collectives(), HAND_SEQ)


def test_one_device_mesh_has_no_collectives():
    """Axes of size 1 shard nothing: on a (1, 1) mesh the step issues its
    collectives over groups of one process, which move nothing and are
    not counted."""
    comp = D.lower_cell(get_config("deepseek-moe-16b").reduced(),
                        TINY_TRAIN, Mesh(("data", "model"), (1, 1))).compile()
    got = comp.collectives()
    assert got["total_bytes"] == 0
    assert all(got[k]["count"] == 0 for k in D._COLLECTIVES)


# ---------------- the count against a real sharded step ---------------------

COUNTS = [(a, seq) for a in ("granite-3-2b", "deepseek-moe-16b",
                             "mamba2-1.3b") for seq in (False, True)]


def _count_tc(seq: bool) -> dict:
    return {"seq_shard": True, "act_dp": ("data",)} if seq else {}


@pytest.fixture(scope="module")
def issued_2x2(tmp_path_factory):
    """One real sharded step of each ``COUNTS`` case on a (2, 2) mesh of
    gloo processes (the default TrainConfig: bf16, remat), on the port's
    own weights and tiny_train's global batch, with the three primitives
    wrapped: rank 0's calls."""
    rng = np.random.default_rng(0)
    cases = []
    for arch, seq in COUNTS:
        cfg = get_config(arch).reduced()
        params = tree_map(lambda t: t.numpy(), init_params(cfg, 0, "cpu"))
        shape = (TINY_TRAIN.global_batch, TINY_TRAIN.seq_len)
        batch = {k: rng.integers(0, cfg.vocab, shape).astype(np.int32)
                 for k in ("tokens", "labels")}
        cases.append(dict(kind="count", arch=arch, params=params,
                          batches=[batch], tc=_count_tc(seq)))
    res = RANKS.run({"mesh": dict(data=2, model=2), "cases": cases}, 4,
                    tmp_path_factory.mktemp("count2x2"))
    return {c: r["calls"] for c, r in zip(COUNTS, res[0]["cases"])}


@pytest.mark.parametrize("arch,seq", COUNTS)
def test_dry_run_counts_what_the_sharded_step_issues(arch, seq, issued_2x2):
    """The dry run's fake-group count of a train cell on (2, 2) equals,
    by kind, count and bytes, what the real step issued on gloo (over
    groups of more than one process); no all-to-all."""
    want = {k: {"count": 0, "bytes": 0} for k in D._COLLECTIVES}
    for kind, n, nbytes in issued_2x2[(arch, seq)]:
        if n > 1:
            want[kind]["count"] += 1
            want[kind]["bytes"] += nbytes
    assert want["all-reduce"]["count"] > 0
    tc = TrainConfig(**_count_tc(seq))
    comp = D.lower_cell(get_config(arch).reduced(), TINY_TRAIN,
                        Mesh(("data", "model"), (2, 2)), tc).compile()
    got = comp.collectives()
    assert {k: got[k] for k in D._COLLECTIVES} == want
    assert got["all-to-all"] == {"count": 0, "bytes": 0}
    assert not dist.is_initialized()


SERVE_COUNTS = [(a, k) for a in ("granite-3-2b", "deepseek-moe-16b",
                                  "mamba2-1.3b", "qwen3-8b")
                for k in ("prefill", "decode")]
TINY = {"prefill": ShapeCell("tiny_prefill", 32, 8, "prefill"),
        "decode": ShapeCell("tiny_decode", 32, 8, "decode")}


@pytest.fixture(scope="module")
def issued_serve_2x2(tmp_path_factory):
    """One real sharded prefill (tiny_prefill's 8 x 32 prompt) and one
    decode step (tiny_decode's 8 rows at one position, caches of 32
    slots) of each architecture on a (2, 2) mesh of gloo processes, in
    bfloat16 as the dry run's default, on the port's own weights, with
    the three primitives wrapped: rank 0's calls of each."""
    rng = np.random.default_rng(1)
    archs = sorted({a for a, _ in SERVE_COUNTS})
    cases = []
    for arch in archs:
        cfg = get_config(arch).reduced()
        params = tree_map(lambda t: t.numpy(), init_params(cfg, 0, "cpu"))
        cell = TINY["prefill"]
        prompt = rng.integers(0, cfg.vocab, (cell.global_batch,
                                             cell.seq_len)).astype(np.int32)
        step = {"token": prompt[:, :1], "pos": np.int64(cell.seq_len - 1),
                "rows": None}
        cases.append(dict(kind="serve", arch=arch, params=params,
                          prompt=prompt, steps=[step],
                          s_cache=TINY["decode"].seq_len, dtype="bfloat16",
                          count=True))
    res = RANKS.run({"mesh": dict(data=2, model=2), "cases": cases}, 4,
                    tmp_path_factory.mktemp("serve2x2"))
    return {(a, k): r[k] for a, r in zip(archs, res[0]["cases"])
            for k in ("prefill", "decode")}


@pytest.mark.parametrize("arch,kind", SERVE_COUNTS)
def test_dry_run_counts_what_the_sharded_serving_step_issues(
        arch, kind, issued_serve_2x2):
    """The dry run's fake-group count of a prefill or decode cell on
    (2, 2) equals, by kind, count and bytes, what the sharded serving
    call issued on gloo (over groups of more than one process)."""
    want = {k: {"count": 0, "bytes": 0} for k in D._COLLECTIVES}
    for k, n, nbytes in issued_serve_2x2[(arch, kind)]:
        if n > 1:
            want[k]["count"] += 1
            want[k]["bytes"] += nbytes
    assert want["all-gather"]["count"] > 0
    comp = D.lower_cell(get_config(arch).reduced(), TINY[kind],
                        Mesh(("data", "model"), (2, 2))).compile()
    assert comp.collectives_basis == "issued"
    got = comp.collectives()
    assert {k: got[k] for k in D._COLLECTIVES} == want
    assert not dist.is_initialized()


@pytest.mark.parametrize("kind", sorted(TINY))
def test_serving_gathers_equal_the_rule(kind):
    """On (4, 1), with the weights in bfloat16 as a serving engine holds
    them, every collective a serving call issues over more than one
    process is an FSDP all-gather, and their bytes are the rule's: each
    data-sharded weight gathered once (a stacked leaf once a block, so
    the rule's one count of it is ``n_blocks`` of the issued ones)."""
    cfg = get_config("granite-3-2b").reduced()
    mesh = Mesh(("data", "model"), (4, 1))
    low = D.lower_cell(cfg, TINY[kind], mesh, param_dtype=torch.bfloat16)
    got = low.compile().collectives()
    rule = D.collective_stats(cfg, TINY[kind], mesh, low.params)
    assert got["all-gather"]["bytes"] == rule["all-gather"]["bytes"] > 0
    nb = D.n_blocks(cfg)
    stacked = rule["all-gather"]["count"] - 1       # all but the embedding
    assert got["all-gather"]["count"] == 1 + nb * stacked
    for k in ("all-reduce", "reduce-scatter", "all-to-all"):
        assert got[k] == rule[k] == {"count": 0, "bytes": 0}


def test_count_refuses_inside_a_process_group():
    """The count makes a fake process group of its own: inside an
    initialised one it refuses, and leaves that group as it was."""
    low = D.lower_cell(get_config("granite-3-2b").reduced(), TINY_TRAIN,
                       Mesh(("data", "model"), (1, 2)))
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        with pytest.raises(RuntimeError, match="already initialised"):
            D.issued_collectives(low)
        assert dist.get_backend() == "gloo"
    finally:
        dist.destroy_process_group()
    D.issued_collectives(low)
    assert not dist.is_initialized()


def test_count_allocates_nothing(tmp_path):
    """Granite-3-2b's train_4k cell on the single pod counted in a fresh
    process, without jax or the reference: on real tensors a device's
    step would hold 40 block inputs of 16 x 4096 x 2048 bf16 (10.7 GB)
    for its backward alone; the process stays under 2 GB."""
    code = """
import resource, sys
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_production_mesh
low = D.lower_cell(get_config("granite-3-2b"),
                   ShapeCell("train_4k", 4096, 256, "train"),
                   make_production_mesh())
got = D.issued_collectives(low)
assert got["total_bytes"] > 0 and got["all-to-all"]["count"] == 0, got
leaked = sorted(k for k in sys.modules
                if k.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not leaked, leaked
print(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert int(out.stdout.split()[-1]) * 1024 < 2e9          # KiB


def test_prefill_flops_closed_form():
    """Prefill of reduced granite (tied head, no window): every projection
    once a token (2 flops a weight), the head on the last position only,
    and q.k^T and p.v in full (no causal halving): exactly."""
    cfg = get_config("granite-3-2b").reduced()
    B, S = 4, 32
    comp = D.lower_cell(cfg, ShapeCell("tiny_prefill", S, B, "prefill"),
                        Mesh(("data", "model"), (1, 1))).compile()
    params, _ = D._param_structs(cfg, Mesh(("data", "model"), (1, 1)))
    n = {p: t for p, t in D._leaf_items(params)}
    norms = sum(t.nbytes // 4 for p, t in n.items()
                if p.endswith("scale"))
    embed = n["embed"].nbytes // 4
    total = sum(t.nbytes // 4 for t in n.values())
    per_token = total - norms - embed
    attn = 2 * 2 * B * cfg.n_heads * S * S * cfg.hd * cfg.n_layers
    want = 2 * B * S * per_token + 2 * B * embed + attn
    ca = comp.cost_analysis()
    assert ca["flops_global"] == want
    assert ca["flops"] == want                 # one device: undivided
    assert ca["bytes accessed"] > 0 and ca["transcendentals"] > 0


def test_train_flops_count_remat():
    """The train step counts the forward, remat's recomputed forward and
    the backward: between 3x and 4x the forward's matmul FLOPs."""
    cfg = get_config("granite-3-2b").reduced()
    mesh = Mesh(("data", "model"), (1, 1))
    fwd = D.lower_cell(cfg, ShapeCell("p", 32, 8, "prefill"), mesh)
    train = D.lower_cell(cfg, ShapeCell("t", 32, 8, "train"), mesh)
    f, t = fwd.compile().flops_global, train.compile().flops_global
    assert 3 * f < t < 4.5 * f


def test_decode_caches_not_counted_as_temporaries():
    """decode_step writes the donated caches in place: their bytes are
    arguments and aliases, not temporaries (counted again, the caches
    alone would pass the temporaries' peak)."""
    cfg = get_config("qwen3-8b").reduced()
    comp = D.lower_cell(cfg, ShapeCell("d", 4096, 8, "decode"),
                        Mesh(("data", "model"), (1, 1)),
                        param_dtype=torch.bfloat16).compile()
    mem = comp.memory_analysis()
    caches = sum(t.nbytes for _, t in D._leaf_items(
        comp.lowered.inputs["caches"]))
    assert mem["alias_bytes"] == caches
    assert 0 < mem["temp_bytes"] < caches


def test_failing_cell_is_recorded(tmp_path):
    rec = D.run_cell(get_config("granite-3-2b"),
                     ShapeCell("bad", 32, 8, "bogus"), False, tmp_path)
    assert rec["ok"] is False and "bogus" in rec["error"]
    saved = json.loads((tmp_path / "granite-3-2b.bad.pod16x16.json")
                       .read_text())
    assert saved == rec


REF_KEYS = {"arch", "shape", "mesh", "kind", "chips", "variant", "ok",
            "lower_s", "compile_s", "flops", "bytes_accessed",
            "transcendentals", "memory", "collectives", "wall_s"}


def test_cli_writes_reference_records(tmp_path, capsys):
    rc = D.main(["--arch", "mamba2-1.3b", "--shape", "long_500k", "--mesh",
                 "both", "--out", str(tmp_path)])
    assert rc == 0
    assert "dry-run complete: 2 ok, 0 failed" in capsys.readouterr().out
    for mesh, chips in (("pod16x16", 256), ("pod2x16x16", 512)):
        rec = json.loads((tmp_path / f"mamba2-1.3b.long_500k.{mesh}.json")
                         .read_text())
        assert REF_KEYS <= set(rec) and rec["ok"] and rec["chips"] == chips
        assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                      "temp_bytes", "alias_bytes",
                                      "code_bytes"}
        assert set(rec["collectives"]) == {
            "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
            "collective-permute", "total_bytes", "depth2_raw_bytes"}
        assert rec["temp_basis"] == D.TEMP_BASIS
        assert rec["collectives_basis"] == "issued"    # a decode cell
        assert rec["flops"] * chips == rec["flops_global"]


REF_PARITY = r"""
import os
os.environ["REPRO_DRYRUN_DEVICES"] = "8"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, sys
import jax
from repro.configs import get_config
from repro.configs.base import ShapeCell
from repro.launch.compat import normalize_cost_analysis
from repro.launch.dryrun import collective_stats, lower_cell
from repro.models import n_blocks

cfg = get_config(sys.argv[1]).reduced()
# Auto axes: the sharding propagation the reference's dry run was written
# for (explicit axes, this jax's default, refuse its embedding gather)
mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 3)
compiled = lower_cell(cfg, ShapeCell("tiny_train", 32, 8, "train"),
                      mesh).compile()
ca = normalize_cost_analysis(compiled.cost_analysis())
print(json.dumps({
    "arg_bytes": compiled.memory_analysis().argument_size_in_bytes,
    "flops": float(ca.get("flops", 0.0)),
    "collectives": collective_stats(compiled.as_text(),
                                    body_trip=n_blocks(cfg))}))
"""


@pytest.mark.slow
def test_argument_bytes_equal_reference_memory_analysis():
    """The reference's test_train_cell_lowers_on_multipod_mesh cell:
    equal argument bytes; the collective totals' ratio is printed."""
    arch = "granite-3-2b"
    out = subprocess.run([sys.executable, "-c", REF_PARITY, arch],
                         capture_output=True, text=True, timeout=600,
                         env=_ref_env())
    assert out.returncode == 0, out.stderr[-3000:]
    ref = json.loads(out.stdout.strip().splitlines()[-1])
    comp = D.lower_cell(get_config(arch).reduced(), TINY_TRAIN,
                        _pod_mesh()).compile()
    mem, coll = comp.memory_analysis(), comp.collectives()
    print(f"argument_bytes port {mem['argument_bytes']} reference "
          f"{ref['arg_bytes']}; collectives total port "
          f"{coll['total_bytes']} reference "
          f"{ref['collectives']['total_bytes']} (ratio "
          f"{coll['total_bytes'] / ref['collectives']['total_bytes']:.3f});"
          f" flops a device port {comp.cost_analysis()['flops']:.4g} "
          f"reference {ref['flops']:.4g}")
    for k in D._COLLECTIVES:
        print(f"  {k}: port {coll[k]} reference {ref['collectives'][k]}")
    assert mem["argument_bytes"] == ref["arg_bytes"]
