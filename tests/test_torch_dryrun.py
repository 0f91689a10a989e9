"""repro_torch.launch.dryrun: the port's input and parameter specs equal
the reference's (``repro.launch.dryrun``, run in one subprocess on an
8-device CPU mesh) for all ten reduced architectures x every cell on a
(2, 2, 2) and a (4, 2) mesh; argument bytes and the collective schedule
against hand counts; the FLOP count of a prefill against its closed
form; a failing cell recorded, not raised; the CLI's records carry the
reference's keys. The slow test holds argument bytes equal to the
reference's compiled ``memory_analysis``."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import REGISTRY, cells_for, get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import Mesh

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


# (arch) -> hand count on the (2, 2, 2) mesh of tiny_train (local batch 2
# x 32 tokens x d_model 64 in bf16 = 8192 bytes of activations; remat:
# the forward's gathers and all-reduces twice, then the backward's)
ACT = 2 * 32 * 64 * 2
HAND = {
    # AG of embed, wq, wk, wv, wo, w_up, w_down, w_gate in bf16 over the
    # model shards, twice; RS of their fp32 grads' 1/8 shards; AR of the
    # three norm scales' grads, and the attention and MLP all-reduces
    "granite-3-2b": {
        "all-gather": (16, 2 * (256 * 64 + 2 * (2 * 64 * 64)
                                + 2 * (2 * 64 * 32) + 3 * (2 * 64 * 128))),
        "reduce-scatter": (8, 4 * (256 * 64 + 2 * (2 * 64 * 64)
                                   + 2 * (2 * 64 * 32) + 3 * (2 * 64 * 128))
                           // 8),
        "all-reduce": (3 + 6, 4 * (64 + 2 * 64 + 2 * 64) + 6 * ACT * 2),
        "all-to-all": (0, 0)},
    # + lm_head, router (fp32, replicated on model: 1/4 a device), 4
    # experts of d_expert 32 split on model (EP), a shared expert; the
    # dispatch buffer (2, 4 experts, capacity 20, 64) in bf16 twice a pass
    "deepseek-moe-16b": {
        "all-gather": (26, 2 * (2 * 256 * 64 + 2 * (2 * 64 * 64)
                                + 2 * (2 * 64 * 32) + 2 * 64 * 4 * 4
                                + 3 * (2 * 4 * 64 * 32)
                                + 3 * (2 * 64 * 32))),
        "reduce-scatter": (13, 4 * (2 * 256 * 64 + 2 * (2 * 64 * 64)
                                    + 2 * (2 * 64 * 32)
                                    + 3 * (2 * 4 * 64 * 32)
                                    + 3 * (2 * 64 * 32)) // 8
                           + 2 * 64 * 4 * 4 // 4),
        "all-reduce": (3 + 6, 4 * (64 + 2 * 64 + 2 * 64) + 6 * ACT * 2),
        "all-to-all": (6, 6 * (2 * 4 * 20 * 64 * 2) * 2)},
    # one Mamba block (+ the reduced MLP): in_proj 64 x 296, out_proj
    # 128 x 64; conv_w (160, 4) split on model only, so its grad is
    # all-reduced; nine replicated leaves in all
    "mamba2-1.3b": {
        "all-gather": (14, 2 * (2 * 256 * 64 + 64 * 296 + 128 * 64
                                + 3 * 64 * 128)),
        "reduce-scatter": (7, 4 * (2 * 256 * 64 + 64 * 296 + 128 * 64
                                   + 3 * 64 * 128) // 8),
        "all-reduce": (9 + 6, 4 * (64 + 64 + 160 * 4 // 2 + 160 + 3 * 8
                                   + 128 + 64) + 6 * ACT),
        "all-to-all": (0, 0)},
}


@pytest.mark.parametrize("arch", sorted(HAND))
def test_collectives_hand_count(arch):
    comp = D.lower_cell(get_config(arch).reduced(), TINY_TRAIN,
                        _pod_mesh()).compile()
    got = comp.collectives()
    for kind, (count, nbytes) in HAND[arch].items():
        assert (got[kind]["count"], got[kind]["bytes"]) == (count, nbytes), \
            kind
    assert got["total_bytes"] == sum(b for _, b in HAND[arch].values())
    assert got["collective-permute"] == {"count": 0, "bytes": 0}
    assert got["depth2_raw_bytes"] == 0


def test_one_device_mesh_has_no_collectives():
    """Axes of size 1 shard nothing: no collective on a (1, 1) mesh."""
    comp = D.lower_cell(get_config("deepseek-moe-16b").reduced(),
                        TINY_TRAIN, Mesh(("data", "model"), (1, 1))).compile()
    got = comp.collectives()
    assert got["total_bytes"] == 0
    assert all(got[k]["count"] == 0 for k in D._COLLECTIVES)


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
