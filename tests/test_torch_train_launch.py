"""The trainer's launch layer on the CPU: `launch/flops.py` and
`distributed/sharding.py` against the reference's
(tests/test_losses_serve.py:94-149, tests/test_sharding_dist.py:43-94),
and the drivers `python -m repro_torch.launch.train` (a SIGTERM'd run
resumed from its checkpoint) and `launch.serve --ckpt-dir`.

The reference's parameter shapes come from ``jax.eval_shape`` of its
``init_params``, the port's from a model on the ``meta`` device
(`repro_torch.launch.flops.meta_shapes`); nothing is allocated.
"""
import dataclasses
import functools
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as ref_configs
from repro.distributed import sharding as ref_sharding
from repro.launch import flops as ref_flops
from repro.models import lm as ref_lm
from repro_torch import configs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.distributed import sharding
from repro_torch.launch import flops
from repro_torch.launch import serve as serve_driver
from repro_torch.models import lm
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.train import optimizer as optim

ROOT = Path(__file__).resolve().parents[1]
MESH = {"data": 16, "model": 16}


class FakeMesh:
    """The reference's shape-only mesh (tests/test_sharding_dist.py)."""

    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


@functools.lru_cache(maxsize=None)
def _ref_shapes(arch):
    cfg = ref_configs.get(arch)
    return cfg, jax.eval_shape(
        lambda: ref_lm.init_params(jax.random.PRNGKey(0), cfg))


@functools.lru_cache(maxsize=None)
def _port_shapes(arch):
    return flops.meta_shapes(configs.get(arch))


def _ref_leaves(tree):
    """Reference leaf name (dotted, as `optim.reference_leaf` names it) →
    leaf."""
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            tree, is_leaf=lambda x: isinstance(x, P)):
        out[".".join(str(getattr(p, "key", getattr(p, "idx", "")))
                     for p in path)] = leaf
    return out


# -- flops --------------------------------------------------------------------

@pytest.mark.parametrize("arch", configs.ARCHS)
def test_param_counts_match_reference(arch):
    cfg, params = _ref_shapes(arch)
    want = ref_flops.param_counts(params, cfg)
    assert flops.param_counts(_port_shapes(arch), configs.get(arch)) == want


def test_param_counts_moe_active():
    """tests/test_losses_serve.py:143."""
    total, active = flops.param_counts(_port_shapes("mixtral-8x22b"),
                                       configs.get("mixtral-8x22b"))
    assert total > 100e9          # 8x22b-ish
    assert active < 0.45 * total  # top-2 of 8 experts + attention


def test_model_flops_six_n_d():
    cfg = configs.get("smollm-360m")
    total, active = flops.param_counts(_port_shapes("smollm-360m"), cfg)
    assert flops.model_flops(cfg, 2048, True, total, active) == \
        6.0 * active * 2048
    assert flops.model_flops(cfg, 2048, False, total, active) == \
        2.0 * active * 2048


def _stack(ws, x, remat=False):
    h = x
    for w in ws:
        def layer(h, w=w):
            return torch.tanh(h @ w)
        h = (torch.utils.checkpoint.checkpoint(layer, h, use_reentrant=False)
             if remat else layer(h))
    return h.sum()


def test_flop_counter_counts_every_layer():
    """tests/test_losses_serve.py:94: 8 layers of tanh(h @ w), (32, 64) @
    (64, 64); the reference's scan is a loop here."""
    ws = torch.empty(8, 64, 64, device="meta")
    x = torch.empty(32, 64, device="meta")
    got = flops.count_fn(_stack, ws, x)["flops"]
    want = 8 * 2 * 32 * 64 * 64
    assert want <= got <= 1.2 * want


def test_flop_counter_grad_and_remat():
    """tests/test_losses_serve.py:107: the gradient with each layer under
    torch.utils.checkpoint: forward, recompute and two backward products
    a layer (the first layer's input needs no gradient: one fewer)."""
    ws = torch.empty(8, 64, 64, requires_grad=True)
    x = torch.empty(32, 64)

    def grad(ws, x):
        torch.autograd.grad(_stack(ws, x, remat=True), ws)
    got = flops.count_fn(grad, ws, x)["flops"]
    want = 8 * 4 * 2 * 32 * 64 * 64
    assert 0.9 * want <= got <= 1.3 * want


# -- sharding -----------------------------------------------------------------

def test_divisibility_rules_smollm():
    """smollm: 15 heads / 5 kv heads do not divide 16 → replicated; its
    d_ff = 2560 and vocab = 49152 do."""
    specs = sharding.param_specs(_port_shapes("smollm-360m"), MESH)
    s = specs["stack.scanned.slot0.0.attn.wq"]
    assert s[-2] is None                        # 15 heads: not head-sharded
    assert s[-3] == "model"                     # falls back to d_model (960)
    assert specs["stack.scanned.slot0.5.mlp.w_gate"][-1] == "model"
    assert specs["embed"][0] == "model"


def test_ep_rules_deepseek():
    """deepseek: 64 experts divide 16 → expert-parallel."""
    shapes = _port_shapes("deepseek-v2-lite-16b")
    specs = sharding.param_specs(shapes, MESH)
    name = "stack.scanned.slot0.0.moe.w_gate"
    assert specs[name][-3] == "model" and shapes[name][-3] == 64


def test_moe_fallback_mixtral():
    """mixtral: 8 experts do not divide 16 → d_ff sharding."""
    specs = sharding.param_specs(_port_shapes("mixtral-8x22b"), MESH)
    s = specs["stack.scanned.slot0.0.moe.w_gate"]
    assert s[-3] is None and s[-1] == "model"


def test_zero_specs_add_data_axis():
    shapes = _port_shapes("olmo-1b")
    pspecs = sharding.param_specs(shapes, MESH)
    s = sharding.zero_specs(shapes, pspecs, MESH)[
        "stack.scanned.slot0.0.mlp.w_gate"]
    assert "data" in s and "model" in s         # ZeRO + TP


def test_strategies():
    shapes = _port_shapes("smollm-360m")
    dp = sharding.param_specs(shapes, MESH, "dp")
    assert dp["embed"][0] == "model"
    assert all(all(e is None for e in s) for k, s in dp.items()
               if k.startswith("stack."))
    s = sharding.param_specs(shapes, MESH, "fsdp")[
        "stack.scanned.slot0.0.mlp.w_gate"]
    assert "data" in s and "model" not in s


def _spec_pairs(arch, port_specs, ref_specs):
    """(port name, port spec, the reference leaf's spec, scanned?)."""
    ref = {k: tuple(v) for k, v in _ref_leaves(ref_specs).items()}
    shapes = _port_shapes(arch)
    for name, spec in port_specs.items():
        leaf, rank = optim.reference_leaf(name, len(shapes[name]))
        want = ref[leaf] + (None,) * (rank - len(ref[leaf]))
        yield name, spec, want, rank != len(shapes[name])


@pytest.mark.parametrize("strategy", ["2d", "dp", "fsdp", "fsdp_all",
                                      "2d_fsdp", "zero"])
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_specs_are_the_references_without_the_repeat_axis(arch, strategy):
    """Every parameter of every architecture under each strategy (and the
    ZeRO-1 moments of "2d"): a scanned parameter's spec is its reference
    leaf's spec with the leading repeat axis removed, any other the
    reference's.  At this (16, 16) mesh no reference spec of the ten
    configs shards a repeat axis, so nothing is dropped."""
    cfg, params = _ref_shapes(arch)
    shapes = _port_shapes(arch)
    mesh = FakeMesh(MESH)
    if strategy == "zero":
        ps = sharding.param_specs(shapes, MESH)
        port = sharding.zero_specs(shapes, ps, MESH)
        ref = ref_sharding.zero_specs(
            params, ref_sharding.param_specs(params, mesh), mesh)
    else:
        port = sharding.param_specs(shapes, MESH, strategy)
        ref = ref_sharding.param_specs(params, mesh, strategy)
    for name, spec, want, scanned in _spec_pairs(arch, port, ref):
        assert spec == (want[1:] if scanned else want), (name, spec, want)
        assert not scanned or want[0] is None, name


def test_cache_and_batch_specs_match_reference():
    """Caches (per repeat in the port, stacked in the reference: the port
    has no repeat axis to skip) and batches, on smoke-sized tensors at a
    mesh that divides them."""
    mesh = {"data": 2, "model": 4}
    cfg = dataclasses.replace(configs.get_smoke("zamba2-7b"),
                              dtype="float32")
    ref_cfg = dataclasses.replace(ref_configs.get_smoke("zamba2-7b"),
                                  dtype="float32")
    port = sharding.cache_specs(lm.cache_init(cfg, 4, 32, torch.float32,
                                              "cpu"), mesh)
    ref = ref_sharding.cache_specs(ref_lm.cache_init(ref_cfg, 4, 32,
                                                     np.float32),
                                   FakeMesh(mesh))
    for li, spec in enumerate(ref["prologue"]):
        for k, s in spec.items():
            assert port["prologue"][li][k] == tuple(s), (li, k)
    for si, spec in ref["body"].items():
        for k, s in spec.items():
            for r in range(cfg.repeats):
                got = port["body"][r][si][k]
                if k == "length":
                    assert got == ()
                elif k == "carry":
                    assert list(got) == [tuple(x)[1:] for x in s]
                else:
                    assert got == tuple(s)[1:], (si, k)
    batch = {"tokens": np.zeros((8, 16), np.int32),
             "labels": np.zeros((3, 16), np.int32)}
    want = ref_sharding.batch_specs(batch, FakeMesh(mesh))
    got = sharding.batch_specs(batch, mesh)
    assert got == {k: tuple(v) for k, v in want.items()}
    assert sharding.data_axes_of({"pod": 2, "data": 4, "model": 8}) == \
        ref_sharding.data_axes_of(FakeMesh({"pod": 2, "data": 4,
                                            "model": 8}))


# -- the drivers --------------------------------------------------------------

TRAIN = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "smollm-360m", "--smoke", "--device", "cpu", "--steps", "8",
         "--ckpt-every", "4", "--log-every", "1", "--global-batch", "16",
         "--seq", "128"]


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                OMP_NUM_THREADS="1")


def _train(ckpt, **kw):
    return subprocess.run(TRAIN + ["--ckpt-dir", str(ckpt)], cwd=ROOT,
                          env=_env(), capture_output=True, text=True,
                          timeout=300, **kw)


def _leaves(ckpt, step):
    d = Path(ckpt) / f"step_{step:08d}"
    man = json.load(open(d / "manifest.json"))
    return {e["key"]: np.load(d / e["file"]) for e in man["leaves"]}


def test_train_driver_resumes_after_sigterm(tmp_path):
    """SIGTERM after step 5's log line: a checkpoint lands (exit 143), the
    same command resumes from it, and the final state equals an
    uninterrupted run's bit for bit (CPU arithmetic is deterministic)."""
    whole = _train(tmp_path / "whole")
    assert whole.returncode == 0, whole.stderr[-2000:]
    ckpt = tmp_path / "cut"
    proc = subprocess.Popen(TRAIN + ["--ckpt-dir", str(ckpt)], cwd=ROOT,
                            env=_env(), stdout=subprocess.PIPE, text=True)
    try:
        for line in proc.stdout:
            if line.startswith("step     5 "):
                proc.send_signal(signal.SIGTERM)
                break
        proc.stdout.read()
        assert proc.wait(timeout=120) == 143
    finally:
        if proc.poll() is None:
            proc.kill()
    landed = CheckpointManager(str(ckpt)).latest_step()
    assert landed is not None and 5 <= landed < 8
    again = _train(ckpt)
    assert again.returncode == 0, again.stderr[-2000:]
    assert f"resumed from checkpoint step {landed}" in again.stdout
    assert f"step {landed:5d} " in again.stdout
    got, want = _leaves(ckpt, 8), _leaves(tmp_path / "whole", 8)
    assert got.keys() == want.keys() and "opt.m.embed" in got
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert int(got["step"]) == int(got["opt.step"]) == 8
    beats = os.listdir(ckpt / "heartbeats")
    assert beats == ["host_0.json"]


def test_serve_restores_a_trained_checkpoint(tmp_path, capsys):
    """`launch.serve --ckpt-dir` on a checkpoint of `launch.train`: the
    greedy tokens of the restored model's Engine run in-process."""
    run = _train(tmp_path)
    assert run.returncode == 0, run.stderr[-2000:]
    serve_driver.main(["--arch", "smollm-360m", "--smoke", "--device", "cpu",
                       "--ckpt-dir", str(tmp_path), "--batch", "2",
                       "--max-new", "6", "--prompt-len", "5"])
    out = capsys.readouterr().out
    assert "restored params from step 8" in out
    rows = [eval(ln.split(": ", 1)[1]) for ln in out.splitlines()
            if ln.startswith("request ")]
    cfg = dataclasses.replace(configs.get_smoke("smollm-360m"),
                              dtype="float32")
    model = lm.LM(cfg, None, device="meta")
    restored = CheckpointManager(str(tmp_path)).restore(
        {"params": dict(model.named_parameters())}, device="cpu")["params"]
    model.load_state_dict(restored, strict=True, assign=True)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 5)).astype(np.int32)
    want = Engine(model, cfg, ServeConfig(max_len=256, batch_size=2),
                  rng_seed=0).generate(prompts, 6)
    assert rows == want.tolist()
    # the trained parameters, not the seed's random ones
    fresh = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert not torch.equal(fresh.embed, model.embed)
