"""The training substrate: the port's data pipeline, AdamW, checkpoints and
fault-tolerance primitives against the reference's
(tests/test_train_substrate.py), on the CPU.

Bars.  Batches are equal bit for bit (the same numpy calls).  AdamW over 5
steps from one state (`convert.train_state`) on the same gradients: rtol
1e-6 with an atol of 1e-6 of each tensor's largest entry, since both
sides compute the same f32 expressions and differ only where the global
norm sums its squares in another order (an ulp of the clip scale) and in
the f32 ``pow`` of the bias corrections; the int8 codes and the error
feedback are equal wherever the scales are.  The reference's update runs
op by op, not under ``jax.jit``: there XLA's CPU compiler contracts the
error feedback's g + ef − q·scale into a fused multiply-add, one rounding
where the expression has two, an ulp of g + ef apart (3e-9 at 0.02),
which a later step's rounding to int8 can turn into a whole code.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.checkpoint.manager import CheckpointManager as RefManager
from repro.data import pipeline as ref_pipeline
from repro.train import loop as ref_loop
from repro.train import optimizer as ref_optim
from repro_torch import convert
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data import pipeline
from repro_torch.distributed.fault_tolerance import (Heartbeat,
                                                     StragglerDetector,
                                                     run_with_restarts)
from repro_torch.train import optimizer as optim

CPU = torch.device("cpu")


# -- data ---------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(vocab_size=100, seq_len=16, global_batch=4),
    dict(vocab_size=49152, seq_len=64, global_batch=8, seed=3),
    dict(vocab_size=50, seq_len=8, global_batch=8, num_hosts=4, host_id=2),
], ids=["small", "smollm-vocab", "host-2-of-4"])
@pytest.mark.parametrize("step", [0, 7])
def test_synthetic_batches_equal_reference_bits(kw, step):
    got = pipeline.SyntheticLM(pipeline.DataConfig(**kw)).batch(step)
    want = ref_pipeline.SyntheticLM(ref_pipeline.DataConfig(**kw)).batch(
        step)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_synthetic_determinism():
    ds = pipeline.SyntheticLM(pipeline.DataConfig(vocab_size=100, seq_len=16,
                                                  global_batch=4))
    b1, b2 = ds.batch(7), ds.batch(7)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert not np.array_equal(b1["tokens"], ds.batch(8)["tokens"])
    assert b1["tokens"].shape == b1["labels"].shape == (4, 16)
    np.testing.assert_array_equal(b1["labels"][:, :-1], b1["tokens"][:, 1:])


def test_host_slicing_disjoint_union():
    full = pipeline.SyntheticLM(pipeline.DataConfig(
        vocab_size=50, seq_len=8, global_batch=8)).batch(3)
    parts = [pipeline.SyntheticLM(pipeline.DataConfig(
        vocab_size=50, seq_len=8, global_batch=8, num_hosts=4,
        host_id=h)).batch(3) for h in range(4)]
    np.testing.assert_array_equal(
        np.concatenate([p["tokens"] for p in parts]), full["tokens"])


@pytest.mark.parametrize("host", [None, 1])
def test_memmap_batches_equal_reference_bits(tmp_path, host):
    toks = np.arange(10_000) % 313
    path = str(tmp_path / "tokens.bin")
    pipeline.write_token_file(path, toks)
    ref_path = str(tmp_path / "ref_tokens.bin")
    ref_pipeline.write_token_file(ref_path, toks)
    assert open(path, "rb").read() == open(ref_path, "rb").read()
    kw = dict(vocab_size=313, seq_len=32, global_batch=4, kind="memmap",
              path=path)
    if host is not None:
        kw.update(num_hosts=2, host_id=host)
    ds = pipeline.make_dataset(pipeline.DataConfig(**kw))
    ref = ref_pipeline.make_dataset(ref_pipeline.DataConfig(**kw))
    for step in (0, 5):
        got, want = ds.batch(step), ref.batch(step)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    b = ds.batch(0)
    np.testing.assert_array_equal(b["labels"][:, :-1], b["tokens"][:, 1:])


def test_make_dataset_rejects_unknown_kind():
    with pytest.raises(ValueError):
        pipeline.make_dataset(pipeline.DataConfig(kind="parquet"))


# -- optimizer ----------------------------------------------------------------

def test_adamw_converges_on_quadratic():
    cfg = optim.OptimizerConfig(lr=0.1, warmup_steps=0, total_steps=200,
                                weight_decay=0.0, grad_clip=1e9)
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3)}
    state = optim.init(params, cfg)
    for _ in range(200):
        optim.apply_updates(params, {"w": 2 * (params["w"] - target)}, state,
                            cfg)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(),
                               atol=1e-2)


def test_lr_schedule_matches_reference():
    cfg = optim.OptimizerConfig(lr=1.0, warmup_steps=10, total_steps=100,
                                min_lr_ratio=0.1)
    ref_cfg = ref_optim.OptimizerConfig(lr=1.0, warmup_steps=10,
                                        total_steps=100, min_lr_ratio=0.1)
    lrs = [float(optim.lr_schedule(cfg, s)) for s in (0, 5, 10, 55, 100)]
    assert lrs[0] == 0.0
    assert lrs[1] == pytest.approx(0.5)
    assert lrs[2] == pytest.approx(1.0)
    assert 0.1 < lrs[3] < 1.0
    assert lrs[4] == pytest.approx(0.1, abs=1e-6)
    for s in range(0, 120, 3):
        got = optim.lr_schedule(cfg, s)
        assert got.dtype == torch.float32
        want = ref_optim.lr_schedule(ref_cfg, jnp.asarray(s, jnp.int32))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_clip_by_global_norm():
    clipped, norm = optim.clip_by_global_norm(
        {"a": torch.tensor([3.0, 4.0])}, 1.0)
    assert float(norm) == pytest.approx(5.0)
    assert float(optim.global_norm(clipped)) == pytest.approx(1.0)


def test_int8_compression_error_feedback():
    """Error feedback keeps the long-run average unbiased: the summed
    compressed updates converge to the summed true gradients."""
    g = torch.tensor(np.random.default_rng(0).normal(size=(64,)) * 1e-3,
                     dtype=torch.float32)
    ef = {"g": torch.zeros_like(g)}
    total = torch.zeros_like(g)
    for _ in range(50):
        out, ef = optim.compress_decompress({"g": g}, ef)
        total = total + out["g"]
    np.testing.assert_allclose((total / 50).numpy(), g.numpy(), atol=2e-6)


def test_quantize_int8_matches_reference():
    x = np.random.default_rng(1).normal(size=(257,)).astype(np.float32)
    x[:4] = [-1.0, 0.5, 1.0, 127.5 / 127.0]   # a half on the grid
    q, scale = optim.quantize_int8(torch.tensor(x))
    rq, rscale = ref_optim.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8
    assert int(q.abs().max()) <= 127
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert float(scale) == float(rscale)


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def _state_and_grads(arch, compress, seed=0):
    """The reference's init_state for ``arch``'s smoke config, and 5 steps
    of random gradients (trees like the parameters)."""
    cfg = _f32(ref_configs.get_smoke(arch))
    ocfg = ref_optim.OptimizerConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                                     compress_grads=compress)
    tcfg = ref_loop.TrainConfig(optimizer=ocfg)
    state = ref_loop.init_state(jax.random.PRNGKey(seed), cfg, tcfg)
    rng = np.random.default_rng(seed)
    grads = [jax.tree.map(lambda p: (rng.normal(size=p.shape) * 0.02).astype(
        np.float32), state["params"]) for _ in range(5)]
    return cfg, ocfg, state, grads


def _port_opt_cfg(ocfg):
    return optim.OptimizerConfig(**dataclasses.asdict(ocfg))


def _close_by_name(got: dict, want: dict, what: str):
    assert got.keys() == want.keys(), what
    for k in want:
        w = want[k].detach().numpy()
        np.testing.assert_allclose(
            got[k].detach().numpy(), w, rtol=1e-6,
            atol=1e-6 * float(np.abs(w).max()), err_msg=f"{what} {k}")


def _run_both(arch, compress, grads_fn=None):
    cfg, ocfg, state, grads = _state_and_grads(arch, compress)
    if grads_fn is not None:
        grads = [grads_fn(g) for g in grads]
    port = convert.train_state(jax.tree.map(np.asarray, state),
                               convert.model_config(dataclasses.asdict(cfg)),
                               CPU)
    pcfg = _port_opt_cfg(ocfg)
    def step(p, g, s):
        return ref_optim.apply_updates(p, g, s, ocfg)
    params, opt = state["params"], state["opt"]
    for g in grads:
        params, opt, ref_metrics = step(params, g, opt)
        metrics = optim.apply_updates(port.params(),
                                      convert.lm_params(g, CPU), port.opt,
                                      pcfg)
        np.testing.assert_allclose(float(metrics["grad_norm"]),
                                   float(ref_metrics["grad_norm"]),
                                   rtol=1e-6)
        # the f32 cosine of the schedule: an ulp apart in XLA and PyTorch
        np.testing.assert_allclose(float(metrics["lr"]),
                                   float(ref_metrics["lr"]), rtol=1e-6)
    assert port.opt.step == int(opt["step"]) == 5
    tree = jax.tree.map(np.asarray, {"params": params, "opt": opt})
    return port, tree


@pytest.mark.parametrize("compress", [False, True],
                         ids=["plain", "int8"])
@pytest.mark.parametrize("arch", ["smollm-360m", "zamba2-7b"])
def test_apply_updates_matches_reference(arch, compress):
    """5 steps from one state on the same gradients: parameters, moments
    and error feedback (smollm: scanned slots only; zamba2: a shared
    slot beside scanned ones)."""
    port, tree = _run_both(arch, compress)
    _close_by_name(port.params(), convert.lm_params(tree["params"], CPU),
                   "params")
    for part in ("m", "v") + (("ef",) if compress else ()):
        _close_by_name(getattr(port.opt, part),
                       convert.lm_params(tree["opt"][part], CPU), part)
    if not compress:
        assert port.opt.ef is None


def test_weight_decay_follows_the_reference_leaf_rank():
    """Trap 1: with zero gradients the update is the decay alone.  A
    scanned slot's norm scale is (d,) here but (repeats, d) in the
    reference, so it decays; ``ln_f.scale`` is (d,) in both and does
    not."""
    port, tree = _run_both("smollm-360m", False,
                           lambda g: jax.tree.map(np.zeros_like, g))
    got = port.params()
    scanned = "stack.scanned.slot0.1.ln1.scale"
    assert got[scanned].ndim == 1
    assert optim.reference_leaf(scanned, 1) == (
        "stack.scanned.slot0.ln1.scale", 2)
    assert optim.reference_leaf("ln_f.scale", 1) == ("ln_f.scale", 1)
    assert float(got[scanned].detach().max()) < 1.0   # decayed from ones
    assert torch.equal(got["ln_f.scale"], torch.ones_like(got["ln_f.scale"]))
    _close_by_name(got, convert.lm_params(tree["params"], CPU), "params")


def test_int8_scale_is_shared_across_a_slot_leafs_repeats():
    """Trap 1: the reference quantizes a stacked leaf with one scale over
    its repeats.  Repeat 1's gradient is 1000× repeat 0's, so repeat 0's
    small entries round to a few codes with the shared scale, and to the
    full int8 range with a scale of its own."""
    def scaled(g):
        g = jax.tree.map(np.array, g)
        g["stack"]["scanned"]["slot0"]["mlp"]["w_up"][1] *= 1000.0
        return g
    port, tree = _run_both("smollm-360m", True, scaled)
    want = convert.lm_params(tree["opt"]["ef"], CPU)
    _close_by_name(port.opt.ef, want, "ef")
    name = "stack.scanned.slot0.0.mlp.w_up"
    groups = optim.leaf_groups(port.params())
    assert (name, "stack.scanned.slot0.1.mlp.w_up") in groups
    g = torch.tensor(np.random.default_rng(2).normal(size=(4, 4)),
                     dtype=torch.float32)
    shared, _ = optim.compress_decompress(
        {"a": g, "b": 1000 * g}, {"a": torch.zeros_like(g),
                                  "b": torch.zeros_like(g)}, [("a", "b")])
    own, _ = optim.compress_decompress({"a": g}, {"a": torch.zeros_like(g)})
    assert len(torch.unique(shared["a"])) < len(torch.unique(own["a"]))


# -- checkpoint ---------------------------------------------------------------

def _tree(seed=0):
    r = np.random.default_rng(seed)
    return {"a": torch.tensor(r.normal(size=(4, 3))),
            "nested": {"b": torch.tensor(r.normal(size=(7,)),
                                         dtype=torch.float32),
                       "bf": torch.tensor(r.normal(size=(5,)),
                                          dtype=torch.bfloat16),
                       "step": 5}}


def _zeros_like(tree):
    return {"a": torch.zeros(4, 3, dtype=torch.float64),
            "nested": {"b": torch.zeros(7), "bf": torch.zeros(
                5, dtype=torch.bfloat16), "step": 0}}


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = _tree()
    mgr.save(10, tree)
    out = mgr.restore(_zeros_like(tree))
    for k in ("a",):
        assert torch.equal(out[k], tree[k])
    for k in ("b", "bf"):
        assert out["nested"][k].dtype == tree["nested"][k].dtype
        assert torch.equal(out["nested"][k], tree["nested"][k])
    assert out["nested"]["step"] == 5


def test_checkpoint_layout_matches_reference(tmp_path):
    """The same files and manifest fields as the reference's; a bf16 leaf
    as its uint16 bits, marked "bfloat16"."""
    CheckpointManager(str(tmp_path / "port")).save(3, _tree())
    RefManager(str(tmp_path / "ref")).save(3, {
        "a": jnp.zeros((4, 3)), "nested": {"b": jnp.zeros(7), "bf": jnp.zeros(
            5, jnp.bfloat16), "step": jnp.asarray(5, jnp.int32)}})
    d, rd = tmp_path / "port" / "step_00000003", tmp_path / "ref" / \
        "step_00000003"
    assert sorted(os.listdir(d)) == sorted(os.listdir(rd))
    man = json.load(open(d / "manifest.json"))
    ref_man = json.load(open(rd / "manifest.json"))
    assert man.keys() == ref_man.keys() and man["complete"]
    assert [sorted(e) for e in man["leaves"]] == \
        [sorted(e) for e in ref_man["leaves"]]
    keys = {e["key"]: e for e in man["leaves"]}
    assert set(keys) == {"a", "nested.b", "nested.bf", "nested.step"}
    assert keys["nested.bf"]["dtype"] == "bfloat16"
    assert np.load(d / keys["nested.bf"]["file"]).dtype == np.uint16


def test_checkpoint_keep_k_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        mgr.save(s, _tree(s))
    assert mgr.all_steps() == [2, 3]
    assert mgr.latest_step() == 3


def test_checkpoint_ignores_incomplete_tmp(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, _tree())
    os.makedirs(str(tmp_path / "step_00000009.tmp"))  # crashed save
    os.makedirs(str(tmp_path / "step_00000007"))      # no manifest
    assert mgr.latest_step() == 1


def test_checkpoint_async_snapshot_is_a_copy(tmp_path):
    """An in-place update after save_async does not reach the checkpoint
    (the port's update is in place, where the reference's returns new
    arrays)."""
    mgr = CheckpointManager(str(tmp_path), keep=3)
    tree = _tree(4)
    before = tree["a"].clone()
    mgr.save_async(4, tree)
    tree["a"].add_(1.0)
    mgr.wait()
    assert mgr.latest_step() == 4
    assert torch.equal(mgr.restore(_zeros_like(tree))["a"], before)


def test_restore_empty_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path)).restore(_zeros_like(_tree()))


# -- fault tolerance ----------------------------------------------------------

def test_run_with_restarts_recovers(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(0, _tree())
    calls = {"n": 0}

    def train_fn(resume):
        calls["n"] += 1
        if calls["n"] == 1:
            mgr.save(5, _tree(5))
            raise RuntimeError("simulated node failure")
        assert resume == 5  # resumed from the crash checkpoint
        return 10

    final, restarts = run_with_restarts(train_fn, mgr, max_restarts=2)
    assert final == 10 and restarts == 1


def test_run_with_restarts_gives_up(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)

    def always_fail(resume):
        raise RuntimeError("hard failure")

    with pytest.raises(RuntimeError):
        run_with_restarts(always_fail, mgr, max_restarts=1)


def test_heartbeat_stale_detection(tmp_path):
    d = str(tmp_path)
    hb0 = Heartbeat(d, 0)
    hb1 = Heartbeat(d, 1)
    hb0.beat(1, t=1000.0)
    hb1.beat(1, t=1100.0)
    assert Heartbeat.stale_hosts(d, timeout_s=60, now=1130.0) == [0]
    assert Heartbeat.stale_hosts(d, timeout_s=200, now=1130.0) == []


def test_straggler_detector():
    det = StragglerDetector(k=3.0, min_samples=4)
    for h in range(6):
        det.record(h, 1.0 + 0.01 * h)
    det.record(6, 30.0)
    assert det.stragglers() == [6]
