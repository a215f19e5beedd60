"""The sharded train step and the sharded decode on 4 gloo ranks (CPU):
`repro_torch.train.loop.shard_state` and `train_step` on a (data, model)
``DeviceMesh`` against the reference's ``train.loop.train_step`` (under
``jax.jit``, one device: the port of tests/test_sharding_dist.py:96,
which only compiles, run here), and prefill + greedy decode on a mesh
against the reference's logits and the one-process engine's tokens.

The ranks' work is two launches of 4 ranks at once
(`tests/_torch_dist.py`), started by a module fixture while this process
computes the reference's side; each check is its own case.  Inputs and bars: tests/_torch_train.py.  The
in-loop gather (``gather_params``) computes in f32 from bf16-rounded
parameters, so a gradient is a bf16 value: `GATHER_BF16`.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_dist import RankGroups
from _torch_train import (CPU, F32, GW_F32, GW_TCFG, STEP_TCFG, XLSTM_F32,
                          _batch, _check_step, _f32, _port_tcfg)
from repro import configs as ref_configs
from repro.models import lm as ref_lm
from repro.train import loop as ref_loop
from repro_torch import convert
from repro_torch.distributed import sharding
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.train import loop

# the gathered step's gradients are bf16 values (the matmuls' outputs in
# the parameters' bf16), and a data-sharded batch rounds each shard's
# partial gradient to bf16 before the sum: two bf16 roundings (2 · 2⁻⁸)
GATHER_BF16 = 2 * 2.0 ** -8
LM_F32 = dict(atol=1e-5, rtol=1e-5)
ARCHS = ("smollm-360m", "olmo-1b", "deepseek-v2-lite-16b", "zamba2-7b",
         "xlstm-350m")
SMOLLM_STRATEGIES = (("dp", (4, 1)), ("fsdp", (2, 2)), ("2d_fsdp", (2, 2)),
                     ("fsdp_all", (2, 2)))
GATHER_TCFG = dataclasses.replace(STEP_TCFG, gather_params=True)
DECODE = {"smollm-360m": 0, "deepseek-v2-lite-16b": 1}


def _bar(arch):
    return XLSTM_F32 if arch == "xlstm-350m" else F32


def _step_inputs(arch, tcfg, batch, seed=0):
    cfg = _f32(ref_configs.get_smoke(arch))
    pcfg = convert.model_config(dataclasses.asdict(cfg))
    state = ref_loop.init_state(jax.random.PRNGKey(seed), cfg, tcfg)
    return cfg, pcfg, state, jax.tree.map(np.asarray, state)


def _cases():
    """name → (reference tcfg, arch, batch) of every step case, and the
    ranks' cases."""
    smollm = ref_configs.get_smoke("smollm-360m")
    wide = _batch(smollm, 8, 16, ("sharded", "smollm-360m"))
    steps = {}
    for arch in ARCHS:
        batch = (wide if arch == "smollm-360m" else _batch(
            ref_configs.get_smoke(arch), 4, 16, ("sharded", arch)))
        steps[f"{arch}/2d/2x2"] = (STEP_TCFG, arch, batch, "2d", (2, 2))
    for strat, mesh in SMOLLM_STRATEGIES:
        steps[f"smollm-360m/{strat}/{mesh[0]}x{mesh[1]}"] = (
            STEP_TCFG, "smollm-360m", wide, strat, mesh)
    steps["smollm-360m/gw/2x2"] = (
        GW_TCFG, "smollm-360m",
        _batch(smollm, 4, 16, ("sharded", "gw"), teacher=True), "2d", (2, 2))
    steps["smollm-360m/gather/2x2"] = (GATHER_TCFG, "smollm-360m", wide,
                                       "2d", (2, 2))
    return steps


def _decode_inputs(arch):
    cfg = _f32(ref_configs.get_smoke(arch))
    params = ref_lm.init_params(jax.random.PRNGKey(DECODE[arch]), cfg)
    prompts = np.random.default_rng(DECODE[arch]).integers(
        0, cfg.vocab_size, (4, 12)).astype(np.int32)
    return cfg, params, prompts


def _ref_greedy(cfg, params, prompts, n, max_len):
    """The reference's prefill and greedy decode, each step's logits."""
    prefill = jax.jit(lambda p, t, c: ref_lm.prefill(p, {"tokens": t}, cfg,
                                                     c))
    decode = jax.jit(lambda p, t, c: ref_lm.decode_step(p, {"tokens": t}, c,
                                                        cfg))
    caches = ref_lm.cache_init(cfg, prompts.shape[0], max_len, np.float32)
    logits, caches = prefill(params, prompts, caches)
    seen, out = [np.asarray(logits)], []
    for _ in range(n):
        out.append(np.argmax(seen[-1], -1))
        logits, caches = decode(params, out[-1][:, None], caches)
        seen.append(np.asarray(logits))
    return np.stack(out, 1), np.stack(seen, 1)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The ranks' results and this process's side: the reference's step
    and the port's one-process step of each case, the reference's
    decode and the one-process engine's tokens."""
    steps = _cases()
    init, cases = {}, []
    for name, (tcfg, arch, batch, strat, mesh) in steps.items():
        cfg, pcfg, state, tree = _step_inputs(arch, tcfg, batch)
        init[name] = (cfg, pcfg, state, tree)
        cases.append({"kind": "step", "name": name, "cfg": pcfg,
                      "tcfg": _port_tcfg(tcfg), "state": tree,
                      "batch": batch, "strategy": strat, "mesh": mesh,
                      "profile": name in ("smollm-360m/2d/2x2",
                                          "smollm-360m/dp/4x1",
                                          "smollm-360m/gather/2x2")})
    for arch in DECODE:
        cfg, params, prompts = _decode_inputs(arch)
        cases.append({"kind": "decode", "name": f"decode/{arch}",
                      "cfg": convert.model_config(dataclasses.asdict(cfg)),
                      "params": jax.tree.map(np.asarray, params),
                      "prompts": prompts, "steps": 8, "max_len": 20,
                      "mesh": (2, 2)})
    cases.append({"kind": "collectives", "name": "collectives"})
    # about half the ranks' time: MoE and Mamba2 (sharding propagation)
    slow = {"deepseek-v2-lite-16b/2d/2x2", "decode/deepseek-v2-lite-16b",
            "zamba2-7b/2d/2x2"}
    ranks = RankGroups(tmp_path_factory.mktemp("sharded"), [
        [c for c in cases if c["name"] in slow],
        [c for c in cases if c["name"] not in slow]])

    ref, one = {}, {}
    jitted = {}
    for name, (tcfg, arch, batch, strat, mesh) in steps.items():
        cfg, pcfg, state, tree = init[name]
        key = (arch, tcfg, id(batch))
        if key not in jitted:
            new, metrics = jax.jit(lambda s, b, cfg=cfg, tcfg=tcfg:
                                   ref_loop.train_step(s, b, cfg, tcfg))(
                state, batch)
            port = convert.train_state(tree, pcfg, CPU)
            pm = loop.train_step(port, batch, pcfg, _port_tcfg(tcfg))
            jitted[key] = (jax.tree.map(np.asarray, new), metrics, port, pm)
        ref[name] = jitted[key][:2]
        one[name] = jitted[key][2:]
    dec = {}
    for arch in DECODE:
        cfg, params, prompts = _decode_inputs(arch)
        pcfg = convert.model_config(dataclasses.asdict(cfg))
        model = convert.lm_model(jax.tree.map(np.asarray, params), pcfg, CPU)
        tokens = Engine(model, pcfg, ServeConfig(max_len=20, batch_size=4)
                        ).generate(prompts, 8)
        dec[arch] = (_ref_greedy(cfg, params, prompts, 8, 20), tokens)
    ranks.results()
    return ranks, steps, ref, one, dec


class _Got:
    """A rank's step result in the shape `_check_step` reads."""

    def __init__(self, got):
        self.step = got["step"]
        self.opt = type("Opt", (), {"step": got["opt_step"],
                                    "m": _tensors(got["m"]),
                                    "v": _tensors(got["v"])})
        self._params = _tensors(got["params"])

    def params(self):
        return self._params


def _tensors(d):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
            d.items()}


def _bar_of(name):
    arch = name.split("/")[0]
    if "/gw/" in name:
        return GW_F32
    if "/gather/" in name:
        return GATHER_BF16
    return _bar(arch)


@pytest.mark.parametrize("name", list(_cases()))
def test_sharded_step_matches_reference(world, name):
    """The sharded step against the reference's one-device step, at the
    train step tests' bars (tests/_torch_train.py)."""
    ranks, _, ref, _, _ = world
    got = ranks.case(name)
    new, metrics = ref[name]
    _check_step(new, metrics, _Got(got),
                {k: torch.tensor(v) for k, v in got["metrics"].items()},
                _bar_of(name))
    assert np.isfinite(got["metrics"]["loss"])


@pytest.mark.parametrize("name", list(_cases()))
def test_one_process_step_matches_reference(world, name):
    """The port's one-process step on the same inputs, at the same
    bars."""
    _, _, ref, one, _ = world
    new, metrics = ref[name]
    port, pm = one[name]
    _check_step(new, metrics, port, pm, _bar_of(name))


@pytest.mark.parametrize("name", list(_cases()))
def test_every_rank_holds_the_same_result(world, name):
    """The metrics are the same 0-d values on every rank, and so is every
    full tensor of the new state."""
    ranks = world[0]
    first = ranks.case(name, 0)
    for r in range(1, 4):
        other = ranks.case(name, r)
        assert other["metrics"] == first["metrics"]
        for k in first["params"]:
            np.testing.assert_array_equal(other["params"][k],
                                          first["params"][k])
            np.testing.assert_array_equal(other["m"][k], first["m"][k])


@pytest.mark.parametrize("name", list(_cases()))
def test_layout_follows_the_specs(world, name):
    """Every rank: each parameter's placements follow its spec and its
    local shard is the reference's block at its mesh coordinates; each
    moment follows its ZeRO spec, and one that `zero_specs` shards over
    ``data`` holds 1/|data| of its parameter's local elements."""
    ranks = world[0]
    checked = 0
    for r in range(4):
        lay = ranks.case(name, r)["layout"]
        assert lay["placements"] == [], lay["placements"]
        assert lay["block"] == [], lay["block"]
        assert lay["zero"] == [], lay["zero"]
        checked += lay["zero_checked"]
    if name.split("/")[1] in ("2d", "dp", "gw", "gather"):
        assert checked > 0


def test_gather_is_one_bf16_all_gather_per_slot_parameter(world):
    """``gather_params`` on a mesh: one bf16 all-gather per non-shared
    slot parameter and period (each microbatch runs every period), per
    mesh dim the parameter is sharded on
    (the reference's ``with_sharding_constraint(a.astype(bf16), P())``).
    The step's other bf16 collectives are the reductions of those bf16
    parameters' gradients."""
    ranks = world[0]
    got = ranks.case("smollm-360m/gather/2x2")
    cfg = convert.model_config(dataclasses.asdict(_f32(
        ref_configs.get_smoke("smollm-360m"))))
    shapes = {k: tuple(v.shape) for k, v in got["params"].items()}
    specs = sharding.param_specs(shapes, {"data": 2, "model": 2})
    per_period = sum(len(sharding._used(s)) for k, s in specs.items()
                     if k.startswith("stack.scanned."))
    want = per_period * GATHER_TCFG.microbatches
    assert per_period > 0 and cfg.repeats == 2
    bf16 = [o["kind"] for o in got["collectives"]
            if o["dtype"] == "c10::BFloat16"]
    assert bf16.count("all-gather") == want
    assert set(bf16) == {"all-gather", "all-reduce"}


@pytest.mark.parametrize("name", ["smollm-360m/2d/2x2",
                                  "smollm-360m/dp/4x1"])
def test_step_collectives_by_kind(world, name):
    """A sharded step's collectives: the gradients' reductions and the
    ZeRO-1 all-gather of the updated parameters, with their bytes."""
    got = world[0].case(name)["collectives"]
    kinds = {o["kind"] for o in got}
    assert {"all-reduce", "all-gather"} <= kinds
    assert all(o["payload_bytes"] > 0 and o["wire_bytes"]
               >= o["payload_bytes"] for o in got)


@pytest.fixture(scope="module")
def known(world):
    return world[0].case("collectives")


def test_known_collectives_counts(known):
    """An all-reduce of an f32 (16, 128) and an all-gather of a bf16
    (1024, 8): tests/test_losses_serve.py:120-140's program without the
    loop factor, read from a profiler trace of 4 ranks."""
    assert known["counts"] == {"all-reduce": 1, "all-gather": 1}
    assert known["payload_bytes"] == 1024 * 8 * 2 + 16 * 128 * 4
    assert known["wire_bytes"] == 1024 * 8 * 2 + 2 * 16 * 128 * 4


@pytest.mark.parametrize("arch", list(DECODE))
def test_sharded_decode_matches_reference(world, arch):
    """Prefill + 8 greedy decode steps of a batch of 4 12-token prompts on
    (2, 2): the one-process engine's tokens, and each step's logits
    within the LM parity bar of the reference's."""
    ranks, _, _, _, dec = world
    got = ranks.case(f"decode/{arch}")
    (want_tokens, want_logits), engine_tokens = dec[arch]
    np.testing.assert_array_equal(got["tokens"], engine_tokens)
    np.testing.assert_array_equal(got["tokens"], want_tokens)
    np.testing.assert_allclose(got["logits"], want_logits, **LM_F32)


@pytest.mark.parametrize("arch", list(DECODE))
def test_sharded_decode_caches_are_sharded(world, arch):
    """The caches lie on the mesh by `cache_specs`: batch over ``data``
    and a dim over ``model``."""
    got = world[0].case(f"decode/{arch}")
    assert any("Shard(dim=0)" in p and p.count("Shard") == 2
               for p in got["cache_sharded"]), got["cache_sharded"]


def test_decode_same_on_every_rank(world):
    ranks = world[0]
    for arch in DECODE:
        first = ranks.case(f"decode/{arch}", 0)
        for r in range(1, 4):
            other = ranks.case(f"decode/{arch}", r)
            np.testing.assert_array_equal(other["tokens"], first["tokens"])
            np.testing.assert_array_equal(other["logits"], first["logits"])
