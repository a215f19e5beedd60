"""The port's LM substrate (``repro_torch.models``) against the reference
(``repro.models``) on the CPU, in f32: the layers on the same inputs, and
every architecture's ``smoke()`` model with the reference's parameters
carried across by `repro_torch.convert.lm_model`.  The reference runs
under ``jax.jit``.

Bars.  ``F32`` (atol = rtol = 1e-5): both sides compute the same f32
arithmetic, but XLA's CPU dots and reductions sum in another order than
PyTorch's, a few ulp of O(1) values per product of ≤ a few hundred terms,
compounded over ≤ 3 layers.  Two exceptions, each measured by
``tests/lm_spreads.py``: the MoE layer's outputs reach ~190 (its (e, d,
ff) experts draw std e^-½ = 0.5, the reference's init rule), so its atol
is 1e-6 of the largest output (the port and the reference each sit
0.9–1.0e-4 from an f64 evaluation there; ``moe_f64``); and xLSTM's sLSTM
recurrence (exp gates over 40 steps) turns a one-ulp change of the
embedding into 0.8–1.3e-5 of the logits (three draws; ``xlstm_ulp``), so
``XLSTM_F32`` has atol 5e-5 and rtol 1e-4.  Cache lengths are equal.
"""
import dataclasses
import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import attention as ref_attention
from repro.models import common as ref_common
from repro.models import lm as ref_lm
from repro.models import mlp as ref_mlp
from repro.models import ssm as ref_ssm
from repro_torch import configs, convert
from repro_torch.models import attention, common, lm, mlp, ssm

F32 = dict(atol=1e-5, rtol=1e-5)
XLSTM_F32 = dict(atol=5e-5, rtol=1e-4)
CPU = torch.device("cpu")


def _rng(*key):
    """A generator seeded by the test's own key, so that a test's inputs do
    not depend on which tests ran before it."""
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _t(x):
    return torch.tensor(np.asarray(x))


def _close(got, want, what="", **bar):
    np.testing.assert_allclose(got.detach().numpy() if isinstance(
        got, torch.Tensor) else got, np.asarray(want), err_msg=what,
        **(bar or F32))


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def _cfgs(arch):
    ref = _f32(ref_configs.get_smoke(arch))
    return ref, convert.model_config(dataclasses.asdict(ref))


def _module(cls, cfg, tree, *args):
    """A port layer module holding the reference layer's parameters."""
    mod = cls(cfg, None, *args, device="meta")
    mod.load_state_dict(convert.lm_params(tree, CPU), strict=True,
                        assign=True)
    return mod


# ---------------------------------------------------------------------------
# norms and RoPE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm",
                                  "layernorm_nonparam"])
def test_apply_norm(norm):
    ref_cfg, cfg = _cfgs("starcoder2-15b")
    ref_cfg = dataclasses.replace(ref_cfg, norm=norm)
    cfg = dataclasses.replace(cfg, norm=norm)
    RNG = _rng("norm", norm)
    x = _np(RNG.normal(size=(2, 5, 64)) * 3 + 1)
    params = {k: _np(RNG.normal(size=64)) for k in
              {"rmsnorm": ["scale"], "layernorm": ["scale", "bias"],
               "layernorm_nonparam": []}[norm]}
    want = jax.jit(functools.partial(ref_common.apply_norm, cfg=ref_cfg))(
        params, x)
    got = common.apply_norm({k: _t(v) for k, v in params.items()}, _t(x),
                            cfg)
    _close(got, want)


def test_apply_rope():
    """Positions below 256: the jit-compiled reference's f32 sin and cos
    of large angles differ from PyTorch's by more than F32 (4.7e-5 at
    positions near 5000, 1.9e-6 below 256; ``tests/lm_spreads.py
    rope_large``), with the same angles."""
    RNG = _rng("rope")
    x = _np(RNG.normal(size=(2, 9, 3, 16)))
    pos = RNG.integers(0, 256, (2, 9))
    want = jax.jit(functools.partial(ref_common.apply_rope, theta=1e6))(
        x, pos)
    _close(common.apply_rope(_t(x), _t(pos), 1e6), want)


def test_apply_m_rope():
    """qwen2-vl's sections for hd = 16: (8 − 2·2, 2, 2) pairs; (t, h, w)
    ids not all equal."""
    RNG = _rng("m_rope")
    x = _np(RNG.normal(size=(2, 9, 4, 16)))
    pos = RNG.integers(0, 64, (2, 9, 3))
    want = jax.jit(functools.partial(ref_common.apply_m_rope, theta=1e4,
                                     sections=(4, 2, 2)))(x, pos)
    _close(common.apply_m_rope(_t(x), _t(pos), 1e4, (4, 2, 2)), want)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

ATTN_CASES = {
    # name: (sq, sk, h, kv, hd, hdv, causal, window, q_offset, chunk)
    "causal": (40, 40, 4, 4, 16, 16, True, None, 0, 1024),
    "causal_chunked": (40, 40, 4, 4, 16, 16, True, None, 0, 8),
    "windowed_chunked": (40, 40, 4, 2, 16, 16, True, 5, 0, 8),
    "q_offset": (16, 40, 4, 2, 16, 16, True, None, 24, 8),
    "q_offset_windowed": (16, 40, 4, 1, 16, 16, True, 9, 24, 8),
    "gqa": (24, 24, 6, 2, 8, 8, True, None, 0, 1024),
    "mla_hd_ne_hdv": (24, 24, 4, 4, 24, 16, True, None, 0, 8),
    "not_causal": (12, 20, 4, 2, 16, 16, False, None, 0, 8),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_chunked_attention(case):
    sq, sk, h, kv, hd, hdv, causal, window, q_offset, chunk = ATTN_CASES[case]
    RNG = _rng("attention", case)
    q = _np(RNG.normal(size=(2, sq, h, hd)))
    k = _np(RNG.normal(size=(2, sk, kv, hd)))
    v = _np(RNG.normal(size=(2, sk, kv, hdv)))
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              q_chunk=chunk, k_chunk=chunk)
    want = jax.jit(functools.partial(ref_attention.chunked_attention,
                                     **kw))(q, k, v)
    got = attention.chunked_attention(_t(q), _t(k), _t(v), **kw)
    assert got.shape == (2, sq, h, hdv)
    _close(got, want)


@pytest.mark.parametrize("n_valid", [1, 13, 20])
def test_decode_attention(n_valid):
    RNG = _rng("decode_attention", n_valid)
    q = _np(RNG.normal(size=(2, 1, 6, 16)))
    kc = _np(RNG.normal(size=(2, 20, 2, 16)))
    vc = _np(RNG.normal(size=(2, 20, 2, 16)))
    want = jax.jit(ref_attention.decode_attention)(q, kc, vc, n_valid)
    _close(attention.decode_attention(_t(q), _t(kc), _t(vc), n_valid), want)


# ---------------------------------------------------------------------------
# recurrent layers
# ---------------------------------------------------------------------------

def _gla_inputs(b, s, h, dk, dv):
    RNG = _rng("gla", b, s, h, dk, dv)
    return (_np(RNG.normal(size=(b, s, h, dk))),
            _np(RNG.normal(size=(b, s, h, dk)) * 0.3),
            _np(RNG.normal(size=(b, s, h, dv))),
            _np(-RNG.uniform(0.0, 0.5, size=(b, s, h))))


@pytest.mark.parametrize("s,with_state", [(300, False), (300, True),
                                          (64, True)])
def test_gla_chunked(s, with_state):
    """300 is no multiple of the 128-step chunk: the last chunk pads."""
    q, k, v, log_f = _gla_inputs(2, s, 3, 8, 5)
    s0 = _np(_rng("state0").normal(size=(2, 3, 8, 5))) if with_state else None
    want_y, want_s = jax.jit(ref_ssm.gla_chunked)(q, k, v, log_f, state0=s0)
    y, state = ssm.gla_chunked(_t(q), _t(k), _t(v), _t(log_f),
                               state0=None if s0 is None else _t(s0))
    _close(y, want_y)
    _close(state, want_s)


def test_gla_decode_step_over_a_sequence():
    q, k, v, log_f = _gla_inputs(2, 10, 3, 8, 5)
    step = jax.jit(ref_ssm.gla_decode_step)
    S_ref = jnp.zeros((2, 3, 8, 5), jnp.float32)
    S = torch.zeros((2, 3, 8, 5))
    for t in range(10):
        sl = slice(t, t + 1)
        S_ref, y_ref = step(S_ref, q[:, sl], k[:, sl], v[:, sl],
                            log_f[:, sl])
        S, y = ssm.gla_decode_step(S, _t(q[:, sl]), _t(k[:, sl]),
                                   _t(v[:, sl]), _t(log_f[:, sl]))
        _close(y, y_ref, f"step {t}")
    _close(S, S_ref)
    # and the recurrence is the chunked form's
    _, S_chunk = ssm.gla_chunked(_t(q), _t(k), _t(v), _t(log_f))
    _close(S, S_chunk.numpy())


MIXERS = {"mlstm": ("xlstm-350m", ref_ssm.mlstm_init, ref_ssm.mlstm_apply,
                    ssm.MLSTM, ref_ssm.mlstm_cache_init),
          "slstm": ("xlstm-350m", ref_ssm.slstm_init, ref_ssm.slstm_apply,
                    ssm.SLSTM, ref_ssm.slstm_cache_init),
          "mamba": ("zamba2-7b", ref_ssm.mamba2_init, ref_ssm.mamba2_apply,
                    ssm.Mamba2, ref_ssm.mamba2_cache_init)}


def _cache_leaves(c):
    for k in sorted(c):
        if k == "carry":
            yield from ((f"carry{i}", a) for i, a in enumerate(c[k]))
        elif k != "length":
            yield k, c[k]


@pytest.mark.parametrize("kind", list(MIXERS))
def test_mixer_prefill_then_decode(kind):
    """No cache over 12 steps; then a prefill of 9 steps into a cache and 3
    decode steps from it (Mamba2's conv buffer included): outputs and
    caches against the reference's."""
    arch, init, apply, cls, cache_init = MIXERS[kind]
    ref_cfg, cfg = _cfgs(arch)
    tree = init(jax.random.PRNGKey(3), ref_cfg)
    mod = _module(cls, cfg, tree)
    x = _np(_rng("mixer", kind).normal(size=(2, 12, ref_cfg.d_model)))
    run = jax.jit(lambda p, x, c: apply(p, x, ref_cfg, cache=c))
    with torch.no_grad():
        want, _ = run(tree, x, None)
        got, _ = mod(_t(x), cfg)
        _close(got, want, "no cache")
        ref_c = cache_init(ref_cfg, 2, jnp.float32)
        c = {k: v for k, v in convert.lm_caches(
            {"prologue": [jax.tree.map(np.asarray, ref_c)], "body": {}},
            dataclasses.replace(cfg, num_layers=1, prologue=("x",),
                                block_template=("x",)),
            CPU)["prologue"][0].items()}
        want, ref_c = run(tree, x[:, :9], ref_c)
        got, c = mod(_t(x[:, :9]), cfg, cache=c)
        _close(got, want, "prefill")
        for t in range(9, 12):
            want, ref_c = run(tree, x[:, t:t + 1], ref_c)
            got, c = mod(_t(x[:, t:t + 1]), cfg, cache=c)
            _close(got, want, f"decode {t}")
        for (name, a), (_, b) in zip(_cache_leaves(c), _cache_leaves(ref_c)):
            _close(a, b, name)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,cf", [("mixtral-8x22b", 4.0),
                                     ("mixtral-8x22b", 0.5),
                                     ("deepseek-v2-lite-16b", 0.75)])
def test_moe(arch, cf):
    """cf < 1 forces capacity drops (cap = int(g·topk/e·cf)); deepseek's
    smoke config adds a shared expert.  Groups of 24 tokens out of 72."""
    ref_cfg, cfg = _cfgs(arch)
    ref_cfg = dataclasses.replace(ref_cfg, moe_capacity_factor=cf,
                                  moe_group_size=30)
    cfg = dataclasses.replace(cfg, moe_capacity_factor=cf,
                              moe_group_size=30)
    tree = ref_mlp.moe_init(jax.random.PRNGKey(5), ref_cfg)
    mod = _module(mlp.MoE, cfg, tree)
    x = _np(_rng("moe", arch, cf).normal(size=(3, 24, ref_cfg.d_model)))
    want, want_aux = jax.jit(functools.partial(ref_mlp.moe_apply,
                                               cfg=ref_cfg))(tree, x)
    with torch.no_grad():
        got, aux = mod(_t(x), cfg)
    assert mlp.group_size(72, 30) == 24
    _close(got, want, atol=1e-6 * float(np.abs(want).max()), rtol=1e-5)
    _close(aux, want_aux)


def test_top_k_ties_lower_index_first():
    probs = np.array([[0.2, 0.3, 0.2, 0.3], [0.25, 0.25, 0.25, 0.25]],
                     np.float32)
    want_v, want_i = jax.lax.top_k(probs, 3)
    got_v, got_i = mlp.top_k_stable(_t(probs), 3)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


# ---------------------------------------------------------------------------
# the model: forward, prefill, decode, for every architecture
# ---------------------------------------------------------------------------

B, S, N_PRE = 2, 40, 37   # 40 > the smoke windows (mixtral's 32): a ring


def _inputs(cfg):
    RNG = _rng("model", cfg.name)
    if cfg.input_mode == "tokens":
        return {"tokens": RNG.integers(0, cfg.vocab_size, (B, S))}
    batch = {"embeddings": _np(RNG.normal(size=(B, S, cfg.d_model)) * 0.1)}
    if cfg.m_rope:   # a (t, h, w) grid of 4 × 10 patches, not all equal
        i = np.arange(S)
        batch["positions"] = np.broadcast_to(
            np.stack([i // 20, (i // 10) % 2 + i // 20, i % 10], -1),
            (B, S, 3)).copy()
    return batch


def _part(batch, lo, hi):
    return {k: v[:, lo:hi] for k, v in batch.items()}


class _Ref:
    """One architecture's reference side: parameters, forward over S
    tokens, prefill of N_PRE and three decode steps, under jax.jit."""

    def __init__(self, arch):
        self.cfg, self.port_cfg = _cfgs(arch)
        cfg = self.cfg
        self.params = ref_lm.init_params(jax.random.PRNGKey(0), cfg)
        self.tree = jax.tree.map(np.asarray, self.params)
        self.batch = _inputs(cfg)
        self.logits, self.aux = jax.jit(
            lambda p, b: ref_lm.forward(p, b, cfg))(self.params, self.batch)
        caches = ref_lm.cache_init(cfg, B, S + 4, jnp.float32)
        self.pre_logits, self.caches = jax.jit(
            lambda p, b, c: ref_lm.prefill(p, b, cfg, c))(
                self.params, _part(self.batch, 0, N_PRE), caches)
        decode = jax.jit(lambda p, b, c, pos: ref_lm.decode_step(
            p, b, c, cfg, position=pos))
        self.dec_logits, c = [], self.caches
        for t in range(N_PRE, S):
            step = _part(self.batch, t, t + 1)
            pos = step.pop("positions", None)
            lg, c = decode(self.params, step, c, pos)
            self.dec_logits.append(lg)


@functools.lru_cache(maxsize=None)
def _ref(arch):
    return _Ref(arch)


def _bar(arch):
    return XLSTM_F32 if arch == "xlstm-350m" else F32


def _port_batch(batch):
    return {k: _t(v) for k, v in batch.items()}


def _port(arch):
    ref = _ref(arch)
    return ref, convert.lm_model(ref.tree, ref.port_cfg, CPU)


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_forward_matches_reference(arch):
    ref, model = _port(arch)
    with torch.no_grad():
        logits, aux = lm.forward(model, _port_batch(ref.batch), ref.port_cfg)
    assert logits.dtype == torch.float32
    _close(logits, ref.logits, **_bar(arch))
    _close(aux, ref.aux)


def _caches_close(got, want, cfg, bar):
    want = convert.lm_caches(jax.tree.map(np.asarray, want), cfg, CPU)
    pairs = list(zip(got["prologue"], want["prologue"]))
    for g, w in zip(got["body"], want["body"]):
        pairs += [(g[k], w[k]) for k in sorted(w)]
    for i, (g, w) in enumerate(pairs):
        assert g.get("length") == w.get("length"), i
        for (name, a), (_, b) in zip(_cache_leaves(g), _cache_leaves(w)):
            _close(a, b, f"cache {i} {name}", **bar)


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """Prefill logits and caches, then three decode steps, each the
    reference's; and the port's own forward at those positions."""
    ref, model = _port(arch)
    cfg = ref.port_cfg
    batch = _port_batch(ref.batch)
    with torch.no_grad():
        caches = lm.cache_init(cfg, B, S + 4, torch.float32, CPU)
        lg, caches = lm.prefill(model, _part(batch, 0, N_PRE), cfg, caches)
        _close(lg, ref.pre_logits, "prefill", **_bar(arch))
        _caches_close(caches, ref.caches, cfg, _bar(arch))
        full, _ = lm.forward(model, batch, cfg)
        for i, t in enumerate(range(N_PRE, S)):
            step = _part(batch, t, t + 1)
            pos = step.pop("positions", None)
            lg, caches = lm.decode_step(model, step, caches, cfg,
                                        position=pos)
            _close(lg, ref.dec_logits[i], f"decode {t}", **_bar(arch))
            _close(lg, full[:, t].numpy(), f"decode {t} against forward",
                   **_bar(arch))


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_decode_from_reference_caches(arch):
    """Decode continues from the reference's prefill caches, carried
    across by `convert.lm_caches`."""
    ref, model = _port(arch)
    cfg = ref.port_cfg
    caches = convert.lm_caches(jax.tree.map(np.asarray, ref.caches), cfg,
                               CPU)
    step = _port_batch(_part(ref.batch, N_PRE, N_PRE + 1))
    pos = step.pop("positions", None)
    with torch.no_grad():
        lg, _ = lm.decode_step(model, step, caches, cfg, position=pos)
    _close(lg, ref.dec_logits[0], **_bar(arch))


def test_loss_fn_matches_reference():
    ref, model = _port("smollm-360m")
    batch = dict(ref.batch, labels=np.where(
        _rng("labels").random((B, S)) < 0.2, -1, ref.batch["tokens"]))
    want, want_parts = jax.jit(lambda p, b: ref_lm.loss_fn(p, b, ref.cfg))(
        ref.params, batch)
    with torch.no_grad():
        got, parts = lm.loss_fn(model, _port_batch(batch), ref.port_cfg)
    _close(got, want)
    _close(parts["ce"], want_parts["ce"])
