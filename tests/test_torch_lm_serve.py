"""The port's LM serving path against the reference on the CPU: the
configs, `repro_torch.convert`'s model config, parameters and caches, the
`Engine` (greedy logits at every step against the reference engine's, EOS,
seeded sampling) and ``launch.serve``'s LM driver.  The reference runs
under ``jax.jit``.

Bar: f32 logits atol = rtol = 1e-5 (``F32``, as in
``tests/test_torch_models.py``: the same arithmetic summed in another
order).  Tokens are compared where the reference's top-2 logit gap exceeds
10× the bar, so that a near tie cannot flip a token.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import lm as ref_lm
from repro.serve.engine import Engine as RefEngine
from repro.serve.engine import ServeConfig as RefServeConfig
from repro_torch import configs, convert
from repro_torch.launch import serve as launch_serve
from repro_torch.models import lm
from repro_torch.serve.engine import Engine, ServeConfig

F32 = dict(atol=1e-5, rtol=1e-5)
CPU = torch.device("cpu")
TOKEN_ARCHS = [a for a in configs.ARCHS
               if configs.get_smoke(a).input_mode == "tokens"]


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def _ref_model(arch, seed=0):
    cfg = _f32(ref_configs.get_smoke(arch))
    params = ref_lm.init_params(jax.random.PRNGKey(seed), cfg)
    port_cfg = convert.model_config(dataclasses.asdict(cfg))
    model = convert.lm_model(jax.tree.map(np.asarray, params), port_cfg, CPU)
    return cfg, params, port_cfg, model


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["get", "get_smoke"])
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_configs_equal_the_reference(arch, which):
    port = getattr(configs, which)(arch)
    ref = getattr(ref_configs, which)(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert (port.hd, port.repeats, port.sub_quadratic) == \
        (ref.hd, ref.repeats, ref.sub_quadratic)
    assert port.compute_dtype == getattr(torch, ref.dtype)
    for name, shape in configs.SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(
            ref_configs.SHAPES[name])
        assert configs.applicable(port, shape) == ref_configs.applicable(
            ref, ref_configs.SHAPES[name])


def test_registry_equals_the_reference():
    assert configs.ARCHS == ref_configs.ARCHS
    assert list(configs.SHAPES) == list(ref_configs.SHAPES)


# ---------------------------------------------------------------------------
# convert: every leaf of the reference's tree, and back
# ---------------------------------------------------------------------------

def _back(model, cfg):
    """The reference's tree rebuilt from the port's parameters: a scanned
    slot's repeats stacked again."""
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    flat = {}
    for name, arr in sd.items():
        parts = name.split(".")
        if parts[:2] == ["stack", "scanned"]:
            key = tuple(parts[:3] + parts[4:])
            flat.setdefault(key, {})[int(parts[3])] = arr
        else:
            flat[tuple(parts)] = arr
    return {k: (np.stack([v[r] for r in range(cfg.repeats)])
                if isinstance(v, dict) else v) for k, v in flat.items()}


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_lm_params_round_trip_covers_every_leaf(arch):
    """Stacked slots (every arch), a shared slot (zamba2: kept once), a tied
    head (smollm, olmo, xlstm: no ``head``) and untied ones."""
    cfg, params, port_cfg, model = _ref_model(arch)
    leaves = {tuple(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path): np.asarray(leaf)
              for path, leaf in jax.tree_util.tree_leaves_with_path(params)}
    back = _back(model, port_cfg)
    assert set(back) == set(leaves)
    for key, leaf in leaves.items():
        np.testing.assert_array_equal(back[key], leaf, err_msg=str(key))
    names = set(model.state_dict())
    assert ("head" in names) == (not (cfg.tie_embeddings
                                      and cfg.input_mode == "tokens"))
    for si in cfg.shared_slots:
        assert not any(n.startswith(f"stack.scanned.slot{si}.")
                       for n in names)
        shared = model.stack.shared[f"slot{si}"]
        assert all(model.stack.layer(si, r) is shared
                   for r in range(cfg.repeats))


def test_lm_caches_from_the_reference():
    """cache_init's stacked body caches split into one dict a repeat, the
    lengths host ints, sLSTM's carry a 4-tuple."""
    cfg = _f32(ref_configs.get_smoke("xlstm-350m"))
    port_cfg = convert.model_config(dataclasses.asdict(cfg))
    ref = jax.tree.map(np.asarray, ref_lm.cache_init(cfg, 2, 8, np.float32))
    got = convert.lm_caches(ref, port_cfg, CPU)
    want = lm.cache_init(port_cfg, 2, 8, torch.float32, CPU)
    assert len(got["body"]) == len(want["body"]) == port_cfg.repeats
    for g, w in zip(got["body"], want["body"]):
        assert g.keys() == w.keys()
        assert len(g["slot0"]["carry"]) == 4
        for a, b in zip(g["slot0"]["carry"], w["slot0"]["carry"]):
            assert a.shape == b.shape and a.dtype == b.dtype
        assert g["slot1"]["state"].shape == w["slot1"]["state"].shape


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _ref_greedy(cfg, params, prompts, n, max_len, eos_id=-1):
    """The reference engine's loop with each step's logits kept (its
    tokens are checked against `repro.serve.engine.Engine`'s)."""
    b = prompts.shape[0]
    prefill = jax.jit(lambda p, t, c: ref_lm.prefill(p, {"tokens": t}, cfg,
                                                     c))
    decode = jax.jit(lambda p, t, c: ref_lm.decode_step(p, {"tokens": t}, c,
                                                        cfg))
    caches = ref_lm.cache_init(cfg, b, max_len, np.float32)
    logits, caches = prefill(params, prompts, caches)
    seen, out = [np.asarray(logits)], []
    tok = np.argmax(seen[-1], -1)
    done = np.zeros(b, bool)
    for _ in range(n):
        out.append(tok)
        done = done | (tok == eos_id)
        logits, caches = decode(params, tok[:, None], caches)
        seen.append(np.asarray(logits))
        tok = np.where(done, tok, np.argmax(seen[-1], -1))
    return np.stack(out, 1), np.stack(seen, 1)


def _check_greedy(got_tokens, got_logits, want_tokens, want_logits):
    """Logits at each step; tokens where the reference's top-2 gap is wide.
    Stops at a near tie that flipped a token: the sequences part there."""
    got_logits = got_logits.numpy()
    for t in range(want_tokens.shape[1] + 1):
        np.testing.assert_allclose(got_logits[:, t], want_logits[:, t],
                                   err_msg=f"step {t}", **F32)
        if t == want_tokens.shape[1]:
            break
        top2 = np.sort(want_logits[:, t], -1)[:, -2:]
        wide = top2[:, 1] - top2[:, 0] > 10 * F32["atol"]
        np.testing.assert_array_equal(got_tokens[wide, t],
                                      want_tokens[wide, t])
        if (got_tokens[:, t] != want_tokens[:, t]).any():
            break


@pytest.mark.parametrize("arch,prompts,n,max_len", [
    ("smollm-360m", [[1, 2, 3, 4], [5, 6, 7, 8]], 8, 64),
    ("olmo-1b", [[3, 1, 4, 1, 5]], 1, 32)])
def test_engine_matches_reference_engine(arch, prompts, n, max_len):
    """``tests/test_losses_serve.py``'s two engine cases."""
    cfg, params, port_cfg, model = _ref_model(arch)
    prompts = np.array(prompts, np.int32)
    b = prompts.shape[0]
    want = RefEngine(params, cfg, RefServeConfig(max_len=max_len,
                                                 batch_size=b)).generate(
        prompts, max_new_tokens=n)
    want_tokens, want_logits = _ref_greedy(cfg, params, prompts, n, max_len)
    np.testing.assert_array_equal(want_tokens, want)
    eng = Engine(model, port_cfg, ServeConfig(max_len=max_len, batch_size=b))
    tokens, logits = eng.generate(prompts, n, return_logits=True)
    assert tokens.shape == (b, n) and logits.shape == (b, n + 1,
                                                       cfg.vocab_size)
    _check_greedy(tokens, logits, want_tokens, want_logits)
    np.testing.assert_array_equal(eng.generate(prompts, n), tokens)


@pytest.mark.parametrize("arch", [a for a in TOKEN_ARCHS
                                  if a not in ("smollm-360m", "olmo-1b")])
def test_engine_greedy_every_token_arch(arch):
    cfg, params, port_cfg, model = _ref_model(arch, seed=1)
    prompts = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 6)).astype(np.int32)
    want_tokens, want_logits = _ref_greedy(cfg, params, prompts, 6, 16)
    eng = Engine(model, port_cfg, ServeConfig(max_len=16, batch_size=2))
    tokens, logits = eng.generate(prompts, 6, return_logits=True)
    _check_greedy(tokens, logits, want_tokens, want_logits)


def test_engine_eos_repeats_its_token():
    """A request that emitted EOS keeps repeating it, as the reference's."""
    cfg, params, port_cfg, model = _ref_model("smollm-360m")
    prompts = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    free = RefEngine(params, cfg, RefServeConfig(max_len=32, batch_size=2)
                     ).generate(prompts, 8)
    eos = int(free[0, 2])
    want = RefEngine(params, cfg, RefServeConfig(
        max_len=32, batch_size=2, eos_id=eos)).generate(prompts, 8)
    got = Engine(model, port_cfg, ServeConfig(
        max_len=32, batch_size=2, eos_id=eos)).generate(prompts, 8)
    np.testing.assert_array_equal(got, want)
    first = int(np.argmax(got[0] == eos))
    assert (got[0, first:] == eos).all()


def test_engine_sampling_repeats_with_its_seed():
    """Temperature sampling draws from a torch.Generator seeded with
    ``rng_seed`` (the reference's ``jax.random`` bits cannot be redrawn):
    the same seed repeats, another seed draws otherwise."""
    _, _, port_cfg, model = _ref_model("smollm-360m")
    scfg = ServeConfig(max_len=32, batch_size=2, temperature=0.8)
    prompts = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    a = Engine(model, port_cfg, scfg, rng_seed=7).generate(prompts, 12)
    b = Engine(model, port_cfg, scfg, rng_seed=7).generate(prompts, 12)
    c = Engine(model, port_cfg, scfg, rng_seed=8).generate(prompts, 12)
    np.testing.assert_array_equal(a, b)
    assert (a != c).any()
    assert ((a >= 0) & (a < port_cfg.vocab_size)).all()


def test_engine_refuses_a_wrong_batch():
    _, _, port_cfg, model = _ref_model("smollm-360m")
    eng = Engine(model, port_cfg, ServeConfig(max_len=16, batch_size=2))
    with pytest.raises(ValueError):
        eng.generate(np.zeros((3, 4), np.int32), 2)


def test_no_card_no_fallback():
    """Without a device the model and its caches go to the card, and raise
    where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    cfg = configs.get_smoke("smollm-360m")
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.cache_init(cfg, 1, 8, torch.float32)


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["smollm-360m", "zamba2-7b"])
def test_launch_serve_lm_on_the_cpu(arch, capsys):
    launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "5", "--max-new",
                       "4"])
    out = capsys.readouterr().out.splitlines()
    assert "(float32) on cpu" in out[0]
    rows = [ln for ln in out if ln.startswith("request ")]
    assert len(rows) == 2 and all(len(json.loads(r.split(": ", 1)[1])) == 4
                                  for r in rows)
    assert out[-1].startswith("8 tokens in ") and out[-1].endswith("tok/s)")


def test_launch_serve_ckpt_dir_names_the_trainer(tmp_path):
    """--ckpt-dir restores a checkpoint of the trainer
    (tests/test_torch_train_launch.py serves one); a directory without one
    exits naming the trainer that writes them."""
    with pytest.raises(SystemExit) as exc:
        launch_serve.main(["--smoke", "--device", "cpu", "--ckpt-dir",
                           str(tmp_path / "empty")])
    assert "repro_torch.launch.train" in str(exc.value.code)
