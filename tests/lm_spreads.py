"""The measurements behind the LM substrate's parity bars, on the CPU:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/lm_spreads.py [case ...]

Cases: ``xlstm_ulp`` (smoke xLSTM: how far a one-ulp change of the
embedding moves the port's logits; tests/test_torch_models.py's
``XLSTM_F32``), ``moe_f64`` (the smoke MoE layer, port and reference, each
against the reference in float64; its scaled atol), ``rope_large`` (RoPE
at positions near 5000, port against reference; why the parity test stays
below 256), ``mla_bf16`` (the reference's own bf16 distances on smoke
deepseek: why chip_smoke's P(b) bf16 bar is a median) and
``xlstm_chaos`` (xLSTM at full width, 8 layers, the port: a one-ulp
change of every weight, against reordered f32 sums and decode against
forward, position by position; chip_smoke's ``P_ENVELOPE``; ~1 GiB, a
minute).  Not a test: pytest does not collect it."""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

jax.config.update("jax_enable_x64", True)   # as tests/conftest.py sets it

from repro import configs as rc  # noqa: E402
from repro.models import common as rcommon  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro.models import mlp as rmlp  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.models import common, lm, mlp  # noqa: E402


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def _port_cfg(cfg):
    return convert.model_config(dataclasses.asdict(cfg))


def xlstm_ulp():
    cfg = _f32(rc.get_smoke("xlstm-350m"))
    params = rlm.init_params(jax.random.PRNGKey(0), cfg)
    tree = jax.tree.map(np.asarray, params)
    toks = torch.tensor(np.random.default_rng(1).integers(0, 256, (2, 40)))
    with torch.no_grad():
        base, _ = lm.forward(convert.lm_model(tree, _port_cfg(cfg), "cpu"),
                             {"tokens": toks}, _port_cfg(cfg))
        for draw in range(3):
            sign = np.random.default_rng(draw).choice([-1, 1],
                                                      tree["embed"].shape)
            moved = dict(tree, embed=(tree["embed"] * (
                1 + np.float32(6e-8) * sign)).astype(np.float32))
            got, _ = lm.forward(convert.lm_model(moved, _port_cfg(cfg),
                                                 "cpu"),
                                {"tokens": toks}, _port_cfg(cfg))
            print(f"xlstm_ulp draw {draw}: max |Δ logits| "
                  f"{float((got - base).abs().max()):.3e} (max |logit| "
                  f"{float(base.abs().max()):.3f})")


def moe_f64():
    for cf in (4.0, 0.5):
        cfg = dataclasses.replace(_f32(rc.get_smoke("mixtral-8x22b")),
                                  moe_group_size=30, moe_capacity_factor=cf)
        tree = rmlp.moe_init(jax.random.PRNGKey(5), cfg)
        mod = mlp.MoE(_port_cfg(cfg), None, device="meta")
        mod.load_state_dict(convert.lm_params(tree, "cpu"), assign=True)
        x = np.random.default_rng(0).normal(size=(3, 24, 64)).astype(
            np.float32)
        ref, _ = rmlp.moe_apply(tree, x, cfg)
        truth, _ = rmlp.moe_apply(
            jax.tree.map(lambda a: a.astype(jnp.float64), tree),
            x.astype(np.float64), dataclasses.replace(cfg, dtype="float64"))
        with torch.no_grad():
            got, _ = mod(torch.tensor(x), _port_cfg(cfg))
        ref, truth = np.asarray(ref), np.asarray(truth)
        print(f"moe_f64 cf {cf}: max |out| {np.abs(truth).max():.1f}; port "
              f"{np.abs(got.numpy() - truth).max():.3e} and reference "
              f"{np.abs(ref - truth).max():.3e} from f64, port from "
              f"reference {np.abs(got.numpy() - ref).max():.3e}")


def rope_large():
    x = np.random.default_rng(0).normal(size=(2, 9, 3, 16)).astype(np.float32)
    for hi in (256, 5000):
        pos = np.random.default_rng(1).integers(hi - 256, hi, (2, 9))
        want = np.asarray(jax.jit(rcommon.apply_rope, static_argnums=2)(
            x, pos, 1e6))
        got = common.apply_rope(torch.tensor(x), torch.tensor(pos),
                                1e6).numpy()
        rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-3)
        print(f"rope_large positions {hi - 256}–{hi}: max |Δ| "
              f"{np.abs(got - want).max():.3e}, max relative {rel.max():.3e}")


def mla_bf16():
    for seed in range(4):
        cfg = dataclasses.replace(rc.get_smoke("deepseek-v2-lite-16b"),
                                  moe_capacity_factor=2.0)
        params = rlm.init_params(jax.random.PRNGKey(seed), cfg)
        toks = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                    (2, 80))
        out = {}
        for c in (_f32(cfg), cfg):
            full, _ = rlm.forward(params, {"tokens": toks}, c)
            caches = rlm.cache_init(c, 2, 80, jnp.float32)
            lg, caches = rlm.prefill(params, {"tokens": toks[:, :64]}, c,
                                     caches)
            steps = [lg]
            for t in range(64, 80):
                lg, caches = rlm.decode_step(
                    params, {"tokens": toks[:, t:t + 1]}, caches, c)
                steps.append(lg)
            out[c.dtype] = (np.asarray(full[:, 63:]),
                            np.stack([np.asarray(s) for s in steps], 1))
        (f_fwd, _), (b_fwd, b_dec) = out["float32"], out["bfloat16"]
        scale = np.abs(f_fwd).max()
        per = np.abs(b_fwd - f_fwd).max(-1) / scale
        print(f"mla_bf16 (the reference, smoke deepseek, seed {seed}): bf16 "
              f"forward from f32 at positions 63–79, max {per.max():.3f}, "
              f"median {np.median(per):.3f}; bf16 decode from bf16 forward, "
              f"max {np.abs(b_dec - b_fwd).max() / scale:.3f}")


def xlstm_chaos():
    cfg = dataclasses.replace(configs.get("xlstm-350m"), num_layers=8,
                              dtype="float32")
    for seed in (0, 1):
        g = torch.Generator().manual_seed(seed)
        m = lm.init_params(cfg, g, "cpu")
        toks = torch.randint(0, cfg.vocab_size, (2, 12), generator=g)
        threads = torch.get_num_threads()
        with torch.no_grad():
            torch.set_num_threads(4)
            a, _ = lm.forward(m, {"tokens": toks}, cfg)
            torch.set_num_threads(1)
            c, _ = lm.forward(m, {"tokens": toks}, cfg)
            torch.set_num_threads(threads)
            caches = lm.cache_init(cfg, 2, 12, torch.float32, "cpu")
            lg, caches = lm.prefill(m, {"tokens": toks[:, :4]}, cfg, caches)
            dec = [lg]
            for t in range(4, 12):
                lg, caches = lm.decode_step(m, {"tokens": toks[:, t:t + 1]},
                                            caches, cfg)
                dec.append(lg)
            dec = torch.stack(dec, 1)
            for p in m.parameters():
                up = torch.randint(0, 2, p.shape, generator=g).bool()
                p.copy_(torch.nextafter(p, torch.where(up, torch.inf,
                                                       -torch.inf)))
            b, _ = lm.forward(m, {"tokens": toks}, cfg)
        scale = a.abs().max()

        def per(x, y):
            return ((x - y).abs().amax(-1) / scale).amax(0)
        env = per(a, b)
        print(f"xlstm_chaos seed {seed}: envelope by position "
              + " ".join(f"{v:.0e}" for v in env.tolist()))
        print(f"  4 against 1 thread over the envelope, max "
              f"{float((per(a, c) / env).max()):.2f}; decode against "
              f"forward, max {float((per(dec, a[:, 3:]) / env[3:]).max()):.2f}")


CASES = {"xlstm_ulp": xlstm_ulp, "moe_f64": moe_f64, "rope_large": rope_large,
         "mla_bf16": mla_bf16, "xlstm_chaos": xlstm_chaos}

if __name__ == "__main__":
    for case in sys.argv[1:] or CASES:
        CASES[case]()
