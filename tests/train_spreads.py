"""The measurements behind the train step's FGW bar, on the CPU:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/train_spreads.py [draws]

``fgw_f32``: musicgen's smoke config with the FGW distillation term of
tests/_torch_train.py (θ = 0.5, 2 outer × 20 Sinkhorn steps,
weight 0.5), over ``draws`` seeded batches (default 3).  For each, the
step's gradient in f32 (the train step casts the hidden states to f32)
from the reference and from the port, each against the reference's f64
gradient of the same expression, as max |Δ| over the largest |gradient| of
each parameter, the worst parameter printed; and the same for the term's
gradient to the hidden states alone.  The solve stops after 2 outer steps,
far from its fixed point, and its implicit gradient's Neumann series runs
its 60 terms in f32 (the L1 stop at 1e-10 is below f32's reach), which
amplifies rounding: that is the spread the bar ``GW_F32`` covers.  Not a
test: pytest does not collect it.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

jax.config.update("jax_enable_x64", True)   # as tests/conftest.py sets it

sys.path.insert(0, "tests")
import _torch_train as T  # noqa: E402
from repro import configs as rc  # noqa: E402
from repro.core import losses as rlosses  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import losses  # noqa: E402
from repro_torch.train import loop  # noqa: E402


def _worst(got: dict, want: dict):
    out = []
    for k, w in want.items():
        w = np.asarray(w, np.float64)
        out.append((float(np.abs(np.asarray(got[k], np.float64) - w).max()
                          / np.abs(w).max()), k))
    return max(out)


def fgw_f32(draws: int = 3):
    cfg32 = T._f32(rc.get_smoke("musicgen-medium"))
    cfg64 = dataclasses.replace(cfg32, dtype="float64",
                                param_dtype="float64")
    pcfg = convert.model_config(dataclasses.asdict(cfg32))
    tcfg = T.GW_TCFG
    acfg = tcfg.gw_align
    params = rlm.init_params(jax.random.PRNGKey(0), cfg32)
    p64 = jax.tree.map(lambda a: a.astype(jnp.float64), params)
    for draw in range(draws):
        batch = T._batch(cfg32, 2, 16, ("gw",) if draw == 0 else
                         ("gw", draw), teacher=True)

        def loss(p, cfg, dt, b):
            value, _ = rlm.loss_fn(p, b, cfg)
            _, _, h = rlm.forward(p, b, cfg, return_hidden=True)
            gw = rlosses.fgw_alignment_loss_batch(
                h.astype(dt), jnp.asarray(b["teacher_h"]).astype(dt), acfg)
            return value + tcfg.gw_align_weight * gw
        b64 = dict(batch, embeddings=batch["embeddings"].astype(np.float64))
        g32 = jax.jit(jax.grad(lambda p: loss(p, cfg32, jnp.float32,
                                              batch)))(params)
        g64 = jax.jit(jax.grad(lambda p: loss(p, cfg64, jnp.float64,
                                              b64)))(p64)
        model = convert.lm_model(jax.tree.map(np.asarray, params), pcfg,
                                 "cpu")
        value, _ = loop._microbatch_loss(model, loop.to_device(batch, "cpu"),
                                         pcfg, T._port_tcfg(tcfg))
        value.backward()
        port = {k: p.grad.numpy() for k, p in model.named_parameters()}
        want = convert.lm_params(jax.tree.map(np.asarray, g64), "cpu")
        ref = convert.lm_params(jax.tree.map(np.asarray, g32), "cpu")
        ref_d, ref_k = _worst({k: v.numpy() for k, v in ref.items()},
                              {k: v.numpy() for k, v in want.items()})
        port_d, port_k = _worst(port, {k: v.numpy() for k, v in
                                       want.items()})
        with torch.no_grad():
            _, _, h = loop.lm.forward(model, loop.to_device(batch, "cpu"),
                                      pcfg, return_hidden=True)
        h = h.numpy()
        t = batch["teacher_h"]

        def term(x, y):
            return rlosses.fgw_alignment_loss_batch(x, y, acfg)
        gh32 = jax.jit(jax.grad(term))(jnp.asarray(h), jnp.asarray(t))
        gh64 = np.asarray(jax.jit(jax.grad(term))(
            jnp.asarray(h, jnp.float64), jnp.asarray(t, jnp.float64)))
        x = torch.tensor(h, requires_grad=True)
        losses.fgw_alignment_loss_batch(
            x, torch.tensor(t), T._port_tcfg(tcfg).gw_align,
            device="cpu").backward()
        s = np.abs(gh64).max()
        print(f"draw {draw}: step gradient from f64, worst parameter: "
              f"reference f32 {ref_d:.3e} ({ref_k}), port f32 {port_d:.3e} "
              f"({port_k}); the term's gradient to the hidden states: "
              f"reference {np.abs(np.asarray(gh32) - gh64).max() / s:.3e}, "
              f"port {np.abs(x.grad.numpy() - gh64).max() / s:.3e}",
              flush=True)


if __name__ == "__main__":
    fgw_f32(int(sys.argv[1]) if len(sys.argv) > 1 else 3)
