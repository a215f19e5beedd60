"""Elastic restore across meshes on 4 gloo ranks (CPU): the port of
tests/test_elastic_restore.py (the same model, olmo-1b smoke, seed 7).

A train state laid out on a (2, 2) mesh is saved (`CheckpointManager`
writes full arrays, the one-process manifest and files) and restored on
(4, 1) (explicit ``shardings``), on (1, 4) (the sharded ``like``'s own
layout) and in this process without a mesh: every leaf comes back bit for
bit.  One step on (4, 1) after the restore is within ``F32`` of the
one-process step from the same state.  The ranks: tests/_torch_dist.py.
"""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from _torch_dist import Ranks, check_state
from _torch_train import CPU, F32, STEP_TCFG, _batch, _f32, _port_tcfg
from repro import configs as ref_configs
from repro.train import loop as ref_loop
from repro_torch import convert
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.train import loop

MESHES = ("4x1", "1x4")


@pytest.fixture(scope="module")
def elastic(tmp_path_factory):
    cfg = _f32(ref_configs.get_smoke("olmo-1b"))
    pcfg = convert.model_config(dataclasses.asdict(cfg))
    tree = jax.tree.map(np.asarray, ref_loop.init_state(
        jax.random.PRNGKey(7), cfg, STEP_TCFG))
    batch = _batch(cfg, 8, 16, ("elastic",))
    tmp = tmp_path_factory.mktemp("elastic")
    ckpt = str(tmp / "ckpt")
    ranks = Ranks(tmp, [{"kind": "elastic", "name": "elastic", "cfg": pcfg,
                         "tcfg": _port_tcfg(STEP_TCFG), "state": tree,
                         "batch": batch, "dir": ckpt}])
    state = convert.train_state(tree, pcfg, CPU)
    want = ({k: p.detach().numpy().copy()
             for k, p in state.params().items()},
            {k: v.numpy().copy() for k, v in state.opt.m.items()},
            {k: v.numpy().copy() for k, v in state.opt.v.items()})
    metrics = loop.train_step(state, batch, pcfg, _port_tcfg(STEP_TCFG))
    after = ({k: float(v) for k, v in metrics.items()},
             {k: p.detach().numpy() for k, p in state.params().items()},
             {k: v.numpy() for k, v in state.opt.m.items()},
             {k: v.numpy() for k, v in state.opt.v.items()})
    ranks.results()
    return ranks, ckpt, tree, pcfg, want, after, tmp


@pytest.mark.parametrize("mesh", MESHES)
def test_restore_onto_another_mesh_bit_for_bit(elastic, mesh):
    """Saved on (2, 2), restored on (4, 1) or (1, 4): every leaf equal to
    the saved state's, on every rank."""
    ranks, _, tree, _, (params, m, v), _, _ = elastic
    for r in range(4):
        got = ranks.case("elastic", r)[mesh]
        for k in params:
            np.testing.assert_array_equal(got["params"][k], params[k])
            np.testing.assert_array_equal(got["m"][k], m[k])
            np.testing.assert_array_equal(got["v"][k], v[k])
        assert got["step"] == int(tree["step"])
        assert got["opt_step"] == int(tree["opt"]["step"])


@pytest.mark.parametrize("mesh", MESHES)
def test_restore_lays_leaves_out_on_the_new_mesh(elastic, mesh):
    """Each restored leaf has the new mesh's placements (its specs there),
    not the (2, 2) layout it was saved from."""
    ranks = elastic[0]
    assert all(ranks.case("elastic", r)[mesh]["laid"] for r in range(4))


@pytest.mark.parametrize("mesh", MESHES)
def test_reference_sum_check(elastic, mesh):
    """tests/test_elastic_restore.py's check: the first leaf's sum saved
    and restored agree within 1e-3 of it."""
    ranks, _, _, _, (params, _, _), _, _ = elastic
    saved = float(params["embed"].sum())
    restored = float(ranks.case("elastic")[mesh]["params"]["embed"].sum())
    assert abs(saved - restored) < 1e-3 * max(1, abs(saved))


def test_restore_in_one_process_bit_for_bit(elastic):
    """The same checkpoint restored here, with no process group and no
    mesh: plain tensors equal to the saved state's."""
    _, ckpt, tree, pcfg, (params, m, v), _, _ = elastic
    like = loop.state_tree(loop.init_state(
        pcfg, _port_tcfg(STEP_TCFG), torch.Generator().manual_seed(1), CPU))
    got = CheckpointManager(ckpt).restore(like)
    for k in params:
        assert type(got["params"][k]) is torch.Tensor
        np.testing.assert_array_equal(got["params"][k].numpy(), params[k])
        np.testing.assert_array_equal(got["opt"]["m"][k].numpy(), m[k])
        np.testing.assert_array_equal(got["opt"]["v"][k].numpy(), v[k])
    assert got["step"] == int(tree["step"])


def test_sharded_save_writes_the_one_process_checkpoint(elastic):
    """A sharded save writes what a one-process save of the same state
    writes: the same manifest (keys, files, shapes, dtypes) and the same
    arrays."""
    _, ckpt, tree, pcfg, _, _, tmp = elastic
    one = str(tmp / "one")
    state = convert.train_state(tree, pcfg, CPU)
    CheckpointManager(one).save(3, loop.state_tree(state))
    with open(os.path.join(ckpt, "step_00000003", "manifest.json")) as f:
        sharded = json.load(f)
    with open(os.path.join(one, "step_00000003", "manifest.json")) as f:
        plain = json.load(f)
    assert sharded == plain
    for e in plain["leaves"]:
        np.testing.assert_array_equal(
            np.load(os.path.join(ckpt, "step_00000003", e["file"])),
            np.load(os.path.join(one, "step_00000003", e["file"])))


def test_step_after_restore_matches_one_process_step(elastic):
    """One step on (4, 1) after the restore, within ``F32`` of the
    one-process step from the same state."""
    ranks, _, _, _, _, (metrics, params, m, v), _ = elastic
    got = ranks.case("elastic")["4x1"]["after"]
    check_state(got, metrics, params, m, v, F32)
