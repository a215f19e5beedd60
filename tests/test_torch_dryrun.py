"""The production dry run (`repro_torch.launch.dryrun`), its input specs
(`repro_torch.launch.specs`) and the byte count of
`repro_torch.launch.flops`, on the CPU.

- The specs of the ten architectures × four shapes at their full configs
  against the reference's ``launch/specs.py`` (``jax.eval_shape`` and the
  ``meta`` device allocate nothing).
- `flops.count_fn` against the reference's jaxpr walker: single ops
  exactly, and a smoke forward's products exactly, its bytes and
  elementwise FLOPs within `BYTES_BAR` and `ELEMENTWISE_BAR` (measured:
  see their comments).
- The dry run on a fake (2, 2) group, in this process: every key of the
  record, ``argument_bytes`` against the specs' reckoning
  (`specs.argument_bytes`) on ranks 0–3, every tensor held
  replication times over over ranks 0–3, the peak above the arguments;
  its collectives against those of the same step on a real 4-rank gloo
  group (`tests/_torch_dist.py`, one launch).  The production meshes and
  the CLI: `tests/test_torch_dryrun_cli.py` (a file of its own, so that
  the two share the suite's workers).

No test leaves a process group behind (`no_group_left`).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_dist import Ranks
from _torch_threads import one_torch_thread  # noqa: F401
from repro import configs as ref_configs
from repro.configs.shapes import SHAPES as REF_SHAPES
from repro.launch import flops as ref_flops
from repro.launch import specs as ref_specs
from repro.models import lm as ref_lm
from repro_torch import configs, convert
from repro_torch.configs.shapes import SHAPES, ShapeSpec
from repro_torch.launch import dryrun, flops, specs
from repro_torch.launch.mesh import local_mesh
from repro_torch.models import lm

# the smoke forward's bytes and elementwise FLOPs against the reference's
# walker, worst over the ten architectures (measured on this tree): bytes
# 3.3 % (zamba2-7b; the norms' mean reads its input where the reference
# sums then divides), elementwise 7.4 % (olmo-1b, starcoder2-15b,
# musicgen-medium: LayerNorm's variance chain); xLSTM's elementwise 15.6 %
# (its log-sigmoid gates: the reference wraps each in max/abs/select
# guards)
BYTES_BAR = 0.04
ELEMENTWISE_BAR = 0.08
XLSTM_ELEMENTWISE_BAR = 0.20
CPU = torch.device("cpu")
SMOKE = {"train": ShapeSpec("smoke_train", "train", 32, 4),
         "prefill": ShapeSpec("smoke_prefill", "prefill", 32, 4),
         "decode": ShapeSpec("smoke_decode", "decode", 32, 4)}
CELLS = {"olmo-1b/train": ("olmo-1b", "train"),
         "deepseek-v2-lite-16b/train": ("deepseek-v2-lite-16b", "train"),
         "zamba2-7b/train": ("zamba2-7b", "train"),
         "smollm-360m/prefill": ("smollm-360m", "prefill"),
         "smollm-360m/decode": ("smollm-360m", "decode")}
KEYS = ("arch", "shape", "mesh", "chips", "strategy", "microbatches",
        "compress", "memory_per_device", "device_cost", "analytic",
        "params_total", "params_active", "model_flops", "collectives",
        "roofline", "dominant", "mfu_bound", "model_vs_counted",
        "first_step_s", "fits_hbm", "hbm_bytes")


@pytest.fixture(autouse=True)
def no_group_left():
    yield
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# specs against the reference's
# ---------------------------------------------------------------------------

def _shape_dtype(x):
    return tuple(x.shape), str(x.dtype).replace("torch.", "")


def _split_caches(tree, cfg):
    """The reference's caches as the port holds them (`convert.lm_caches`'s
    rule): each body slot's stacked repeats split, ``length`` dropped;
    leaves (shape, dtype)."""
    def leaves(c, rep=None):
        out = {}
        for k, v in c.items():
            if k == "length":
                continue
            vs = v if k == "carry" else [v]
            out[k] = [(tuple(a.shape[1:] if rep is not None else a.shape),
                       str(a.dtype)) for a in vs]
        return out
    return {"prologue": [leaves(c) for c in tree["prologue"]],
            "body": [{f"slot{si}": leaves(tree["body"][f"slot{si}"], r)
                      for si in range(len(cfg.block_template))}
                     for r in range(cfg.repeats)]}


def _port_caches(tree):
    def leaves(c):
        return {k: [_shape_dtype(a) for a in (v if k == "carry" else [v])]
                for k, v in c.items() if k != "length"}
    return {"prologue": [leaves(c) for c in tree["prologue"]],
            "body": [{k: leaves(c) for k, c in rep.items()}
                     for rep in tree["body"]]}


@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_input_specs_match_reference(arch, shape_name):
    """Batch keys and shapes as the reference's (token ids and labels
    int64 where the reference's are int32; embeddings bf16, positions
    int32, the reference's), parameters as `flops.meta_shapes` (and a
    train state's moments as its parameters), caches as the reference's
    split per repeat; all on ``meta``."""
    ref_cfg, cfg = ref_configs.get(arch), configs.get(arch)
    shape = SHAPES[shape_name]
    got = specs.input_specs(cfg, shape)
    want_batch = ref_specs.batch_specs_for(ref_cfg, REF_SHAPES[shape_name])
    assert got["batch"].keys() == want_batch.keys()
    for k, v in got["batch"].items():
        want = want_batch[k]
        assert tuple(v.shape) == tuple(want.shape), k
        assert v.is_meta
        wd = str(want.dtype)
        assert str(v.dtype).replace("torch.", "") == (
            "int64" if k in ("tokens", "labels") else wd), k
    want_params = flops.meta_shapes(cfg)
    if shape.kind == "train":
        state = got["state"]
        params = {k: tuple(p.shape) for k, p in state.params().items()}
        assert params == want_params
        for moments in (state.opt.m, state.opt.v):
            assert {k: tuple(t.shape) for k, t in moments.items()} \
                == want_params
            assert all(t.is_meta and t.dtype == torch.float32
                       for t in moments.values())
        return
    assert {k: tuple(p.shape) for k, p in
            got["params"].named_parameters()} == want_params
    assert all(p.is_meta for p in got["params"].parameters())
    want_caches = jax.eval_shape(lambda: ref_lm.cache_init(
        ref_cfg, shape.global_batch, shape.seq_len, jnp.bfloat16))
    assert _port_caches(got["caches"]) == _split_caches(want_caches,
                                                        ref_cfg)


# ---------------------------------------------------------------------------
# the byte count against the reference's walker
# ---------------------------------------------------------------------------

def _x(*shape, dtype=jnp.float32):
    return jax.ShapeDtypeStruct(shape, dtype)


def _t(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


SINGLE_OPS = {
    "product": (lambda x, w: x @ w, (_x(4, 8), _x(8, 16)),
                lambda x, w: x @ w, (_t(4, 8), _t(8, 16))),
    "softmax": (lambda x: jax.nn.softmax(x, -1), (_x(4, 8),),
                lambda x: torch.softmax(x, -1), (_t(4, 8),)),
    "reduction": (lambda x: x.sum(-1), (_x(4, 8),),
                  lambda x: x.sum(-1), (_t(4, 8),)),
    "gather": (lambda w, i: w[i], (_x(8, 16), _x(3, dtype=jnp.int32)),
               lambda w, i: w[i], (_t(8, 16), _t(3, dtype=torch.long))),
    "cat": (lambda x: jnp.concatenate([x, x]), (_x(4, 8),),
            lambda x: torch.cat([x, x]), (_t(4, 8),)),
    "cumsum": (lambda x: jnp.cumsum(x, 0), (_x(4, 8),),
               lambda x: torch.cumsum(x, 0), (_t(4, 8),)),
    "log_softmax": (lambda x: jax.nn.log_softmax(x, -1), (_x(4, 8),),
                    lambda x: torch.log_softmax(x, -1), (_t(4, 8),)),
    "logsumexp": (lambda x: jax.nn.logsumexp(x, -1), (_x(4, 8),),
                  lambda x: torch.logsumexp(x, -1), (_t(4, 8),)),
    "logaddexp": (lambda x: jnp.logaddexp(x, x), (_x(4, 8),),
                  lambda x: torch.logaddexp(x, x), (_t(4, 8),)),
    "silu": (lambda x: jax.nn.silu(x), (_x(4, 8),),
             lambda x: torch.nn.functional.silu(x), (_t(4, 8),)),
    "mean": (lambda x: x.mean(-1), (_x(4, 8),),
             lambda x: x.mean(-1), (_t(4, 8),)),
    "square": (lambda x: x ** 2, (_x(4, 8),),
               lambda x: x ** 2, (_t(4, 8),)),
}


@pytest.mark.parametrize("op", list(SINGLE_OPS))
def test_single_op_counts_equal_reference(op):
    """Bytes equal, and products plus elementwise FLOPs equal to the
    reference walker's ``flops``."""
    ref_fn, ref_args, fn, args = SINGLE_OPS[op]
    want = ref_flops.count_fn(ref_fn, *ref_args)
    got = flops.count_fn(fn, *args)
    assert got["bytes"] == want["bytes"]
    assert got["flops"] + got["elementwise_flops"] == want["flops"]


def test_transcendentals_count_an_output_element():
    got = flops.count_fn(lambda x: torch.exp(torch.softmax(x, -1)),
                         _t(4, 8))
    assert got["transcendentals"] == 2 * 32


def _ref_products(jaxpr, mult=1) -> int:
    """The reference walker's products alone (its ``dot_general`` FLOPs,
    scan bodies times their length)."""
    n = 0
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if name == "scan":
            n += _ref_products(eqn.params["jaxpr"].jaxpr,
                               int(eqn.params["length"]))
        elif name == "cond":
            n += max(_ref_products(b.jaxpr) for b in eqn.params["branches"])
        elif "jaxpr" in eqn.params or "call_jaxpr" in eqn.params:
            j = eqn.params.get("jaxpr", eqn.params.get("call_jaxpr"))
            n += _ref_products(j.jaxpr if hasattr(j, "jaxpr") else j)
        elif name == "dot_general":
            n += ref_flops._dot_flops(eqn)
    return n * mult


@pytest.mark.parametrize("arch", ["smollm-360m", "deepseek-v2-lite-16b",
                                  "xlstm-350m"])
def test_smoke_forward_counts_against_reference(arch):
    """A smoke forward (2 × 16 tokens, f32): product FLOPs equal, bytes
    within `BYTES_BAR`, elementwise FLOPs within `ELEMENTWISE_BAR`
    (xLSTM's `XLSTM_ELEMENTWISE_BAR`)."""
    ref_cfg = dataclasses.replace(ref_configs.get_smoke(arch),
                                  dtype="float32")
    cfg = convert.model_config(dataclasses.asdict(ref_cfg))
    b, s = 2, 16
    params = jax.eval_shape(lambda: ref_lm.init_params(
        jax.random.PRNGKey(0), ref_cfg))
    jaxpr = jax.make_jaxpr(lambda p, t: ref_lm.forward(p, t, ref_cfg))(
        params, {"tokens": _x(b, s, dtype=jnp.int32)}).jaxpr
    want = ref_flops.count_jaxpr(jaxpr)
    want_products = _ref_products(jaxpr)
    model = lm.LM(cfg, None, device="meta")
    got = flops.count_fn(lambda: lm.forward(
        model, {"tokens": _t(b, s, dtype=torch.long)}, cfg))
    assert got["flops"] == want_products
    assert abs(got["bytes"] / want["bytes"] - 1) <= BYTES_BAR
    bar = XLSTM_ELEMENTWISE_BAR if arch == "xlstm-350m" else ELEMENTWISE_BAR
    assert abs(got["elementwise_flops"]
               / (want["flops"] - want_products) - 1) <= bar


# ---------------------------------------------------------------------------
# the dry run on a fake (2, 2) group
# ---------------------------------------------------------------------------

def _cell(arch, kind, rank=0):
    return dryrun.run_cell(arch, SMOKE[kind].name, False, verbose=False,
                           device="cpu", rank=rank, mesh_shape=(2, 2),
                           cfg=configs.get_smoke(arch), shape=SMOKE[kind])


@pytest.fixture(scope="module")
def real_ranks(tmp_path_factory):
    """The olmo-1b smoke train cell's share on a real 4-rank gloo group,
    started first: it runs while this process runs the fake ones."""
    arch = "olmo-1b"
    return Ranks(tmp_path_factory.mktemp("dryrun"), [
        {"kind": "dryrun", "name": "olmo", "arch": arch,
         "cfg": configs.get_smoke(arch), "shape": SMOKE["train"]}])


@pytest.fixture(scope="module")
def records(real_ranks):
    return {name: _cell(arch, kind) for name, (arch, kind) in CELLS.items()}


def _on_fake_group(rank, fn):
    """``fn(mesh)`` on rank ``rank`` of a fake (2, 2) CPU group."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=4)
    try:
        return fn(local_mesh(2, 2, device_type="cpu"))
    finally:
        dist.destroy_process_group()
        dryrun._forget_meshes()


@pytest.mark.parametrize("name", list(CELLS))
def test_record_has_every_key(records, name):
    rec = records[name]
    assert "error" not in rec and "oom" not in rec
    for k in KEYS:
        assert k in rec, k
    assert rec["mesh"] == "2x2" and rec["chips"] == 4
    assert set(rec["roofline"]) == {"compute_s", "memory_s_analytic",
                                    "memory_s_device", "collective_s"}
    assert rec["dominant"] in ("compute", "memory", "collective")
    assert rec["device_cost"]["flops_per_device"] > 0
    assert rec["analytic"]["flops_global"] > 0
    assert rec["collectives"]["counts"]
    assert rec["fits_hbm"] is True


@pytest.mark.parametrize("name", list(CELLS))
def test_argument_bytes_equal_the_specs_reckoning(records, name):
    arch, kind = CELLS[name]
    want = specs.argument_bytes(configs.get_smoke(arch), SMOKE[kind], (2, 2))
    assert records[name]["memory_per_device"]["argument_bytes"] == want


@pytest.mark.parametrize("name", ["olmo-1b/train", "smollm-360m/decode"])
def test_argument_bytes_of_every_rank_equal_the_specs_reckoning(name):
    """`specs.argument_bytes` at each rank's mesh coordinates against the
    bytes of the shards `dryrun.build_cell` makes on ranks 0–3."""
    arch, kind = CELLS[name]
    cfg, shape = configs.get_smoke(arch), SMOKE[kind]
    for rank in range(4):
        held = _on_fake_group(rank, lambda mesh: dryrun.local_bytes(
            dryrun.build_cell(arch, shape.name, mesh, cfg=cfg,
                              shape=shape)[1]))
        want = specs.argument_bytes(cfg, shape, (2, 2), coords={
            "data": rank // 2, "model": rank % 2})
        assert held == want, rank


def test_an_out_of_memory_share_keeps_no_counts(monkeypatch):
    """A share that runs out of memory is recorded so: ``oom`` and a
    lower-bound peak, no fit, and no count, roofline or dominant term
    (they would be of part of a step)."""
    def step_of(cfg, shape, tcfg):
        def step_fn(*args):
            torch.ones(3) + 1
            raise torch.cuda.OutOfMemoryError("Tried to allocate 30 GiB")
        return step_fn
    monkeypatch.setattr(dryrun, "step_of", step_of)
    rec = dryrun.run_cell("olmo-1b", "smoke_train", False, count_flops=False,
                          verbose=False, device="cpu", mesh_shape=(2, 2),
                          cfg=configs.get_smoke("olmo-1b"),
                          shape=SMOKE["train"])
    assert "Tried to allocate 30 GiB" in rec["oom"]
    assert rec["fits_hbm"] is False
    assert rec["memory_per_device"]["peak_is_lower_bound"] is True
    for k in ("device_cost", "collectives", "roofline", "dominant",
              "mfu_bound"):
        assert rec[k] is None, k


@pytest.mark.parametrize("name", list(CELLS))
def test_peak_is_at_least_the_arguments(records, name):
    mem = records[name]["memory_per_device"]
    assert mem["total_bytes"] >= mem["argument_bytes"] > 0
    assert mem["temp_bytes"] == (mem["total_bytes"] - mem["argument_bytes"]
                                 - mem["output_bytes"])


def _local_numels(arch, kind, rank) -> dict:
    """Name → this rank's local elements of each argument of a cell."""
    def held(mesh):
        _, args, _, _ = dryrun.build_cell(
            arch, SMOKE[kind].name, mesh, cfg=configs.get_smoke(arch),
            shape=SMOKE[kind])
        out = {}

        def walk(prefix, tree):
            if isinstance(tree, dict):
                for k, v in tree.items():
                    walk(f"{prefix}.{k}", v)
            elif isinstance(tree, (list, tuple)):
                for i, v in enumerate(tree):
                    walk(f"{prefix}.{i}", v)
            elif isinstance(tree, torch.Tensor):
                out[prefix] = (tree.to_local().numel(), tree.numel(),
                               tree.placements)
        if kind == "train":
            state, batch = args
            walk("params", state.params())
            walk("m", state.opt.m)
            walk("v", state.opt.v)
        else:
            model, batch, caches = args
            walk("params", dict(model.named_parameters()))
            walk("caches", caches)
        walk("batch", batch)
        return out
    return _on_fake_group(rank, held)


@pytest.mark.parametrize("name", ["olmo-1b/train", "smollm-360m/decode"])
def test_every_tensor_is_held_replication_times_over_the_ranks(name):
    """Over ranks 0–3, each tensor's local elements sum to its size
    times its replication (the mesh dims that do not shard it)."""
    arch, kind = CELLS[name]
    ranks = [_local_numels(arch, kind, r) for r in range(4)]
    assert ranks[0].keys() == ranks[3].keys()
    for k, (_, size, placements) in ranks[0].items():
        copies = int(np.prod([2 for p in placements if p.is_replicate()]))
        assert sum(r[k][0] for r in ranks) == size * copies, k


def test_fake_group_collectives_equal_a_real_gloo_step(records, real_ranks):
    """The olmo-1b smoke train cell: counts by kind and payload bytes a
    device on the fake (2, 2) group equal rank 0's on a real gloo group
    running the same share."""
    real = real_ranks.case("olmo")
    fake = records["olmo-1b/train"]["collectives"]
    assert fake["counts"] == real["counts"]
    assert fake["payload_bytes_per_device"] == \
        real["payload_bytes_per_device"]
    assert fake["wire_bytes_per_device"] == real["wire_bytes_per_device"]


def test_cpu_group_runs_moe_all_to_all_as_all_gathers(records):
    """The CPU group has no all-to-all: the MoE cell's shard-to-shard
    moves are all-gathers here (on the card they are all-to-alls)."""
    counts = records["deepseek-v2-lite-16b/train"]["collectives"]["counts"]
    assert "all-to-all" not in counts and counts["all-gather"] > 0


def test_fake_group_is_one_process_of_the_world():
    """What the dry run takes from ``fake_pg``: a group of the production
    world in one process whose collectives complete at once, with no
    peer, their outputs of the right shape (a sum over the world is not
    taken)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=5,
                            world_size=256)
    try:
        assert dist.get_world_size() == 256 and dist.get_rank() == 5
        x = torch.full((4,), 3.0)
        out = torch.zeros(4 * 256)
        dist.all_gather_into_tensor(out, x)
        assert out.shape == (1024,)
        dist.all_reduce(x)
        assert torch.equal(x, torch.full((4,), 3.0))
    finally:
        dist.destroy_process_group()


def test_analytic_count_extends_two_periods_exactly():
    """`dryrun.analytic_count` (one and two template periods, extended
    linearly) equals `flops.count_fn` over the whole step: a smoke
    zamba2-7b of five periods (its shared slot included), a train step."""
    cfg = configs.get_smoke("zamba2-7b")
    cfg = dataclasses.replace(cfg, num_layers=len(cfg.prologue)
                              + 5 * len(cfg.block_template))
    shape, tcfg = ShapeSpec("t", "train", 16, 2), dryrun.train_config()
    assert dryrun.analytic_count(cfg, shape, tcfg) == \
        dryrun._count_unsharded(cfg, shape, tcfg)
