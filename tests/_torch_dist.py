"""The multi-rank harness of tests/test_torch_sharded.py and
tests/test_torch_elastic.py; not collected by pytest.

The pytest side (`Ranks`) pickles a list of cases, starts one subprocess
``python -m torch.distributed.run --nproc-per-node 4 --master-addr
127.0.0.1 --master-port <free> tests/_torch_dist.py <job>`` under a
timeout, so that a hung rank cannot stall the suite, and reads back what
each rank pickled; the launch is a session of its own, so that no signal
of its shutdown reaches pytest, and a timeout kills every rank.  The
ranks (this file run as a script) start a gloo
group on the CPU, run each case on their meshes with one thread each
(the suite's workers share the cores), and import no JAX: the reference's
states come in as numpy trees, and every result goes back as numpy (full
tensors).  A case that raises records its traceback, and its test fails
with it.
"""
import os
import pickle
import signal
import socket
import subprocess
import sys
import time
import traceback

import numpy as np

WORLD = 4
SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Ranks:
    """``WORLD`` ranks running ``cases`` (dicts with a ``"kind"`` and a
    ``"name"``) in the background; `results` waits for them."""

    def __init__(self, tmp, cases, timeout: float = 600,
                 device: str = "cpu"):
        self.dir = str(tmp)
        self.timeout = timeout
        job = os.path.join(self.dir, "job.pkl")
        with open(job, "wb") as f:
            pickle.dump(cases, f)
        env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=SRC)
        env.pop("XLA_FLAGS", None)
        self.log = open(os.path.join(self.dir, "ranks.log"), "w+")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run",
             "--nproc-per-node", str(WORLD), "--master-addr", "127.0.0.1",
             "--master-port", str(_free_port()), os.path.abspath(__file__),
             job, device], stdout=self.log, stderr=subprocess.STDOUT, env=env,
            cwd=self.dir, start_new_session=True)
        self._out = None

    def results(self) -> list[dict]:
        """Each rank's {case name: result}, after the ranks exit."""
        if self._out is None:
            try:
                rc = self.proc.wait(timeout=self.timeout)
            except subprocess.TimeoutExpired:
                os.killpg(self.proc.pid, signal.SIGKILL)   # every rank
                self.proc.wait()
                rc = "timeout"
            self.log.seek(0)
            tail = self.log.read()[-4000:]
            self.log.close()
            assert rc == 0, f"ranks exited with {rc}:\n{tail}"
            self._out = []
            for r in range(WORLD):
                with open(os.path.join(self.dir, f"rank{r}.pkl"), "rb") as f:
                    self._out.append(pickle.load(f))
        return self._out

    def case(self, name: str, rank: int = 0) -> dict:
        out = self.results()[rank][name]
        assert "error" not in out, out["error"]
        return out


class RankGroups:
    """Several `Ranks` launches at once, one a group of cases (the
    slowest cases apart from the rest, so that the groups end together);
    `case` finds a case in its group."""

    def __init__(self, tmp, groups, **kw):
        self.launches, self.where = [], {}
        for i, cases in enumerate(groups):
            d = os.path.join(str(tmp), f"group{i}")
            os.makedirs(d, exist_ok=True)
            self.launches.append(Ranks(d, cases, **kw))
            self.where.update({c["name"]: self.launches[-1] for c in cases})

    def results(self):
        return [launch.results() for launch in self.launches]

    def case(self, name: str, rank: int = 0) -> dict:
        return self.where[name].case(name, rank)


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _np(x):
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        x = x.full_tensor()
    return x.detach().cpu().numpy().copy()


def local_block(full: np.ndarray, spec: tuple, mesh_shape: dict,
                coords: dict) -> np.ndarray:
    """The block of ``full`` that the reference's device at mesh
    coordinates ``coords`` (axis → index) holds under ``spec``: along a
    dim sharded over axes (a, b), block ``coords[a]·|b| + coords[b]`` of
    ``|a|·|b|`` equal blocks."""
    idx = []
    for d, n in enumerate(full.shape):
        entry = spec[d] if d < len(spec) else None
        if entry is None:
            idx.append(slice(None))
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        k, parts = 0, 1
        for a in axes:
            k, parts = k * mesh_shape[a] + coords[a], parts * mesh_shape[a]
        step = n // parts
        idx.append(slice(k * step, (k + 1) * step))
    return full[tuple(idx)]


def _layout(state, full0: dict, mesh, strategy: str) -> dict:
    """This rank's layout faults: parameters whose placements do not
    follow their spec, whose local shard is not the reference's block at
    this rank's mesh coordinates, and moments that `zero_specs` shards
    over ``data`` that do not hold 1/|data| of the parameter's local
    elements."""
    from repro_torch.distributed import sharding
    shape = sharding.mesh_shape(mesh)
    shapes = {k: tuple(v.shape) for k, v in full0.items()}
    pspecs = sharding.param_specs(shapes, shape, strategy)
    zspecs = sharding.zero_specs(shapes, pspecs, shape)
    coords = {a: mesh.get_local_rank(i)
              for i, a in enumerate(mesh.mesh_dim_names)}
    bad = {"placements": [], "block": [], "zero": [], "zero_checked": 0}
    for k, p in state.params().items():
        if list(p.placements) != sharding.placements(pspecs[k], mesh):
            bad["placements"].append(k)
        want = local_block(full0[k].numpy(), pspecs[k], shape, coords)
        if not np.array_equal(p.to_local().detach().cpu().numpy(), want):
            bad["block"].append(k)
        m = state.opt.m[k]
        if list(m.placements) != sharding.placements(zspecs[k], mesh):
            bad["placements"].append("m." + k)
        if ("data" in sharding._used(zspecs[k])
                and "data" not in sharding._used(pspecs[k])):
            bad["zero_checked"] += 1
            if m.to_local().numel() * shape["data"] != \
                    p.to_local().numel():
                bad["zero"].append(k)
    return bad


def _state(case, dev):
    """The case's train state on ``dev``: from the reference's init tree
    (``"state"``), or drawn from ``"seed"`` on the CPU and moved."""
    import torch

    from repro_torch import convert
    from repro_torch.train import loop, optimizer
    if "state" in case:
        return convert.train_state(case["state"], case["cfg"], dev)
    state = loop.init_state(case["cfg"], case["tcfg"],
                            torch.Generator().manual_seed(case["seed"]),
                            "cpu")
    state.model.to(dev)
    state.opt = optimizer.init(state.params(), case["tcfg"].optimizer)
    return state


def _step(case, mesh_of, dev):
    """A train step on a sharded state from the reference's init tree:
    the new state's full tensors, the metrics, the layout faults and (with
    ``"profile"``) the collectives of the step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import collectives
    from repro_torch.train import loop
    state = _state(case, dev)
    full0 = {k: p.detach().cpu().clone() for k, p in state.params().items()}
    mesh = mesh_of(case["mesh"])
    loop.shard_state(state, mesh, case["strategy"])
    layout = _layout(state, full0, mesh, case["strategy"])
    if case.get("profile"):
        with profile(activities=[ProfilerActivity.CPU],
                     record_shapes=True) as prof:
            metrics = loop.train_step(state, case["batch"], case["cfg"],
                                      case["tcfg"])
        coll = collectives.ops(prof)
    else:
        metrics = loop.train_step(state, case["batch"], case["cfg"],
                                  case["tcfg"])
        coll = None
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "params": {k: _np(p) for k, p in state.params().items()},
            "m": {k: _np(v) for k, v in state.opt.m.items()},
            "v": {k: _np(v) for k, v in state.opt.v.items()},
            "step": state.step, "opt_step": state.opt.step,
            "layout": layout, "collectives": coll}


def _decode(case, mesh_of, dev):
    """Greedy decoding of ``case["prompts"]`` on a (data, model) mesh:
    parameters by `param_specs`, caches by `cache_specs`, prompts and
    tokens by `batch_specs`.  Returns the tokens and every step's logits
    (the prefill's and each decode step's), whole."""
    import torch

    from repro_torch import convert
    from repro_torch.distributed import sharding
    from repro_torch.models import lm
    cfg = case["cfg"]
    model = convert.lm_model(case["params"], cfg, dev)
    mesh = mesh_of(case["mesh"])
    shape = sharding.mesh_shape(mesh)
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    sharding.distribute_module(model, mesh,
                               sharding.param_specs(shapes, shape))
    prompts = torch.as_tensor(case["prompts"], dtype=torch.long,
                              device=dev)
    b = prompts.shape[0]
    with torch.inference_mode():
        caches = lm.cache_init(cfg, b, case["max_len"], "float32", dev,
                               mesh=mesh)
        logits, caches = lm.prefill(
            model, sharding.distribute_batch({"tokens": prompts}, mesh),
            cfg, caches)
        seen, out = [logits.full_tensor()], []
        for _ in range(case["steps"]):
            tok = torch.argmax(seen[-1], dim=-1)
            out.append(tok)
            logits, caches = lm.decode_step(
                model, sharding.distribute_batch({"tokens": tok[:, None]},
                                                 mesh), caches, cfg)
            seen.append(logits.full_tensor())
    return {"tokens": torch.stack(out, 1).cpu().numpy(),
            "logits": torch.stack(seen, 1).cpu().numpy(),
            "cache_sharded": sorted({str(c.placements) for c in
                                     _cache_tensors(caches)})}


def _cache_tensors(tree):
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k != "length":
                yield from _cache_tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _cache_tensors(v)
    else:
        yield tree


def _collectives(case, mesh_of, dev):
    """A known program: an all-reduce of an f32 (16, 128) and an
    all-gather of a bf16 (1024, 8) over the world."""
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import collectives
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        dist.all_reduce(torch.ones(16, 128, device=dev))
        out = torch.empty(1024, 8, dtype=torch.bfloat16, device=dev)
        dist.all_gather_into_tensor(
            out, torch.ones(1024 // WORLD, 8, dtype=torch.bfloat16,
                            device=dev))
    return collectives.parse(prof)


def _elastic(case, mesh_of, dev):
    """Save a sharded state on (2, 2); restore it on (4, 1) (explicit
    ``shardings``) and on (1, 4) (the sharded ``like``'s own layout); one
    step on (4, 1) after the restore."""
    import torch

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.distributed import sharding
    from repro_torch.train import loop
    cfg, tcfg = case["cfg"], case["tcfg"]
    state = _state(case, dev)
    loop.shard_state(state, mesh_of((2, 2)), "2d")
    mgr = CheckpointManager(case["dir"])
    mgr.save(3, loop.state_tree(state))
    out = {}
    for shape in ((4, 1), (1, 4)):
        mesh = mesh_of(shape)
        like = loop.init_state(cfg, tcfg, torch.Generator().manual_seed(1),
                               dev)
        loop.shard_state(like, mesh, "2d")
        tree = loop.state_tree(like)
        shardings = None
        if shape == (4, 1):
            ms = sharding.mesh_shape(mesh)
            shapes = {k: tuple(p.shape) for k, p in like.params().items()}
            ps = sharding.param_specs(shapes, ms)
            zs = sharding.zero_specs(shapes, ps, ms)
            shardings = {"params": {k: (mesh, s) for k, s in ps.items()},
                         "opt": {"m": {k: (mesh, s) for k, s in zs.items()},
                                 "v": {k: (mesh, s) for k, s in zs.items()},
                                 "step": None}, "step": None}
        restored = mgr.restore(tree, shardings=shardings)
        laid = all(list(r.placements) == list(t.placements)
                   for key in ("params",) for k, r in
                   restored[key].items() for t in [tree[key][k]]) and all(
            list(restored["opt"][w][k].placements)
            == list(tree["opt"][w][k].placements)
            for w in ("m", "v") for k in tree["opt"][w])
        loop.load_state_tree(like, restored)
        res = {"params": {k: _np(p) for k, p in like.params().items()},
               "m": {k: _np(v) for k, v in like.opt.m.items()},
               "v": {k: _np(v) for k, v in like.opt.v.items()},
               "step": like.step, "opt_step": like.opt.step, "laid": laid}
        if shape == (4, 1):
            metrics = loop.train_step(like, case["batch"], cfg, tcfg)
            res["after"] = {
                "metrics": {k: float(v) for k, v in metrics.items()},
                "params": {k: _np(p) for k, p in like.params().items()},
                "m": {k: _np(v) for k, v in like.opt.m.items()},
                "v": {k: _np(v) for k, v in like.opt.v.items()}}
        out[f"{shape[0]}x{shape[1]}"] = res
    return out


def _dryrun(case, mesh_of, dev):
    """The dry run's share of a cell (`repro_torch.launch.dryrun.build_cell`
    on the (2, 2) mesh of a real group) run once under its
    `CollectiveRecorder`: the collectives a real step issues."""
    from repro_torch.launch import dryrun
    step_fn, args, _, _ = dryrun.build_cell(
        case["arch"], case["shape"].name, mesh_of((2, 2)), cfg=case["cfg"],
        shape=case["shape"])
    recorder = dryrun.CollectiveRecorder()
    with recorder:
        step_fn(*args)
    return recorder.summary()


KINDS = {"step": _step, "decode": _decode, "collectives": _collectives,
         "elastic": _elastic, "dryrun": _dryrun}


def main(job: str, device: str):
    import torch
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_mod
    torch.set_num_threads(1)
    rank = mesh_mod.init_distributed(device)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if device == "cuda" else torch.device("cpu"))
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    meshes = {}

    def mesh_of(shape):
        shape = tuple(shape)
        if shape not in meshes:
            meshes[shape] = mesh_mod.local_mesh(*shape, device_type=device)
        return meshes[shape]

    with open(job, "rb") as f:
        cases = pickle.load(f)
    out = {}
    for case in cases:
        t0 = time.perf_counter()
        try:
            out[case["name"]] = KINDS[case["kind"]](case, mesh_of, dev)
        except Exception:
            out[case["name"]] = {"error": traceback.format_exc()}
        out[case["name"]]["seconds"] = time.perf_counter() - t0
    with open(os.path.join(os.path.dirname(job), f"rank{rank}.pkl"),
              "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the pytest side's checks
# ---------------------------------------------------------------------------

def rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def check_state(got: dict, want_metrics: dict, want_params: dict,
                want_m: dict, want_v: dict, bar: float, lr: float = 1e-3,
                eps: float = 1e-8):
    """`tests/_torch_train.py::_check_step`'s rules for a step's result
    held as numpy (``got``: "metrics", "params", "m", "v") against
    another's: the metrics and m at ``bar``, v at twice it, and the new
    parameters wherever the gradient is not within the bar of zero."""
    assert got["metrics"].keys() == want_metrics.keys()
    for k in want_metrics:
        assert rel(got["metrics"][k], want_metrics[k]) <= bar, (
            k, got["metrics"][k], float(want_metrics[k]))
    for k in want_params:
        assert rel(got["m"][k], want_m[k]) <= bar, ("m", k)
        assert rel(got["v"][k], want_v[k]) <= 2 * bar, ("v", k)
        mk = np.abs(np.asarray(want_m[k]))
        away = mk > max(bar * mk.max(), 0.1 * 1e3 * eps)
        w = np.asarray(want_params[k])[away]
        d = np.abs(got["params"][k][away] - w)
        assert (d <= bar * (lr + np.abs(w))).all(), ("params", k)



if __name__ == "__main__":
    main(*sys.argv[1:3])
