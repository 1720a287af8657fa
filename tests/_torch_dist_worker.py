"""One rank of the gloo worlds that ``tests/test_torch_distributed.py``
starts on the CPU.

    python tests/_torch_dist_worker.py <directory> <rank> <world>

The ranks meet on a ``file://`` store in ``<directory>``, read the jobs
the test wrote there (``jobs.pkl``: ``(name, kind, args)``), run each
on every rank and write what they return (``out_<rank>.pkl``: ``{name:
("ok", result) or ("error", traceback)}``).  Imports torch and the port
only; the test holds the results against the JAX package.
"""
import os
import pickle
import sys
import traceback
import warnings

import numpy as np
import torch
import torch.distributed as dist

_MESHES: dict = {}


def _mesh(axes):
    """The ``DeviceMesh`` of ``((name, size), ...)`` over the world's
    first ranks, made once."""
    from torch.distributed.device_mesh import DeviceMesh
    axes = tuple(axes)
    if axes not in _MESHES:
        shape = tuple(s for _, s in axes)
        n = int(np.prod(shape))
        _MESHES[axes] = DeviceMesh("cpu", torch.arange(n).reshape(shape),
                                   mesh_dim_names=tuple(a for a, _ in axes))
    return _MESHES[axes]


def _np(t):
    return t.detach().cpu().float().numpy()


def _full(y):
    from repro_torch.distributed import comm
    return comm.gather_full(y.to_local(), y.device_mesh, y.placements)


def job_apply(label, arrays, cotangent, as_dtensor):
    """A ``_plan_cases`` entry through ``ops.apply(mesh=)`` on whole
    operands: the whole result, each operand's gradient of ``sum(out *
    cotangent)`` and the result's placements; on DTensors placed as the
    plan reads them, the result and its placements."""
    from torch.distributed.tensor import DTensor

    from repro_torch.analysis import verify_all
    from repro_torch.distributed import plan as dplan
    from repro_torch.kernels import ops
    (_, form, ms, shard, kw), = [c for c in verify_all._plan_cases()
                                 if c[0] == label]
    mesh = _mesh(ms.axes)
    leaves = [torch.tensor(a, requires_grad=True) for a in arrays]
    ins = leaves
    if as_dtensor:
        from repro_torch.distributed import comm
        plan = dplan.derive_plan(form, mesh, shard=shard, **kw)
        ins = [DTensor.from_local(comm.local_chunk(t, mesh, pl), mesh, pl,
                                  run_check=False)
               for t, pl in zip(leaves, plan.in_placements(mesh))]
    y = ops.apply(form, *ins, mesh=mesh, shard=shard, verify=True, **kw)
    full = _full(y)
    if as_dtensor:
        return _np(full), None, [str(p) for p in y.placements]
    (full * torch.tensor(cotangent)).sum().backward()
    return (_np(full), [_np(t.grad) for t in leaves],
            [str(p) for p in y.placements])


def job_rings(x, w, x2, w2, axis_size):
    """``ag_matmul`` / ``psum_matmul`` and their plain references on this
    rank's shards of a mesh ``("x", axis_size)``."""
    from repro_torch.distributed import collectives as cl
    from repro_torch.distributed import comm
    mesh = _mesh((("x", axis_size),))
    g = mesh.get_group("x")
    x, w, x2, w2 = (torch.tensor(a) for a in (x, w, x2, w2))
    xs = comm.chunk_of(x, g, 0).contiguous()
    xk = comm.chunk_of(x2, g, 1).contiguous()
    wk = comm.chunk_of(w2, g, 0).contiguous()
    return tuple(_np(t) for t in (
        cl.ag_matmul(xs, w, mesh, "x"), cl.reference_ag_matmul(xs, w, mesh,
                                                                "x"),
        cl.psum_matmul(xk, wk, mesh, "x"),
        cl.reference_psum_matmul(xk, wk, mesh, "x")))


def _config(arch):
    from repro_torch.configs import get_config
    return get_config(arch, reduced=True)


def job_lm_planned(arch, tree, batch, axes):
    """The family's loss on this rank's rows under ``planned_mesh`` (the
    data axis deferred), its gradients reduced over "data" as the
    sharded step reduces them: the global batch's loss and gradients."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.distributed import comm
    from repro_torch.distributed import plan as dplan
    from repro_torch.models import registry
    cfg = _config(arch)
    mesh = _mesh(axes)
    params = params_from_numpy(tree, device="cpu", trainable=True)
    dg = mesh.get_group("data")
    dp, row = comm.group_size(dg), comm.group_rank(dg)
    rows = {k: torch.from_numpy(v).chunk(dp)[row] for k, v in batch.items()}
    names, leaves = zip(*params.named_parameters())
    with dplan.planned_mesh(mesh, defer=("data",)):
        loss, _ = registry.loss(params, cfg, rows)
        grads = torch.autograd.grad(loss, leaves)
    loss = comm.all_reduce(loss.detach(), dg) / dp
    return float(loss), {n: _np(comm.all_reduce(g, dg) / dp)
                         for n, g in zip(names, grads)}


def job_moe(arch, tree, x, axes):
    """``_apply_moe_shardmap`` on this rank's rows of ``x``: the whole
    output (rows gathered over "data"), the top-k of this rank's rows
    and the stats."""
    from repro_torch.distributed import comm
    from repro_torch.models import moe
    cfg = _config(arch)
    mesh = _mesh(axes)
    dg = mesh.get_group("data")
    p = {k: torch.tensor(v) for k, v in tree.items()}
    xs = comm.chunk_of(torch.tensor(x), dg, 0).contiguous()
    y, st = moe._apply_moe_shardmap(p, xs, cfg, mesh)
    idx = moe.route(p, xs.reshape(-1, xs.shape[-1]), cfg)[3]
    return (_np(comm.all_gather(y, dg, 0)),
            _np(comm.all_gather(idx.reshape(xs.shape[0], -1), dg, 0)),
            [float(v) for v in st])


def job_train(arch, tree, batches, axes, comp_on, lr):
    """Sharded train steps (``make_sharded_train_step``) from the
    parameters ``tree``: the metrics of each step, the whole parameters
    after the last, and whether every rank's leaves (parameters, masters,
    m, v) hold exactly its rule-table chunk."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.distributed import comm
    from repro_torch.distributed.compression import CompressionConfig
    from repro_torch.distributed.sharding import param_placements
    from repro_torch.models import registry
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import train_step as ts
    cfg = _config(arch)
    mesh = _mesh(axes)
    comp = CompressionConfig(enabled=comp_on)
    opt = AdamWConfig(lr_peak=lr, warmup_steps=2, decay_steps=10)
    params = params_from_numpy(tree, device="cpu", trainable=True)
    state = ts.init_sharded_state(cfg, params, mesh, comp)
    step = ts.make_sharded_train_step(cfg, mesh, opt, comp)
    row = mesh.get_coordinate()[0]
    dp = mesh.size(0)
    metrics = []
    for b in batches:
        rows = {k: torch.from_numpy(v).chunk(dp)[row] for k, v in b.items()}
        state, m = step(state, rows)
        metrics.append({k: float(v) for k, v in m.items()})
    whole = {k: comm.gather_full(t.to_local(), mesh, t.placements)
             for k, t in state.params.items()}
    want = param_placements(params, registry.param_axes(cfg), mesh)
    placed = all(
        tuple(t.placements) == tuple(want[k]) and torch.equal(
            t.to_local(), comm.local_chunk(whole[k], mesh, want[k]))
        for k, t in state.params.items())
    for tree in (state.opt.master, state.opt.m, state.opt.v):
        placed &= all(tuple(t.placements) == tuple(want[k])
                      for k, t in tree.items())
    return metrics, {k: _np(v) for k, v in whole.items()}, bool(placed)


def job_train_planned(arch, tree, batches, axes, lr):
    """``make_train_step(planned_mesh=)`` steps, every rank holding the
    whole state and batch: the metrics and the parameters after them."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import train_step as ts
    cfg = _config(arch)
    mesh = _mesh(axes)
    params = params_from_numpy(tree, device="cpu", trainable=True)
    state = ts.init_state(cfg, params, "cpu")
    step = ts.make_train_step(cfg, AdamWConfig(lr_peak=lr, warmup_steps=2,
                                               decay_steps=10),
                              planned_mesh=mesh)
    metrics = []
    for b in batches:
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, {k: _np(p) for k, p in params.named_parameters()}


def _bits(t):
    t = t.detach()
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
        else t.numpy()


def job_checkpoint(arch, directory):
    """One compressed sharded step at (data 2, model 2), saved; restored
    into a fresh sharded state at (data 4, model 1), and its parameters
    into plain chunks through ``restore(shardings=)``; the restored
    parameters resharded by ``ElasticManager`` onto its mesh.  Returns
    the saved and the restored state's whole leaves as bits, the step,
    whether the plain chunks equal the DTensors', and the elastic mesh's
    shape with whether its chunks are the rule table's."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.distributed import comm
    from repro_torch.distributed.compression import CompressionConfig
    from repro_torch.models import registry
    from repro_torch.train import train_step as ts
    cfg = _config(arch)
    comp = CompressionConfig(enabled=True)
    m22 = _mesh((("data", 2), ("model", 2)))
    params = registry.init(cfg, torch.Generator().manual_seed(3), "cpu",
                           trainable=True)
    state = ts.init_sharded_state(cfg, params, m22, comp)
    tok = torch.randint(0, cfg.vocab_size, (4, 8),
                        generator=torch.Generator().manual_seed(4))
    row = m22.get_coordinate()[0]
    state, _ = ts.make_sharded_train_step(cfg, m22, comp=comp)(
        state, {"tokens": tok.chunk(2)[row], "targets": tok.chunk(2)[row]})
    ck = Checkpointer(directory)
    ck.save(1, state, metadata={"data_step": 1})

    def whole(st):
        from torch.distributed.tensor import DTensor
        out = {}
        for tree_name, tree in (("params", st.params),
                                ("master", st.opt.master), ("m", st.opt.m),
                                ("v", st.opt.v), ("err", st.err_fb)):
            for k, t in tree.items():
                assert isinstance(t, DTensor)
                out[f"{tree_name}/{k}"] = _bits(comm.gather_full(
                    t.to_local(), t.device_mesh, t.placements))
        return out
    saved = whole(state)
    m41 = _mesh((("data", 4), ("model", 1)))
    fresh = ts.init_sharded_state(
        cfg, registry.init(cfg, torch.Generator().manual_seed(9), "cpu",
                           trainable=True), m41, comp)
    fresh, manifest = ck.restore(fresh)
    # the same leaves into plain chunks through restore(shardings=)
    like = {"params": {k: torch.empty_like(t.to_local())
                       for k, t in fresh.params.items()}}
    shardings = {"params/" + k.replace(".", "/"): (m41, t.placements)
                 for k, t in fresh.params.items()}
    like, _ = ck.restore(like, shardings=shardings)
    plain_equal = all(torch.equal(like["params"][k], t.to_local())
                      for k, t in fresh.params.items())
    # the elastic re-mesh: best_mesh_shape(4) is (1, 4); reshard the
    # restored whole parameters by the rule table onto it
    from repro_torch.distributed.fault import ElasticManager
    from repro_torch.distributed.sharding import param_placements
    em = ElasticManager()
    me = em.make_mesh(device_type="cpu")
    whole_params = {k: comm.gather_full(t.to_local(), m41, t.placements)
                    for k, t in fresh.params.items()}
    axes = registry.param_axes(cfg)
    placed = em.reshard(whole_params, axes, me)
    want = param_placements(whole_params, axes, me)
    elastic = (tuple(me.shape), all(
        tuple(t.placements) == tuple(want[k]) and torch.equal(
            t.to_local(), comm.local_chunk(whole_params[k], me, want[k]))
        for k, t in placed.items()))
    return saved, whole(fresh), int(manifest["step"]), plain_equal, elastic


def job_compress(shapes_specs, arrays, errors):
    """``compress_sharded`` on this rank's chunks against
    ``compress_grads`` on the whole leaves, each leaf's result gathered
    whole."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed import comm
    from repro_torch.distributed.compression import (CompressionConfig,
                                                     compress_grads,
                                                     compress_sharded)
    cfg = CompressionConfig(enabled=True)
    mesh = _mesh((("data", 2), ("model", 2)))
    out = {}
    for (name, dims), g, e in zip(shapes_specs, arrays, errors):
        pl = tuple(Shard(d) if d is not None else Replicate() for d in dims)
        whole_g, whole_e = compress_grads(
            cfg, {name: torch.tensor(g)}, {name: torch.tensor(e)})
        gl = comm.local_chunk(torch.tensor(g), mesh, pl).clone()
        el = comm.local_chunk(torch.tensor(e), mesh, pl).clone()
        sg, se = compress_sharded(cfg, {name: gl}, {name: el},
                                  {name: g.shape}, {name: pl}, mesh)
        out[name] = (_np(whole_g[name]), _np(whole_e[name]),
                     _np(comm.gather_full(sg[name], mesh, pl)),
                     _np(comm.gather_full(se[name], mesh, pl)))
    return out


JOBS = {"apply": job_apply, "rings": job_rings,
        "lm_planned": job_lm_planned, "moe": job_moe, "train": job_train,
        "train_planned": job_train_planned,
        "checkpoint": job_checkpoint, "compress": job_compress}


def main(directory: str, rank: int, world: int) -> None:
    # this torch warns that all_gather_into_tensor is deprecated; the port
    # writes against the API the card's torch has too
    warnings.simplefilter("ignore")
    torch.manual_seed(0)
    dist.init_process_group("gloo", init_method=f"file://{directory}/store",
                            rank=rank, world_size=world)
    with open(os.path.join(directory, "jobs.pkl"), "rb") as f:
        jobs = pickle.load(f)
    out = {}
    for name, kind, args in jobs:
        try:
            out[name] = ("ok", JOBS[kind](*args))
        except Exception:
            out[name] = ("error", traceback.format_exc())
            break                    # the other ranks may wait in a collective
    with open(os.path.join(directory, f"out_{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), "src"))
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
