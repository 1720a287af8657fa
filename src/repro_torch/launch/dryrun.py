"""``python -m repro_torch.launch.dryrun`` -- the multi-pod dry-run's
counterpart (``repro.launch.dryrun``): a memory and collective model of
every (architecture x input shape x mesh) cell.

The reference lowers each cell with ``jax.jit`` on 512 forced host devices
and reads XLA's ``memory_analysis`` / ``cost_analysis`` and the collectives
of the partitioned HLO.  The port has no compiler to ask; what decides
those quantities is its own: the lifting rule table
(``distributed.sharding``), the distributed plans' byte model
(``distributed.plan``) and the three-term roofline (``core.cost``).  Each
record says ``"source": "model"``, so that no reader takes it for a
lowering.  Per cell:

* the production mesh, 16 x 16 (``data``, ``model``) or 2 x 16 x 16
  (``pod``, ``data``, ``model``), stood in for by a :class:`SizedMesh`
  (its axis names and sizes; no rank is started);
* ``status``: ``SKIP`` with the reference's reason where the cell does not
  apply (``configs.cell_applicable``), ``FAIL`` with the error where the
  model raises, else ``OK``;
* ``params_total`` / ``params_active`` (``ArchConfig.param_count``) and,
  for a train cell, ``microbatches`` (:func:`default_microbatches`, lowered
  until each microbatch still splits over the data axes, as the
  reference's ``lower_cell``);
* ``per_rank_bytes``: every parameter leaf's shard at
  ``sharding.param_placements`` (a ``Shard`` over a mesh dim divides that
  tensor dim by the dim's size): ``params`` in the leaf's dtype and, for a
  train cell, the AdamW state at the same placements, ``master``, ``m``
  and ``v`` in f32 (``optim.adamw.init``); ``cache`` the decode cache of
  ``registry.input_specs`` at its activation placements
  (``cache_logical_axes`` + ``act_spec``); ``activations`` under this
  model: a train microbatch keeps one residual ``(rows, S, d)`` a layer
  for the backward (remat "full") plus the f32 logits and their gradient
  over the vocab's ``model`` shard, and the sharded step's gathered
  weights (:func:`gathered_bytes`: the largest layer's and the table's,
  each with its gradient); a prefill holds two residual streams and the
  last position's f32 logits; a decode step two ``(rows, d)`` residuals
  and its f32 logits ("rows": the batch over the data axes);
* ``collectives_bytes``: per-device interconnect bytes by op.  A train
  cell's is the sharded train step as it runs
  (:func:`train_collective_bytes`: each layer's parameter gathers over
  the data axes, again in the remat rerun, and their reduce-scatters; the
  leaves outside the stacks once a microbatch; every layer's ``"model"``
  collectives, the MLP's, GQA's, MLA's, the RG-LRU's, Mamba-2's and the
  MoE's; the embedding's psum and the vocabulary-parallel loss; the
  gradient reduction over the data axes a chunk is not sharded on),
  held to what the step sends (``comm.SENT``) by
  ``tests/test_torch_distributed.py``.  A prefill or decode cell's is
  the plans' ring model (``DistributedPlan.ici_bytes_by_kind``) for
  every product the step plans (``models.layers``' tensor-parallel MLP:
  its ``"col"`` and ``"sigma"`` plans a layer, on the decoder's rows or
  the encoder's frames; the vocab head's ``"col"`` plan with its columns
  gathered), each derived on one data rank's rows (the batch split over
  ``pod`` x ``data``), its rows left whole and only its ``"model"`` roles
  sharded; the routed experts' exchange there has no plan and is listed
  in ``not_modeled``;
* ``roofline``: ``cost.from_quantities`` on the ``H100`` table at the
  mesh's chip count, with ``model_flops_lm`` (6 N D training, 2 N D
  inference, active parameters for MoE) as both the useful and the
  per-device flops (``model_flops / chips``) and per-device HBM bytes of
  this model: the parameters read once a forward and twice a backward
  per microbatch, the optimizer state read and written once, the
  activations written and read, the cache read (and written by a
  prefill).  A plan axis that its mesh axis does not divide (whisper's
  51865-column head over 16) stays replicated, and the record lists it
  under ``replication_fallbacks``.

    python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k
    python -m repro_torch.launch.dryrun --all --mesh both --out DIR

``--all --mesh both`` writes the 80 records in well under a minute on the
CPU and imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
import warnings
from typing import NamedTuple

import torch

from repro_torch.configs import (SHAPES, all_cells, cell_applicable,
                                 get_config)
from repro_torch.configs.common import ArchConfig
from repro_torch.core import cost as cost_mod
from repro_torch.core.cost import CollectiveStats, from_quantities
from repro_torch.distributed import plan as dplan
from repro_torch.distributed import sharding as shard_rules
from repro_torch.hardware import H100
from repro_torch.models import registry
from repro_torch.models.common import ShapeConfig

#: the reference's HLO opcode names of the plans' collective kinds
OP_NAMES = {"psum": "all-reduce", "reduce_scatter": "reduce-scatter",
            "all_gather": "all-gather"}
F32 = 4


class SizedMesh:
    """A device mesh's names and sizes, duck-typed as the rule table and
    the plans read a ``DeviceMesh`` (``mesh_dim_names``, ``shape``,
    ``size(i)``): the production mesh without its ranks."""

    def __init__(self, sizes: dict):
        self.mesh_dim_names = tuple(sizes)
        self.shape = tuple(int(v) for v in sizes.values())

    def size(self, i: int | None = None) -> int:
        if i is None:
            n = 1
            for s in self.shape:
                n *= s
            return n
        return self.shape[i]


def production_mesh(multi_pod: bool) -> SizedMesh:
    """``launch.mesh.make_production_mesh``'s shape, without ranks."""
    if multi_pod:
        return SizedMesh({"pod": 2, "data": 16, "model": 16})
    return SizedMesh({"data": 16, "model": 16})


def default_microbatches(cfg: ArchConfig, shp: ShapeConfig,
                         dp: int = 32, tp: int = 16,
                         logit_budget: int = 2 * 2**30) -> int:
    """Activation-memory heuristic (the lifting view of the batch axis).

    The dominant per-device temp for training is the f32 logits+grad buffer
    ~ 2 x B_local x S x vocab/tp x 4B; choose the microbatch count that
    keeps it under ``logit_budget``, then round to a divisor of B_local."""
    if cfg.train_microbatches:
        return cfg.train_microbatches
    b_local = max(shp.global_batch // dp, 1)
    logit_bytes = 2.0 * b_local * shp.seq_len * (cfg.vocab_size / tp) * 4
    act_bytes = 0.0
    if cfg.moe:
        # dispatch replicates tokens x top_k: (t_loc*k, d) gather/scatter
        # buffers live through the layer backward
        act_bytes = 6.0 * b_local * shp.seq_len * cfg.top_k * cfg.d_model * 2
    mb = max(1, int(-(-max(logit_bytes, act_bytes) // logit_budget)))
    while b_local % mb:
        mb += 1
    return min(mb, b_local)


def layer_variants(cfg: ArchConfig) -> tuple[list[tuple[ArchConfig, int]], int]:
    """Two reduced-depth configs + the full unit count, for the linear
    cost regression (XLA cost_analysis counts a scanned layer body ONCE —
    metric(units) = a + b*units recovers the per-layer slope, then we
    extrapolate to full depth)."""
    if cfg.family == "audio":
        mk = lambda k: cfg.with_(n_layers=k, encoder_layers=k, scan_unroll=True)
        return [(mk(1), 1), (mk(2), 2)], cfg.n_layers
    if cfg.family == "hybrid" and cfg.layer_pattern:
        per = len(cfg.layer_pattern)
        tail = cfg.n_layers % per
        mk = lambda g: cfg.with_(n_layers=per * g + tail, scan_unroll=True)
        return [(mk(1), 1), (mk(2), 2)], (cfg.n_layers - tail) // per
    if cfg.layer_pattern:
        per = len(cfg.layer_pattern)
        mk = lambda g: cfg.with_(n_layers=per * g, scan_unroll=True)
        return [(mk(1), 1), (mk(2), 2)], cfg.n_layers // per
    base = cfg.first_dense_layers
    mk = lambda L: cfg.with_(n_layers=L, scan_unroll=True)
    return [(mk(base + 1), base + 1), (mk(base + 2), base + 2)], cfg.n_layers


def _sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _dp(mesh) -> int:
    sizes = _sizes(mesh)
    return sizes.get("pod", 1) * sizes.get("data", 1)


def _nbytes(shape, dtype) -> int:
    n = torch.empty((), dtype=dtype).element_size()
    for s in shape:
        n *= s
    return n


def _local_shape(shape, placements, mesh) -> tuple[int, ...]:
    """One rank's shard of ``shape`` under ``placements`` (one a mesh dim;
    the rule table only shards a dim its mesh axes divide)."""
    out = list(shape)
    for size, pl in zip(mesh.shape, placements):
        if pl.is_shard():
            out[pl.dim] //= size
    return tuple(out)


def param_leaves(cfg: ArchConfig) -> dict[str, tuple]:
    """``{dotted name: (shape, dtype)}`` of the parameter tree, from the
    family's ``param_shapes`` (no allocation)."""
    from repro_torch.models import encdec, transformer
    shapes = encdec.param_shapes(cfg) if cfg.family == "audio" else \
        transformer.param_shapes(cfg)
    dt = getattr(torch, cfg.dtype) if isinstance(cfg.dtype, str) else \
        cfg.dtype
    out = {}
    for group, leaves in shapes.items():
        for name, (shape, _, *own) in leaves.items():
            # a leaf's own dtype (the MoE router's f32), as draw_params
            leaf_dt = getattr(torch, own[0]) if own else dt
            out[f"{group}.{name}"] = (tuple(shape), leaf_dt)
    return out


def state_bytes(cfg: ArchConfig, mesh, train: bool = True) -> dict[str, int]:
    """Per-rank bytes of the parameters at ``sharding.param_placements``
    and, with ``train``, of AdamW's f32 master, m and v at the same
    placements (``optim.adamw.init``'s state, its scalar step left out)."""
    leaves = param_leaves(cfg)
    placed = shard_rules.param_placements(
        {k: s for k, (s, _) in leaves.items()}, registry.param_axes(cfg),
        mesh)
    out = {"params": 0}
    if train:
        out.update(master=0, m=0, v=0)
    for name, (shape, dt) in leaves.items():
        local = _local_shape(shape, placed[name], mesh)
        out["params"] += _nbytes(local, dt)
        if train:
            for k in ("master", "m", "v"):
                out[k] += _nbytes(local, torch.float32)
    return out


def _cache_bytes(cache, mesh) -> int:
    """Per-rank bytes of a decode cache at its activation placements."""
    axes = registry.cache_logical_axes(cache)

    def walk(node, ax):
        if isinstance(node, torch.Tensor):
            spec = shard_rules.act_spec(ax, tuple(node.shape), mesh)
            pl = shard_rules.placements(spec, mesh)
            return _nbytes(_local_shape(tuple(node.shape), pl, mesh),
                           node.dtype)
        if isinstance(node, dict):
            return sum(walk(node[k], ax[k]) for k in node)
        return sum(walk(v, a) for v, a in zip(node, ax))
    return walk(cache, axes)


def _tp(mesh) -> int:
    return _sizes(mesh).get("model", 1)


class _Stacked(NamedTuple):
    """A parameter leaf's shape, dtype and stored placements, sliced per
    layer as the model's layer loop slices a tensor (``unbind``: the
    leading stack axis dropped, a ``Shard`` dim moved down one)."""
    shape: tuple
    dtype: torch.dtype
    placements: tuple

    def unbind(self, dim: int = 0) -> list:
        from torch.distributed.tensor import Shard
        assert dim == 0 and not any(p.is_shard() and p.dim == 0
                                    for p in self.placements)
        pl = tuple(Shard(p.dim - 1) if p.is_shard() else p
                   for p in self.placements)
        return [_Stacked(self.shape[1:], self.dtype, pl)] * self.shape[0]


def _leaf_tree(cfg: ArchConfig, mesh) -> dict:
    """The parameter tree of :class:`_Stacked` leaves (shape, dtype,
    stored placements), nested by the dotted group names."""
    leaves = param_leaves(cfg)
    placed = shard_rules.param_placements(
        {k: s for k, (s, _) in leaves.items()}, registry.param_axes(cfg),
        mesh)
    tree: dict = {}
    for name, (shape, dt) in leaves.items():
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = _Stacked(shape, dt, placed[name])
    return tree


def _layer_slices(cfg: ArchConfig, tree: dict) -> list:
    """``[(kind, {group: {leaf: _Stacked}})]`` a layer, in order, as the
    model's own loops slice and name them (``transformer.layer_params``;
    the encoder-decoder's ``"encoder"`` then ``"decoder"`` stack)."""
    from repro_torch.models import transformer
    if cfg.family == "audio":
        return [(stack, lp) for stack in ("encoder", "decoder")
                for lp in transformer._slices(tree[stack], 1)]
    return transformer.layer_params(tree, cfg)


def _read(group: str, leaf: str, v: _Stacked, shapes: dict, mesh
          ) -> tuple[tuple, bool]:
    """``(shape as the layer reads it, read at its "model" chunk)``."""
    from repro_torch.distributed.fsdp import read_placements
    keep = shard_rules.reads_model_chunk(group, leaf, shapes, _tp(mesh))
    return _local_shape(v.shape, read_placements(
        v.placements, tuple(mesh.mesh_dim_names), keep), mesh), keep


def gathered_layers(cfg: ArchConfig, mesh) -> tuple[list, int]:
    """``([(kind, bytes) a layer], table)``: the bytes of each layer's
    weights as the sharded train step gathers them inside the layer
    (``distributed.fsdp``: whole over the data axes; over ``"model"`` the
    stored chunk where ``sharding.reads_model_chunk`` says the layer
    reads it, else whole), the layers in order as the model's own loops
    slice and name them, and the embedding table's (the untied head's
    alike)."""
    tree = _leaf_tree(cfg, mesh)

    def read(group: str, p: dict) -> int:
        shapes = {k: v.shape for k, v in p.items()}
        return sum(_nbytes(_read(group, k, v, shapes, mesh)[0], v.dtype)
                   for k, v in p.items())
    table = max(read(g, {k: tree[g][k]})
                for g, k in (("embed", "table"), ("unembed", "w"))
                if k in tree.get(g, {}))
    return [(kind, sum(read(g, p) for g, p in lp.items()))
            for kind, lp in _layer_slices(cfg, tree)], table


def gathered_bytes(cfg: ArchConfig, mesh) -> tuple[int, int]:
    """``(largest layer, table)`` of :func:`gathered_layers`."""
    layers, table = gathered_layers(cfg, mesh)
    return max(b for _, b in layers), table


def _activation_bytes(cfg: ArchConfig, shp: ShapeConfig, mesh,
                      mb: int) -> int:
    """The activation model of the module docstring, per rank."""
    rows = max(shp.global_batch // _dp(mesh), 1)
    esize = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    vocab_local = cfg.vocab_size / _tp(mesh)
    d, s = cfg.d_model, shp.seq_len
    if shp.kind == "train":
        r = rows / mb
        layers = cfg.n_layers + cfg.encoder_layers
        layer, table = gathered_bytes(cfg, mesh)
        return int(r * s * d * esize * (layers + 1)
                   + 2 * r * s * vocab_local * F32 + 2 * (layer + table))
    if shp.kind == "prefill":
        return int(2 * rows * s * d * esize + rows * vocab_local * F32)
    return int(2 * rows * d * esize + rows * vocab_local * F32)


def _mlp_pairs(cfg: ArchConfig):
    """``(count, d, wi columns, wo rows, encoder)`` of every stacked MLP
    of the tree (``*.mlp.wi`` / ``*.mlp.wo``)."""
    leaves = param_leaves(cfg)
    for name, (shape, _) in leaves.items():
        if not name.endswith("mlp.wi"):
            continue
        wo = leaves[name[:-2] + "wo"][0]
        count = 1
        for e in shape[:-2]:
            count *= e
        yield count, shape[-2], shape[-1], wo[-2], name.startswith("encoder")


def collective_bytes(cfg: ArchConfig, shp: ShapeConfig, mesh,
                     mb: int) -> dict[str, float]:
    """Per-device interconnect bytes by op (the module docstring's
    model); a train cell's is :func:`train_collective_bytes`."""
    if shp.kind == "train":
        return train_collective_bytes(cfg, shp, mesh, mb)
    dtype = cfg.dtype if isinstance(cfg.dtype, str) else \
        str(cfg.dtype).removeprefix("torch.")
    # one data rank's sequences
    b = max(shp.global_batch // _dp(mesh), 1)
    rows = b * (1 if shp.kind == "decode" else shp.seq_len)
    enc_rows = b * cfg.encoder_seq
    if shp.kind == "decode":
        enc_rows = 0              # the cross K/V is the cache's
    out: dict[str, float] = {}

    def tp(kind):                 # the "model" roles; the rows stay whole
        return {r: a for r, a in dplan.tp_matmul_shard(mesh, kind).items()
                if a == "model"}

    def add(plan, times):
        for kind, v in plan.ici_bytes_by_kind(dtype).items():
            out[OP_NAMES[kind]] = out.get(OP_NAMES[kind], 0.0) + v * times

    for count, d, n_wi, k_wo, enc in _mlp_pairs(cfg):
        m = enc_rows if enc else rows
        if not m:
            continue
        col = dplan.matmul_plan(m, d, n_wi, mesh, shard=tp("col"),
                                dtype=dtype)
        sigma = dplan.matmul_plan(m, k_wo, d, mesh, shard=tp("sigma"),
                                  dtype=dtype)
        add(col, count)
        add(sigma, count)
    head = dplan.matmul_plan(b, cfg.d_model, cfg.vocab_size, mesh,
                             shard=tp("col"),
                             transpose_b=cfg.tie_embeddings,
                             replicate_out=True, dtype=dtype)
    add(head, 1)
    return out


def _share(op: str, p: int) -> float:
    """``comm.count``'s per-device ring share of a tensor's bytes."""
    if p <= 1:
        return 0.0
    return 2.0 * (p - 1) / p if op == "all-reduce" else (p - 1) / p


def train_collective_bytes(cfg: ArchConfig, shp: ShapeConfig, mesh,
                           mb: int) -> dict[str, float]:
    """The sharded train step's per-device interconnect bytes by op, as
    ``train.train_step.make_sharded_train_step`` sends them (``comm.SENT``
    counts the same ops in the same convention), on one data rank's rows
    of each of ``mb`` microbatches:

    * the parameter gathers (``distributed.fsdp``): each layer's leaves
      all-gathered over the data axes where stored there, and over
      ``"model"`` where stored there and read whole
      (``sharding.reads_model_chunk``), once a forward and again in the
      remat rerun (``cfg.remat``), or with remat off once more each time
      the backward unpacks a saved view of it
      (``fsdp.saved_regathers``); each
      data gather's gradient reduce-scattered once; the leaves outside
      the stacks (the table, tied or not, the head, the final norms, the
      frontend) gathered and reduce-scattered once a microbatch;
    * each layer's ``"model"`` collectives on one data rank's rows, as
      each layer kind lists them beside its forward (``comm.Traffic``:
      ``attention``, ``rglru``, ``ssm`` and ``moe``'s ``train_traffic``,
      ``layers.mlp_traffic``), in the order the layer runs them; the
      remat rerun repeats its forward ones but the last (the rerun stops
      at the last tensor the backward saves);
    * the embedding's psum of its rows, the head's input gradient and the
      vocabulary-parallel NLL's three f32 row all-reduces where
      ``"model"`` divides the vocabulary (else the head and the loss run
      whole: nothing over ``"model"``);
    * ``reduce_grad``'s all-reduce of each stored chunk over the data
      axes it is not sharded on (in the leaf's dtype for one microbatch,
      else f32).

    The f32 scalars (the norm, the metrics, the MoE's drop count) are
    left out; they move a few bytes."""
    from repro_torch.distributed.fsdp import saved_regathers
    from repro_torch.models import attention, moe, rglru, ssm
    from repro_torch.models.layers import mlp_traffic
    remat = cfg.remat
    sizes = _sizes(mesh)
    names = tuple(mesh.mesh_dim_names)
    tp = sizes.get("model", 1)
    data_axes = [a for a in ("pod", "data") if a in sizes]
    esz = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    b = max(shp.global_batch // mb // _dp(mesh), 1)
    rows = b * shp.seq_len
    enc_rows = b * cfg.encoder_seq
    d = cfg.d_model
    out: dict[str, float] = {}

    def add(op, p, nbytes, times=1):
        share = _share(op, p)
        if share and nbytes and times:
            out[op] = out.get(op, 0.0) + share * nbytes * times

    def gathers(group, leaf, v, shapes, layer: bool):
        """One leaf's gathers (each forward, the reruns or regathers)
        and its gradient's reduce-scatters."""
        shape = list(_local_shape(v.shape, v.placements, mesh))
        moves = []
        for a in reversed(data_axes):            # the inner axis first
            pl = v.placements[names.index(a)]
            if pl.is_shard() and sizes[a] > 1:
                shape[pl.dim] *= sizes[a]
                moves.append((a, _nbytes(shape, v.dtype)))
        keep = _read(group, leaf, v, shapes, mesh)[1]
        pl = v.placements[names.index("model")] if "model" in names \
            else None
        if pl is not None and pl.is_shard() and not keep and tp > 1:
            shape[pl.dim] *= tp
            moves.append(("model", _nbytes(shape, v.dtype)))
        times = 1
        if layer:
            times = 2 if remat else \
                1 + saved_regathers(leaf, v.dtype, cfg.conv_width)
        for a, n in moves:
            add("all-gather", sizes[a], n, times)
            if a != "model":
                add("reduce-scatter", sizes[a], n)

    def traffic(kind, lp) -> list:
        """The layer's ``"model"`` collectives a block at a time, in the
        order it runs its blocks."""
        r = enc_rows if kind == "encoder" else rows
        gated = cfg.mlp in ("swiglu", "geglu")
        blocks = [attention.train_traffic(
            lp[g], cfg, r, tp, esz, enc_rows if g == "cross_attn" else 0)
            for g in ("self_attn", "attn", "cross_attn") if g in lp]
        blocks += [fn(lp[g], cfg, r, tp, esz)
                   for g, fn in (("rec", rglru.train_traffic),
                                 ("mixer", ssm.train_traffic),
                                 ("moe", moe.train_traffic)) if g in lp]
        if "mlp" in lp:
            blocks.append(mlp_traffic(lp["mlp"]["wi"], cfg, r, tp, esz,
                                      gated))
        return blocks

    tree = _leaf_tree(cfg, mesh)
    for kind, lp in _layer_slices(cfg, tree):
        for group, p in lp.items():
            shapes = {k: v.shape for k, v in p.items()}
            for leaf, v in p.items():
                gathers(group, leaf, v, shapes, True)
        blocks = traffic(kind, lp)
        # the rerun stops at the psum that ends the layer: the last
        # forward collective of its last block
        ends = max((i for i, t in enumerate(blocks[-1]) if t.when == "fwd"),
                   default=None) if blocks else None
        for j, block in enumerate(blocks):
            for i, t in enumerate(block):
                again = t.when == "weight" or (
                    t.when == "fwd" and remat
                    and (j, i) != (len(blocks) - 1, ends))
                add(t.op, tp, t.nbytes, 2 if again else 1)
    for group, p in tree.items():
        if all(isinstance(v, _Stacked) for v in p.values()):
            for leaf, v in p.items():
                gathers(group, leaf, v, {}, False)
    if cfg.vocab_size % tp == 0:
        text = rows - b * cfg.num_patches if cfg.family == "vlm" else rows
        table = tree["embed"]["table"]
        add("all-reduce", tp, text * d * table.dtype.itemsize)
        add("all-reduce", tp, text * d * esz)
        add("all-reduce", tp, text * F32, 3)
    if mb > 1:
        out = {k: v * mb for k, v in out.items()}
    for name, v in param_leaves(cfg).items():
        placed = _leaf_of(tree, name)
        local = _local_shape(placed.shape, placed.placements, mesh)
        for a in data_axes:
            if not placed.placements[names.index(a)].is_shard():
                add("all-reduce", sizes[a], _nbytes(
                    local, v[1] if mb == 1 else torch.float32))
    return out


def _leaf_of(tree: dict, name: str) -> _Stacked:
    node = tree
    for part in name.split("."):
        node = node[part]
    return node


def _model_flops(cfg: ArchConfig, shp: ShapeConfig) -> float:
    total, active = cfg.param_count()
    if shp.kind == "train":
        return cost_mod.model_flops_lm(total, shp.tokens,
                                       active_params=active, training=True)
    n = shp.tokens if shp.kind == "prefill" else shp.global_batch
    return cost_mod.model_flops_lm(total, n, active_params=active,
                                   training=False)


def model_cell(cfg: ArchConfig, shape_name: str, multi_pod: bool) -> dict:
    """The record's modelled fields for one applicable cell."""
    shp = SHAPES[shape_name]
    mesh = production_mesh(multi_pod)
    n_chips = mesh.size()
    train = shp.kind == "train"
    total, active = cfg.param_count()
    rec = {"arch": cfg.name, "shape": shp.name, "kind": shp.kind,
           "n_chips": n_chips, "source": "model",
           "params_total": total, "params_active": active}
    mb = 1
    if train:
        mb = default_microbatches(cfg, shp)
        dp = _dp(mesh)
        while mb > 1 and (shp.global_batch // mb) % dp:
            mb -= 1
        rec["microbatches"] = mb
    per_rank = state_bytes(cfg, mesh, train=train)
    specs = registry.input_specs(cfg, shp)
    per_rank["cache"] = _cache_bytes(specs["cache"], mesh) \
        if "cache" in specs else 0
    per_rank["activations"] = _activation_bytes(cfg, shp, mesh, mb)
    rec["per_rank_bytes"] = per_rank
    with warnings.catch_warnings(record=True) as fallbacks:
        warnings.simplefilter("always", dplan.ReplicationFallbackWarning)
        coll = collective_bytes(cfg, shp, mesh, mb)
    rec["collectives_bytes"] = coll
    # a plan's axis that its mesh axis does not divide stays replicated
    rec["replication_fallbacks"] = sorted({str(w.message) for w in fallbacks})
    if train and cfg.vocab_size % _tp(mesh):
        rec["replication_fallbacks"].append(
            f"vocab {cfg.vocab_size} over model {_tp(mesh)}: the head and "
            f"the loss run whole")
    rec["not_modeled"] = ["moe expert dispatch"] if cfg.moe and not train \
        else []
    mf = _model_flops(cfg, shp)
    reads = per_rank["params"] * (3 * mb if train else 1)
    if train:
        reads += 2 * (per_rank["master"] + per_rank["m"] + per_rank["v"])
    hbm = reads + 2 * per_rank["activations"] + per_rank["cache"] * (
        2 if shp.kind == "prefill" else 1)
    rl = from_quantities(f"{cfg.name}/{shp.name}", n_chips=n_chips,
                         per_device_flops=mf / n_chips,
                         per_device_hbm_bytes=hbm,
                         collective_stats=CollectiveStats(
                             bytes_by_op={k: int(v) for k, v in coll.items()}),
                         hardware=H100, model_flops=mf)
    rec["roofline"] = rl.to_dict()
    return rec


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             out_dir: str | None) -> dict:
    """One cell's record, written to ``{arch}__{shape}__{mesh}.json`` in
    ``out_dir`` (None: not written)."""
    ok, why = cell_applicable(arch, shape_name)
    if not ok:
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
               "status": "SKIP", "reason": why, "source": "model"}
    else:
        try:
            rec = model_cell(get_config(arch), shape_name,
                             mesh_kind == "multi")
            rec.update(mesh=mesh_kind, status="OK")
        except Exception as e:
            rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                   "status": "FAIL", "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-2000:],
                   "source": "model"}
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fn = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_kind}.json")
        with open(fn, "w") as f:
            json.dump(rec, f, indent=1, default=str)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=[None, *SHAPES])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--no-donate", action="store_true",
                    help="accepted for the reference's command line; the "
                         "model has no buffers to donate")
    args = ap.parse_args(argv)
    cells = all_cells() if args.all else [
        (a, s) for a, s in all_cells()
        if (args.arch in (None, a)) and (args.shape in (None, s))]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    failed = 0
    for arch, shape_name in cells:
        for mk in meshes:
            t0 = time.time()
            rec = run_cell(arch, shape_name, mk, args.out)
            status = rec.get("status")
            dom = rec.get("roofline", {}).get("dominant", "-")
            print(f"[{time.time()-t0:7.1f}s] {arch:28s} {shape_name:12s} "
                  f"{mk:6s} {status:5s} dominant={dom}", flush=True)
            if status == "FAIL":
                failed += 1
                print(rec.get("error"), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
