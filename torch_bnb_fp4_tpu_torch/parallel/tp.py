"""Tensor and data parallelism over ``torch.distributed`` process groups.

Counterpart of ``torch_bnb_fp4_tpu/parallel/tp.py``.  The JAX package runs
one ``shard_map`` over a ``(data, model)`` device mesh; here every rank is a
process holding one device, and the mesh is a set of process groups:

  * rank ``r = d * n_model + m`` sits at data index d and model index m (JAX's
    ``reshape(n_data, n_model)`` of the device list);
  * its ``model_group`` holds the n_model ranks of data replica d, its
    ``data_group`` the n_data ranks of model index m;
  * the params of a rank are its local shards (:func:`shard_params`):
    column-parallel wq/wk/wv/w_gate/w_up (and the fused wqkv / w_gateup,
    interleaved per shard by ``fuse_params(tp=)``) split their output
    columns, row-parallel wo/w_down split K (a split-K packing with
    ``k_shards = tp`` self-contained slices), the lm_head its vocabulary,
    expert stacks their trailing axes; embed, norms and the router are
    replicated;
  * the forward (:func:`tp_forward_fn`) runs the port's kernels on the local
    shards and sums the two row-parallel outputs of each layer over the model
    group: 2 all-reduces per dense layer (Megatron's pattern, the JAX
    package's two psums).  Logits stay vocabulary-sharded; the greedy steps
    (:func:`make_decode_step`, :func:`make_prefill`) gather them over the
    model group before the argmax.

Backend rule (one rule, logged and kept on ``Mesh.backend``; nothing switches
backend after a failure): the mesh's groups use ``nccl`` when every rank's
device is a CUDA device that no other rank on its host uses, and ``gloo``
otherwise (CPU ranks, or ranks that share a card; NCCL refuses two ranks on
one card).  The world group that :func:`init_multihost` creates is always
gloo: it carries the host-side control plane (``serve/multihost.py``) even
when the tensors go over NCCL.  Collectives are counted in
:data:`COLLECTIVES` (:func:`collective_counts`).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import socket
from typing import Any

import torch
import torch.distributed as dist

from ..models import transformer as T
from ..models.linear import (DenseLinear, LoRALinear, MultiLoRALinear, QuantLinear, attach_int8_shadow, local_view,
                             quantize_linear)

log = logging.getLogger("torch_bnb_fp4_tpu_torch.parallel")

DATA_AXIS = "data"
MODEL_AXIS = "model"

# collectives issued by this process, by kind (all_reduce, all_gather, broadcast)
COLLECTIVES: dict[str, int] = {"all_reduce": 0, "all_gather": 0, "broadcast": 0}


def collective_counts() -> dict[str, int]:
    return dict(COLLECTIVES)


def reset_collective_counts() -> None:
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0


# ---------------------------------------------------------------------------
# Process groups
# ---------------------------------------------------------------------------


def init_multihost(coordinator_address: str | None = None, num_processes: int | None = None,
                   process_id: int | None = None) -> int:
    """Join this process to the job: ``dist.init_process_group("gloo",
    init_method=f"tcp://{coordinator_address}")``.  Absent arguments are read
    from torchrun's environment (``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``), torch's counterpart of JAX reading the TPU
    metadata.  The world group is gloo (the control plane); :func:`make_mesh`
    makes the data and model groups.  Returns this process's rank."""
    env = os.environ
    need = {"coordinator_address": ("MASTER_ADDR", "MASTER_PORT"), "num_processes": ("WORLD_SIZE",),
            "process_id": ("RANK",)}
    given = dict(coordinator_address=coordinator_address, num_processes=num_processes, process_id=process_id)
    missing = [v for k, vs in need.items() if given[k] is None for v in vs if v not in env]
    if missing:
        raise ValueError(f"init_multihost: pass the coordinator address, process count and id, or set "
                         f"{', '.join(missing)} (torchrun sets them)")
    if coordinator_address is None:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    world = int(env["WORLD_SIZE"]) if num_processes is None else num_processes
    rank = int(env["RANK"]) if process_id is None else process_id
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}", world_size=world, rank=rank)
    return dist.get_rank()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a ``(data, model)`` mesh: its indices, its two
    process groups, the groups' backend and its device.  ``ctrl_group`` is
    a gloo group over every rank for host objects (``None``: the world
    group, which :func:`init_multihost` makes gloo)."""

    n_data: int
    n_model: int
    rank: int
    data_index: int
    model_index: int
    model_group: Any
    data_group: Any
    backend: str
    device: torch.device
    ctrl_group: Any = None

    def data_rank(self, data_index: int) -> int:
        """Global rank of this model index's rank in data replica ``data_index``
        (a source for ``data_group`` collectives)."""
        return data_index * self.n_model + self.model_index


def mesh_backend(keys: list[tuple[str, str]]) -> str:
    """The backend rule over every rank's (host, device): ``nccl`` when each
    device is a CUDA device no other rank on its host uses, else ``gloo``."""
    cuda = all(dev.startswith("cuda") for _, dev in keys)
    return "nccl" if cuda and len(set(keys)) == len(keys) else "gloo"


def make_mesh(n_model: int | None = None, n_data: int = 1, device=None) -> Mesh:
    """Build this rank's view of a ``(data, model)`` mesh over every process
    of the job (:func:`init_multihost` first).  ``n_model`` defaults to the
    world size over ``n_data``.  ``device``: default ``cuda:{local_rank %
    device_count}`` (local rank: this rank's order among the ranks on its
    host), or the caller's (``"cpu"`` in the tests; one card may be given to
    several ranks).  Every rank creates every model group, then every data
    group, in one order (``dist.new_group`` is collective)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group: call init_multihost first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_model is None:
        n_model = world // n_data
    if n_model < 1 or n_data < 1 or n_model * n_data != world:
        raise ValueError(f"mesh data={n_data} x model={n_model} does not cover the {world} processes")
    ctrl = None if dist.get_backend() == "gloo" else dist.new_group(backend="gloo")
    host = socket.gethostname()
    hosts: list = [None] * world
    dist.all_gather_object(hosts, host, group=ctrl)
    local_rank = hosts[:rank].count(host)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available on this host; pass device='cpu' to run the plain versions")
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    keys: list = [None] * world
    dist.all_gather_object(keys, (host, str(device)), group=ctrl)
    backend = mesh_backend(keys)
    d, m = divmod(rank, n_model)
    model_groups = [dist.new_group([dd * n_model + mm for mm in range(n_model)], backend=backend)
                    for dd in range(n_data)]
    data_groups = [dist.new_group([dd * n_model + mm for dd in range(n_data)], backend=backend)
                   for mm in range(n_model)]
    log.info("mesh data=%d x model=%d: rank %d (data %d, model %d) on %s, %s groups (%s)", n_data, n_model, rank,
             d, m, device, backend, "one card per rank" if backend == "nccl" else "CPU ranks or a shared card")
    return Mesh(n_data=n_data, n_model=n_model, rank=rank, data_index=d, model_index=m,
                model_group=model_groups[d], data_group=data_groups[m], backend=backend, device=device,
                ctrl_group=ctrl)


# ---------------------------------------------------------------------------
# Collectives, counted.  gloo takes CUDA tensors for each of them (staging
# them through the host itself), so no backend needs a path of its own.
# ---------------------------------------------------------------------------


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` over ``group`` in place; returns ``x``."""
    COLLECTIVES["all_reduce"] += 1
    dist.all_reduce(x, group=group)
    return x


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Each rank's ``x`` (one shape on every rank) concatenated along ``dim``
    in the group's rank order."""
    n = dist.get_world_size(group)
    COLLECTIVES["all_gather"] += 1
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def broadcast_(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """``x`` of global rank ``src`` written into every rank's ``x`` in place."""
    COLLECTIVES["broadcast"] += 1
    dist.broadcast(x, src=src, group=group)
    return x


def gather_vocab(logits: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Full-vocabulary logits from this rank's vocabulary shard (..., V/tp)
    (the model group holds the shards in model-index order)."""
    return logits if mesh.n_model == 1 else all_gather(logits, mesh.model_group, dim=-1)


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------


def validate_tp(cfg: T.ModelConfig, tp: int) -> None:
    """Check the geometry admits a model-axis width of ``tp``."""
    kv_dim = cfg.n_kv_heads * cfg.head_dim
    ok = (
        cfg.n_heads % tp == 0
        and cfg.n_kv_heads % tp == 0
        and (kv_dim // tp) % 128 == 0
        and (cfg.dim // tp) % 128 == 0
        and (cfg.q_dim // tp) % 128 == 0  # o_proj K when head_dim decoupled
        and (cfg.ffn_dim // tp) % 128 == 0
        and cfg.dim % (tp * 2 * cfg.blocksize) == 0
        and cfg.q_dim % (tp * 2 * cfg.blocksize) == 0
        and cfg.ffn_dim % (tp * 2 * cfg.blocksize) == 0
        and cfg.vocab_size % tp == 0
    )
    if not ok:
        raise ValueError(f"geometry {cfg} does not shard over tp={tp}")


def quantize_params_tp(cfg: T.ModelConfig, weights: dict, tp: int, fuse: bool = False,
                       device=None) -> T.ModelParams:
    """``models.quantize_params`` arranged for a model-axis width of ``tp``.
    Pair-K shards contiguously in both dims, so its packing is kept (fused
    per shard with ``fuse``); split-K row-parallel layers (wo, w_down) are
    requantized with ``k_shards = tp`` so their K axis shards contiguously."""
    validate_tp(cfg, tp)
    params = T.quantize_params(cfg, weights, device=device)
    if params.layers[0].wo.layout == "pairk":
        return T.fuse_params(params, tp=tp) if fuse else params
    if fuse:
        raise ValueError("fusion is pairk-only")

    def requant(name: str, i: int) -> QuantLinear:
        return quantize_linear(weights[f"model.layers.{i}.{name}.weight"], blocksize=cfg.blocksize,
                               quant_type=cfg.quant_type, k_shards=tp, device=params.final_norm.device)

    layers = [dataclasses.replace(lp, wo=requant("self_attn.o_proj", i), w_down=requant("mlp.down_proj", i))
              for i, lp in enumerate(params.layers)]
    return dataclasses.replace(params, layers=layers)


# ---------------------------------------------------------------------------
# Partition specs: the dimension the model axis splits, per tensor
# ---------------------------------------------------------------------------

# the port's QuantLinear fields under the JAX package's names
_JAX_FIELD = {"scale": "absmax_hi", "scale_lo": "absmax_lo"}
_COL = dict(packed=1, absmax_hi=1, absmax_lo=1, bias=0, codebook=None, w=1, w8=1, w8_scale=1)
_ROW = dict(packed=0, absmax_hi=0, absmax_lo=0, bias=None, codebook=None, w=0, w8=0, w8_scale=0)
_ROW_PARALLEL = ("wo", "w_down")
_NORMS = ("attn_norm", "mlp_norm", "post_attn_norm", "post_mlp_norm", "q_norm", "k_norm")


def _map_tensors(fn, obj, path=(), owner=None):
    """A copy of ``obj`` (dataclasses and lists of tensors) with every tensor
    ``t`` replaced by ``fn(path, owner, t)``: ``path`` the field names from
    the root (``None`` for a list index, as JAX's key paths), ``owner`` the
    dataclass holding ``t``."""
    if isinstance(obj, torch.Tensor):
        return fn(path, owner, obj)
    if isinstance(obj, list):
        return [_map_tensors(fn, v, path + (None,), owner) for v in obj]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: _map_tensors(fn, getattr(obj, f.name), path + (f.name,), obj)
                                           for f in dataclasses.fields(obj) if f.init})
    return obj


def _ql_field_spec(names, owner, leaf) -> int | None:
    """The split dimension of one tensor of a (possibly adapted) linear: the
    target's name decides column- or row-parallel (JAX's ``_ql_field_spec``).
    LoRA factors: column-parallel targets replicate ``a`` and split ``b``'s
    output dim; row-parallel ones split ``a``'s input dim (the delta's
    partial rides the base's all-reduce) and replicate ``b``; a multi-LoRA
    stack's leading adapter axis and its (L,) scales are replicated."""
    field, parent = names[-1], names[-2] if len(names) >= 2 else None
    if parent == "base":  # a LoRA wrapper's base: the target's name decides
        parent = names[-3]
    row = parent in _ROW_PARALLEL
    if isinstance(owner, MultiLoRALinear) and field == "scale":
        return None
    if isinstance(owner, (LoRALinear, MultiLoRALinear)) and field in ("a", "b"):
        d = (0 if row else None) if field == "a" else (None if row else 1)
        return None if d is None else d + (leaf.ndim - 2)
    return (_ROW if row else _COL)[_JAX_FIELD.get(field, field)]


def _moe_field_spec(names, leaf) -> int | None:
    """The split dimension of one tensor of a MoE block (JAX's
    ``_moe_field_spec``): expert stacks keep their leading expert axis whole
    and split their trailing axes as the dense MLP does (gate/up/gateup
    column-parallel, down row-parallel); the router is replicated."""
    field, parent = names[-1], names[-2]
    if parent == "router" or field == "codebook":
        return None
    if field == "bias":  # stacked (E, n)
        return None if parent == "down" else 1
    return 1 if parent == "down" else 2


def _leaf_spec(names, owner, leaf) -> int | None:
    if "embed" in names or "final_norm" in names or names[-1] in _NORMS:
        return None
    if "moe" in names:
        return _moe_field_spec(names, leaf)
    if "lm_head" in names and isinstance(owner, DenseLinear):
        return 1 if names[-1] == "w" else 0  # vocabulary-sharded
    return _ql_field_spec(names, owner, leaf)


def param_specs(params: T.ModelParams) -> T.ModelParams:
    """A tree with the structure of ``params`` whose leaves are the
    dimension of each tensor that the model axis splits, or ``None`` for a
    replicated one (the JAX package's ``param_specs``, a dimension in place
    of each PartitionSpec)."""
    return _map_tensors(_leaf_spec, params)


def cache_specs(cache: T.KVCache, data_sharded: bool = True) -> T.KVCache:
    """A KVCache whose leaves are ``(data dim, model dim)`` of each tensor:
    K/V (B, rows, heads, D) split their batch over the data axis (``None``
    with ``data_sharded=False``: the engine's replicated prefill) and their
    heads over the model axis; the lengths (B,) follow the batch."""
    batch = 0 if data_sharded else None
    return T.KVCache(k=[(batch, 2) for _ in cache.k], v=[(batch, 2) for _ in cache.v], length=(batch, None))


def _shard(t: torch.Tensor, dim: int | None, parts: int, index: int, device) -> torch.Tensor:
    """Part ``index`` of ``parts`` of ``t`` along ``dim``, copied to ``device``
    alone (the full tensor stays where it lives); replicated when ``dim`` is
    None."""
    if dim is None:
        return t.to(device)
    if t.shape[dim] % parts:
        raise ValueError(f"a tensor of shape {tuple(t.shape)} does not split into {parts} along dim {dim}")
    n = t.shape[dim] // parts
    return t.narrow(dim, index * n, n).to(device, copy=True).contiguous()


def _localize_layer(lp: T.LayerParams, tp: int) -> T.LayerParams:
    """Rewrite a layer's static shape fields to this rank's (the tensors are
    already local): JAX's ``_localize_params``, per layer."""

    def loc(lin, **kw):
        return None if lin is None else local_view(lin, **kw)

    moe = lp.moe
    if moe is not None:
        moe = dataclasses.replace(moe, gate=loc(moe.gate, n_parts=tp), up=loc(moe.up, n_parts=tp),
                                  gateup=loc(moe.gateup, n_parts=tp), down=loc(moe.down, k_parts=tp))
    return dataclasses.replace(
        lp, wq=loc(lp.wq, n_parts=tp), wk=loc(lp.wk, n_parts=tp), wv=loc(lp.wv, n_parts=tp),
        wqkv=loc(lp.wqkv, n_parts=tp), wo=loc(lp.wo, k_parts=tp), w_gate=loc(lp.w_gate, n_parts=tp),
        w_up=loc(lp.w_up, n_parts=tp), w_gateup=loc(lp.w_gateup, n_parts=tp), w_down=loc(lp.w_down, k_parts=tp),
        moe=moe)


def _shard_tree(obj, mesh: Mesh, path: tuple):
    """``obj`` (found at ``path`` under ModelParams) with every tensor cut to
    this rank's part and moved to ``mesh.device``."""
    return _map_tensors(lambda names, owner, t: _shard(t, _leaf_spec(names, owner, t), mesh.n_model,
                                                       mesh.model_index, mesh.device), obj, path)


def shard_layer(lp: T.LayerParams, mesh: Mesh) -> T.LayerParams:
    """One decoder layer of :func:`shard_params`: a builder that shards each
    layer as it is made holds at most one full layer at a time
    (``utils.synth.synth_params(mesh=)``)."""
    return _localize_layer(_shard_tree(lp, mesh, ("layers", None)), mesh.n_model)


def shard_params(params: T.ModelParams, mesh: Mesh) -> T.ModelParams:
    """This rank's shard of ``params`` on ``mesh.device``, with its local
    static shapes (:func:`param_specs`, then JAX's ``_localize_params``).
    Each tensor is sliced where the full params live and only the slice is
    moved: build or load the full params on the CPU (or one layer at a time,
    :func:`shard_layer`) and no rank ever holds the whole model on its
    card."""
    return T.ModelParams(embed=_shard_tree(params.embed, mesh, ("embed",)),
                         layers=[shard_layer(lp, mesh) for lp in params.layers],
                         final_norm=_shard_tree(params.final_norm, mesh, ("final_norm",)),
                         lm_head=local_view(_shard_tree(params.lm_head, mesh, ("lm_head",)), n_parts=mesh.n_model))


def shard_cache(cache: T.KVCache, mesh: Mesh) -> T.KVCache:
    """This rank's part of a cache (:func:`cache_specs`): its data replica's
    batch rows (contiguous) and its model index's KV heads, on
    ``mesh.device``."""

    def part(t, dims):
        bd, md = dims
        if bd is not None:
            t = _shard(t, bd, mesh.n_data, mesh.data_index, t.device)
        return _shard(t, md, mesh.n_model, mesh.model_index, mesh.device)

    specs = cache_specs(cache)
    return T.KVCache(k=[part(t, s) for t, s in zip(cache.k, specs.k)], v=[part(t, s) for t, s in zip(cache.v, specs.v)],
                     length=part(cache.length, specs.length))


def attach_local_shadow(params: T.ModelParams, tp: int) -> T.ModelParams:
    """Int8 prefill shadows attached to a rank's LOCAL shards (after
    :func:`shard_params`), on its device: the same bytes as
    ``shard_params(attach_prefill_shadow(full, tp))``.  A column-parallel
    shard keeps the whole K, so its tile depth is chosen for K / tp as the
    full layer's; a row-parallel shard (wo, w_down) already holds K / tp.
    Every shadow tile and column scale lies inside one shard either way."""

    def walk(v, row=False):
        if isinstance(v, QuantLinear):
            return attach_int8_shadow(v, tp=1 if row else tp) if v.packed.ndim == 2 and v.layout == "pairk" else v
        if isinstance(v, list):
            return [walk(x) for x in v]
        if isinstance(v, T.LayerParams):
            return dataclasses.replace(v, **{f.name: walk(getattr(v, f.name), f.name in _ROW_PARALLEL)
                                             for f in dataclasses.fields(v)})
        if isinstance(v, (LoRALinear, MultiLoRALinear)):
            return dataclasses.replace(v, base=walk(v.base, row))
        if isinstance(v, T.ModelParams):
            return dataclasses.replace(v, layers=walk(v.layers), lm_head=walk(v.lm_head))
        return v

    return walk(params)


# ---------------------------------------------------------------------------
# The sharded forward
# ---------------------------------------------------------------------------


def tp_forward_fn(params: T.ModelParams, cfg: T.ModelConfig, cache: T.KVCache, mesh: Mesh,
                  data_sharded: bool = True, with_last_index: bool = False, with_adapter_idx: bool = False):
    """The forward of this rank's shards, with the JAX function's argument
    order: ``fn(params, tokens, cache[, last_index][, adapter_idx]) ->
    (logits (b, L, vocab / tp) f32, cache)``.  ``params`` and ``cache`` are
    this rank's (:func:`shard_params`, :func:`shard_cache`) and ``tokens``
    its batch rows: a data shard, or with ``data_sharded=False`` the batch
    every data replica runs alike (the engine's prefill); the body is the
    same.  Logits stay vocabulary-sharded (the final softcap is
    elementwise); the row-parallel outputs are summed over the model group,
    2 all-reduces per dense layer (none at tp = 1).  ``params`` and ``cache``
    of this call are checked against the mesh."""
    tp = mesh.n_model
    if cache.k and cache.k[0].shape[2] * tp != cfg.n_kv_heads:
        raise ValueError(f"cache holds {cache.k[0].shape[2]} KV heads; a model-axis width of {tp} gives each rank "
                         f"{cfg.n_kv_heads // tp} (shard_cache)")
    if params.lm_head.n_out * tp != cfg.vocab_size:
        raise ValueError(f"lm_head has {params.lm_head.n_out} outputs; shard_params gives each of {tp} ranks "
                         f"{cfg.vocab_size // tp}")
    group = mesh.model_group if tp > 1 else None

    def fwd(p, tokens, c, *extra):
        li = extra[0] if with_last_index else None
        ai = extra[-1] if with_adapter_idx else None
        return T.forward(p, cfg, tokens, c, last_index=li, adapter_idx=ai, group=group)

    return fwd


def make_decode_step(params: T.ModelParams, cfg: T.ModelConfig, cache: T.KVCache, mesh: Mesh):
    """Greedy decode step over the mesh: ``step(params, token (b,), cache) ->
    (next_token (b,) int32, cache)``.  The argmax runs on the logits gathered
    over the model group: ties go to the first index, as JAX's argmax over
    the global array."""
    fwd = tp_forward_fn(params, cfg, cache, mesh)

    @torch.no_grad()
    def step(p, token, c):
        logits, c = fwd(p, token[:, None], c)
        return torch.argmax(gather_vocab(logits[:, -1], mesh), dim=-1).to(torch.int32), c

    return step


def make_prefill(params: T.ModelParams, cfg: T.ModelConfig, cache: T.KVCache, mesh: Mesh):
    """Greedy prefill over the mesh: ``pre(params, tokens (b, L), cache) ->
    (first token (b,) int32, cache)``, the argmax as in
    :func:`make_decode_step`."""
    fwd = tp_forward_fn(params, cfg, cache, mesh)

    @torch.no_grad()
    def pre(p, tokens, c):
        logits, c = fwd(p, tokens, c)
        return torch.argmax(gather_vocab(logits[:, -1], mesh), dim=-1).to(torch.int32), c

    return pre

