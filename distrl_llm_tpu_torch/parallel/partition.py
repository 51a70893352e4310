"""Placement of the learner state over a role mesh, and its collectives.

Counterpart of the JAX package's ``parallel/partition.py``. ``spec_for_path``
is its rule table, copied: each leaf of a param, adapter or cache tree gets
its axis names by its path (the up-projections' out dim and the down-
projections' in dim over "tp", the other weight dim over "fsdp", norms and
biases replicated, batch rows over "dp"). The port reads the table for two
decisions: which leaves fsdp shards (those whose spec names "fsdp"), and
that a "tp" axis above 1 is refused (ROADMAP item 10b).

The layout differs from JAX's in bytes, never in results:

* JAX shards a leaf along its fsdp DIM (``P(None, "fsdp", None)`` on a
  LoRA factor ``[L, in, r]``). The port shards each member tensor of a leaf
  (a per-layer ``[in, out]`` weight, or a stacked adapter factor) by
  contiguous, block-aligned ranges of its flattened elements, in rank order
  (the flat-parameter layout of ZeRO and FSDP1). Adam8bit quantizes its
  moments in blocks of 256 elements of the WHOLE leaf's flat layout
  (``learner/optim.py``); a dim shard splits those blocks across ranks, a
  block-aligned range never does, so each rank keeps only its blocks' int8
  codes and scales and they equal a one-rank run's. A member whose size is
  not a multiple of 256 stays whole on every rank (as JAX keeps blockwise
  payloads replicated, ``opt_state_specs``).
* In LoRA mode the frozen base (bf16, or K3's int4 / int8 buffers) stays
  whole on every rank, as each of the reference's learners holds its base;
  fsdp shards the trained state (the adapter and its moments). JAX also
  shards the base.
* The batch is laid out over "dp" only (``learner/train_step.py::
  place_update_batch``): the ranks of one dp group (its fsdp ranks) see the
  same rows and compute the same grads, each keeping its own range of them.

``FlatShard.gather`` is differentiable: the forward all-gathers the member
over the fsdp group (each kernel then sees whole local tensors), the
backward keeps this rank's range of the member's grad. Full fine-tuning
gathers each decoder layer inside its checkpointed forward, so the whole
f32 model is never resident (``ShardedDecoder``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from distrl_llm_tpu_torch.learner.optim import BLOCK
from distrl_llm_tpu_torch.models.transformer import Decoder

_ITEM_10B = "ROADMAP queue 1 item 10b: tensor and sequence parallelism"

# layer weights whose OUT dim is tp-sharded (column parallel)
_COL = {"wq", "wk", "wv", "w_gate", "w_up"}
# layer weights whose IN dim is tp-sharded (row parallel)
_ROW = {"wo", "w_down"}


def spec_for_path(path: tuple[str, ...], shape: tuple[int, ...]) -> tuple:
    """The JAX ``_spec_for_path``: one axis name (or None) per dim."""
    ndim = len(shape)
    name = path[-1]
    if name in ("a", "b"):  # LoRA factor: path is (..., "layers", target, "a"|"b")
        target = path[-2]
        if name == "a":  # [L, in, r]
            return (None, "tp" if target in _ROW else "fsdp", None)
        return (None, None, "tp" if target in _COL else "fsdp")  # [L, r, out]
    if name == "embed":
        return ("tp", "fsdp")
    if name == "lm_head":
        return ("fsdp", "tp")
    if name in ("final_norm", "attn_norm", "mlp_norm"):
        return (None,) * ndim
    if name in _COL:
        return (None, "fsdp", "tp")
    if name in _ROW:
        return (None, "tp", "fsdp")
    if name.startswith("b"):  # projection biases [L, out]
        return (None, "tp") if name in ("bq", "bk", "bv") else (None, "fsdp")
    if name in ("k", "v"):  # kv cache: per-layer [B, K, hd, S]
        return ("dp", "tp", None, None)
    if name in ("q", "scale") and len(path) >= 2 and path[-2] in (_COL | _ROW):
        target = path[-2]
        in_ax, out_ax = ("fsdp", "tp") if target in _COL else ("tp", "fsdp")
        if shape[1] > 1:
            return (None, in_ax, None, out_ax)
        if name == "q":
            return (None, None, in_ax, out_ax)
        return (None, None, None, out_ax)
    return (None,) * ndim


def _check_mesh(mesh) -> None:
    if mesh.shape["tp"] > 1 or mesh.shape["sp"] > 1:
        raise NotImplementedError(f"a mesh with tp or sp > 1 is not ported yet ({_ITEM_10B})")


def shard_range(numel: int, parts: int, index: int) -> tuple[int, int, int]:
    """(lo, hi, chunk): rank ``index``'s block-aligned range of ``numel``
    elements over ``parts`` ranks, and the padded per-rank size."""
    blocks = -(-numel // BLOCK)
    chunk = -(-blocks // parts) * BLOCK
    lo = min(index * chunk, numel)
    return lo, min(lo + chunk, numel), chunk


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, shard):
        ctx.shard = shard
        return shard.full_flat(data).view(shard.shape)

    @staticmethod
    def backward(ctx, grad):
        s = ctx.shard
        return grad.reshape(-1)[s.lo:s.hi], None


class FlatShard:
    """One member tensor of a leaf on one rank: its ``data`` (the rank's
    block-aligned range, f32, the leaf the optimizer updates) and how to
    gather the whole member over ``group``. ``group`` None: the member stays
    whole on every rank."""

    def __init__(self, full: torch.Tensor, group, parts: int, index: int,
                 dtype: torch.dtype = torch.float32):
        self.shape = tuple(full.shape)
        self.numel = full.numel()
        self.group = group if self.numel % BLOCK == 0 else None
        self.parts = parts if self.group is not None else 1
        if self.group is None:
            self.lo, self.hi, self.chunk = 0, self.numel, self.numel
        else:
            self.lo, self.hi, self.chunk = shard_range(self.numel, parts, index)
        self.data = full.detach().reshape(-1)[self.lo:self.hi].to(dtype, copy=True)

    def full_flat(self, data: torch.Tensor | None = None) -> torch.Tensor:
        """The whole member flattened (a new tensor, or ``data`` itself when
        the member is whole on every rank); no autograd."""
        data = self.data if data is None else data
        if self.group is None:
            return data
        mine = torch.nn.functional.pad(data.detach(), (0, self.chunk - data.numel()))
        out = torch.empty(self.parts * self.chunk, dtype=data.dtype, device=data.device)
        dist.all_gather(list(out.chunk(self.parts)), mine, group=self.group)
        return out[:self.numel]

    def gather(self) -> torch.Tensor:
        """The whole member, differentiable into ``data``."""
        if self.group is None:
            return self.data.view(self.shape)
        return _Gather.apply(self.data, self)

    def full(self) -> torch.Tensor:
        """The whole member, detached, in a storage of its own size (what a
        checkpoint saves byte for byte as a one-rank run's)."""
        if self.group is None:
            return self.data.detach().view(self.shape)
        return self.full_flat().view(self.shape).clone()

    def to_host(self, dst: int, piece: torch.Tensor | None = None,
                per: int = 1) -> torch.Tensor | None:
        """The whole member of ``piece`` (default this rank's ``data``; a
        per-element state with one value every ``per`` elements) flattened on
        the host of global rank ``dst``, in a storage of its own size (what a
        checkpoint saves byte for byte as a one-rank run's); None on the
        other ranks. One ``gather`` into ``dst``'s device, no other rank
        receiving anything: only the fsdp group holding ``dst`` takes part,
        and no more than this member is ever whole on a device."""
        piece = (self.data if piece is None else piece).detach().reshape(-1)
        rank = dist.get_rank() if dist.is_initialized() else 0
        if self.group is None:
            return piece.to("cpu", copy=True) if rank == dst else None
        if dst not in dist.get_process_group_ranks(self.group):
            return None
        chunk = self.chunk // per
        mine = (piece if piece.numel() == chunk else
                torch.nn.functional.pad(piece, (0, chunk - piece.numel())))
        out = (torch.empty(self.parts * chunk, dtype=piece.dtype, device=piece.device)
               if rank == dst else None)
        dist.gather(mine, list(out.chunk(self.parts)) if out is not None else None, dst=dst,
                    group=self.group)
        return out[:self.numel // per].to("cpu", copy=True) if out is not None else None


def _fsdp_group(mesh):
    """(group, parts, index) of this rank along fsdp. A one-rank fsdp axis
    still gathers through its group (a copy), so the collectives of the
    path run on every mesh, one card's included."""
    _check_mesh(mesh)
    if mesh.device_mesh is None:
        return None, 1, 0
    return mesh.group("fsdp"), mesh.fsdp, mesh.coordinate()[1]


class ShardedLora:
    """An adapter ``{"layers": {target: {"a", "b"}}}`` sharded over the
    learner mesh's fsdp axis. ``gather()`` is the whole adapter, every
    factor differentiable into its shard; ``full()`` a detached copy."""

    def __init__(self, lora: dict, mesh):
        group, parts, index = _fsdp_group(mesh)
        self.shards = {t: {k: FlatShard(x, group if "fsdp" in spec_for_path(
            ("layers", t, k), tuple(x.shape)) else None, parts, index)
            for k, x in ab.items()} for t, ab in lora["layers"].items()}
        for s in self._members():
            s.data.requires_grad_(True)

    def _members(self) -> list[FlatShard]:
        return [self.shards[t][k] for t in sorted(self.shards) for k in ("a", "b")]

    def trainable(self) -> list[torch.Tensor]:
        """The optimizer's leaves, in the one-rank adapter's order."""
        return [s.data for s in self._members()]

    def gather(self) -> dict:
        return {"layers": {t: {k: s.gather() for k, s in ab.items()}
                           for t, ab in self.shards.items()}}

    def full(self) -> dict:
        return {"layers": {t: {k: s.full() for k, s in ab.items()}
                           for t, ab in self.shards.items()}}

    def to_host(self, dst: int) -> dict | None:
        """The whole adapter on the host of global rank ``dst`` (None
        elsewhere), a factor at a time (``FlatShard.to_host``)."""
        out = {t: {k: s.to_host(dst) for k, s in ab.items()} for t, ab in self.shards.items()}
        if any(x is None for ab in out.values() for x in ab.values()):
            return None
        return {"layers": {t: {k: x.view(self.shards[t][k].shape) for k, x in ab.items()}
                           for t, ab in out.items()}}

    def load_full(self, lora: dict) -> None:
        """Overwrite the shards with this rank's ranges of a whole adapter
        (a host copy read lazily, as a memory-mapped checkpoint, is read
        only there)."""
        with torch.no_grad():
            for t, ab in self.shards.items():
                for k, s in ab.items():
                    s.data.copy_(lora["layers"][t][k].reshape(-1)[s.lo:s.hi])


def _param_spec(name: str, shape: tuple) -> tuple:
    """Spec of a ``Decoder`` parameter by its name (``layers.3.wq``)."""
    return spec_for_path(tuple(name.split(".")[-1:]), (1,) + shape if "." in name else shape)


class ShardedDecoder(Decoder):
    """Full fine-tuning's f32 master weights sharded over the learner mesh's
    fsdp axis. The module itself holds no weights (its parameters are on the
    meta device): each forward gathers the embedding, the final norm and the
    LM head, and each decoder layer gathers its own weights inside its
    (checkpointed) forward, so the remat recompute gathers them again and no
    gathered layer outlives its use. ``shards`` holds a ``FlatShard`` per
    parameter, by the model's parameter names."""

    def __init__(self, model: Decoder, mesh):
        super().__init__(model.cfg, dtype=torch.float32, device="meta")
        group, parts, index = _fsdp_group(mesh)
        self.shards = {}
        for name, p in model.named_parameters():
            spec = _param_spec(name, tuple(p.shape))
            self.shards[name] = FlatShard(p, group if "fsdp" in spec else None, parts, index)
            self.shards[name].data.requires_grad_(True)
        self._bound = False

    def trainable(self) -> list[torch.Tensor]:
        return [s.data for s in self.shards.values()]

    def leaf_groups(self, stacks: dict[str, list]) -> list[list[torch.Tensor]]:
        """The optimizer's leaves grouped as ``param_stacks(model)`` groups
        the model's parameters (one stacked JAX leaf a group)."""
        by_id = {id(p): n for n, p in self.named_parameters()}
        return [[self.shards[by_id[id(p)]].data for p in members] for members in stacks.values()]

    def _layer_call(self, i: int):
        layer = self.layers[i]
        names = [n for n, _ in layer.named_parameters()]
        shards = [self.shards[f"layers.{i}.{n}"] for n in names]

        def run(*args, **kw):
            params = {n: s.gather() for n, s in zip(names, shards)}
            return torch.func.functional_call(layer, params, args, kw)

        return run

    def forward(self, input_ids, **kw):
        root = [n for n in ("embed", "final_norm", "lm_head") if n in self.shards]
        saved = {n: self._parameters[n] for n in root}
        try:
            for n in root:
                self._parameters[n] = self.shards[n].gather()
            self._bound = True
            return super().forward(input_ids, **kw)
        finally:
            self._parameters.update(saved)
            self._bound = False

    def lm_head_weight(self) -> torch.Tensor:
        if self._bound:
            return super().lm_head_weight()
        if self.cfg.tie_word_embeddings:
            return self.shards["embed"].gather().T
        return self.shards["lm_head"].gather()

    def full_named(self):
        """(name, whole detached f32 tensor) per parameter, one gathered at a
        time (every fsdp rank must iterate it to the end)."""
        for name, s in self.shards.items():
            yield name, s.full()

    def to_host(self, dst: int) -> dict | None:
        """{name: whole f32 tensor} on the host of global rank ``dst`` (None
        elsewhere), a parameter at a time (``FlatShard.to_host``)."""
        out = {name: s.to_host(dst) for name, s in self.shards.items()}
        if any(x is None for x in out.values()):
            return None
        return {name: x.view(self.shards[name].shape) for name, x in out.items()}

    def load_full(self, named: dict) -> None:
        """Overwrite the shards with this rank's ranges of whole tensors by
        parameter name (a memory-mapped checkpoint is read only there)."""
        if sorted(named) != sorted(self.shards):
            raise ValueError("the checkpoint holds another model's weights")
        with torch.no_grad():
            for name, s in self.shards.items():
                s.data.copy_(named[name].reshape(-1)[s.lo:s.hi])


def shard_tree(tree, mesh):
    """Shard the learner's trainable tree over ``mesh``'s fsdp axis: an
    adapter dict becomes a ``ShardedLora``, a dense ``Decoder`` (full
    fine-tuning's masters) a ``ShardedDecoder``."""
    if isinstance(tree, Decoder):
        return ShardedDecoder(tree, mesh)
    return ShardedLora(tree, mesh)


def _members_of(optimizer, sharded) -> list[list[FlatShard]]:
    """The ``FlatShard``s behind each of the optimizer's leaves (an
    ``Adam8bit`` leaf, or one parameter of ``torch.optim.Adam``)."""
    by_data = {id(s.data): s for s in (sharded._members() if isinstance(sharded, ShardedLora)
                                       else sharded.shards.values())}
    leaves = getattr(optimizer, "leaves", None) or [[p] for p in
                                                    optimizer.param_groups[0]["params"]]
    return [[by_data[id(t)] for t in leaf] for leaf in leaves]


def _opt_keys(optimizer) -> tuple:
    """(state key, elements per stored value) of the per-element state."""
    if hasattr(optimizer, "leaves"):  # Adam8bit: int8 codes and block scales
        return (("mu_q", 1), ("nu_q", 1), ("mu_scale", BLOCK), ("nu_scale", BLOCK))
    return (("exp_avg", 1), ("exp_avg_sq", 1))


def _host(tree):
    """``tree`` with its device tensors copied to the host (host tensors kept,
    as a one-rank ``state_dict()`` keeps the live ones)."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_host(v) for v in tree]
    return tree.cpu() if torch.is_tensor(tree) else tree


def gather_opt_state(optimizer, sharded, dst: int) -> dict | None:
    """``optimizer.state_dict()`` over ``sharded``'s ranges in a one-rank
    run's layout, on the host of global rank ``dst`` (None elsewhere): each
    sharded member's state gathered into ``dst`` (an Adam8bit leaf's blocks
    are its members' blocks in order, each member being a whole number of
    blocks), one member and state at a time. Every rank of the fsdp group
    holding ``dst`` must call it (the others may: they gather nothing)."""
    state = optimizer.state_dict()
    rank = dist.get_rank() if dist.is_initialized() else 0
    keys = _opt_keys(optimizer)
    for i, leaf in enumerate(_members_of(optimizer, sharded)):
        if all(s.group is None for s in leaf):
            continue
        entry = state["state"][i]
        for key, per in keys:
            local = entry[key]
            pieces = local.reshape(-1).split([(s.hi - s.lo) // per for s in leaf])
            whole = [s.to_host(dst, piece, per) for s, piece in zip(leaf, pieces)]
            if rank != dst:
                continue
            whole = torch.cat(whole) if len(whole) > 1 else whole[0]
            # torch.optim.Adam's moments have their parameter's shape
            entry[key] = whole.view(leaf[0].shape) if key.startswith("exp") else whole
    return _host(state) if rank == dst else None


def shard_opt_state(state: dict, optimizer, sharded) -> dict:
    """A one-rank ``state_dict()`` cut to this rank's ranges of ``sharded``,
    what ``optimizer.load_state_dict`` takes: the inverse of
    ``gather_opt_state``."""
    keys = _opt_keys(optimizer)
    out = {**state, "state": {}}
    for i, leaf in enumerate(_members_of(optimizer, sharded)):
        entry = dict(state["state"][i])
        if not all(s.group is None for s in leaf):
            for key, per in keys:
                pieces = entry[key].reshape(-1).split([s.numel // per for s in leaf])
                entry[key] = torch.cat([p[s.lo // per:s.hi // per] for s, p in zip(leaf, pieces)])
        out["state"][i] = entry
    return out


