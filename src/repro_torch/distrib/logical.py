"""Logical-axis sharding: named logical axes -> physical mesh axes
(port of ``repro/distrib/logical.py``).

Every parameter and activation carries *logical* axis names (``"embed"``,
``"ffn"``, ``"q_heads"``, ...).  An :class:`AxisRules` maps each logical
name to zero or more physical mesh axes: that mapping IS the parallelism
strategy, the inner configuration space of the sharding autotuner.  A
divisibility guard drops a physical axis from a mapping when the
dimension does not divide by the mesh axis' size.

A spec is a plain tuple, one entry a tensor dim (``None``, an axis name
or a tuple of names; trailing ``None`` trimmed), where the reference has
a ``PartitionSpec``.  :class:`ShardCtx` turns a spec into DTensor
placements on a ``DeviceMesh`` (``repro_torch.launch.mesh``) and
redistributes activations to them; with no mesh (``NOSHARD``, every
single-device path) it constrains nothing.

:class:`P`, :func:`spec_map` and :func:`init_params` keep the
reference's declarative parameter tree.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

Physical = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Physical, ...]


@dataclasses.dataclass(frozen=True)
class AxisRules:
    """logical axis name -> physical mesh axis (or tuple of axes, or None)."""
    rules: Dict[str, Physical]

    def get(self, name: str) -> Physical:
        return self.rules.get(name)

    def replace(self, **kw: Physical) -> "AxisRules":
        d = dict(self.rules)
        d.update(kw)
        return AxisRules(d)


def fsdp_tp_rules(multi_pod: bool) -> AxisRules:
    """``logical.py:46``: the paper-faithful default strategy: batch over
    (pod, data), parameters model-parallel over "model" on the wide dim
    and FSDP over "data" on the embed dim, the residual stream's sequence
    over "model"."""
    dp = ("pod", "data") if multi_pod else ("data",)
    return AxisRules({
        "batch": dp,
        "seq": "model",
        "kv_seq": None,
        "embed": "data",
        "vocab": "model",
        "q_heads": "model",
        "kv_heads": "model",
        "kv_hd": "model",
        "ffn": "model",
        "experts": "model",
        "inner": "model",
        "ssm_heads": "model",
        "ssm_hd": "model",
        "state": None,
        "conv": None,
        "img": None,
        "layers": None,
        "act_embed": None,      # activation d_model dim
        "act_heads": "model",   # activation head dim
        "act_ffn": "model",
        "act_kv_seq": None,     # KV-cache sequence dim
        "expert_cap": None,
    })


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``, or of any object whose
    ``shape`` is already such a dict (the reference's ``Mesh.shape``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def _names(axes: Physical) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _divisible(mesh, axes: Physical, dim: int) -> bool:
    if mesh is None or axes is None:
        return True
    sizes = axis_sizes(mesh)
    return dim % math.prod(sizes[a] for a in _names(axes)) == 0


def _best_prefix(mesh, axes: Physical, dim: int) -> Physical:
    """Longest prefix of the axis tuple whose size divides ``dim``: batch
    256 on ('pod', 'data', 'model') = 512 falls back to ('pod', 'data')
    = 32 instead of replicating entirely."""
    if mesh is None or axes is None:
        return axes
    sizes = axis_sizes(mesh)
    names = _names(axes)
    for k in range(len(names), 0, -1):
        if dim % math.prod(sizes[a] for a in names[:k]) == 0:
            return names[:k] if k > 1 else names[0]
    return None


def logical_to_spec(logical: Sequence[Optional[str]], rules: AxisRules,
                    shape: Optional[Sequence[int]] = None,
                    mesh=None) -> Spec:
    """``logical.py:101``: a tuple of logical axis names -> a spec tuple.
    A physical axis is used once; trailing ``None`` entries are trimmed."""
    used: set = set()
    out = []
    for i, name in enumerate(logical):
        phys = rules.get(name) if name else None
        if phys is not None and shape is not None and not _divisible(
                mesh, phys, shape[i]):
            phys = _best_prefix(mesh, phys, shape[i])
        names = () if phys is None else _names(phys)
        names = tuple(n for n in names if n not in used)
        used.update(names)
        if not names:
            out.append(None)
        elif len(names) == 1:
            out.append(names[0])
        else:
            out.append(names)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def spec_placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of a spec on ``mesh``, one per mesh dim: tensor
    dim d split over axes (a, b) is ``Shard(d)`` on both mesh dims, a
    major to b minor, which is the layout of JAX's ``PartitionSpec``
    when the axes keep the mesh's order (every rule here does)."""
    from torch.distributed.tensor import Replicate, Shard

    order = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(order)
    for d, phys in enumerate(spec):
        if phys is None:
            continue
        idx = [order.index(a) for a in _names(phys)]
        if idx != sorted(idx):
            raise ValueError(
                f"spec {spec}: axes {phys} are out of the mesh's order "
                f"{tuple(order)}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Threaded through the model code to apply activation sharding
    (``logical.py:129``).  ``mesh=None`` makes every constraint a no-op:
    the single-device paths run it so."""
    mesh: object = None
    rules: Optional[AxisRules] = None

    def sharding_for(self, logical: Sequence[Optional[str]],
                     shape: Sequence[int]) -> Optional[tuple]:
        """The placements of a tensor of ``shape`` with these logical
        axes, or ``None`` with no mesh."""
        if self.mesh is None or self.rules is None:
            return None
        return spec_placements(
            logical_to_spec(logical, self.rules, shape, self.mesh),
            self.mesh)

    def weights(self, tree):
        """A block's parameters as its products use them: each leaf
        gathered over the mesh axes the "embed" rule maps to (FSDP's
        per-layer all-gather, whose backward reduce-scatters the
        gradient), its model-parallel sharding kept.  Called inside the
        block, so remat gathers again instead of keeping the gathered
        copy.  ``tree`` itself with no mesh or no FSDP axis."""
        if self.mesh is None or self.rules is None:
            return tree
        fsdp = self.rules.get("embed")
        if fsdp is None:
            return tree
        from torch.distributed.tensor import Replicate, Shard
        order = list(self.mesh.mesh_dim_names)
        dims = [order.index(a) for a in _names(fsdp)]

        def one(x):
            if isinstance(x, dict):
                return {k: one(v) for k, v in x.items()}
            pl = list(x.placements)
            if not any(isinstance(pl[i], Shard) for i in dims):
                return x
            for i in dims:
                pl[i] = Replicate()
            return x.redistribute(self.mesh, tuple(pl))

        return one(tree)

    def constrain(self, x: torch.Tensor, *logical: Optional[str]
                  ) -> torch.Tensor:
        """``x`` redistributed to the placements of its logical axes (a
        DTensor in, a DTensor out); ``x`` itself with no mesh."""
        if self.mesh is None or self.rules is None:
            return x
        placements = self.sharding_for(logical, x.shape)
        if tuple(x.placements) == placements:
            return x
        return x.redistribute(self.mesh, placements)

    def pad_front(self, x: torch.Tensor, n: int) -> torch.Tensor:
        """(B, L, C) ``x`` with ``n`` zero rows in front of its sequence:
        ``F.pad``, and under a mesh a concatenation with zeros, the same
        values (torch 2.11's DTensor fails to plan ``F.pad``'s
        redistribution on a mesh of more than one dim)."""
        if self.mesh is None:
            return torch.nn.functional.pad(x, (0, 0, n, 0))
        return torch.cat([x.new_zeros((x.shape[0], n, x.shape[2])), x],
                         dim=1)

    def cumsum(self, x: torch.Tensor) -> torch.Tensor:
        """``torch.cumsum`` along the last dim; under a mesh one whose
        backward reverses the gradient with ``index_select`` where
        torch's reverses it with ``flip``, the same values (torch before
        2.13 places no flip)."""
        if self.mesh is None:
            return torch.cumsum(x, dim=-1)
        return _CumSum.apply(x)

    def _axes_of(self, x: torch.Tensor, dim: int) -> Tuple[str, ...]:
        """The mesh axes that shard ``x``'s ``dim`` (none with no mesh)."""
        if self.mesh is None:
            return ()
        from torch.distributed.tensor import Shard
        dim %= x.dim()
        return tuple(a for a, pl in zip(self.mesh.mesh_dim_names,
                                        x.placements)
                     if isinstance(pl, Shard) and pl.dim == dim)

    def gold_grad(self, grad: torch.Tensor, labels: torch.Tensor,
                  like: torch.Tensor) -> torch.Tensor:
        """The gradient of ``gather(like, -1, labels)`` for ``like`` of
        shape (..., V) and ``labels`` and ``grad`` of shape (..., 1):
        ``grad`` at each row's label and zero elsewhere, ``torch.gather``'s
        own backward (zeros and a ``scatter_add``).

        Under a mesh it is ``where(arange(V) == labels, grad, 0)``, each
        shard comparing its own slice of the vocab (the arange from its
        global offset), as GSPMD partitions an iota compare: it keeps
        ``like``'s placement, where DTensor places the scatter's zeros
        replicated.  Each row has one nonzero, so both give the same
        bits."""
        if self.mesh is None:
            return torch.zeros_like(like).scatter_add_(-1, labels, grad)
        from torch.distributed.tensor import DTensor, Replicate
        from torch.distributed.tensor._utils import (
            compute_local_shape_and_global_offset)
        axes = self._axes_of(like, -1)
        rows = tuple(Replicate() if a in axes else p
                     for a, p in zip(self.mesh.mesh_dim_names,
                                     like.placements))
        local = labels.redistribute(self.mesh, rows).to_local()
        shape, offset = compute_local_shape_and_global_offset(
            like.shape, self.mesh, like.placements)
        vocab = torch.arange(offset[-1], offset[-1] + shape[-1],
                             device=local.device)
        hit = DTensor.from_local(vocab == local, self.mesh, like.placements,
                                 run_check=False, shape=like.shape,
                                 stride=like.stride())
        # 0 + grad, as the scatter_add sums it (a -0.0 becomes +0.0)
        return torch.where(hit, grad + 0.0, 0.0)

    def embed(self, table: torch.Tensor, tokens: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
        """The rows of the (V, D) ``table`` (cast to ``dtype``) at
        ``tokens``: ``F.embedding``.

        Under a mesh that splits the table's vocab, each rank looks up
        its own slice of the vocab on the local shards (``local_map``):
        a token outside the slice gives a zero row, and the result is a
        plain pending sum over the vocab's axes, which the caller settles
        into the activation's placement, as GSPMD partitions a gather
        from a row-split table.  The tokens are first gathered over those
        axes; the table never is.  The backward is the lookup's own
        scatter-add onto the local slice: the gradient comes back split
        as the table is, and a pending sum over the axes that split the
        tokens (torch 2.11's DTensor cannot move the pending gradient of
        its own masked lookup).  Otherwise ``F.embedding``."""
        w = table.to(dtype)
        if self.mesh is None or not (_is_dtensor(w) and _is_dtensor(tokens)
                                     and self._axes_of(w, 0)):
            return torch.nn.functional.embedding(tokens, w)
        from torch.distributed.tensor import Partial, Replicate, Shard
        from torch.distributed.tensor._utils import (
            compute_local_shape_and_global_offset)
        from torch.distributed.tensor.experimental import local_map
        tok_pl, out_pl, grad_pl = [], [], []
        for p, t in zip(w.placements, tokens.placements):
            if p == Shard(0):                        # the vocab split
                tok_pl.append(Replicate())
                out_pl.append(Partial())
                grad_pl.append(p)
            elif isinstance(p, Replicate) and type(t) in (Shard, Replicate):
                tok_pl.append(t)
                out_pl.append(t)
                grad_pl.append(Partial() if isinstance(t, Shard) else p)
            else:
                return torch.nn.functional.embedding(tokens, w)
        tok_pl = tuple(tok_pl)
        if any(tokens.shape[p.dim] % self.mesh.size(i)
               for i, p in enumerate(tok_pl) if isinstance(p, Shard)):
            return torch.nn.functional.embedding(tokens, w)
        if tok_pl != tuple(tokens.placements):
            tokens = tokens.redistribute(self.mesh, tok_pl)
        shape, offset = compute_local_shape_and_global_offset(
            w.shape, self.mesh, w.placements)
        first, rows = offset[0], shape[0]

        def lookup(w_loc, tok_loc):
            local = tok_loc.long() - first
            hit = (local >= 0) & (local < rows)
            found = torch.nn.functional.embedding(
                torch.where(hit, local, 0), w_loc)
            return torch.where(hit[..., None], found, 0.0)

        return local_map(lookup, out_placements=out_pl,
                         in_placements=(tuple(w.placements), tok_pl),
                         in_grad_placements=(tuple(grad_pl), tok_pl),
                         device_mesh=self.mesh)(w, tokens)

    def fold_groups(self, x: torch.Tensor, groups: int) -> torch.Tensor:
        """(B, S, D) ``x`` as (``groups``, B / groups * S, D): each group
        the tokens of B / groups rows, in order (a view).

        Under a mesh that splits the sequence, ``x`` is first gathered
        over the axes that split it, as DTensor (2.13) places this view:
        the fold then flattens no split dim into the one before it, which
        torch 2.11's DTensor refuses.  The gradient is placed as the
        folded view was before it is unfolded, and then returned to
        ``x``'s placement."""
        B, S, D = x.shape
        if self.mesh is None or not self._axes_of(x, 1):
            return x.reshape(groups, B // groups * S, D)
        return _Fold.apply(x, self, (groups, B // groups * S, D), True)

    def unfold_groups(self, y: torch.Tensor, batch: int) -> torch.Tensor:
        """(G, Tg, D) ``y`` as (``batch``, G * Tg / batch, D): the mirror
        of :meth:`fold_groups`.  Under a mesh the gradient, which may
        come back split along the sequence, is gathered over the axes
        that split it before it is folded, then returned to ``y``'s
        placement."""
        G, Tg, D = y.shape
        shape = (batch, G * Tg // batch, D)
        if self.mesh is None or not _is_dtensor(y):
            return y.reshape(shape)
        return _Fold.apply(y, self, shape, False)

    def _gather_axes(self, x: torch.Tensor, axes) -> torch.Tensor:
        """``x`` replicated over the mesh axes ``axes``."""
        from torch.distributed.tensor import Replicate
        pl = tuple(Replicate() if a in axes else p
                   for a, p in zip(self.mesh.mesh_dim_names, x.placements))
        return x if pl == tuple(x.placements) else x.redistribute(
            self.mesh, pl)

    def transpose(self, w: torch.Tensor) -> torch.Tensor:
        """``w.T`` of a 2-dim ``w``.  Under a mesh its gradient comes back
        in ``w``'s own placements: a tied table's gradient from the
        logits product then meets the lookup's, which its FSDP gather
        reduce-scatters there, in one placement where autograd sums them
        (torch 2.11's DTensor cannot move the lookup's split gradient onto
        the product's pending sum)."""
        if self.mesh is None or not _is_dtensor(w):
            return w.T
        return _GradIn.apply(w, self.mesh).T

    def write_rows(self, cache: torch.Tensor, new: torch.Tensor,
                   pos) -> None:
        """Write one token's (B, 1, ...) rows ``new`` into the (B, S, ...)
        ``cache`` IN PLACE, at the scalar ``pos`` or at each slot's own
        ``(B,)`` position: a scatter along the sequence.

        Where the mesh shards the cache, the write is a masked select over
        the local shard, ``where(s == pos, new, cache)`` copied back: how
        GSPMD partitions a ``dynamic_update_slice`` along a sharded
        sequence (every shard compares its own positions), with the local
        shard's bytes.  On a cache split only over batch or heads XLA
        updates in place and moves the token's rows alone; torch 2.11's
        DTensor places ``scatter_`` only on a replicated tensor."""
        B = cache.shape[0]
        posb = torch.as_tensor(pos, device=cache.device).long()
        posb = posb.reshape(-1).expand(B)
        new = new.to(cache.dtype)
        tail = (1,) * (cache.dim() - 2)
        if self.mesh is not None and any(
                self._axes_of(cache, d) for d in range(cache.dim())):
            seq = torch.arange(cache.shape[1], device=cache.device)
            hit = (seq == posb[:, None]).reshape(B, -1, *tail)
            cache.copy_(torch.where(hit, new, cache))
            return
        cache.scatter_(1, posb.view(B, 1, *tail).expand(new.shape), new)

    def einsum(self, eq: str, *operands: torch.Tensor) -> torch.Tensor:
        """``torch.einsum(eq, *operands)``.

        Under a mesh, where each rank's product of its own shards is its
        shard of the result (:func:`_local_plan`: every mesh axis splits
        one letter the same way in each operand that holds it, and the
        others are whole on that axis), the product is taken on the local
        shards through ``local_map``: no view of a DTensor (torch 2.11's
        DTensor refuses the one ``einsum`` makes to fold two sharded batch
        dims into ``bmm``'s one) and no collective.  A split contracted
        letter, or one operand's pending sum, leaves a pending sum.
        Otherwise DTensor plans ``torch.einsum`` as ever, and raises where
        it cannot."""
        import functools
        return self._local(functools.partial(torch.einsum, eq), eq, operands)

    def matmul(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x @ w`` for an activation ``x`` (..., S, D) and a weight ``w``
        (D, F).

        Under a mesh that splits a dim of ``x`` between its first and its
        last (the sequence), which the product would fold into the first
        (torch 2.11's DTensor refuses that view), both are first placed as
        DTensor places them for the folded ``x @ w``: ``x`` gathered on a
        mesh axis that splits ``w``'s F, moved onto D on one that splits
        ``w``'s D, kept on one that leaves ``w`` whole; ``w`` gathered on
        an axis that splits both ``x``'s batch and ``w``'s D.  The
        backward of each redistribution returns the gradient to the
        operand's placements.
        The product is then taken on the local shards, as :meth:`einsum`
        takes it.  Otherwise ``x @ w``."""
        if self.mesh is None or not (_is_dtensor(x) and _is_dtensor(w)):
            return x @ w
        from torch.distributed.tensor import Replicate, Shard
        n = x.dim()
        if not any(type(p) is Shard and 0 < p.dim < n - 1
                   for p in x.placements):
            return x @ w
        pl, wpl = list(x.placements), list(w.placements)
        for i, (p, q) in enumerate(zip(x.placements, w.placements)):
            if type(p) is Shard and 0 < p.dim < n - 1:
                if q == Shard(1):
                    pl[i] = Replicate()
                elif q == Shard(0):
                    pl[i] = Shard(n - 1)
            elif p == Shard(0) and q == Shard(0):
                wpl[i] = Replicate()
        plan = _local_plan(_matmul_eq(n), ((x.shape, tuple(pl)),
                                           (w.shape, tuple(wpl))), self.mesh)
        if plan is None:
            return x @ w
        if tuple(pl) != tuple(x.placements):
            x = x.redistribute(self.mesh, tuple(pl))
        if tuple(wpl) != tuple(w.placements):
            w = w.redistribute(self.mesh, tuple(wpl))
        return self._local(torch.matmul, _matmul_eq(n), (x, w))

    def _local(self, fn, eq: str, operands):
        """``fn(*operands)``, which computes ``torch.einsum(eq, ...)``: on
        the local shards where :func:`_local_plan` finds the product
        local, else as it is."""
        if self.mesh is None:
            return fn(*operands)
        plan = _local_plan(eq, [(x.shape, tuple(x.placements)
                                 if _is_dtensor(x) else None)
                                for x in operands], self.mesh)
        if plan is None:
            return fn(*operands)
        from torch.distributed.tensor.experimental import local_map
        out, grads = plan
        return local_map(
            fn, out_placements=list(out),
            in_placements=tuple(x.placements if _is_dtensor(x) else None
                                for x in operands),
            in_grad_placements=grads, device_mesh=self.mesh)(*operands)

    def _whole_heads(self, x: torch.Tensor, dim: int, heads: int,
                     drop: Tuple[str, ...] = ()) -> torch.Tensor:
        """``x`` redistributed, where it has to be, so that ``dim`` holds
        whole heads: the mesh axes that shard it keep their longest
        prefix whose size divides ``heads`` and the rest, and the axes in
        ``drop``, are replicated."""
        axes = self._axes_of(x, dim)
        if not axes and not drop:
            return x
        from torch.distributed.tensor import Replicate
        keep = _best_prefix(self.mesh, axes, heads) if axes else None
        keep = () if keep is None else _names(keep)
        pl = tuple(Replicate() if a in drop or (a in axes and a not in keep)
                   else p
                   for a, p in zip(self.mesh.mesh_dim_names, x.placements))
        if pl == tuple(x.placements):
            return x
        return x.redistribute(self.mesh, pl)

    def _split(self, x: torch.Tensor, heads: int, dim: int) -> torch.Tensor:
        x = self._whole_heads(x, dim, heads)
        shape = x.shape
        return x.reshape(*shape[:dim], heads, shape[dim] // heads,
                         *shape[dim + 1:])

    def _merge(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        x = self._whole_heads(x, dim, x.shape[dim],
                              drop=self._axes_of(x, dim + 1))
        return x.flatten(dim, dim + 1)

    def split_heads(self, x: torch.Tensor, heads: int, dim: int = -1
                    ) -> torch.Tensor:
        """``x``'s ``dim`` of size ``heads * d`` split into (heads, d).

        Under a mesh that shards that dim over axes that hold no whole
        heads, ``x`` is first redistributed so that the heads dim keeps
        the longest prefix of those axes whose size divides ``heads`` and
        is replicated over the rest: the placement ``logical_to_spec``'s
        divisibility guard gives the split shape, and the reshard GSPMD
        inserts before such a reshape.  The gradient is merged back as
        :meth:`merge_heads` merges."""
        dim %= x.dim()
        if self.mesh is None:
            return self._split(x, heads, dim)
        return _Regroup.apply(x, self, heads, dim, True)

    def merge_heads(self, x: torch.Tensor, dim: int = -2) -> torch.Tensor:
        """``x``'s dims (dim, dim + 1), (heads, d), merged into one: the
        mirror of :meth:`split_heads`.  Under a mesh, the heads dim keeps
        the longest prefix of its axes that divides the heads (DTensor
        may have split them unevenly, settling a pending sum) and the
        ``d`` dim, which a merge cannot keep sharded, is replicated; the
        gradient is split back as :meth:`split_heads` splits."""
        dim %= x.dim()
        if self.mesh is None:
            return self._merge(x, dim)
        return _Regroup.apply(x, self, x.shape[dim], dim, False)


NOSHARD = ShardCtx()


def _is_dtensor(x) -> bool:
    return hasattr(x, "placements") and hasattr(x, "to_local")


def _local_plan(eq: str, operands, mesh):
    """Whether the einsum ``eq`` of operands given as (shape, placements)
    pairs (placements ``None`` for a plain tensor, read as replicated) on
    ``mesh`` is each rank's product of its own shards -> (the result's
    placements, each operand's gradient placements, ``None`` for a plain
    tensor), or ``None``.

    It is, on each mesh axis, where
    * every operand is whole (replicated): so are the result and the
      gradients;
    * one letter is split the same way (``Shard``) in every operand that
      holds it and the others are whole: the result is split along it
      (a pending sum where it is contracted); the gradient of an operand
      that holds it is split as the operand is, that of one that does not
      is a pending sum of each rank's part;
    * one operand is a pending sum and the others are whole: the result
      is a pending sum, that operand's gradient whole and the others'
      pending sums;
    * the axis has one rank, which holds every operand whole whatever its
      placement: the result is whole, each gradient placed as its
      operand (whole for a pending sum).  On a (1, 1) mesh torch 2.11's
      DTensor leaves attention's probabilities whole beside a value split
      over batch and heads, and its own einsum folds them.
    Each letter must split evenly over the axes that split it, as
    ``local_map`` infers the result's shape from the local one."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    if "->" not in eq or "." in eq:
        return None
    ins, out = eq.replace(" ", "").split("->")
    ins = ins.split(",")
    if len(ins) != len(operands) or any(len(set(s)) != len(s) for s in ins):
        return None
    placed = [pl if pl is not None else (Replicate(),) * mesh.ndim
              for _, pl in operands]
    sizes = {c: shape[i] for (shape, _), s in zip(operands, ins)
             for i, c in enumerate(s)}
    ways = dict.fromkeys(sizes, 1)
    out_pl, grads = [], [[] for _ in operands]
    for axis in range(mesh.ndim):
        pls = [p[axis] for p in placed]
        if mesh.size(axis) == 1:
            out_pl.append(Replicate())
            for g, p in zip(grads, pls):
                g.append(Replicate() if isinstance(p, Partial) else p)
            continue
        if all(isinstance(p, Replicate) for p in pls):
            out_pl.append(Replicate())
            for g in grads:
                g.append(Replicate())
            continue
        pending = [k for k, p in enumerate(pls) if isinstance(p, Partial)]
        if pending:
            if len(pending) > 1 or pls[pending[0]] != Partial() or not all(
                    isinstance(p, (Partial, Replicate)) for p in pls):
                return None
            out_pl.append(Partial())
            for k, g in enumerate(grads):
                g.append(Replicate() if k == pending[0] else Partial())
            continue
        if not all(type(p) in (Shard, Replicate) for p in pls):
            return None
        split = {ins[k][p.dim] for k, p in enumerate(pls)
                 if isinstance(p, Shard)}
        if len(split) != 1:
            return None
        c = split.pop()
        for k, (p, s) in enumerate(zip(pls, ins)):
            if p != (Shard(s.index(c)) if c in s else Replicate()):
                return None
            grads[k].append(p if c in s else Partial())
        out_pl.append(Shard(out.index(c)) if c in out else Partial())
        ways[c] *= mesh.size(axis)
    if any(sizes[c] % w for c, w in ways.items()):
        return None
    return tuple(out_pl), tuple(
        tuple(g) if pl is not None else None
        for (_, pl), g in zip(operands, grads))


def _matmul_eq(n: int) -> str:
    """The einsum of ``x @ w`` for an ``n``-dim ``x`` and a 2-dim ``w``."""
    rows = "abcdefgh"[:n - 1]
    return f"{rows}y,yz->{rows}z"


class _Regroup(torch.autograd.Function):
    """A head split (``split``) or merge under a mesh whose gradient is
    regrouped the same way back: autograd's own backward of a reshape
    views the gradient as it lies, whatever its placement."""

    @staticmethod
    def forward(ctx, x, shard: ShardCtx, heads: int, dim: int, split: bool):
        ctx.args = shard, heads, dim, split
        return shard._split(x, heads, dim) if split else shard._merge(x, dim)

    @staticmethod
    def backward(ctx, g):
        shard, heads, dim, split = ctx.args
        g = shard._merge(g, dim) if split else shard._split(g, heads, dim)
        return g, None, None, None, None


class _Fold(torch.autograd.Function):
    """A view between (B, S, D) and (G, B / G * S, D) under a mesh
    (``ShardCtx.fold_groups``, ``unfold_groups``): whichever of the two
    is the (B, S, D) side, input or gradient, is gathered over the mesh
    axes that split its sequence before it is folded, and the other
    side's gradient is returned to its forward placement (autograd's own
    backward of a view would fold the gradient as it lies, a split dim
    inside the fold)."""

    @staticmethod
    def forward(ctx, x, shard: ShardCtx, shape, fold: bool):
        ctx.args = shard, tuple(x.placements), tuple(x.shape), fold
        if fold:                        # (B, S, D) -> (G, Tg, D)
            x = shard._gather_axes(x, shard._axes_of(x, 1))
        out = x.reshape(shape)
        ctx.out = tuple(out.placements)
        return out

    @staticmethod
    def backward(ctx, g):
        shard, placements, shape, fold = ctx.args
        if not fold:                    # the gradient folds
            g = shard._gather_axes(g, shard._axes_of(g, 1))
        elif tuple(g.placements) != ctx.out:
            g = g.redistribute(shard.mesh, ctx.out)
        g = g.reshape(shape)
        if tuple(g.placements) != placements:
            g = g.redistribute(shard.mesh, placements)
        return g, None, None, None


class _GradIn(torch.autograd.Function):
    """The identity, whose backward redistributes the gradient to the
    input's own placements (``ShardCtx.transpose``)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.placements = mesh, tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.placements:
            g = g.redistribute(ctx.mesh, ctx.placements)
        return g, None


class _CumSum(torch.autograd.Function):
    """``torch.cumsum`` along the last dim whose backward, the suffix sum
    of the gradient, reverses with ``index_select``
    (``ShardCtx.cumsum``)."""

    @staticmethod
    def forward(ctx, x):
        return torch.cumsum(x, dim=-1)

    @staticmethod
    def backward(ctx, g):
        d = g.dim() - 1
        rev = torch.arange(g.shape[d] - 1, -1, -1, device=g.device)
        return g.index_select(d, rev).cumsum(d).index_select(d, rev)


@dataclasses.dataclass(frozen=True)
class P:
    """A parameter leaf: shape + logical axes + init scale (``:162``)."""
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    scale: float = 0.02
    init: str = "normal"     # normal | zeros | ones

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def spec_map(fn, spec):
    """Map ``fn`` over every P leaf of a nested-dict spec (``:178``)."""
    if isinstance(spec, P):
        return fn(spec)
    return {k: spec_map(fn, v) for k, v in spec.items()}


def abstract_params(spec, dtype: torch.dtype = torch.float32):
    """``logical.py:209``: ``meta`` tensors of the spec's shapes, no
    allocation (the dry-run's parameters)."""
    return spec_map(lambda p: torch.empty(p.shape, dtype=dtype,
                                          device="meta"), spec)


def param_shardings(spec, ctx: ShardCtx):
    """``logical.py:215``: placements aligned with the param tree."""
    return spec_map(lambda p: ctx.sharding_for(p.axes, p.shape), spec)


def place(x: torch.Tensor, placements, mesh):
    """``x`` as a DTensor under ``placements`` on ``mesh`` (``x`` itself
    for ``None``).  Every rank passes the same whole ``x`` and keeps its
    own shard: no collective (``jax.device_put`` of a host array)."""
    if placements is None:
        return x
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(x, mesh, placements, src_data_rank=None)


def count_params(spec) -> int:
    total = 0

    def add(p):
        nonlocal total
        total += math.prod(p.shape)

    spec_map(add, spec)
    return total


def init_params(generator: torch.Generator, spec,
                dtype: torch.dtype = torch.float32):
    """Materialize parameters from a spec tree on ``generator.device``.

    Same leaves as ``repro.distrib.logical.init_params`` (``:185``):
    normal * scale, zeros or ones.  The numbers differ from JAX's, whose
    generator is another; parity tests load JAX's trees instead
    (``repro_torch.interop``).

    A leaf stacked over layers (over one or more leading ``layers`` axes:
    a grouped stack has two) is drawn one layer's slice at a time, so
    the f32 temporary never holds more than one slice (a full-width MoE
    expert stack in bf16 would otherwise need twice its size again in
    f32); a draw in another dtype equals the f32 draw rounded.
    """
    device = generator.device

    def normal(shape, scale):
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return x.mul_(scale)

    def make(p: P):
        if p.init == "zeros":
            return torch.zeros(p.shape, dtype=dtype, device=device)
        if p.init == "ones":
            return torch.ones(p.shape, dtype=dtype, device=device)
        lead = next((i for i, a in enumerate(p.axes) if a != "layers"),
                    len(p.axes))
        if not lead:
            return normal(p.shape, p.scale).to(dtype)
        out = torch.empty(p.shape, dtype=dtype, device=device)
        for layer in out.view(-1, *p.shape[lead:]):
            layer.copy_(normal(p.shape[lead:], p.scale))
        return out

    return spec_map(make, spec)

