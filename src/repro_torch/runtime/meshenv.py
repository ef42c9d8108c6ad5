"""Mesh environment: one object threading distribution context through
model code.

The port of the JAX package's ``repro/runtime/meshenv.py`` on a
``torch.distributed.device_mesh.DeviceMesh``.  ``MeshEnv`` knows which
mesh axes mean "batch" (data parallel: ``data``, and ``pod`` or
``replica`` where the mesh has them) and which axis is tensor parallel
(``model``).  Model code asks the env for ``PartitionSpec``s, for its
coordinate on an axis and for the few collectives it needs; it never
names an axis itself.

Where the reference lets GSPMD and ``shard_map`` insert collectives,
the port calls them explicitly, over the process group of a named axis
(or of a tuple of axes, major first):

* :meth:`MeshEnv.psum`: all-reduce forward, identity backward (the
  output of a row-parallel product, a reduction over vocab shards);
* :meth:`MeshEnv.psum_grad`: identity forward, all-reduce backward (a
  replicated tensor entering a tensor-parallel region, whose gradient
  each rank holds only in part);
* :meth:`MeshEnv.psum_both`: all-reduce forward and backward (a sum
  that every rank then uses whole, so each rank's part of it takes the
  gradient of every rank's use);
* :meth:`MeshEnv.pmax` / :meth:`MeshEnv.pmin`: reductions that carry no
  gradient;
* :meth:`MeshEnv.all_gather`: the shards of an axis concatenated along
  a dim, one ``all_gather`` (no gradient);
* :meth:`MeshEnv.all_gather_grad`: the same with a gradient, whose
  backward is this rank's slice of the incoming gradient, summed over
  the axis first (an all-reduce) when each rank uses the gathered
  tensor only in part (context parallelism's k/v: each rank's queries
  read every key) and taken as it is when every rank holds its whole
  gradient (the gathered attention output, entering the replicated
  residual).

Every collective is an ``all_reduce`` or an ``all_gather``: ``nccl``
runs both, and so does ``gloo`` on CUDA tensors, which is what ranks
sharing one card use (``launch/mesh.py``).

An env can also be a layout without process groups (:func:`make_env`
of a ``{axis: size}`` dict): enough to compute spec trees, as the
reference's dry run does on forced devices, and nothing else.  A
:class:`RecordingEnv` (:func:`recording_env`) adds a coordinate and
records the collectives instead of issuing them: the dry run's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch._tree import tree_map

AxisName = Union[str, Tuple[str, ...], None]

#: axis names that carry data parallelism, as the reference's make_env
BATCH_AXIS_NAMES = ("pod", "data", "replica")


class PartitionSpec:
    """The reference's ``PartitionSpec``: one entry per tensor dim,
    ``None`` (not sharded), an axis name, or a tuple of axis names (the
    dim sharded over their product, the first the major one).  Not a
    tuple, so that parameter trees keep it as a leaf; iterating it gives
    its entries, so ``tuple(spec)`` compares with the reference's."""

    __slots__ = ("entries",)

    def __init__(self, *entries: AxisName):
        self.entries = tuple(tuple(e) if isinstance(e, list) else e
                             for e in entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, PartitionSpec):
            return self.entries == other.entries
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self.entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{self.entries!r}"


P = PartitionSpec


def _names(axis: AxisName) -> Tuple[str, ...]:
    if axis is None:
        return ()
    return (axis,) if isinstance(axis, str) else tuple(axis)


class _Reduce(torch.autograd.Function):
    """all-reduce (sum) forward, identity backward."""

    @staticmethod
    def forward(ctx, x, env, axis):
        return env._all_reduce(x.clone(), axis, "fwd")

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _ReduceGrad(torch.autograd.Function):
    """identity forward, all-reduce (sum) backward."""

    @staticmethod
    def forward(ctx, x, env, axis):
        ctx.env, ctx.axis = env, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.env._all_reduce(g.clone(), ctx.axis, "bwd"), None, None


class _ReduceBoth(torch.autograd.Function):
    """all-reduce (sum) forward and backward."""

    @staticmethod
    def forward(ctx, x, env, axis):
        ctx.env, ctx.axis = env, axis
        return env._all_reduce(x.clone(), axis, "fwd")

    @staticmethod
    def backward(ctx, g):
        return ctx.env._all_reduce(g.clone(), ctx.axis, "bwd"), None, None


class _Gather(torch.autograd.Function):
    """all-gather along ``dim`` forward; backward, this rank's slice of
    the gradient, all-reduced (sum) over the axis first when ``summed``."""

    @staticmethod
    def forward(ctx, x, env, dim, axis, summed):
        ctx.env, ctx.dim, ctx.axis, ctx.summed = env, dim, axis, summed
        return torch.cat(env.gather_parts(x, axis), dim=dim)

    @staticmethod
    def backward(ctx, g):
        env = ctx.env
        if ctx.summed:
            g = env._all_reduce(g.contiguous().clone(), ctx.axis, "bwd")
        return (env.local_slice(g, ctx.dim, ctx.axis).contiguous(), None,
                None, None, None)


@dataclasses.dataclass(frozen=True)
class _Group:
    """One process group of an axis key: the global ranks in it, in
    axis order, and this rank's index among them."""
    pg: object
    ranks: Tuple[int, ...]
    index: int


@dataclasses.dataclass(frozen=True)
class MeshEnv:
    mesh: Optional[object] = None          # a DeviceMesh, or None
    batch_axes: Tuple[str, ...] = ()
    model_axis: Optional[str] = None
    # the reference's §Perf flag: with tp > 1, attention shards over the
    # sequence instead of the heads (its weights replicate; k/v and the
    # output all-gather; models/transformer.py)
    context_parallel_attn: bool = False
    #: (name, size) of every mesh axis, major first; empty off the mesh
    axes: Tuple[Tuple[str, int], ...] = ()
    #: this rank's coordinate on every axis (None: a layout only, or a
    #: rank outside the mesh)
    coordinate: Optional[Tuple[int, ...]] = None
    groups: Dict[Tuple[str, ...], _Group] = dataclasses.field(
        default_factory=dict, compare=False, repr=False)

    # ------------------------------------------------------------------
    @property
    def is_spmd(self) -> bool:
        return bool(self.axes)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(self.axes)

    @property
    def member(self) -> bool:
        """True when this rank holds a coordinate on the mesh."""
        return self.coordinate is not None

    @property
    def tp(self) -> int:
        """Size of the tensor-parallel axis."""
        if not self.is_spmd or self.model_axis is None:
            return 1
        return self.shape[self.model_axis]

    @property
    def dp(self) -> int:
        return self.axis_size(self.batch_axes)

    # ------------------------------------------------------------------
    def batch(self) -> AxisName:
        """Axis-name entry for a batch-sharded dim."""
        if not self.batch_axes:
            return None
        return (self.batch_axes if len(self.batch_axes) > 1
                else self.batch_axes[0])

    def batch_if(self, n: int) -> AxisName:
        """Batch axis entry only when dim ``n`` divides the DP size."""
        if self.dp > 1 and n % self.dp == 0:
            return self.batch()
        return None

    def model(self) -> AxisName:
        return self.model_axis

    def spec(self, *entries: AxisName) -> PartitionSpec:
        """A PartitionSpec, with no axes when not SPMD."""
        if not self.is_spmd:
            return P()
        return P(*entries)

    def divides_model(self, n: int) -> bool:
        """True if dim ``n`` divides evenly over the model axis."""
        return self.tp <= 1 or (n % self.tp == 0)

    # ------------------------------------------------------------------
    # coordinates
    # ------------------------------------------------------------------
    def axis_size(self, axis: AxisName) -> int:
        """Product of the named axes' sizes; an axis the mesh lacks
        counts 1 (the reference's specs name ``model`` on every mesh)."""
        shape = self.shape
        return math.prod(shape.get(a, 1) for a in _names(axis))

    def axis_index(self, axis: AxisName) -> int:
        """This rank's coordinate on the named axes (major first)."""
        if not self.is_spmd:
            return 0
        if self.coordinate is None:
            raise RuntimeError("this rank has no coordinate on the mesh")
        names = [n for n, _ in self.axes]
        idx = 0
        for a in _names(axis):
            if a in names:
                idx = idx * self.shape[a] + self.coordinate[names.index(a)]
        return idx

    def local_slice(self, x, dim: int, axis: AxisName):
        """This rank's contiguous chunk of ``x`` along ``dim`` when that
        dim is sharded over ``axis`` (a view for a tensor)."""
        n = self.axis_size(axis)
        if n == 1:
            return x
        size = x.shape[dim]
        if size % n:
            raise ValueError(f"dim {dim} of size {size} does not divide "
                             f"axis {axis!r} of size {n}")
        c = size // n
        i = self.axis_index(axis)
        if torch.is_tensor(x):
            return x.narrow(dim, i * c, c)
        sl = [slice(None)] * x.ndim
        sl[dim] = slice(i * c, (i + 1) * c)
        return x[tuple(sl)]

    def shard(self, x, spec: PartitionSpec):
        """This rank's piece of the logical ``x`` under ``spec``."""
        for dim, entry in enumerate(spec):
            if entry is not None:
                x = self.local_slice(x, dim, entry)
        return x

    def unshard(self, x: torch.Tensor, spec: PartitionSpec) -> torch.Tensor:
        """The logical tensor of a local piece ``x`` under ``spec``: a
        collective over every axis the spec names (no gradient)."""
        for dim, entry in enumerate(spec):
            if entry is not None:
                x = self.all_gather(x, dim, entry)
        return x

    @property
    def is_first(self) -> bool:
        """True on one process, and on the mesh's rank at coordinate
        (0, ..., 0): the one that writes what the mesh writes once."""
        return not self.is_spmd or (self.coordinate is not None
                                    and not any(self.coordinate))

    # ------------------------------------------------------------------
    # collectives
    # ------------------------------------------------------------------
    def barrier(self) -> None:
        """Wait for every rank of the mesh (nothing on one process)."""
        if self.is_spmd:
            dist.barrier(group=self.group(tuple(n for n, _ in self.axes)).pg)

    def group(self, axis: AxisName) -> _Group:
        key = tuple(a for a in _names(axis) if a in self.shape)
        try:
            return self.groups[key]
        except KeyError:
            raise RuntimeError(f"no process group for axes {key} "
                               "(a layout-only env, or a rank outside "
                               "the mesh)") from None

    def psum(self, x: torch.Tensor, axis: AxisName) -> torch.Tensor:
        """Sum over ``axis``: all-reduce forward, identity backward."""
        if self.axis_size(axis) == 1:
            return x
        return _Reduce.apply(x, self, axis)

    def psum_grad(self, x: torch.Tensor, axis: AxisName) -> torch.Tensor:
        """Identity forward, all-reduce (sum) of the gradient backward."""
        if self.axis_size(axis) == 1:
            return x
        return _ReduceGrad.apply(x, self, axis)

    def psum_both(self, x: torch.Tensor, axis: AxisName) -> torch.Tensor:
        """Sum over ``axis``, all-reduce forward and backward: the
        transpose of a sum whose result each rank uses whole."""
        if self.axis_size(axis) == 1:
            return x
        return _ReduceBoth.apply(x, self, axis)

    def _all_reduce(self, x: torch.Tensor, axis: AxisName, phase: str,
                    op=None) -> torch.Tensor:
        """The one all-reduce primitive: ``x`` reduced in place over
        ``axis`` (``op`` None: a sum); ``phase`` says whether autograd's
        forward ("fwd") or backward ("bwd") emits it.  Returns x."""
        dist.all_reduce(x, op=dist.ReduceOp.SUM if op is None else op,
                        group=self.group(axis).pg)
        return x

    def _reduce(self, x, axis, op):
        out = x.detach().clone()
        if self.axis_size(axis) > 1:
            self._all_reduce(out, axis, "fwd", op)
        return out

    def pmax(self, x: torch.Tensor, axis: AxisName) -> torch.Tensor:
        """Elementwise max over ``axis``; no gradient."""
        return self._reduce(x, axis, dist.ReduceOp.MAX)

    def pmin(self, x: torch.Tensor, axis: AxisName) -> torch.Tensor:
        """Elementwise min over ``axis``; no gradient."""
        return self._reduce(x, axis, dist.ReduceOp.MIN)

    def all_reduce_(self, x: torch.Tensor, axis: AxisName) -> torch.Tensor:
        """In-place sum of ``x`` over ``axis`` (no autograd); returns x."""
        if self.axis_size(axis) > 1:
            self._all_reduce(x, axis, "fwd")
        return x

    def gather_parts(self, x: torch.Tensor, axis: AxisName) -> list:
        """Every member's ``x`` (all of one shape), in axis order: one
        ``all_gather`` over the axis's group, the one all-gather
        primitive."""
        x = x.detach().contiguous()
        parts = [torch.empty_like(x) for _ in range(self.axis_size(axis))]
        dist.all_gather(parts, x, group=self.group(axis).pg)
        return parts

    def all_gather(self, x: torch.Tensor, dim: int,
                   axis: AxisName) -> torch.Tensor:
        """Every member's ``x`` concatenated along ``dim`` in axis order
        (every member's ``x`` has the same shape); no gradient."""
        if self.axis_size(axis) == 1:
            return x
        return torch.cat(self.gather_parts(x, axis), dim=dim)

    def all_gather_grad(self, x: torch.Tensor, dim: int, axis: AxisName,
                        summed: bool) -> torch.Tensor:
        """:meth:`all_gather` with a gradient: backward, this rank's chunk
        of the incoming gradient along ``dim``, summed over ``axis``
        first when ``summed`` (each rank's use of the gathered tensor
        gives only part of its gradient)."""
        if self.axis_size(axis) == 1:
            return x
        return _Gather.apply(x, self, dim, axis, summed)

    def gather_into_(self, full: torch.Tensor, dim: int,
                     axis: AxisName) -> torch.Tensor:
        """In place: chunk ``i`` of ``full`` along ``dim`` from member
        ``i`` of ``axis`` (each member holds its own chunk already); no
        gradient."""
        n = self.axis_size(axis)
        if n == 1:
            return full
        c = full.shape[dim] // n
        me = self.group(axis).index
        parts = self.gather_parts(full.narrow(dim, me * c, c), axis)
        for i, part in enumerate(parts):
            if i != me:
                full.narrow(dim, i * c, c).copy_(part)
        return full


CPU_ENV = MeshEnv()


@dataclasses.dataclass(frozen=True)
class RecordingEnv(MeshEnv):
    """A layout with a coordinate and no process groups: every
    collective the program emits is appended to :attr:`record` as
    ``(kind, bytes, group size, "fwd" | "bwd")`` (``launch/
    collective_stats.py``), and returns what the real one's shape is
    without communicating.  An all-reduce records its tensor's bytes
    and leaves the tensor as it is (this member's part); an all-gather
    records its output's bytes (every member's piece) and returns
    copies of this member's piece.  The reductions autograd's backward
    emits (``psum_grad``, ``psum_both``) record there, as "bwd".  Used
    by the dry run (``launch/dryrun.py``) to run one rank's program on
    ``meta`` at a layout no world has; nothing here calls
    ``torch.distributed``."""
    record: list = dataclasses.field(default_factory=list, compare=False,
                                     repr=False)

    def group(self, axis: AxisName) -> _Group:
        key = tuple(a for a in _names(axis) if a in self.shape)
        return _Group(pg=None, ranks=(), index=self.axis_index(key))

    def barrier(self) -> None:
        pass

    def _all_reduce(self, x, axis, phase, op=None):
        self.record.append(("all-reduce", x.numel() * x.element_size(),
                            self.axis_size(axis), phase))
        return x

    def gather_parts(self, x, axis):
        n = self.axis_size(axis)
        self.record.append(("all-gather", n * x.numel() * x.element_size(),
                            n, "fwd"))
        x = x.detach()
        return [x.clone(memory_format=torch.contiguous_format)
                for _ in range(n)]


def recording_env(layout: Dict[str, int],
                  coordinate: Optional[Tuple[int, ...]] = None, *,
                  context_parallel_attn: bool = False) -> RecordingEnv:
    """The :class:`RecordingEnv` of a ``{axis: size}`` layout at
    ``coordinate`` (default (0, ..., 0)), its record empty."""
    base = make_env(dict(layout), context_parallel_attn=context_parallel_attn)
    coordinate = (tuple(0 for _ in base.axes) if coordinate is None
                  else tuple(int(c) for c in coordinate))
    if len(coordinate) != len(base.axes) or any(
            not 0 <= c < n for c, (_, n) in zip(coordinate, base.axes)):
        raise ValueError(f"coordinate {coordinate} is not on the layout "
                         f"{dict(base.axes)}")
    return RecordingEnv(batch_axes=base.batch_axes,
                        model_axis=base.model_axis,
                        context_parallel_attn=context_parallel_attn,
                        axes=base.axes, coordinate=coordinate)


def shard_tree(tree, specs, env: MeshEnv):
    """Each rank's own piece of every leaf of a logical tree (tensors
    or numpy arrays), under the spec tree ``specs`` of the same
    structure; a tensor piece is a contiguous copy, not a view that
    would keep the logical tensor alive."""
    def cut(x, spec):
        x = env.shard(x, spec)
        return (x.clone(memory_format=torch.contiguous_format)
                if torch.is_tensor(x) else x)
    return tree_map(cut, tree, specs)


def unshard_tree(tree, specs, env: MeshEnv):
    """The logical tree of each rank's pieces: a collective over every
    axis the specs name (every rank of the mesh calls it)."""
    return tree_map(env.unshard, tree, specs)


def _axis_groups(mesh, names: Tuple[str, ...]) -> Optional[_Group]:
    """The process group over ``names`` (major first) that holds this
    rank; every rank of the world creates every such group, in the same
    order, as ``new_group`` requires."""
    all_names = tuple(mesh.mesh_dim_names)
    layout = mesh.mesh
    keep = [all_names.index(n) for n in names]
    rest = [i for i in range(layout.dim()) if i not in keep]
    perm = layout.permute(*rest, *keep).reshape(-1, math.prod(
        layout.shape[i] for i in keep))
    mine = None
    me = dist.get_rank()
    for row in perm.tolist():
        if len(keep) == 1:
            if me in row:
                mine = _Group(pg=mesh.get_group(names[0]), ranks=tuple(row),
                              index=row.index(me))
            continue
        pg = dist.new_group(row)
        if me in row:
            mine = _Group(pg=pg, ranks=tuple(row), index=row.index(me))
    return mine


def make_env(mesh, *, context_parallel_attn: bool = False) -> MeshEnv:
    """The env of a ``DeviceMesh`` (process groups for the model axis and
    for the batch axes together and one by one), of a ``{axis: size}``
    dict (a layout: spec trees only), or ``CPU_ENV`` for None."""
    if mesh is None:
        return CPU_ENV
    if isinstance(mesh, dict):
        axes = tuple((str(k), int(v)) for k, v in mesh.items())
        coordinate, groups = None, {}
    else:
        names = tuple(mesh.mesh_dim_names)
        axes = tuple(zip(names, (int(s) for s in mesh.mesh.shape)))
        coord = mesh.get_coordinate()
        coordinate = None if coord is None else tuple(int(c) for c in coord)
        keys = [(n,) for n in names]
        batch = tuple(n for n in names if n in BATCH_AXIS_NAMES)
        if len(batch) > 1:
            keys.append(batch)
        if len(names) > 1:
            keys.append(names)
        groups = {}
        for key in keys:
            g = _axis_groups(mesh, key)
            if g is not None:
                groups[key] = g
    names = [n for n, _ in axes]
    batch = tuple(n for n in names if n in BATCH_AXIS_NAMES)
    model = "model" if "model" in names else None
    return MeshEnv(mesh=None if isinstance(mesh, dict) else mesh,
                   batch_axes=batch, model_axis=model,
                   context_parallel_attn=context_parallel_attn, axes=axes,
                   coordinate=coordinate, groups=groups)


__all__ = ["AxisName", "BATCH_AXIS_NAMES", "CPU_ENV", "MeshEnv",
           "P", "PartitionSpec", "RecordingEnv", "make_env", "recording_env",
           "shard_tree", "unshard_tree"]
