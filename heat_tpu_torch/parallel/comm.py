"""Communication over ``torch.distributed`` (counterpart of heat_tpu/parallel/comm.py).

The port is SPMD: one process (rank) per card, and a :class:`Communication`
is a ``torch.distributed`` process group seen from one rank.  With no process
group initialised the world has one rank.

Canonical distribution (pad-and-mask), the same as the JAX package's: a
global shape ``g`` split along axis ``s`` over ``n`` ranks is padded along
``s`` to the next multiple of ``n`` and cut into equal chunks.  The real data
is a contiguous prefix and the padding a suffix owned by the highest ranks.
Each rank stores its padded chunk; anything that reduces or contracts across
the split axis masks the padding with its own neutral element first.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Communication", "HierarchicalCommunication", "SELF", "WORLD", "comm_epoch", "finalize", "get_comm", "init",
           "is_initialized", "sanitize_comm", "use_comm"]

#: the names of the hierarchical grid's axes: 'global' spans the nodes, 'node'
#: the ranks within one node (heat_tpu/parallel/comm.py's names)
GLOBAL_AXIS_NAME = "global"
NODE_AXIS_NAME = "node"


class Communication:
    """One rank's view of a process group.

    ``size`` and ``rank`` may be given to describe a world without joining
    it: such a communicator answers the layout questions (``chunk``,
    ``lshape_map``, ``counts_displs_shape``) and refuses collectives."""

    def __init__(self, group=None, size: Optional[int] = None, rank: Optional[int] = None):
        if (size is None) != (rank is None):
            raise ValueError("give both size and rank, or neither")
        if size is not None and not 0 <= rank < size:
            raise ValueError(f"rank {rank} is outside a world of size {size}")
        self.group = group
        self._size = size
        self._rank = rank
        self._retired = False
        #: ``(parent, ranks)`` of a communication made by :meth:`reshape`:
        #: its rank i is the parent's rank ``ranks[i]``
        self._origin = None

    @classmethod
    def _outside(cls, size: int, **kwargs) -> "Communication":
        """What a rank that is not a member gets of a new communication of
        ``size`` ranks: its layout, rank -1 (no chunk of its own) and no
        collectives."""
        c = cls(size=size, rank=0, **kwargs)
        c._rank = -1
        return c

    @property
    def is_member(self) -> bool:
        """Whether this process is one of the communication's ranks."""
        return self.rank >= 0

    @property
    def retired(self) -> bool:
        """True once :meth:`reshape` replaced this communication (it stays
        usable: its arrays still need it to move)."""
        return self._retired

    @property
    def size(self) -> int:
        """Number of ranks."""
        if self._size is not None:
            return self._size
        return dist.get_world_size(self.group) if dist.is_initialized() else 1

    @property
    def rank(self) -> int:
        """This process's rank."""
        if self._rank is not None:
            return self._rank
        return dist.get_rank(self.group) if dist.is_initialized() else 0

    def __repr__(self) -> str:
        return f"Communication(size={self.size}, rank={self.rank})"

    # ------------------------------------------------------------------
    # canonical layout (heat_tpu/parallel/comm.py:271-368)
    # ------------------------------------------------------------------
    def pad_amount(self, extent: int) -> int:
        """Padding needed to make ``extent`` divisible by ``size``."""
        return (-extent) % self.size

    def padded_extent(self, extent: int) -> int:
        return extent + self.pad_amount(extent)

    def chunk(
        self, shape: Sequence[int], split: Optional[int], rank: Optional[int] = None
    ) -> Tuple[int, Tuple[int, ...], Tuple[slice, ...]]:
        """``(offset, true local shape, slices)`` of one rank's block: every
        rank gets ``ceil(extent / size)`` rows, so the true local shape of
        the highest ranks may be smaller or zero."""
        shape = tuple(int(s) for s in shape)
        if split is None:
            return 0, shape, tuple(slice(0, s) for s in shape)
        rank = self.rank if rank is None else rank
        extent = shape[split]
        per = self.padded_extent(extent) // self.size
        start = min(rank * per, extent) if rank >= 0 else extent  # a rank outside holds nothing
        stop = min(start + per, extent)
        lshape = shape[:split] + (stop - start,) + shape[split + 1 :]
        slices = tuple(slice(start, stop) if d == split else slice(0, s) for d, s in enumerate(shape))
        return start, lshape, slices

    def lshape_map(self, shape: Sequence[int], split: Optional[int]) -> np.ndarray:
        """(size, ndim) array of true local shapes, one row per rank."""
        shape = tuple(int(s) for s in shape)
        out = np.empty((self.size, max(len(shape), 1)), dtype=np.int64)
        for r in range(self.size):
            out[r, : len(shape)] = self.chunk(shape, split, rank=r)[1]
        return out[:, : len(shape)]

    def counts_displs_shape(
        self, shape: Sequence[int], axis: int
    ) -> Tuple[Tuple[int, ...], Tuple[int, ...], Tuple[int, ...]]:
        """Counts and displacements along ``axis`` per rank, and this rank's
        true local shape."""
        counts, displs = [], []
        for r in range(self.size):
            off, lsh, _ = self.chunk(shape, axis, rank=r)
            counts.append(lsh[axis])
            displs.append(off)
        return tuple(counts), tuple(displs), tuple(self.chunk(shape, axis)[1])

    # ------------------------------------------------------------------
    # collectives: eager, on this rank's tensors
    # ------------------------------------------------------------------
    def _check_joined(self) -> None:
        if self._size is not None and self._size > 1:
            raise RuntimeError("this Communication only describes a world; it has joined no process group")

    def _reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        if self.size > 1:
            self._check_joined()
            dist.all_reduce(x, op=op, group=self.group)
        return x

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over all ranks, in place; returns ``x``.  A tensor that
        takes part in a gradient (``requires_grad`` under grad mode) is
        summed out of place instead, and its gradient is the sum of the
        ranks' gradients, as ``jax.lax.psum`` transposes."""
        if self.size > 1 and torch.is_grad_enabled() and x.requires_grad:
            self._check_joined()
            return _PSum.apply(x, self)
        return self._reduce(x, dist.ReduceOp.SUM)

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, dist.ReduceOp.MIN)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, dist.ReduceOp.MAX)

    def pprod(self, x: torch.Tensor) -> torch.Tensor:
        """Product of ``x`` over all ranks, in place; returns ``x``."""
        return self._reduce(x, dist.ReduceOp.PRODUCT)

    def all_gather(self, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """Every rank's ``x`` (all of one shape), concatenated along ``axis``
        in rank order."""
        if self.size == 1:
            return x
        self._check_joined()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts, dim=axis)

    def all_gather_varying(self, x: torch.Tensor, extents: Sequence[int], axis: int) -> List[torch.Tensor]:
        """Every rank's ``x``, in rank order, where rank r's extent along
        ``axis`` is ``extents[r]`` and all else is equal: each is padded to
        the largest extent for one equal-shape all-gather and cut back."""
        extents = [int(e) for e in extents]
        if len(extents) != self.size or x.shape[axis] != extents[self.rank]:
            raise ValueError(f"rank {self.rank} holds extent {x.shape[axis]}; extents are {extents}")
        pad = max(extents) - x.shape[axis]
        if pad:
            widths = list(x.shape)
            widths[axis] = pad
            x = torch.cat([x, x.new_zeros(widths)], dim=axis)
        if self.size == 1:
            return [x.narrow(axis, 0, extents[0])]
        self._check_joined()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return [p.narrow(axis, 0, e) for p, e in zip(parts, extents)]

    def all_to_all_varying(self, blocks: Sequence[torch.Tensor], recv_extents: Sequence[int],
                           axis: int) -> List[torch.Tensor]:
        """One exchange of blocks whose extents along ``axis`` vary: this
        rank sends ``blocks[r]`` to rank r and receives, in rank order, the
        block rank r sends it, of extent ``recv_extents[r]`` (all else of
        one shape).  Every block is padded to the largest extent any rank
        sends (one max all-reduce of a scalar) for one equal-shape
        all-to-all, then cut back."""
        blocks = list(blocks)
        recv_extents = [int(e) for e in recv_extents]
        if len(blocks) != self.size or len(recv_extents) != self.size:
            raise ValueError(f"need one block and one extent per rank, got {len(blocks)} and {len(recv_extents)}")
        if self.size == 1:
            return [blocks[0].narrow(axis, 0, recv_extents[0])]
        self._check_joined()
        top = torch.tensor([max(b.shape[axis] for b in blocks)], dtype=torch.int64, device=blocks[0].device)
        pad = int(self.pmax(top)[0])
        send = []
        for b in blocks:
            if b.shape[axis] < pad:
                widths = list(b.shape)
                widths[axis] = pad - b.shape[axis]
                b = torch.cat([b, b.new_zeros(widths)], dim=axis)
            send.append(b.contiguous())
        got = [torch.empty_like(send[0]) for _ in range(self.size)]
        dist.all_to_all(got, send, group=self.group)
        return [g.narrow(axis, 0, e) for g, e in zip(got, recv_extents)]

    def psum_scatter(self, x: torch.Tensor, scatter_dimension: int = 0) -> torch.Tensor:
        """Reduce-scatter, tiled (``jax.lax.psum_scatter(..., tiled=True)``):
        the sum of every rank's ``x`` is cut into ``size`` equal blocks
        along ``scatter_dimension`` and rank r keeps block r.  A complex
        tensor travels as its real view."""
        size, d = self.size, scatter_dimension % max(x.ndim, 1)
        if x.shape[d] % size:
            raise ValueError(f"psum_scatter: extent {x.shape[d]} of axis {d} is not divisible by {size} ranks")
        if size == 1:
            return x
        self._check_joined()
        if x.is_complex():
            return torch.view_as_complex(self.psum_scatter(torch.view_as_real(x), d))
        send = x.movedim(d, 0).contiguous()
        out = send.new_empty((send.shape[0] // size,) + tuple(send.shape[1:]))
        _REDUCE_SCATTER(out, send, op=dist.ReduceOp.SUM, group=self.group)
        return out.movedim(0, d)

    def bcast(self, x: torch.Tensor, root: int) -> torch.Tensor:
        """Rank ``root``'s ``x`` on every rank (of one shape and dtype on
        all of them); in place, returns ``x``."""
        if self.size == 1:
            return x
        self._check_joined()
        dist.broadcast(x, src=self._global_rank(root), group=self.group)
        return x

    def all_to_all(self, x: torch.Tensor, split_axis: int, concat_axis: int) -> torch.Tensor:
        """The tiled all-to-all of ``jax.lax.all_to_all(..., tiled=True)``:
        ``x`` is cut into ``size`` equal blocks along ``split_axis``, block r
        goes to rank r, and the blocks received are concatenated along
        ``concat_axis`` in rank order.  A complex tensor travels as its real
        view.  Differentiable: the gradient goes back by the all-to-all with
        the two axes swapped."""
        size = self.size
        if x.shape[split_axis] % size:
            raise ValueError(f"all_to_all: extent {x.shape[split_axis]} of axis {split_axis} is not divisible by {size} ranks")
        if size == 1:
            return x
        self._check_joined()
        return _AllToAll.apply(x, self, split_axis % x.ndim, concat_axis % x.ndim)

    def _all_to_all(self, x: torch.Tensor, split_axis: int, concat_axis: int) -> torch.Tensor:
        """The exchange itself, outside autograd (both axes non-negative)."""
        if x.is_complex():
            return torch.view_as_complex(self._all_to_all(torch.view_as_real(x), split_axis, concat_axis))
        parts = [p.contiguous() for p in torch.tensor_split(x, self.size, dim=split_axis)]
        got = [torch.empty_like(parts[0]) for _ in range(self.size)]
        dist.all_to_all(got, parts, group=self.group)
        return torch.cat(got, dim=concat_axis)

    def ppermute(self, x: torch.Tensor, perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """``jax.lax.ppermute``: for each ``(src, dst)`` pair rank src sends
        its ``x`` to rank dst; a rank that is no pair's destination gets
        zeros.  Every rank passes the same ``perm``, with each rank at most
        once as a source and once as a destination.  Differentiable: the
        gradient goes back by the ppermute with every pair reversed (a
        rank that sent nothing gets a zero gradient)."""
        perm = tuple((int(s), int(d)) for s, d in perm)
        if self.size == 1:
            return x if (0, 0) in perm else torch.zeros_like(x)
        self._check_joined()
        return _PPermute.apply(x, self, perm)

    def pscan(self, x: torch.Tensor, inclusive: bool = True, combine=torch.add, neutral=0) -> torch.Tensor:
        """Prefix scan of ``x`` over the ranks, rank 0 first, with
        ``combine(earlier, later)`` (a sum by default): log2(size) rounds of
        :meth:`ppermute`, in each of which a rank combines what the rank
        ``shift`` below it sends.  The exclusive scan is the previous rank's
        inclusive one, ``neutral`` at rank 0.  ``x`` travels as bytes, so
        any dtype goes; the scan is not differentiable."""
        n = self.size
        if n == 1:
            return x if inclusive else torch.full_like(x, neutral)

        def shifted(t, shift):
            return _from_bytes(self.ppermute(_as_bytes(t), [(i, i + shift) for i in range(n - shift)]), t.dtype)

        acc, shift = x, 1
        while shift < n:
            got = shifted(acc, shift)
            if self.rank >= shift:
                acc = combine(got, acc)
            shift *= 2
        if inclusive:
            return acc
        prev = shifted(acc, 1)
        return prev if self.rank > 0 else torch.full_like(x, neutral)

    def exscan(self, x: torch.Tensor, combine=torch.add, neutral=0) -> torch.Tensor:
        """Exclusive prefix scan over the ranks (``neutral`` at rank 0)."""
        return self.pscan(x, False, combine, neutral)

    def _ppermute(self, x: torch.Tensor, perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """The exchange itself, outside autograd."""
        rank = self.rank
        dst = [d for s, d in perm if s == rank]
        src = [s for s, d in perm if d == rank]
        if len(dst) > 1 or len(src) > 1:
            raise ValueError(f"rank {rank} appears more than once as a source or a destination in {perm}")
        x = x.contiguous()
        out = torch.zeros_like(x)
        if dst == [rank]:
            out.copy_(x)
            return out
        ops = []
        if dst:
            ops.append(dist.P2POp(dist.isend, x, self._global_rank(dst[0]), self.group))
        if src:
            ops.append(dist.P2POp(dist.irecv, out, self._global_rank(src[0]), self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return out

    def ring_shift(self, x: torch.Tensor, shift: int = 1) -> torch.Tensor:
        """Cyclic shift by ``shift`` ranks: rank i's ``x`` goes to rank
        ``(i + shift) % size`` (the ring of ring attention).  Its gradient
        goes back by ``ring_shift(-shift)``."""
        n = self.size
        return self.ppermute(x, [(i, (i + shift) % n) for i in range(n)])

    def _global_rank(self, rank: int) -> int:
        return rank if self.group is None else dist.get_global_rank(self.group, rank)

    # ------------------------------------------------------------------
    # sub-communicators (heat_tpu/parallel/comm.py:373-386)
    # ------------------------------------------------------------------
    def split(self, color_ranks: Sequence[int], axis_name: Optional[str] = None) -> "Communication":
        """A flat communication over the ranks ``color_ranks`` of this one
        (in that order), by ``dist.new_group``: every rank of this
        communication calls it with the same ranks, members or not (torch's
        rule for creating a group).  A rank outside the subset gets a
        communication it may not use.  ``axis_name`` is accepted for the
        reference's signature (a mesh axis there; a group has none)."""
        ranks = [int(r) for r in color_ranks]
        if not all(0 <= r < self.size for r in ranks):
            raise ValueError(f"ranks {ranks} are not all in a world of {self.size}")
        if self._size is None and dist.is_initialized() and self.size > 1:
            return Communication(dist.new_group([self._global_rank(r) for r in ranks]))
        # a world of one, or a described world: the layout of the subset
        return Communication(size=len(ranks), rank=ranks.index(self.rank) if self.rank in ranks else 0)

    # ------------------------------------------------------------------
    # elastic reshape (heat_tpu/parallel/comm.py:439-463)
    # ------------------------------------------------------------------
    def _surviving_ranks(self, n_devices: Optional[int], devices) -> List[int]:
        """The ranks of this communication a reshape keeps, in order: the
        explicit ``devices`` (ranks of this communication), or the first
        ``n_devices``.  Raises :class:`ReshapeError` for an impossible
        target."""
        from ..resilience.errors import ReshapeError

        if devices is not None:
            ranks = [int(d) for d in devices]
            missing = [r for r in ranks if not 0 <= r < self.size]
            if missing or len(set(ranks)) != len(ranks):
                raise ReshapeError(
                    f"reshape target names rank(s) {missing or ranks} that are not distinct ranks of this "
                    f"communication of {self.size}", old_size=self.size, new_size=len(ranks))
            if not ranks:
                raise ReshapeError("reshape target is empty", old_size=self.size, new_size=0)
            return ranks
        if n_devices is None:
            raise ReshapeError("reshape needs n_devices or an explicit device list", old_size=self.size)
        n = int(n_devices)
        if n < 1:
            raise ReshapeError(f"reshape target world size must be >= 1, got {n}", old_size=self.size, new_size=n)
        if n > self.size:
            raise ReshapeError(
                f"reshape target world size {n} exceeds the {self.size} ranks of this communication: a larger "
                "world is a restart (finalize(), then init() with the new WORLD_SIZE)",
                old_size=self.size, new_size=n)
        return list(range(n))

    def reshape(self, n_devices: Optional[int] = None, devices=None) -> "Communication":
        """A new communication over the ranks that stay: the first
        ``n_devices`` ranks of this one, or its ranks ``devices``.

        The elastic primitive: every rank of this communication calls it,
        the ranks that leave included; each gets the new communication (a
        rank that leaves one it is not a member of: ``is_member`` False, no
        chunk, no collectives).  Live arrays move with
        :meth:`DNDarray.reshard_` (a row exchange over this communication,
        on which every rank is still alive), checkpointed state with
        ``Checkpointer.restore(..., comm=new)``.  This communication is
        marked retired but stays usable.  A world that lost a process cannot
        make a group: that loss is recovered by a restart (``finalize()``,
        then ``init()`` with the new ``WORLD_SIZE``), the process
        supervisor's path.  Raises :class:`ReshapeError` for an impossible
        target (empty, larger than this world, ranks it does not have)."""
        from ..telemetry.spans import span

        ranks = self._surviving_ranks(n_devices, devices)
        with span("comm.reshape", old=self.size, new=len(ranks)):
            new = self._reshaped(ranks)
        new._origin = (self, ranks)
        self._retired = True
        _clear_dispatch_cache()
        return new

    def _joined(self) -> bool:
        return self._size is None and dist.is_initialized() and self.size > 1

    def _reshaped(self, ranks: List[int]) -> "Communication":
        if self.rank not in ranks:
            return Communication._outside(len(ranks))
        if not self._joined() or len(ranks) == 1:
            # a described world, a world of one, or a target of one rank:
            # no process group is needed
            return Communication(size=len(ranks), rank=ranks.index(self.rank))
        return Communication(_member_group([self._global_rank(r) for r in ranks]))


class _PSum(torch.autograd.Function):
    """psum out of place; the gradient of every rank's sum is the sum of
    the ranks' gradients."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return comm._reduce(x.clone(), dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm._reduce(g.clone(), dist.ReduceOp.SUM), None


class _AllToAll(torch.autograd.Function):
    """The tiled all-to-all; its transpose swaps the split and concat axes."""

    @staticmethod
    def forward(ctx, x, comm, split_axis, concat_axis):
        ctx.comm, ctx.axes = comm, (split_axis, concat_axis)
        return comm._all_to_all(x, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis = ctx.axes
        return ctx.comm._all_to_all(g, concat_axis, split_axis), None, None, None


class _PPermute(torch.autograd.Function):
    """ppermute; its transpose sends back along every pair reversed."""

    @staticmethod
    def forward(ctx, x, comm, perm):
        ctx.comm, ctx.perm = comm, perm
        return comm._ppermute(x, perm)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm._ppermute(g, [(d, s) for s, d in ctx.perm]), None, None


class HierarchicalCommunication(Communication):
    """A (n_node, per_node) grid over a group's ranks, nodes contiguous (the
    counterpart of heat_tpu/parallel/comm.py:611-733, and of heat's DASO
    pair of a node-local group and a cross-node world): rank ``r`` is the
    ``r % per_node``-th rank of node ``r // per_node``.  Axis ``'node'``
    (size ``per_node``) spans the ranks of one node, axis ``'global'``
    (size ``n_node``) the ranks of one local index across the nodes.

    Every rank builds every node group and every global group, in the same
    order (``dist.new_group``'s rule), and keeps the two it belongs to as
    :attr:`node_comm` and :attr:`global_comm`.  Used as a plain
    :class:`Communication` for split arrays, the flattened grid is the
    group's own rank order, so chunks, ``lshape_map`` and
    ``counts_displs_shape`` are the plain communication's; the collectives
    take an ``axis``: ``'node'``, ``'global'``, or None / both for the
    whole grid.  ``reshape`` makes the grid of the ranks that stay.
    """

    def __init__(self, grid: Optional[Tuple[int, int]] = None, group=None,
                 axis_names: Tuple[str, str] = (GLOBAL_AXIS_NAME, NODE_AXIS_NAME),
                 size: Optional[int] = None, rank: Optional[int] = None, _local_groups: bool = False):
        super().__init__(group, size, rank)
        n = self.size
        joined = size is None and dist.is_initialized() and n > 1
        if grid is None:
            grid = self.infer_grid(self._hosts() if joined else [""] * n)
        n_node, per_node = int(grid[0]), int(grid[1])
        if n_node < 1 or per_node < 1 or n_node * per_node != n:
            raise ValueError(f"grid {tuple(grid)} does not tile {n} ranks")
        self._grid = (n_node, per_node)
        self._axis_names = tuple(axis_names)
        me = self.rank
        node, local = divmod(me, per_node)
        if joined and _local_groups:
            # a reshaped grid: the members alone make their two groups (the
            # ranks that left make none), every rank in the same order
            me_node = list(range(node * per_node, (node + 1) * per_node))
            me_global = list(range(local, n, per_node))
            self.node_comm, self.global_comm = (
                Communication(_member_group([self._global_rank(r) for r in members])) if len(members) > 1
                else Communication(size=1, rank=0) for members in (me_node, me_global))
        elif joined:
            ranks = [self._global_rank(r) for r in range(n)]
            nodes = [dist.new_group(ranks[i * per_node:(i + 1) * per_node]) for i in range(n_node)]
            globals_ = [dist.new_group(ranks[j::per_node]) for j in range(per_node)]
            self.node_comm = Communication(nodes[node])
            self.global_comm = Communication(globals_[local])
        else:
            self.node_comm = Communication(size=per_node, rank=local)
            self.global_comm = Communication(size=n_node, rank=node)

    def _hosts(self):
        """Each rank's host name, in rank order (one all-gather)."""
        import socket

        out = [None] * self.size
        dist.all_gather_object(out, socket.gethostname(), group=self.group)
        return out

    @staticmethod
    def infer_grid(hosts: Sequence[str]) -> Tuple[int, int]:
        """``(n_node, per_node)`` for ranks on ``hosts`` (each rank's host, in
        rank order): one node per host where the hosts hold equal,
        contiguous runs of ranks; ``(1, n)`` on one host or otherwise."""
        hosts = list(hosts)
        n = len(hosts)
        names = list(dict.fromkeys(hosts))
        k = len(names)
        if k > 1 and n % k == 0:
            per = n // k
            if all(hosts[i * per:(i + 1) * per] == [names[i]] * per for i in range(k)):
                return (k, per)
        return (1, n)

    @property
    def global_axis(self) -> str:
        """The axis across the nodes."""
        return self._axis_names[0]

    @property
    def node_axis(self) -> str:
        """The axis across one node's ranks."""
        return self._axis_names[1]

    @property
    def num_nodes(self) -> int:
        return self._grid[0]

    @property
    def node_size(self) -> int:
        return self._grid[1]

    @property
    def node_index(self) -> int:
        """This rank's node."""
        return self.rank // self._grid[1]

    def _along(self, axis) -> Communication:
        """The communication of an axis: the node's, the local index's
        across the nodes, or the whole grid (None, or both axes)."""
        if axis is None or (isinstance(axis, (tuple, list)) and set(axis) == set(self._axis_names)):
            return Communication(self.group, self._size, self._rank)
        if axis == self.node_axis:
            return self.node_comm
        if axis == self.global_axis:
            return self.global_comm
        raise ValueError(f"unknown axis {axis!r}; the axes are {self._axis_names}")

    def psum(self, x: torch.Tensor, axis=None) -> torch.Tensor:
        """Sum over ``axis`` (see :meth:`Communication.psum`)."""
        return Communication.psum(self._along(axis), x)

    def pmax(self, x: torch.Tensor, axis=None) -> torch.Tensor:
        return Communication.pmax(self._along(axis), x)

    def pmin(self, x: torch.Tensor, axis=None) -> torch.Tensor:
        return Communication.pmin(self._along(axis), x)

    def all_gather(self, x: torch.Tensor, axis: int = 0, mesh_axis=None) -> torch.Tensor:
        """Every rank's ``x`` over ``mesh_axis`` concatenated along ``axis``
        in rank order."""
        return Communication.all_gather(self._along(mesh_axis), x, axis)

    def bcast(self, x: torch.Tensor, root: int, axis=None) -> torch.Tensor:
        """Rank ``root`` (of ``axis``'s communication)'s ``x`` on every rank
        of that communication."""
        return Communication.bcast(self._along(axis), x, root)

    def _reshaped(self, ranks: List[int]) -> "HierarchicalCommunication":
        """The grid over the ranks that stay (:meth:`Communication.reshape`),
        re-inferred from their hosts (one all-gather of the host names over
        this communication), not carried over: a loss usually leaves a
        partial node."""
        hosts = self._hosts() if self._joined() else [""] * self.size
        grid = self.infer_grid([hosts[r] for r in ranks])
        if self.rank not in ranks:
            return HierarchicalCommunication._outside(len(ranks), grid=grid, axis_names=self._axis_names)
        if not self._joined() or len(ranks) == 1:
            return HierarchicalCommunication(grid, axis_names=self._axis_names, size=len(ranks),
                                             rank=ranks.index(self.rank))
        group = _member_group([self._global_rank(r) for r in ranks])
        return HierarchicalCommunication(grid, group, self._axis_names, _local_groups=True)

    def __eq__(self, other) -> bool:
        # the same ranks on another grid is another topology: its node and
        # global collectives differ
        return (isinstance(other, HierarchicalCommunication) and other.group is self.group
                and (other._size, other._rank) == (self._size, self._rank) and other._grid == self._grid
                and other._axis_names == self._axis_names)

    def __hash__(self) -> int:
        return hash(("hierarchical", id(self.group), self._size, self._rank, self._grid, self._axis_names))

    def __repr__(self) -> str:
        return f"HierarchicalCommunication(nodes={self.num_nodes}, per_node={self.node_size}, rank={self.rank})"


#: process groups made by reshape, by (epoch, global ranks): torch names a
#: group its members alone make after its ranks and refuses a second one
_GROUPS = {}


def _member_group(global_ranks: List[int]):
    """The process group over ``global_ranks`` (None for the whole world),
    made by its members alone (``use_local_synchronization``: the ranks that
    left take no part) and reused for the same ranks."""
    if list(global_ranks) == list(range(dist.get_world_size())):
        return None
    key = (_EPOCH, tuple(global_ranks))
    if key not in _GROUPS:
        _GROUPS[key] = dist.new_group(list(global_ranks), use_local_synchronization=True)
    return _GROUPS[key]


# torch 2.13 renames reduce_scatter_tensor; older releases have only the old name
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor

WORLD = Communication()
#: this rank alone: a world of one, whatever the process group
SELF = Communication(size=1, rank=0)

__default_comm = WORLD


def get_comm() -> Communication:
    """The current default communication."""
    return __default_comm


def sanitize_comm(comm: Optional[Communication]) -> Communication:
    """Validate ``comm`` or return the default."""
    if comm is None:
        return get_comm()
    if not isinstance(comm, Communication):
        raise TypeError(f"Unknown communication, must be instance of Communication, got {type(comm)}")
    return comm


def use_comm(comm: Optional[Communication] = None) -> None:
    """Set the default communication."""
    global __default_comm
    __default_comm = sanitize_comm(comm)


# ----------------------------------------------------------------------
# the process-group bootstrap (heat_tpu/parallel/comm.py:735-860): call
# ``init`` before any array work on more than one rank
# ----------------------------------------------------------------------
_initialized = False

#: bumped whenever init()/finalize() (may have) changed the process
#: group, as the reference's device-inventory epoch
_EPOCH = 0

#: the environment variables a launcher (torchrun, a batch script) sets for
#: ``init_method="env://"``: with all three present a cluster is detected
_ENV_RENDEZVOUS = ("MASTER_ADDR", "WORLD_SIZE", "RANK")


def _detected_cluster() -> bool:
    """Whether the launcher's environment names a cluster to join: all of
    :data:`_ENV_RENDEZVOUS` set.  Raises where it names one only in part (a
    rendezvous variable missing, or an ``srun`` step of several tasks with
    none of them), rather than leave every process a world of one."""
    missing = [k for k in _ENV_RENDEZVOUS if k not in os.environ]
    if not missing:
        return True
    tasks = os.environ.get("SLURM_STEP_NUM_TASKS", "1")
    if len(missing) < len(_ENV_RENDEZVOUS) or (tasks.isdigit() and int(tasks) > 1):
        raise RuntimeError(f"init(): the launcher's environment names a cluster but not {', '.join(missing)}; "
                           "set them, or pass the rendezvous to init()")
    return False


def comm_epoch() -> int:
    """The process group's epoch: bumped by every :func:`init` that joins
    a group and every :func:`finalize`."""
    return _EPOCH


def _backend() -> str:
    return "nccl" if torch.cuda.is_available() else "gloo"


def init(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids=None,
    **kwargs,
) -> None:
    """Join the process group: every rank runs the same program, and after
    ``init`` the default WORLD communication spans every rank.

    The explicit form gives the rendezvous (``coordinator_address`` as
    ``host:port`` or a ``tcp://`` / ``file://`` URL), the world size and
    this rank; ``local_device_ids`` picks this rank's card; other keyword
    arguments (``backend``, ``timeout``) go to
    ``torch.distributed.init_process_group``.  With no arguments a cluster
    is detected from the launcher's environment (``MASTER_ADDR``,
    ``WORLD_SIZE``, ``RANK``); on a single host with none of that, or with
    a group already joined, ``init`` is a no-op, as the reference's is.  An
    environment that names a cluster only in part raises.

    The bootstrap runs under the init retry policy
    (``resilience.default_init_policy``: bounded exponential backoff,
    ``HEAT_TPU_INIT_RETRY_*``) behind the ``comm.init`` fault site: a
    rendezvous that comes up after its workers is retried.  A detected
    cluster that cannot be reached fails loudly once the policy gives
    up; it never falls back to a world of one rank."""
    from ..resilience.faults import inject
    from ..resilience.retry import default_init_policy

    global _initialized
    explicit = not (coordinator_address is None and num_processes is None and process_id is None
                    and local_device_ids is None and not kwargs)
    if dist.is_initialized() or (not explicit and not _detected_cluster()):
        _initialized = True  # nothing to detect, or already joined: a no-op
        return
    if local_device_ids is not None:
        ids = [local_device_ids] if isinstance(local_device_ids, int) else list(local_device_ids)
        torch.cuda.set_device(int(ids[0]))
    options = dict(kwargs)
    options.setdefault("backend", _backend())
    if explicit:
        url = coordinator_address
        if url is not None and "://" not in url:
            url = f"tcp://{url}"
        options.update(init_method=url or "env://", world_size=num_processes if num_processes is not None else -1,
                       rank=process_id if process_id is not None else -1)
    else:
        options["init_method"] = "env://"

    def _bootstrap() -> None:
        inject("comm.init")
        dist.init_process_group(**options)

    default_init_policy().call(_bootstrap)
    _initialized = True
    _reset_defaults()


def is_initialized() -> bool:
    """Whether :func:`init` has run (``MPI.Is_initialized``'s analogue)."""
    return _initialized


def finalize() -> None:
    """Leave the process group (``MPI_Finalize``'s analogue): destroys it
    where one was joined, bumps the epoch and resets the default
    communication; safe for repeated ``finalize()`` + ``init()`` cycles."""
    global _initialized
    if dist.is_initialized():
        dist.destroy_process_group()
    _initialized = False
    _reset_defaults()


def _reset_defaults() -> None:
    """After the process group (may have) changed: a new epoch, WORLD the
    default communication again."""
    global __default_comm, _EPOCH
    _EPOCH += 1
    __default_comm = WORLD
    _clear_dispatch_cache()


def _clear_dispatch_cache() -> None:
    """Drop the dispatch keys: they name devices and shapes of the
    previous process group (the reference drops its compiled executables
    here)."""
    from ..core import dispatch

    dispatch.clear_cache()


def _as_bytes(x: torch.Tensor) -> torch.Tensor:
    """``x`` as bytes, one more trailing axis for each element's bytes (the
    other axes keep their extents), so that any dtype, bool, bfloat16 and
    complex included, travels through every backend's collectives."""
    shape = tuple(x.shape) + (x.element_size(),)
    if x.numel() == 0:
        return torch.empty(shape, dtype=torch.uint8, device=x.device)
    return _flat(x).view(torch.uint8).reshape(shape)


def _from_bytes(b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Undo :func:`_as_bytes`."""
    if b.numel() == 0:
        return torch.empty(tuple(b.shape[:-1]), dtype=dtype, device=b.device)
    return _flat(b).view(dtype).reshape(tuple(b.shape[:-1]))


def _flat(x: torch.Tensor) -> torch.Tensor:
    """``x``'s elements as a 1-D tensor of stride 1 (a view where ``x`` is
    contiguous: torch may keep any stride on an axis of length 1)."""
    x = x.contiguous()
    return x.as_strided((x.numel(),), (1,))
