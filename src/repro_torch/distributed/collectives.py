"""The collectives that the explicit-SPMD code runs over a mesh axis's
process group (``launch.mesh.Mesh.group``): the counterparts of the
reference's ``psum``, ``psum_scatter``, ``all_gather``, ``all_to_all``,
``ppermute`` and a broadcast.

NCCL takes CUDA tensors, and so does gloo for every collective here but
the point-to-point pair of ``ring_shift``: handed a CUDA tensor for
``send`` / ``recv``, gloo writes the device pointer to its socket and the
call raises ("writev ... Bad address", torch 2.11 on an H100;
``python -m repro_torch.launch.gloo_probe`` shows which calls gloo takes
on a card). So ``ring_shift`` copies a CUDA tensor to host memory on a
gloo group, runs the pair on the copy and copies the result back; every
other call hands its tensors over as they are, and gloo stages them
itself. That is the transport of ranks sharing one card
(``launch.mesh.backend_for``).

Five of them are also autograd functions. Two are the pair of tensor
parallelism over a group whose ranks all compute the same loss:
:func:`sum_forward` (an all-reduce forward, the gradient passed as it is)
ends a split product, and :func:`sum_backward` (the identity forward, the
gradient all-reduced) starts one. The third is FSDP's over the data axis,
whose ranks each compute their own shard's part of the loss:
:func:`gather_data` all-gathers a leaf's blocks forward and
reduce-scatters the float32 gradient back to the rank's block, which is
then the sum of every shard's gradient of it. The fourth,
:func:`inner_halves`, hands Mamba's ``in_proj`` output from the
contiguous column blocks that its spec gives the ranks of the model axis
to each rank's channels of both halves (``xb`` and ``z``), by one
``all_to_all`` of uneven splits, and its gradient back the same way.
The fifth, :func:`exchange_columns`, hands each rank the columns it
wants of a product whose column blocks the ranks hold (a q head that
straddles two ranks' blocks of ``wq``), also by one uneven
``all_to_all``. ``torch.distributed.nn.functional`` is not used: its
all-gather sums the gradient over the ranks, which counts a loss that
every rank computes the same way once a rank.
"""
from __future__ import annotations

import torch

__all__ = ["all_reduce", "all_reduce_max", "reduce_scatter", "all_gather",
           "all_to_all", "broadcast", "gather_to_first", "ring_shift",
           "sum_forward", "sum_backward", "gather_data", "inner_halves",
           "exchange_columns"]


def _dist():
    import torch.distributed as dist
    return dist


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over the group, in place; returns ``t``."""
    _dist().all_reduce(t, group=group)
    return t


def all_reduce_max(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum of ``t`` over the group, in place; returns
    ``t``."""
    dist = _dist()
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t


def reduce_scatter(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over the group; group rank i gets block i of its first
    dim (``psum_scatter(..., tiled=True)``)."""
    dist = _dist()
    n = dist.get_world_size(group)
    src = t.contiguous()
    out = src.new_empty((t.shape[0] // n, *t.shape[1:]))
    dist.reduce_scatter_tensor(out, src, group=group)
    return out


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors concatenated along ``dim``, group rank order
    (``all_gather(..., axis=dim, tiled=True)``)."""
    dist = _dist()
    n = dist.get_world_size(group)
    src = t.contiguous()
    out = src.new_empty((n * src.shape[0], *src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=group)
    dim %= t.dim()
    if dim == 0:
        return out
    return out.view(n, *src.shape).movedim(0, dim).flatten(dim, dim + 1)


def all_to_all(t: torch.Tensor, group, send=None, recv=None
               ) -> torch.Tensor:
    """Block j of ``t``'s first dim to group rank j; block j of the result
    from group rank j (``all_to_all(..., 0, 0, tiled=True)``). With
    ``send`` and ``recv`` (the rows to and from each group rank: ``send``
    adds up to ``t``'s first dim, ``recv`` to the result's) the blocks
    are those sizes, some of them empty."""
    src = t.contiguous()
    out = (torch.empty_like(src) if recv is None
           else src.new_empty((sum(recv), *src.shape[1:])))
    _dist().all_to_all_single(out, src, recv, send, group=group)
    return out


def broadcast(t: torch.Tensor, src_rank: int, group) -> torch.Tensor:
    """Group rank ``src_rank``'s ``t`` to every rank, in place."""
    dist = _dist()
    dist.broadcast(t, dist.get_global_rank(group, src_rank), group=group)
    return t


def gather_to_first(t: torch.Tensor, group) -> list:
    """Every group rank's ``t`` (same shape) on group rank 0, in group
    rank order, through host memory; an empty list on the others."""
    dist = _dist()
    src = t.detach().cpu().contiguous()
    first = dist.get_rank(group) == 0
    out = [torch.empty_like(src) for _ in range(
        dist.get_world_size(group))] if first else None
    dist.gather(src, out, dst=dist.get_global_rank(group, 0), group=group)
    return out if first else []


def ring_shift(t: torch.Tensor, group) -> torch.Tensor:
    """Each group rank's ``t`` to the next (the last's to the first);
    returns what the previous rank sent (``ppermute`` over the ring). One
    ``batch_isend_irecv`` pair, so no ring of blocking sends deadlocks; on
    a gloo group through host memory."""
    dist = _dist()
    n = dist.get_world_size(group)
    if n == 1:
        return t
    rank = dist.get_rank(group)
    staged = t.is_cuda and dist.get_backend(group) == "gloo"
    src = t.cpu() if staged else t.contiguous()
    out = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src,
                      dist.get_global_rank(group, (rank + 1) % n), group),
           dist.P2POp(dist.irecv, out,
                      dist.get_global_rank(group, (rank - 1) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out.to(t.device)


class _SumForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return all_reduce(t.clone(memory_format=torch.contiguous_format),
                          group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(memory_format=torch.contiguous_format),
                          ctx.group), None


def sum_forward(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over the group; the gradient passes back as it is.
    Where autograd records, the sum goes into a copy (never into a tensor
    the graph holds); else into ``t``'s own storage when contiguous."""
    if torch.is_grad_enabled() and t.requires_grad:
        return _SumForward.apply(t, group)
    return all_reduce(t.contiguous(), group)


def sum_backward(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` as it is; its gradient summed over the group."""
    if torch.is_grad_enabled() and t.requires_grad:
        return _SumBackward.apply(t, group)
    return t


class _GatherData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group, summed):
        ctx.dim, ctx.group, ctx.summed = dim, group, summed
        return all_gather(t, group, dim)

    @staticmethod
    def backward(ctx, g):
        if not ctx.summed:  # every rank's gradient is the same: its block
            n = g.shape[ctx.dim] // _dist().get_world_size(ctx.group)
            return (g.narrow(ctx.dim, _dist().get_rank(ctx.group) * n, n),
                    None, None, None)
        block = reduce_scatter(g.float().movedim(ctx.dim, 0), ctx.group)
        return block.movedim(0, ctx.dim), None, None, None


def gather_data(t: torch.Tensor, dim: int, group,
                summed: bool = True) -> torch.Tensor:
    """The group's blocks of a leaf concatenated along ``dim`` (FSDP's
    all-gather). Its gradient comes back as this rank's block: with
    ``summed`` (the group's ranks hold different shards of the batch)
    reduce-scattered in float32, the sum over the group (autograd casts
    it to ``t``'s type); without, as it is (every rank computed the same
    batch)."""
    if torch.is_grad_enabled() and t.requires_grad:
        return _GatherData.apply(t, dim % t.dim(), group, summed)
    return all_gather(t, group, dim)


def _halves_plan(n: int, r: int, w: int):
    """Group rank r of n holding columns [2rw, 2rw + 2w) of an (.., 2nw)
    product whose first nw columns are ``xb`` and the rest ``z``: the
    rows it sends to each rank (its two w-blocks, block b to rank b mod
    n), whether it sends them swapped (in rank order), and the rows it
    receives from each (``xb``'s block r from rank r // 2, then ``z``'s
    from rank (n + r) // 2)."""
    send, recv = [0] * n, [0] * n
    dests = [(2 * r) % n, (2 * r + 1) % n]
    for d in dests:
        send[d] += w
    recv[r // 2] += w
    recv[(n + r) // 2] += w
    return send, dests[0] > dests[1], recv


def _swap(t: torch.Tensor, w: int) -> torch.Tensor:
    return torch.cat([t[w:], t[:w]])


def _to_channels(xz: torch.Tensor, group) -> torch.Tensor:
    if xz.shape[-1] % 2:
        raise ValueError(
            f"a rank's in_proj block of {xz.shape[-1]} columns does not "
            f"split into its channels of xb and z: the model axis must "
            f"divide Mamba's inner width")
    dist = _dist()
    n, r = dist.get_world_size(group), dist.get_rank(group)
    w = xz.shape[-1] // 2
    send, swapped, recv = _halves_plan(n, r, w)
    t = xz.movedim(-1, 0)
    out = all_to_all(_swap(t, w) if swapped else t, group, send, recv)
    return out.movedim(0, -1)


class _InnerHalves(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xz, group):
        ctx.group = group
        return _to_channels(xz, group)

    @staticmethod
    def backward(ctx, g):
        dist = _dist()
        n, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        w = g.shape[-1] // 2
        send, swapped, recv = _halves_plan(n, r, w)
        out = all_to_all(g.movedim(-1, 0), ctx.group, recv, send)
        return (_swap(out, w) if swapped else out).movedim(0, -1), None


def inner_halves(xz: torch.Tensor, group) -> torch.Tensor:
    """A rank's block of ``x @ in_proj`` (its 2w contiguous columns of
    the 2·di, as ``param_specs`` splits the leaf over the model axis) ->
    ``[xb | z]`` of its w = di/n channels: channels rw .. rw + w - 1 of
    both halves. One ``all_to_all`` whose every rank sends its two
    blocks and receives two (an all-gather and a slice would move n/2
    times the bytes); the gradient goes back by the inverse one. An odd
    block raises ValueError."""
    if torch.is_grad_enabled() and xz.requires_grad:
        return _InnerHalves.apply(xz, group)
    return _to_channels(xz, group)


def _overlap(x, y):
    """The overlap [lo, hi) of two ranges [lo, hi); (0, 0) where none."""
    lo, hi = max(x[0], y[0]), min(x[1], y[1])
    return (lo, hi) if lo < hi else (0, 0)


def _columns_plan(held, wanted, r: int):
    """Group rank r of ``held`` / ``wanted`` (each rank's [lo, hi) of the
    columns): the part of its block that each rank wants, as [lo, hi)
    within its block ((0, 0) where none), and the columns it receives
    from each rank."""
    lo = held[r][0]
    parts = []
    for want in wanted:
        a, b = _overlap(held[r], want)
        parts.append((a - lo, b - lo) if b else (0, 0))
    recv = [b - a for a, b in (_overlap(h, wanted[r]) for h in held)]
    return parts, recv


def _exchange(t: torch.Tensor, group, held, wanted) -> torch.Tensor:
    r = _dist().get_rank(group)
    parts, recv = _columns_plan(held, wanted, r)
    src = t.movedim(-1, 0)
    send = torch.cat([src[a:b] for a, b in parts])
    out = all_to_all(send, group, [b - a for a, b in parts], recv)
    return out.movedim(0, -1).contiguous()  # P1 reads rows of whole heads


class _Columns(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, held, wanted):
        ctx.group, ctx.held, ctx.wanted = group, held, wanted
        return _exchange(t, group, held, wanted)

    @staticmethod
    def backward(ctx, g):
        r = _dist().get_rank(ctx.group)
        parts, recv = _columns_plan(ctx.held, ctx.wanted, r)
        sizes = [b - a for a, b in parts]
        got = all_to_all(g.movedim(-1, 0), ctx.group, recv, sizes)
        lo, hi = ctx.held[r]
        out = got.new_zeros((hi - lo, *got.shape[1:]))
        for (a, b), piece in zip(parts, got.split(sizes)):
            out[a:b] += piece  # a column two ranks read: both gradients
        return out.movedim(0, -1), None, None, None


def exchange_columns(t: torch.Tensor, group, held, wanted) -> torch.Tensor:
    """A rank's block of columns (the last dim of ``t``: ``held[r]``,
    [lo, hi) of a product whose columns the group's ranks hold in
    contiguous blocks) -> the columns ``wanted[r]``, which may reach into
    the blocks of other ranks, and which ranks may want at once. One
    ``all_to_all`` of uneven splits moves to each rank only the columns
    it lacks (and its own to itself); the gradient comes back by the
    inverse one, and a column that several ranks read gets the sum of
    their gradients."""
    if torch.is_grad_enabled() and t.requires_grad:
        return _Columns.apply(t, group, held, wanted)
    return _exchange(t, group, held, wanted)
