"""The multi-process runtime on ``torch.distributed``: the counterpart of
``flexflow_tpu/parallel/distributed.py``.

The JAX package runs one process per host, each holding every device of
that host, and XLA routes the collectives.  The port runs one process
per device, a *rank*: ``torchrun --nproc-per-node=N train.py`` (or any
launcher that sets ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
``MASTER_PORT``), or explicit arguments.  Every rank runs the same
script; a :class:`~flexflow_tpu_torch.parallel.mesh.MachineMesh` then
spans the ranks, and the mesh product equals the world size.

The backend is an explicit choice.  It defaults to ``nccl`` when the
ranks' device is CUDA and to ``gloo`` on the CPU.  NCCL refuses two
ranks on one GPU, so ranks that share a card raise here unless the
caller names a backend that takes them, ``"cpu:gloo,cuda:gloo"``; the
runtime never switches backend by itself.  Rank ``r``'s device is
``cuda:{local_rank % device_count()}``.

Under gloo on CUDA tensors the runtime runs DTensor's collectives
itself, through c10d on the device tensors, and counts them
(``collectives``).  Gloo runs every collective on CUDA tensors but the
point to point exchange (torch 2.11: "writev ... Bad address"), so the
ring attention's shift (:func:`ring_shift`) and the pipeline's hops
between stages (:func:`stage_shift`) are staged through pinned host
memory.  Nothing of an op's compute leaves the device.

The pipeline's and the experts' collectives run over one mesh axis's
line (:class:`AxisGroup`, ``MachineMesh.axis_group``) as
``autograd.Function``s, each with the backward its use needs: the
stages' hop and its reverse, the last stage's output to every rank of
the line (its cotangent handed back once), and the sum, gather and copy
whose gradients either sum over the line or stay the rank's own.
"""

from __future__ import annotations

import os
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

# the runtime's own settings, kept beside torch.distributed's process
# group (itself process-global): the local rank and the ranks' device type
_RUNTIME: Dict[str, object] = {"local_rank": 0, "device_type": None}

# the functional collectives (the ops DTensor's redistribute runs) that
# the runtime runs itself under gloo on CUDA tensors, each counted in
# ``collectives`` (:func:`_count_collectives`)
FUNCTIONAL_COLLECTIVES: Tuple[str, ...] = (
    "all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
    "all_to_all_single", "broadcast")

# the collectives run under gloo, by name: {"calls": n, "bytes": b (this
# rank's input bytes), "host": staged through host memory};
# ``ring_shift`` counts there too
collectives: Dict[str, Dict[str, object]] = {}


def default_backend(device_type: str) -> str:
    """``nccl`` for ranks on CUDA devices, ``gloo`` on the CPU."""
    return "nccl" if device_type == "cuda" else "gloo"


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def _uses_nccl(backend: str, device_type: str) -> bool:
    """Does ``backend`` (``"nccl"`` or a ``"cpu:gloo,cuda:nccl"``
    mapping) run the ranks' CUDA tensors on NCCL?"""
    b = backend.lower()
    if ":" not in b:
        return b == "nccl"
    pairs = dict(p.split(":", 1) for p in b.split(","))
    return pairs.get(device_type) == "nccl"


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           backend: Optional[str] = None,
                           device_type: Optional[str] = None,
                           local_rank: Optional[int] = None,
                           local_world_size: Optional[int] = None) -> bool:
    """Bring up the process group.  Arguments default to torchrun's
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT`` as
    ``env://``).  ``device_type`` is the ranks' device, ``"cuda"`` by
    default (raises where there is none) or ``"cpu"``; ``backend``
    defaults to :func:`default_backend` of it.  Returns True when a
    process group came up, False for the single-process no-op (no
    world size and no init method anywhere).

    Raises ValueError when several ranks are asked for and nothing says
    how to reach the others, and RuntimeError when ranks that share a
    CUDA device would run NCCL, which refuses that."""
    if dist.is_initialized():
        return True
    world_size = world_size if world_size is not None else _env_int(
        "WORLD_SIZE")
    rank = rank if rank is not None else _env_int("RANK")
    if init_method is None and os.environ.get("MASTER_ADDR") \
            and os.environ.get("MASTER_PORT"):
        init_method = "env://"
    if init_method is None and world_size is None:
        return False
    world_size = 1 if world_size is None else int(world_size)
    rank = 0 if rank is None else int(rank)
    if init_method is None:
        raise ValueError(
            f"{world_size} ranks requested but no rendezvous is "
            f"configured: set MASTER_ADDR and MASTER_PORT (torchrun does) "
            f"or pass init_method ('tcp://host:port' or 'file://path')")
    if device_type is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "flexflow_tpu_torch ranks run on CUDA devices and none is "
                "available; pass device_type='cpu' to run them on the CPU")
        device_type = "cuda"
    backend = backend or default_backend(device_type)
    if local_rank is None:
        local_rank = _env_int("LOCAL_RANK")
    local_rank = rank if local_rank is None else int(local_rank)
    if local_world_size is None:
        local_world_size = _env_int("LOCAL_WORLD_SIZE")
    local_world_size = (world_size if local_world_size is None
                        else int(local_world_size))
    if device_type == "cuda":
        count = torch.cuda.device_count()
        if count < 1:
            raise RuntimeError("device_type='cuda' but no CUDA device is "
                               "visible")
        if _uses_nccl(backend, "cuda") and local_world_size > count:
            raise RuntimeError(
                f"{local_world_size} ranks on this host share {count} CUDA "
                f"device(s), and NCCL refuses two ranks on one GPU; pass "
                f"backend='cpu:gloo,cuda:gloo' to run them on one card")
        torch.cuda.set_device(local_rank % count)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    _RUNTIME["local_rank"] = local_rank
    _RUNTIME["device_type"] = device_type
    if device_type == "cuda" and not _uses_nccl(backend, "cuda"):
        _count_collectives()
    return True


def _count_collectives(key: str = "CUDA") -> None:
    """Under gloo, run each functional collective on CUDA tensors here,
    through c10d on the device tensors, counted in ``collectives``.
    Registered for the dispatch key ``key`` (the CPU tests register the
    same functions for ``"CPU"``), once per process."""
    if _RUNTIME.get("collective_lib") is not None:
        return
    lib = torch.library.Library("_c10d_functional", "IMPL")
    for name in FUNCTIONAL_COLLECTIVES:
        lib.impl(name, _collective(name), key)
    _RUNTIME["collective_lib"] = lib   # the registrations live with it


_REDUCE = {"sum": "SUM", "avg": "SUM", "max": "MAX", "min": "MIN",
           "product": "PRODUCT"}


def _collective(name: str):
    """The kernel of ``_c10d_functional.<name>``: the same result through
    the c10d call on this rank's tensors."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    def impl(tensor, *args):
        group = _resolve_process_group(args[-1])
        t = tensor.contiguous()
        if name == "all_reduce":
            out = t.clone()
            dist.all_reduce(out, getattr(dist.ReduceOp, _REDUCE[args[0]]),
                            group=group)
            if args[0] == "avg":
                out /= dist.get_world_size(group)
        elif name == "broadcast":
            out = t.clone()
            dist.broadcast(out, args[0], group=group)
        elif name == "all_gather_into_tensor":
            out = t.new_empty((args[0] * t.shape[0],) + tuple(t.shape[1:]))
            dist.all_gather_into_tensor(out, t, group=group)
        elif name == "reduce_scatter_tensor":
            out = t.new_empty((t.shape[0] // args[1],) + tuple(t.shape[1:]))
            dist.reduce_scatter_tensor(
                out, t, getattr(dist.ReduceOp, _REDUCE[args[0]]),
                group=group)
            if args[0] == "avg":
                out /= args[1]
        else:   # all_to_all_single(input, out_splits, in_splits, group)
            rows = sum(args[0]) if args[0] else t.shape[0]
            out = t.new_empty((rows,) + tuple(t.shape[1:]))
            dist.all_to_all_single(out, t, args[0] or None, args[1] or None,
                                   group=group)
        _count(name, t.numel() * t.element_size(), False)
        return out

    return impl


def rank_device(device_type: Optional[str] = None) -> torch.device:
    """This rank's device: ``cuda:{local_rank % device_count()}``, or the
    CPU when ``device_type`` (default: the runtime's, else ``"cuda"``)
    is ``"cpu"``.  Raises when CUDA is asked for and absent."""
    device_type = device_type or _RUNTIME["device_type"] or "cuda"
    if device_type == "cpu":
        return torch.device("cpu")
    if device_type != "cuda":
        raise ValueError(f"unsupported device type {device_type!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "flexflow_tpu_torch runs on a CUDA device and none is "
            "available; pass device='cpu' explicitly to run on the CPU")
    return torch.device(
        "cuda", int(_RUNTIME["local_rank"]) % torch.cuda.device_count())


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def coordination_barrier(name: str = "ff_barrier") -> None:
    """Every rank waits here for the others (single-process no-op).
    ``name`` labels the call site for a reader of a hang's traceback;
    torch's barrier is anonymous."""
    del name
    if world_size() > 1:
        dist.barrier()


def finalize_distributed() -> None:
    """Tear the process group down after a barrier, so no rank leaves
    while another still sends to it (single-process no-op)."""
    if not dist.is_initialized():
        return
    dist.barrier()
    dist.destroy_process_group()


def process_info() -> dict:
    if not dist.is_initialized():
        return {"process_index": 0, "process_count": 1, "local_devices": 1,
                "global_devices": 1, "backend": None}
    return {"process_index": dist.get_rank(),
            "process_count": dist.get_world_size(),
            "local_devices": 1,
            "global_devices": dist.get_world_size(),
            "backend": str(dist.get_backend())}


def _count(name: str, nbytes: int, host: bool) -> None:
    c = collectives.setdefault(name, {"calls": 0, "bytes": 0, "host": host})
    c["calls"] += 1
    c["bytes"] += int(nbytes)


def _exchange(sends, recvs):
    """One round of point to point messages: ``sends`` is a list of
    (tensor, global rank), ``recvs`` a list of (template tensor, global
    rank); returns the received tensors, shaped and typed as their
    templates, on the templates' device.  Gloo takes no point to point
    exchange of CUDA tensors, so there each message is staged through
    pinned host memory; returns (received, staged)."""
    first = (sends or recvs)[0][0]
    staged = (first.device.type == "cuda"
              and not _uses_nccl(str(dist.get_backend()), "cuda"))
    ops, bufs = [], []
    for t, peer in sends:
        t = t.contiguous()
        ops.append(dist.P2POp(dist.isend,
                              t.to("cpu").pin_memory() if staged else t,
                              peer))
    for like, peer in recvs:
        buf = (torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
               if staged else torch.empty_like(like))
        bufs.append(buf)
        ops.append(dist.P2POp(dist.irecv, buf, peer))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if staged:
        bufs = [b.to(like.device, non_blocking=True)
                for b, (like, _) in zip(bufs, recvs)]
    return bufs, staged


def ring_shift(tensors, send_to: int, recv_from: int):
    """Send each of ``tensors`` to global rank ``send_to`` and return the
    tensors of the same shapes received from ``recv_from``: one step of
    a ring.  Under NCCL, or on CPU tensors, the exchange runs on the
    tensors themselves; gloo takes no point to point exchange of CUDA
    tensors, so there each tensor is staged through pinned host memory
    (counted in ``collectives["ring_shift"]``)."""
    tensors = [t.contiguous() for t in tensors]
    recvs, staged = _exchange([(t, send_to) for t in tensors],
                              [(t, recv_from) for t in tensors])
    _count("ring_shift", sum(t.numel() * t.element_size()
                             for t in tensors), staged)
    return recvs


# ----------------------------------------------------------------------
# collectives over one mesh axis, with their gradients
# ----------------------------------------------------------------------
class AxisGroup(NamedTuple):
    """This rank's line along one mesh axis: the process group of the
    line, its global ranks in the axis's order (sub-axes major to
    minor, the order of ``MachineMesh.axis_ring``) and this rank's
    place in it."""
    group: object
    ranks: Tuple[int, ...]
    index: int

    @property
    def size(self) -> int:
        return len(self.ranks)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _StageShift(torch.autograd.Function):
    """One tick's activation hop between pipeline stages: send ``y`` to
    ``send_to`` and receive an activation like ``like`` from
    ``recv_from`` (either may be None).  The backward runs the hop in
    reverse: the gradient of what was received goes back to its sender,
    and the gradient of what was sent comes from its receiver.

    ``token`` chains the hops of one rank (each hop returns the next
    token), so that every hop's backward runs on every rank that took
    part, in the reverse of the forward's order, even where its rank
    only sent (its received output is unused) or only received (its
    sent input is None): the first token is cut from a parameter, so
    the chain reaches the leaves autograd is asked for, and the last
    feeds the stages' output collective."""

    @staticmethod
    def forward(ctx, y, token, send_to, recv_from, like):
        ctx.send_to, ctx.recv_from = send_to, recv_from
        ctx.like = (tuple(like.shape), like.dtype, like.device)
        sends = [(y, send_to)] if send_to is not None else []
        recvs = [(like, recv_from)] if recv_from is not None else []
        got, staged = _exchange(sends, recvs)
        _count("stage_shift", _nbytes(y) if sends else 0, staged)
        recv = got[0] if recvs else like.new_empty(0)
        return recv, token.new_empty(0)

    @staticmethod
    def backward(ctx, g_recv, g_token):
        shape, dtype, device = ctx.like
        sends = [(g_recv, ctx.recv_from)] if ctx.recv_from is not None \
            else []
        like = torch.empty(shape, dtype=dtype, device=device)
        recvs = [(like, ctx.send_to)] if ctx.send_to is not None else []
        g_y = None
        if sends or recvs:
            got, staged = _exchange(sends, recvs)
            _count("stage_shift", _nbytes(g_recv) if sends else 0, staged)
            g_y = got[0] if recvs else None
        return g_y, g_token.new_zeros(0), None, None, None


def stage_shift(y: Optional[torch.Tensor], token: torch.Tensor,
                send_to: Optional[int], recv_from: Optional[int],
                like: torch.Tensor):
    """Send the stage output ``y`` to global rank ``send_to`` and receive
    an activation shaped as ``like`` from ``recv_from`` (None for no
    message either way): the open chain s -> s+1 of the GPipe schedule,
    or with the last rank sending to the first the closed ring of the
    interleaved one.  Returns (received or None, next token); see
    :class:`_StageShift` for the token.  Under gloo on CUDA tensors the
    message is staged through pinned host memory, counted in
    ``collectives["stage_shift"]``."""
    recv, token = _StageShift.apply(y, token, send_to, recv_from, like)
    return (recv if recv_from is not None else None), token


class _LastStageToAll(torch.autograd.Function):
    """The last pipeline stage's outputs to every rank of the line: the
    sum over the line of ``out`` masked to the last rank (the JAX
    package's ``psum`` of the masked output).  Downstream of the
    pipeline every rank holds the same loss, so every rank receives the
    same cotangent of the result; the backward hands it to the last
    stage once (summing it over the line would scale every stage's
    gradient by the line's size)."""

    @staticmethod
    def forward(ctx, out, token, group, is_last):
        ctx.is_last = is_last
        res = out.clone() if is_last else torch.zeros_like(out)
        dist.all_reduce(res, group=group)
        _count("all_reduce", _nbytes(res), False)
        return res

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.is_last else None), g.new_zeros(0), None, None


def last_stage_to_all(out: torch.Tensor, token: torch.Tensor,
                      line: AxisGroup) -> torch.Tensor:
    """``out`` of the line's last rank on every rank of ``line``
    (:class:`_LastStageToAll`); the other ranks pass a tensor of the
    same shape, whose values are not read."""
    return _LastStageToAll.apply(out, token, line.group,
                                 line.index == line.size - 1)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, grad_sum):
        ctx.group, ctx.grad_sum = group, grad_sum
        out = x.clone()
        dist.all_reduce(out, group=group)
        _count("all_reduce", _nbytes(out), False)
        return out

    @staticmethod
    def backward(ctx, g):
        if not ctx.grad_sum:
            return g, None, None
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        _count("all_reduce", _nbytes(g), False)
        return g, None, None


def all_reduce(x: torch.Tensor, line: AxisGroup,
               grad: str = "sum") -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``line``, on every one of them.
    ``grad`` says how the ranks use the sum: ``"sum"`` where each uses
    it for its own share of the work (its rows), so the cotangents are
    partial and their sum is the gradient (an all-reduce again);
    ``"same"`` where every rank computes the same thing from it (a
    replicated loss term), so each rank's cotangent is already the
    gradient."""
    return _AllReduce.apply(x, line.group, grad == "sum")


class _CopyToLine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        _count("all_reduce", _nbytes(g), False)
        return g, None


def copy_to_line(x: torch.Tensor, line: AxisGroup) -> torch.Tensor:
    """``x`` as it is, where every rank of ``line`` holds the same ``x``
    and each uses it for a share of the work (its experts): the forward
    moves nothing and the backward sums the partial gradients over the
    line."""
    return _CopyToLine.apply(x, line.group)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, index, grad_sum):
        ctx.group, ctx.size, ctx.index = group, size, index
        ctx.grad_sum = grad_sum
        x = x.contiguous()
        out = x.new_empty((size * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=group)
        _count("all_gather_into_tensor", _nbytes(x), False)
        return out

    @staticmethod
    def backward(ctx, g):
        if not ctx.grad_sum:
            return g.chunk(ctx.size)[ctx.index].contiguous(), None, None, \
                None, None
        g = g.contiguous()
        out = g.new_empty((g.shape[0] // ctx.size,) + tuple(g.shape[1:]))
        dist.reduce_scatter_tensor(out, g, group=ctx.group)
        _count("reduce_scatter_tensor", _nbytes(g), False)
        return out, None, None, None, None


def all_gather(x: torch.Tensor, line: AxisGroup,
               grad: str = "sum") -> torch.Tensor:
    """The ranks' ``x`` of ``line`` concatenated along dim 0, in the
    line's order, on every rank.  ``grad`` as in :func:`all_reduce`:
    ``"sum"`` where each rank uses its own part of the result (the
    backward is a reduce-scatter), ``"own"`` where every rank computes
    the same thing from all of it (the backward takes this rank's
    part)."""
    return _AllGather.apply(x, line.group, line.size, line.index,
                            grad == "sum")


def gather_counts(x: torch.Tensor, line: AxisGroup) -> torch.Tensor:
    """Every rank's ``x`` of ``line`` stacked on a new leading dim, in the
    line's order (no gradient)."""
    with torch.no_grad():
        out = all_gather(x, line)
    return out.reshape((line.size,) + tuple(x.shape))
