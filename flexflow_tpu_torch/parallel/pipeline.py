"""Pipeline parallelism over the ``p`` mesh axis: the counterpart of
``flexflow_tpu/parallel/pipeline.py``.

Homogeneous stages hold their weights stacked on a leading stage dim,
split over ``p``; microbatches stream through ticks, activations hop
from stage to stage, and the last stage's outputs go to every rank of
the line.  Gradients come from autograd through the ticks, so the
update is synchronous GPipe: every microbatch's gradient accumulates
before the step.

Schedules (the JAX package's):

* ``"gpipe"``: tick t runs rank s's group of stages on microbatch
  ``t - s``; S + M - 1 ticks.
* ``"interleaved"``: each rank holds ``virtual_stages`` chunks (global
  stage t on rank ``t % S`` as its chunk ``t // S``) and runs one chunk a
  tick; an activation rides the ring with wrap-around, and rank 0
  injects a fresh microbatch whenever nothing arrives.  The tick count
  is :func:`_interleaved_ticks`'s.

The JAX loops carry integer tags (chunk, microbatch) around the ring
beside the activation.  They do not depend on the data, so here the
host derives every rank's unit at every tick from the same static
simulation (:func:`gpipe_schedule`, :func:`interleaved_schedule`) and
only the activation moves.  A rank with nothing to do at a tick (a
bubble) runs nothing: the JAX loops run their stages on zeros there and
mask the result, which changes no value.  The p == 1 path applies the
stages over the whole batch in the schedule's traversal order, so its
numbers are the pipelined run's.

One process is one rank: each runs :func:`pipeline_apply` on its own
stage block, and the hops are point to point messages between the
line's ranks (``parallel.distributed.stage_shift``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional

import torch

from . import distributed


def traversal_order(total_stages: int, S: int, schedule: str):
    """Storage-index visit order of the pipeline.  gpipe visits the stage
    dim in storage order; interleaved visits round-robin over ranks
    (traversal step t -> storage index (t % S) * v + t // S, i.e. rank
    t % S, local chunk t // S under contiguous p-sharding)."""
    if schedule != "interleaved" or S <= 1:
        return list(range(total_stages))
    v = total_stages // S
    return [(t % S) * v + t // S for t in range(total_stages)]


def _interleaved_ticks(S: int, M: int, v: int) -> int:
    """Exact tick count of the interleaved dataflow: the length of
    :func:`interleaved_schedule`'s simulation of the tag protocol."""
    return len(interleaved_schedule(S, M, v))


class Unit(NamedTuple):
    """What one rank does at one tick."""
    mb: int                 # the microbatch
    chunk: Optional[int]    # its local chunk; None: the rank's whole group
    inject: bool            # reads the microbatch (else last tick's hop)
    emit: bool              # its output is the pipeline's for ``mb``
    send: bool              # its output hops to the next rank


Schedule = List[List[Optional[Unit]]]   # [tick][rank]


def gpipe_schedule(S: int, M: int) -> Schedule:
    """Rank r at tick t runs its group on microbatch t - r, for
    r <= t < r + M; S + M - 1 ticks."""
    return [[Unit(t - r, None, r == 0, r == S - 1, r < S - 1)
             if 0 <= t - r < M else None for r in range(S)]
            for t in range(S + M - 1)]


def interleaved_schedule(S: int, M: int, v: int) -> Schedule:
    """The units of the interleaved dataflow, tick by tick (a static
    simulation of the JAX loop's tag protocol, with its priority rule):
    an arriving unit beats an injection at rank 0, rank S - 1 wraps a
    chunk other than the last to rank 0 as the next chunk, and the last
    chunk at rank S - 1 is the output."""
    arriving: list = [None] * S
    inj = done = 0
    ticks: Schedule = []
    while done < M:
        nxt: list = [None] * S
        row: List[Optional[Unit]] = [None] * S
        for r in range(S):
            unit, inject = arriving[r], False
            if r == 0 and unit is None and inj < M:
                unit, inject = (inj, 0), True
                inj += 1
            if unit is None:
                continue
            mb, c = unit
            emit = r == S - 1 and c == v - 1
            if emit:
                done += 1
            elif r == S - 1:
                nxt[0] = (mb, c + 1)
            else:
                nxt[r + 1] = (mb, c)
            row[r] = Unit(mb, c, inject, emit, not emit)
        arriving = nxt
        ticks.append(row)
    return ticks


def _normalized(stage_fn: Callable):
    """Stages may or may not emit an auxiliary loss."""
    def sfn(params, h):
        r = stage_fn(params, h)
        if isinstance(r, tuple):
            return r
        return r, torch.zeros((), dtype=torch.float32, device=h.device)
    return sfn


def _stage(stacked: Dict[str, torch.Tensor], i: int) -> dict:
    return {k: v[i] for k, v in stacked.items()}


def pipeline_apply(stage_fn: Callable, stacked: Dict[str, torch.Tensor],
                   x: torch.Tensor, num_stages: int,
                   line: Optional["distributed.AxisGroup"] = None,
                   num_microbatches: Optional[int] = None,
                   schedule: str = "gpipe",
                   virtual_stages: Optional[int] = None):
    """Run the stacked stages over ``x`` as a pipeline over ``line`` (this
    rank's ranks along ``p``; None or one rank for the p == 1 path).
    Returns ``(y, aux)``: aux is the sum of the stages' auxiliary
    losses (0 when ``stage_fn`` returns a bare tensor), per microbatch
    summed over the valid ticks and divided by M on the pipeline, as
    the JAX package scales it.

    ``stage_fn(params, h) -> y [or (y, aux)]`` with ``y.shape ==
    h.shape``; ``stacked`` maps names to this rank's block of the stage
    dim (all ``num_stages`` stages on the p == 1 path, num_stages / S on
    a line of S ranks, in storage order).  ``schedule`` is "gpipe" or
    "interleaved"; the latter needs ``virtual_stages``, the chunks a
    rank holds, which fixes the traversal order whatever the mesh."""
    assert schedule in ("gpipe", "interleaved"), schedule
    total_stages = int(num_stages)
    sfn = _normalized(stage_fn)
    if schedule == "interleaved":
        if not virtual_stages or total_stages % virtual_stages != 0:
            raise ValueError(
                f"interleaved schedule needs virtual_stages dividing "
                f"num_stages={total_stages}, got {virtual_stages}")
        S_eff = total_stages // virtual_stages  # required pipeline width
    S = 1 if line is None else line.size
    if S <= 1:
        # sequential: the same math in the schedule's traversal order
        order = traversal_order(total_stages,
                                S_eff if schedule == "interleaved" else 1,
                                schedule)
        h = x
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in order:
            h, a = sfn(_stage(stacked, i), h)
            aux = aux + a
        return h, aux
    if total_stages % S != 0:
        raise ValueError(
            f"num_stages={total_stages} must be a multiple of the mesh 'p' "
            f"axis size {S} (each rank runs a group of stages)")
    if schedule == "interleaved" and S != S_eff:
        raise ValueError(
            f"interleaved schedule with virtual_stages={virtual_stages} "
            f"needs mesh p == {S_eff}, got {S}")
    M = num_microbatches or S
    n = x.shape[0]
    if n % M:
        # the JAX loops assert this (``assert n_loc % M == 0``)
        raise AssertionError((n, M))
    v = total_stages // S
    ticks = (interleaved_schedule(S, M, v) if schedule == "interleaved"
             else gpipe_schedule(S, M))
    return _run_ticks(sfn, stacked, x, line, M, v, ticks)


def _run_ticks(sfn, stacked, x, line, M: int, v: int, ticks: Schedule):
    """This rank's part of ``ticks``: its units' stages, the hops to and
    from its neighbours on the line, then the last rank's outputs to
    every rank and the auxiliary loss summed over the line over M."""
    S, r = line.size, line.index
    xm = x.reshape((M, x.shape[0] // M) + tuple(x.shape[1:]))
    like = xm[0].detach()
    nxt, prv = line.ranks[(r + 1) % S], line.ranks[(r - 1) % S]
    # the hops' token starts at the parameters and at x (see
    # stage_shift): every rank's backward then reaches x, which only the
    # first stage reads, and hands on its (zero) share of x's gradient
    anchors = [t for t in (*stacked.values(), x) if t.requires_grad]
    token = (torch.cat([t.reshape(-1)[:0].float() for t in anchors])
             if anchors and torch.is_grad_enabled() else x.new_empty(0))
    outs: List[Optional[torch.Tensor]] = [None] * M
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    recv = None
    for row in ticks:
        u, y = row[r], None
        if u is not None:
            h = xm[u.mb] if u.inject else recv
            chunks = range(v) if u.chunk is None else (u.chunk,)
            for c in chunks:
                h, a = sfn(_stage(stacked, c), h)
                h = h.to(x.dtype)
                aux = aux + a
            y = h
            if u.emit:
                outs[u.mb] = y
        before = row[(r - 1) % S]
        receives = before is not None and before.send
        sends = u is not None and u.send
        recv = None
        if sends or receives:
            recv, token = distributed.stage_shift(
                y if sends else None, token, nxt if sends else None,
                prv if receives else None, like)
    out = (torch.stack(outs) if r == S - 1
           else torch.zeros_like(xm))
    y = distributed.last_stage_to_all(out, token, line)
    aux = distributed.all_reduce(aux, line, grad="same") / M
    return y.reshape(x.shape), aux
