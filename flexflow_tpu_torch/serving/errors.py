"""Typed serving failures, as ``flexflow_tpu/serving/errors.py`` defines
them for the dense engine.

All derive from :class:`ServingError`, so ``except ServingError``
catches exactly the engine's load-management failures; a dispatch bug
still surfaces as whatever it was.
"""

from __future__ import annotations


class ServingError(RuntimeError):
    """Base class for load-management failures of the serving engine."""


class OverloadError(ServingError):
    """Request refused at admission (full queue under ``reject``, or no
    room under ``shed_oldest``), or the engine is draining.  Raised
    synchronously from ``submit()``."""


class SheddedError(ServingError):
    """A queued request was evicted for newer work (``shed_oldest``) or
    failed by ``drain(timeout)`` as a straggler.  Delivered through the
    request's future."""


class DeadlineExceeded(ServingError):
    """The request's deadline passed while it was queued; it expired
    before packing, so no dispatch was spent on it.  Delivered through
    the request's future."""


class KVCacheExhausted(SheddedError):
    """The paged KV pool had no page left for a stream, even after
    evicting every unreferenced prefix-cache page, so that stream alone
    was shed.  Only an undersized ``serve_kv_pages`` reaches it: the
    auto pool holds every slot's longest stream."""


class GenerationCancelled(ServingError):
    """A generation stream was cancelled by its client while prefilling
    or decoding: its slot and pages were freed and only it failed;
    tokens already streamed stay valid."""
