"""Serving events: one ``logging`` record per event on the
``flexflow_tpu_torch.serve`` logger, the port's stand-in for the JAX
package's ``fflogger`` event stream until the tooling slice ports it.

Each record's message is ``<name> <json fields>`` and the record carries
``ff_event`` (the name) and ``ff_fields`` (the dict), so a handler or a
test reads them without parsing text."""

from __future__ import annotations

import json
import logging

LOGGER = logging.getLogger("flexflow_tpu_torch.serve")


def event(name: str, level: int = logging.INFO, **fields) -> None:
    """Emit one event ``name`` with ``fields`` at ``level``."""
    if LOGGER.isEnabledFor(level):
        LOGGER.log(level, "%s %s", name,
                   json.dumps(fields, default=str, sort_keys=True),
                   extra={"ff_event": name, "ff_fields": dict(fields)})


__all__ = ["LOGGER", "event"]
