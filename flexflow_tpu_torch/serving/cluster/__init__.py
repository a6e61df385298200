"""flexflow_tpu_torch.serving.cluster — disaggregated prefill/decode
serving, the port of ``flexflow_tpu/serving/cluster``.

* :class:`FleetRouter` — a front over role-tagged fleet hosts: requests
  route to the least-loaded prefill host, and at prefill completion the
  KV page chain migrates (``pages.export_pages``/``import_pages``) to a
  decode-role host, so decode engines dispatch nothing but decode steps;
* :func:`build_disagg` — one prefill-role and one decode-role fleet over
  one model's parameters, fronted by a router.
"""

from .bench import build_disagg
from .router import FleetRouter

__all__ = ["FleetRouter", "build_disagg"]
