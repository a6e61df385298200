"""flexflow_tpu_torch.nn_compat — the torch.nn-style frontend, the port of
``flexflow_tpu/torch`` (reference ``python/flexflow/torch``), renamed so
that it never reads as torch itself.  ``from flexflow_tpu_torch.nn_compat
import nn`` then ``class Net(nn.Module)``."""

from . import nn

__all__ = ["nn"]
