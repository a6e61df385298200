"""The port's operators (counterparts of ``flexflow_tpu/ops``)."""
