"""Bindings of the benchmark's model families to the program: how to build
and drive each family through flexflow_tpu_torch's normal path."""
