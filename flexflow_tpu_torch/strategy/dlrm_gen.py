"""Offline DLRM strategy generators, the JAX package's
``strategy/dlrm_gen.py`` (after the reference's ``dlrm_strategy.cc`` and
``dlrm_strategy_hetero.cc``).  Both write the reference's wire format:

* :func:`generate_dlrm_strategy`: each ``embedding{i}`` table on device
  ``i % num_devices``, the dense layers and the loss data-parallel over
  all devices;
* :func:`generate_dlrm_hetero_strategy`: the tables on the HOST (device
  type CPU, ZCM memory), everything else data-parallel on the devices.

Run ``python -m flexflow_tpu_torch.strategy.dlrm_gen [--gpu N] [--node
N] [--cpu N] [--emb N] [--hetero]`` to write one to the working
directory.
"""

from __future__ import annotations

from typing import Dict

from ..config import DeviceType, MemoryType, ParallelConfig
from .proto import save_strategy_file

FBM = MemoryType.FBM
ZCM = MemoryType.ZCM


def generate_dlrm_strategy(gpus_per_node: int, num_nodes: int,
                           num_embeddings: int = 24,
                           num_mlp_layers: int = 6
                           ) -> Dict[str, ParallelConfig]:
    n = gpus_per_node * num_nodes
    out: Dict[str, ParallelConfig] = {}
    for i in range(num_embeddings):
        out[f"embedding{i}"] = ParallelConfig(
            device_type=DeviceType.DEVICE, dims=(1, 1),
            device_ids=(i % n,), memory_types=(FBM, FBM, FBM))
    out["concat"] = ParallelConfig(
        device_type=DeviceType.DEVICE, dims=(num_nodes, 1),
        device_ids=tuple(i * gpus_per_node for i in range(num_nodes)),
        memory_types=(FBM,))
    dp = ParallelConfig(device_type=DeviceType.DEVICE, dims=(n, 1),
                        device_ids=tuple(range(n)),
                        memory_types=(FBM, FBM, FBM))
    # per-layer names used by models/dlrm.py (the reference generator's
    # single "linear" entry relies on its shared-name fallback)
    out["linear"] = dp
    for prefix, count in (("bot", num_mlp_layers), ("top", num_mlp_layers)):
        for i in range(count):
            out[f"{prefix}_dense_{i}"] = dp
    out["mse_loss"] = ParallelConfig(
        device_type=DeviceType.DEVICE, dims=(n, 1),
        device_ids=tuple(range(n)), memory_types=(FBM,))
    out["interact"] = out["concat"]
    return out


def generate_dlrm_hetero_strategy(gpus: int = 1, cpus: int = 1,
                                  num_embeddings: int = 8,
                                  num_mlp_layers: int = 6
                                  ) -> Dict[str, ParallelConfig]:
    out: Dict[str, ParallelConfig] = {}
    for i in range(num_embeddings):
        out[f"embedding{i}"] = ParallelConfig(
            device_type=DeviceType.HOST, dims=(1, 1),
            device_ids=(i % cpus,), memory_types=(ZCM, ZCM, ZCM))
    dp = ParallelConfig(device_type=DeviceType.DEVICE, dims=(gpus, 1),
                        device_ids=tuple(range(gpus)))
    out["linear"] = dp
    for prefix, count in (("bot", num_mlp_layers), ("top", num_mlp_layers)):
        for i in range(count):
            out[f"{prefix}_dense_{i}"] = dp
    out["mse_loss"] = dp
    out["concat"] = dp
    out["interact"] = dp
    return out


def main(argv=None) -> None:
    """Command-line entry: the reference executables' --gpu/--node flags
    and output file names."""
    import sys

    argv = sys.argv[1:] if argv is None else argv
    gpus_per_node, num_nodes, hetero, cpus, nemb = 1, 1, False, 1, 24
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--gpu":
            i += 1
            gpus_per_node = int(argv[i])
        elif a == "--node":
            i += 1
            num_nodes = int(argv[i])
        elif a == "--cpu":
            i += 1
            cpus = int(argv[i])
        elif a == "--emb":
            i += 1
            nemb = int(argv[i])
        elif a == "--hetero":
            hetero = True
        i += 1
    if hetero:
        s = generate_dlrm_hetero_strategy(gpus_per_node, cpus, nemb)
        path = f"dlrm_strategy_{nemb}nEmb_{cpus}cpu_{gpus_per_node}gpu.pb"
    else:
        s = generate_dlrm_strategy(gpus_per_node, num_nodes, nemb)
        path = f"dlrm_strategy_gpu_{gpus_per_node}_node_{num_nodes}.pb"
    save_strategy_file(path, s)
    print(f"wrote {path} ({len(s)} ops)")


if __name__ == "__main__":
    main()
