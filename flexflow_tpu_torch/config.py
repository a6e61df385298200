"""FFConfig / ParallelConfig — run configuration and the strategy atom.

The port's own copy of ``flexflow_tpu/config.py``: the same fields, the
same defaults and the same validation, so a configuration written for
the JAX package means the same thing here.  The worker unit is a CUDA
device (``workers_per_node``).  Fields that
drive machinery the port has not grown yet (strategy search,
multi-device meshes, generation serving, tracing) are kept so
configurations stay portable; ``FFModel.compile`` refuses the ones it
cannot honour.  The command-line
parser comes with the tooling slice.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Optional, Tuple


class DeviceType(enum.IntEnum):
    """strategy.proto's Op.DeviceType (GPU=0, CPU=1)."""

    DEVICE = 0
    HOST = 1

    GPU = 0
    CPU = 1
    TPU = 0


class MemoryType(enum.IntEnum):
    """strategy.proto Op.MemoryType: FBM (device memory) / ZCM (host)."""

    FBM = 0
    ZCM = 1


# per-op precision axis: "" follows FFConfig.compute_dtype, "bf16"/"f32"
# force the op (wire values in strategy.proto field 6: 0, 1, 2)
PRECISIONS = ("", "bf16", "f32")
PRECISION_DTYPES = {"bf16": "bfloat16", "f32": "float32"}
VALID_COMPUTE_DTYPES = ("bfloat16", "float32", "float16")
VALID_PARAM_DTYPES = ("float32", "bfloat16", "float64")


def dtype_short(dtype_name: str) -> str:
    """The short spelling of a dtype name in a precision tag
    ("bfloat16" -> "bf16")."""
    return {"bfloat16": "bf16", "float32": "f32",
            "float16": "f16"}.get(dtype_name, dtype_name)


def _validate_dtype_field(field: str, value: str, allowed) -> None:
    if value not in allowed:
        raise ValueError(
            f"FFConfig.{field} must be one of {', '.join(allowed)}, got "
            f"{value!r}")


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """The SOAP strategy atom: ``dims[i]`` is the partition degree of
    logical output dim ``i`` (sample dim first); ``device_ids`` the flat
    device coordinates owning each part."""

    device_type: DeviceType = DeviceType.DEVICE
    dims: Tuple[int, ...] = (1,)
    device_ids: Tuple[int, ...] = (0,)
    memory_types: Tuple[MemoryType, ...] = ()
    precision: str = ""

    def __post_init__(self):
        if self.precision not in PRECISIONS:
            raise ValueError(
                f"ParallelConfig.precision must be one of "
                f"{PRECISIONS}, got {self.precision!r}")

    @staticmethod
    def data_parallel(num_parts: int, ndims: int = 2) -> "ParallelConfig":
        """Partition only the sample (outermost) dim."""
        return ParallelConfig(device_type=DeviceType.DEVICE,
                              dims=(num_parts,) + (1,) * (ndims - 1),
                              device_ids=tuple(range(num_parts)))


@dataclasses.dataclass
class FFConfig:
    """Run configuration; field meanings as in ``flexflow_tpu.config``."""

    epochs: int = 1
    batch_size: int = 64
    learning_rate: float = 0.01
    weight_decay: float = 1e-4
    workers_per_node: int = 0
    cpus_per_node: int = 1
    num_nodes: int = 1
    profiling: bool = False
    print_frequency: int = 1
    search_budget: int = 0
    search_alpha: float = 0.05
    search_chains: int = 1
    search_overlap_backward_update: bool = False
    search_precision: bool = False
    search_mode: str = "mcmc"
    best_known_file: str = ""
    reshard_search_budget: Optional[int] = None
    import_strategy_file: str = ""
    export_strategy_file: str = ""
    dataset_path: str = ""
    seed: int = 0
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    mesh_shape: Optional[Dict[str, int]] = None
    simulator_mode: str = "analytic"
    calibration_file: str = ""
    cost_estimator: str = "auto"
    remat: bool = False
    # internal conv/pool layout: "nchw", "nhwc" (torch.channels_last
    # memory format under the logical NCHW shape) or "auto" (nhwc on a
    # CUDA device, nchw on the CPU — op.resolve_conv_layout)
    conv_layout: str = "auto"
    flash_attention: Optional[bool] = None
    trace_dir: str = ""
    trace_sample_rate: float = 0.0
    metrics_port: int = 0
    metrics_host: str = "127.0.0.1"
    gradient_accumulation_steps: int = 1
    steps_per_dispatch: int = 1
    pad_tail_batches: bool = False
    # serving engine knobs (serving/engine.py): largest packed batch
    # (0 = batch_size), coalescing deadline, bounded-queue admission,
    # priority aging and explicit shape buckets
    serve_max_batch: int = 0
    serve_max_wait_ms: float = 2.0
    serve_max_queue_rows: int = 0
    serve_admission: str = "block"
    serve_starvation_ms: float = 250.0
    serve_model_name: str = ""
    serve_quantize: str = ""
    serve_buckets: str = ""
    serve_gen_slots: int = 8
    serve_gen_max_seq: int = 0
    serve_gen_max_new_tokens: int = 32
    serve_kv_page: int = 16
    serve_kv_pages: int = 0
    serve_prefix_cache: str = "on"
    serve_prefill_chunk: int = 0
    serve_spec_gamma: int = 0
    serve_spec_gamma_max: int = 4
    serve_spec_policy: str = "fixed"
    sparse_embedding_updates: Optional[bool] = None

    strategies: Dict[str, ParallelConfig] = dataclasses.field(
        default_factory=dict)

    def __post_init__(self):
        _validate_dtype_field("compute_dtype", self.compute_dtype,
                              VALID_COMPUTE_DTYPES)
        _validate_dtype_field("param_dtype", self.param_dtype,
                              VALID_PARAM_DTYPES)
        if self.serve_quantize not in ("", "int8"):
            raise ValueError(
                f"FFConfig.serve_quantize must be '' or 'int8', got "
                f"{self.serve_quantize!r}")
        if self.serve_prefix_cache not in ("on", "off"):
            raise ValueError(
                f"FFConfig.serve_prefix_cache must be 'on' or 'off', "
                f"got {self.serve_prefix_cache!r}")
        if self.serve_kv_page < 1:
            raise ValueError(
                f"FFConfig.serve_kv_page must be >= 1, got "
                f"{self.serve_kv_page}")
        if self.serve_kv_pages < 0 or self.serve_prefill_chunk < 0:
            raise ValueError(
                f"FFConfig.serve_kv_pages/serve_prefill_chunk must be "
                f">= 0 (0 = auto/monolithic), got "
                f"{self.serve_kv_pages}/{self.serve_prefill_chunk}")
        if self.serve_spec_gamma != 0 and self.serve_spec_gamma < 2:
            raise ValueError(
                f"FFConfig.serve_spec_gamma must be 0 (off) or >= 2, "
                f"got {self.serve_spec_gamma}")
        if self.serve_spec_gamma_max < 2:
            raise ValueError(
                f"FFConfig.serve_spec_gamma_max must be >= 2, got "
                f"{self.serve_spec_gamma_max}")
        if self.serve_spec_policy not in ("fixed", "adaptive"):
            raise ValueError(
                f"FFConfig.serve_spec_policy must be 'fixed' or "
                f"'adaptive', got {self.serve_spec_policy!r}")

    @property
    def num_devices(self) -> int:
        return max(1, self.workers_per_node) * self.num_nodes

    def precision_policy(self) -> str:
        """Short tag of the run's precision policy: the compute dtype
        ("bf16", "f32", ...), then "+mixed(Bbf16/Ff32)" when per-op
        strategy overrides are set (B ops bf16, F ops f32), then
        "+int8w" under serving weight quantization."""
        short = dtype_short(self.compute_dtype)
        nb = sum(1 for pc in self.strategies.values()
                 if pc is not None and pc.precision == "bf16")
        nf = sum(1 for pc in self.strategies.values()
                 if pc is not None and pc.precision == "f32")
        if nb or nf:
            short += f"+mixed({nb}bf16/{nf}f32)"
        if self.serve_quantize:
            short += f"+{self.serve_quantize}w"
        return short
