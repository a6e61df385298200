"""FFConfig / ParallelConfig — run configuration and the strategy atom.

The port's own copy of ``flexflow_tpu/config.py``: the same fields, the
same defaults and the same validation, so a configuration written for
the JAX package means the same thing here.  The worker unit is a CUDA
device (``workers_per_node``, ``-ll:gpu``).  Fields that drive
machinery the port has not grown yet (tracing) are kept so
configurations stay portable; ``FFModel.compile`` refuses the ones it
cannot honour.  ``FFConfig.parse_args`` reads the reference's flag set,
the JAX package's parser flag for flag.

The process-wide defaults live here too: the config the script runner
(``cli.py``) parsed, and the device it was told to run on
(:func:`set_default_config`, :func:`get_default_config`,
:func:`set_default_device`, :func:`get_default_device`).
"""

from __future__ import annotations

import dataclasses
import enum
import os
from typing import Dict, List, Optional, Sequence, Tuple


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

    @property
    def num_parts(self) -> int:
        n = 1
        for d in self.dims:
            n *= d
        return n

    def with_dims(self, dims: Sequence[int]) -> "ParallelConfig":
        """The same placement with degrees ``dims`` over devices
        ``0..prod(dims)-1``."""
        nparts = 1
        for d in dims:
            nparts *= d
        return ParallelConfig(
            device_type=self.device_type,
            dims=tuple(int(d) for d in dims),
            device_ids=tuple(range(nparts)),
            memory_types=self.memory_types,
            precision=self.precision,
        )

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

    @staticmethod
    def parse_args(argv: Optional[List[str]] = None) -> "FFConfig":
        """CLI parser with the reference's flag set (model.cc:1221-1289),
        the JAX package's flags in its order and with its errors:
        ``-e/--epochs -b/--batch-size --lr/--learning-rate
        --wd/--weight-decay -p/--print-freq -d/--dataset --budget --alpha
        -s/--export -import/--import -ll:gpu -ll:cpu --nodes --profiling
        --overlap`` and the search, precision, serving and observability
        flags after them.  ``-ll:gpu`` counts CUDA devices a node;
        ``-ll:tpu`` is its alias, as ``-ll:gpu`` is the JAX package's.
        Unknown flags pass through."""
        import sys

        if argv is None:
            argv = sys.argv[1:]
        cfg = FFConfig()
        i = 0
        while i < len(argv):
            a = argv[i]

            def val() -> str:
                nonlocal i
                i += 1
                return argv[i]

            if a in ("-e", "--epochs"):
                cfg.epochs = int(val())
            elif a in ("-b", "--batch-size"):
                cfg.batch_size = int(val())
            elif a in ("--lr", "--learning-rate"):
                cfg.learning_rate = float(val())
            elif a in ("--wd", "--weight-decay"):
                cfg.weight_decay = float(val())
            elif a in ("-p", "--print-freq"):
                cfg.print_frequency = max(1, int(val()))
            elif a in ("-d", "--dataset"):
                cfg.dataset_path = val()
            elif a == "--budget":
                cfg.search_budget = int(val())
            elif a == "--alpha":
                cfg.search_alpha = float(val())
            elif a == "--chains":
                cfg.search_chains = max(1, int(val()))
            elif a == "--search-precision":
                cfg.search_precision = True
            elif a == "--search-mode":
                mode = val().lower()
                if mode not in ("mcmc", "hybrid"):
                    raise ValueError(
                        f"--search-mode {mode!r}: want 'mcmc' or 'hybrid'")
                cfg.search_mode = mode
            elif a == "--best-known":
                cfg.best_known_file = val()
            elif a == "--reshard-budget":
                cfg.reshard_search_budget = int(val())
            elif a == "--calibration":
                cfg.calibration_file = val()
            elif a == "--cost-estimator":
                cfg.cost_estimator = val().lower()
            elif a == "--overlap":
                cfg.search_overlap_backward_update = True
            elif a in ("-s", "--export"):
                cfg.export_strategy_file = val()
            elif a in ("-import", "--import"):
                cfg.import_strategy_file = val()
            elif a in ("-ll:gpu", "-ll:tpu"):
                cfg.workers_per_node = int(val())
            elif a == "-ll:cpu":
                cfg.cpus_per_node = int(val())
            elif a == "--nodes":
                cfg.num_nodes = int(val())
            elif a == "--profiling":
                cfg.profiling = True
            elif a == "--seed":
                cfg.seed = int(val())
            elif a == "--remat":
                cfg.remat = True
            elif a == "--conv-layout":
                cfg.conv_layout = val().lower()
            elif a == "--accum-steps":
                cfg.gradient_accumulation_steps = int(val())
            elif a == "--steps-per-dispatch":
                cfg.steps_per_dispatch = int(val())
            elif a == "--pad-tail":
                cfg.pad_tail_batches = True
            elif a == "--serve-max-batch":
                cfg.serve_max_batch = int(val())
            elif a == "--serve-max-wait-ms":
                cfg.serve_max_wait_ms = float(val())
            elif a == "--serve-buckets":
                cfg.serve_buckets = val()
            elif a == "--serve-quantize":
                cfg.serve_quantize = val().lower()
                if cfg.serve_quantize not in ("", "int8"):
                    raise ValueError(
                        f"--serve-quantize must be '' or 'int8', got "
                        f"{cfg.serve_quantize!r}")
            elif a == "--compute-dtype":
                cfg.compute_dtype = val().lower()
                _validate_dtype_field("compute_dtype", cfg.compute_dtype,
                                      VALID_COMPUTE_DTYPES)
            elif a == "--param-dtype":
                cfg.param_dtype = val().lower()
                _validate_dtype_field("param_dtype", cfg.param_dtype,
                                      VALID_PARAM_DTYPES)
            elif a == "--serve-model-name":
                cfg.serve_model_name = val()
            elif a == "--serve-max-queue-rows":
                cfg.serve_max_queue_rows = int(val())
            elif a == "--serve-admission":
                cfg.serve_admission = val().lower()
            elif a == "--serve-starvation-ms":
                cfg.serve_starvation_ms = float(val())
            elif a == "--serve-gen-slots":
                cfg.serve_gen_slots = int(val())
            elif a == "--serve-gen-max-seq":
                cfg.serve_gen_max_seq = int(val())
            elif a == "--serve-gen-max-new":
                cfg.serve_gen_max_new_tokens = int(val())
            elif a == "--serve-kv-page":
                cfg.serve_kv_page = int(val())
            elif a == "--serve-kv-pages":
                cfg.serve_kv_pages = int(val())
            elif a == "--serve-prefix-cache":
                cfg.serve_prefix_cache = val().lower()
                if cfg.serve_prefix_cache not in ("on", "off"):
                    raise ValueError(
                        f"--serve-prefix-cache must be 'on' or 'off', "
                        f"got {cfg.serve_prefix_cache!r}")
            elif a == "--serve-prefill-chunk":
                cfg.serve_prefill_chunk = int(val())
            elif a == "--serve-spec-gamma":
                cfg.serve_spec_gamma = int(val())
            elif a == "--serve-spec-gamma-max":
                cfg.serve_spec_gamma_max = int(val())
            elif a == "--serve-spec-policy":
                cfg.serve_spec_policy = val().lower()
                if cfg.serve_spec_policy not in ("fixed", "adaptive"):
                    raise ValueError(
                        f"--serve-spec-policy must be 'fixed' or "
                        f"'adaptive', got {cfg.serve_spec_policy!r}")
            elif a == "--trace-sample-rate":
                cfg.trace_sample_rate = float(val())
            elif a == "--metrics-port":
                cfg.metrics_port = int(val())
            elif a == "--metrics-host":
                cfg.metrics_host = val()
            # unknown flags pass through (the reference forwards Legion's)
            i += 1
        return cfg


# the process-wide defaults the script runner installs (cli.py)
_default_config: Optional[FFConfig] = None
_default_device: Optional[str] = None


def set_default_config(cfg: Optional[FFConfig]) -> None:
    """Install the process-wide default FFConfig (None removes it):
    ``FFModel()``, keras ``compile`` and ``nn_compat.Module`` without a
    config read it.  The ``flexflow-tpu-torch`` runner installs the one
    it parsed."""
    global _default_config
    _default_config = cfg


def get_default_config() -> FFConfig:
    """A fresh copy per call — models must not share mutable strategy
    state (compile() writes searched strategies into its config)."""
    import copy
    if _default_config is None:
        return FFConfig()
    return copy.deepcopy(_default_config)


def set_default_device(device: Optional[str]) -> None:
    """Install the device entry points run on when the caller names
    none (``"cuda"`` or ``"cpu"``; None removes it, and the card is the
    default again).  The runner's ``--device`` sets it."""
    global _default_device
    if device is not None and str(device) not in ("cuda", "cpu"):
        raise ValueError(f"default device must be 'cuda' or 'cpu', got "
                         f"{device!r}")
    _default_device = None if device is None else str(device)


def get_default_device() -> Optional[str]:
    """The installed default device, or None (the card)."""
    return _default_device


# FLEXFLOW_PLATFORM's values (the JAX package's backend switch,
# flexflow_tpu/__init__.py) and the device each names
PLATFORMS = {"cpu": "cpu", "cuda": "cuda", "gpu": "cuda"}


def platform_device() -> Optional[str]:
    """The device the ``FLEXFLOW_PLATFORM`` environment variable names,
    or None where it is unset or empty.  The package installs it as the
    default device at import; a C host, which has no device argument,
    asks for the CPU so.  Raises ImportError on any other value."""
    name = os.environ.get("FLEXFLOW_PLATFORM")
    if not name:
        return None
    if name not in PLATFORMS:
        raise ImportError(f"FLEXFLOW_PLATFORM={name!r}: flexflow_tpu_torch "
                          f"runs on 'cpu' or 'cuda' (also 'gpu')")
    return PLATFORMS[name]
