"""The cases of the port's reshard, elastic and sharded-generation tests
(``tests/test_torch_reshard.py``, ``test_torch_elastic.py``,
``test_torch_generation_mesh.py``): models, data and strategies shared
by the test process (the JAX package and the port's one-device runs)
and by the ranks (``tests/_torch_a8b_worker.py``,
``tests/_torch_elastic_worker.py``).  It imports neither package: each
function takes the package module it builds with.
"""

from __future__ import annotations

import importlib

import numpy as np

# tests/test_reshard.py's model: 8 features, a 32-wide ReLU layer, 4
# classes, batch 16, SGD with momentum 0.9
BS, NFEAT, NCLS = 16, 8, 4
# the channel-split strategy the reshard cases carry across meshes
DEGREES = {"dense": (2, 2), "dense_1": (2, 2)}
# source mesh -> target meshes of the same four ranks
SOURCE = {"n": 2, "c": 2}
TARGETS = {"n4": {"n": 4}, "c4": {"c": 4}, "n2p2": {"n": 2, "p": 2}}
PRE, POST = 2, 3


def strategies(pkg, degrees=DEGREES) -> dict:
    return {name: pkg.ParallelConfig(
        dims=tuple(d), device_ids=tuple(range(int(np.prod(d)))))
        for name, d in degrees.items()}


def mlp(pkg, mesh=None, degrees=DEGREES, momentum=0.9, **model_kw):
    """The reshard model, compiled on ``mesh`` (the package's mesh or
    None) and initialised from seed 0."""
    cfg = pkg.FFConfig(batch_size=BS, compute_dtype="float32")
    cfg.strategies = strategies(pkg, degrees)
    m = pkg.FFModel(cfg, mesh=mesh, **model_kw)
    x = m.create_tensor((BS, NFEAT), name="x")
    t = m.dense(x, 32, activation="relu")
    t = m.dense(t, NCLS)
    m.compile(pkg.SGDOptimizer(lr=0.1, momentum=momentum),
              "sparse_categorical_crossentropy", [], final_tensor=t)
    m.init_layers(seed=0)
    return m


def batch(step: int):
    """The batch of step ``step``: a resharded run and its fixed-mesh
    reference replay the same data."""
    rng = np.random.default_rng(1000 + step)
    return (rng.standard_normal((BS, NFEAT)).astype(np.float32),
            rng.integers(0, NCLS, (BS, 1)).astype(np.int32))


def train(m, steps: int) -> list:
    return [float(m.train_batch(*batch(m._step))) for _ in range(steps)]


def weights(model) -> dict:
    return {p.name: np.asarray(model.get_weights(p.name), np.float32)
            for p in model.parameters}


# ----------------------------------------------------------------------
# sharded generation: tests/test_generation.py's LM and strategy
# ----------------------------------------------------------------------
VOCAB, SEQ = 61, 32
LM = dict(num_layers=2, d_model=32, num_heads=2, d_ff=64, seq_len=SEQ,
          vocab_size=VOCAB)
TP_OPS = ("attention_0", "attention_1", "ffn_up_0", "ffn_up_1",
          "ffn_down_0", "ffn_down_1", "tok_embedding")
GEN_MESH = {"n": 2, "c": 2}
SLOTS = 4


def build_lm(pkg, seed: int = 0, **model_kw):
    """The LM of ``pkg``, uncompiled (float32, the config's seed)."""
    cfg = pkg.FFConfig(batch_size=4, compute_dtype="float32", seed=seed)
    build = importlib.import_module(
        pkg.__name__ + ".models.transformer").build_transformer_lm
    return build(cfg, **LM, **model_kw)[0]


def write_tp_strategy(pkg, path: str) -> None:
    """The JAX test's tensor-parallel strategy: (2, 1, 2) for the
    attention, FFN and token-embedding ops."""
    proto = importlib.import_module(pkg.__name__ + ".strategy.proto")
    proto.save_strategy_file(str(path), {
        name: pkg.ParallelConfig(device_type=pkg.DeviceType.DEVICE,
                                 dims=(2, 1, 2), device_ids=(0, 1, 2, 3))
        for name in TP_OPS})


def prompts(count: int = 6) -> list:
    rng = np.random.default_rng(3)
    return [rng.integers(1, VOCAB, int(rng.integers(2, 9)))
            .astype(np.int32) for _ in range(count)]
