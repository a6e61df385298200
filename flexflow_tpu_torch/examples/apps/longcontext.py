"""Long-context transformer via ring-attention sequence parallelism: the
sequence dim shards over the `s` mesh axis and K/V blocks rotate around
the ICI ring (ops/attention.py ring_attention), so context length scales
with the mesh — the capability the reference's NMT timestep-chunking
gestures at (SURVEY §5 long-context) without delivering.

Run (8-way sequence parallel, 2048 tokens):
    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        flexflow-tpu longcontext.py -b 4 -e 1 -ll:tpu 8
Flash attention kicks in automatically at s >= 1024 on TPU (BASELINE.md).
"""

import numpy as np

import flexflow_tpu as ff
from flexflow_tpu.models.transformer import build_transformer

SEQ = 2048
VOCAB = 32000


def top_level_task():
    cfg = ff.get_default_config()
    from flexflow_tpu.parallel.distributed import world_size
    # -ll:tpu unset (workers_per_node 0) means all visible devices
    # (model.py mesh inference convention)
    ndev = (cfg.num_devices if cfg.workers_per_node
            else world_size())
    model, tokens, logits = build_transformer(
        cfg, num_layers=2, d_model=256, num_heads=8, d_ff=1024,
        seq_len=SEQ, vocab_size=VOCAB, num_classes=2, causal=True)
    mesh = ff.MachineMesh({"s": ndev}) if ndev > 1 else None
    model.compile(ff.AdamOptimizer(alpha=1e-4),
                  ff.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                  [ff.METRICS_ACCURACY], final_tensor=logits, mesh=mesh)
    model.init_layers(seed=cfg.seed)
    if mesh is not None:
        print(f"ring attention over s={ndev}, seq_len {SEQ}")
    else:
        print(f"single device: dense/flash attention, seq_len {SEQ}")
    n = cfg.batch_size * 2
    rng = np.random.default_rng(cfg.seed)
    x = rng.integers(0, VOCAB, (n, SEQ)).astype(np.int32)
    y = rng.integers(0, 2, (n, 1)).astype(np.int32)
    model.fit(x, y, epochs=cfg.epochs)


if __name__ == "__main__":
    top_level_task()
