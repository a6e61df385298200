"""The encoder classifier through the program's normal training path:
``models.transformer.build_transformer``, ``FFModel.compile`` with Adam,
sparse cross-entropy and accuracy (as ``examples/apps/transformer.py``
trains it), ``init_layers``, then the benchmark's weights through
``set_weights``.  The configuration's keys are Hugging Face's BERT
names."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from portbench.traffic import derive
from portbench.weights import Spec


def geometry(cfg: Dict) -> Dict:
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    return {"layers": cfg["num_hidden_layers"], "d_model": d, "heads": h,
            "head_dim": d // h, "d_ff": cfg["intermediate_size"],
            "vocab": cfg["vocab_size"], "classes": cfg["num_labels"],
            "eps": cfg["layer_norm_eps"]}


def weight_spec(cfg: Dict, seq_len: int) -> Spec:
    """Every leaf as the program names it.  Matrices and embeddings are
    normal at the configuration's ``initializer_range``; biases too, and
    LayerNorm scales about 1, so no term of the block is zero.  The
    position table holds the cell's ``seq_len`` rows (the program sizes
    it to the sequence)."""
    g, std = geometry(cfg), cfg["initializer_range"]
    d, f = g["d_model"], g["d_ff"]
    spec = [("tok_embedding/table", (g["vocab"], d), 0.0, std),
            ("pos_embedding/table", (seq_len, d), 0.0, std)]
    for i in range(g["layers"]):
        a = f"attention_{i}"
        spec += [(f"{a}/{k}", (d, d), 0.0, std)
                 for k in ("wq", "wk", "wv", "wo")]
        spec += [(f"{a}/bias", (d,), 0.0, std)]
        for ln in ("ln_attn", "ln_ffn"):
            spec += [(f"{ln}_{i}/scale", (d,), 1.0, std),
                     (f"{ln}_{i}/bias", (d,), 0.0, std)]
        spec += [(f"ffn_up_{i}/kernel", (f, d), 0.0, std),
                 (f"ffn_up_{i}/bias", (f,), 0.0, std),
                 (f"ffn_down_{i}/kernel", (d, f), 0.0, std),
                 (f"ffn_down_{i}/bias", (d,), 0.0, std)]
    spec += [("classifier/kernel", (g["classes"], d), 0.0, std),
             ("classifier/bias", (g["classes"],), 0.0, std)]
    return spec


def build(cfg: Dict, traffic: Dict, device):
    """The program's model for one training cell, compiled and
    initialised on ``device``."""
    import flexflow_tpu_torch as ft
    from flexflow_tpu_torch.models.transformer import build_transformer

    g = geometry(cfg)
    prec, opt = cfg["precision"], cfg["optimizer"]
    fcfg = ft.FFConfig(batch_size=traffic["batch"],
                       compute_dtype=prec["compute"],
                       param_dtype=prec["params"])
    model, _, out = build_transformer(
        fcfg, num_layers=g["layers"], d_model=g["d_model"],
        num_heads=g["heads"], d_ff=g["d_ff"], seq_len=traffic["seq_len"],
        vocab_size=g["vocab"], num_classes=g["classes"],
        dropout=cfg["hidden_dropout_prob"], device=device)
    model.compile(ft.AdamOptimizer(alpha=opt["lr"], beta1=opt["beta1"],
                                   beta2=opt["beta2"],
                                   epsilon=opt["epsilon"],
                                   weight_decay=opt["weight_decay"]),
                  ft.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                  [ft.METRICS_ACCURACY], final_tensor=out)
    model.init_layers(seed=0)
    return model


def batches(cfg: Dict, traffic: Dict, seed: int, device
            ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """``traffic["pool"]`` distinct batches of uniform token ids and
    labels, made on the device from the seed."""
    gen = torch.Generator(device=device).manual_seed(derive(seed, "batches"))
    n, s, pool = traffic["batch"], traffic["seq_len"], traffic["pool"]
    tok = torch.randint(0, cfg["vocab_size"], (pool, n, s), generator=gen,
                        device=device, dtype=torch.int32)
    lab = torch.randint(0, cfg["num_labels"], (pool, n, 1), generator=gen,
                        device=device, dtype=torch.int32)
    return list(zip(tok.unbind(0), lab.unbind(0)))


def first_gradient_norms(model) -> Dict[str, float]:
    """The gradient the optimizer got at its first step, by leaf, worked
    out from Adam's first moment after that step: ``m = (1 - b1) g``."""
    b1 = model.optimizer.beta1
    m = model._opt_state["m"]
    return {k: float(v.float().norm()) / (1.0 - b1) for k, v in m.items()}


def parameters(model) -> Dict[str, torch.Tensor]:
    """The program's parameter tensors, read in place."""
    return dict(model._params)
