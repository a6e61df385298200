"""The causal LM served through the program's normal generation path:
``models.transformer.build_transformer_lm``, ``FFModel.compile`` and
``init_layers``, the benchmark's weights through ``set_weights``, then
``GenerationEngine`` with the configuration's serving settings.  The
configuration's keys are Hugging Face's GPT-2 names."""

from __future__ import annotations

from typing import Dict

from portbench.weights import Spec


def geometry(cfg: Dict) -> Dict:
    d, h = cfg["n_embd"], cfg["n_head"]
    return {"layers": cfg["n_layer"], "d_model": d, "heads": h,
            "head_dim": d // h, "d_ff": cfg["n_inner"] or 4 * d,
            "vocab": cfg["vocab_size"], "max_seq": cfg["n_positions"],
            "eps": cfg["layer_norm_epsilon"]}


def weight_spec(cfg: Dict) -> Spec:
    """Every leaf as the program names it, normal at the
    configuration's ``initializer_range`` (LayerNorm scales about 1)."""
    g, std = geometry(cfg), cfg["initializer_range"]
    d, f = g["d_model"], g["d_ff"]
    spec = [("tok_embedding/table", (g["vocab"], d), 0.0, std),
            ("pos_embedding/table", (g["max_seq"], d), 0.0, std)]
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
    spec += [("lm_head/kernel", (g["vocab"], d), 0.0, std),
             ("lm_head/bias", (g["vocab"],), 0.0, std)]
    return spec


def build(cfg: Dict, device):
    import flexflow_tpu_torch as ft
    from flexflow_tpu_torch.models.transformer import build_transformer_lm

    g = geometry(cfg)
    prec = cfg["precision"]
    fcfg = ft.FFConfig(batch_size=1, compute_dtype=prec["compute"],
                       param_dtype=prec["params"])
    model, _, out = build_transformer_lm(
        fcfg, num_layers=g["layers"], d_model=g["d_model"],
        num_heads=g["heads"], d_ff=g["d_ff"], seq_len=g["max_seq"],
        vocab_size=g["vocab"], dropout=0.0, device=device)
    model.compile(final_tensor=out)
    model.init_layers(seed=0)
    return model


def engine(model, cfg: Dict, queue: int, window_s: float):
    """The configuration's generation engine over ``model``, its
    admission queue holding ``queue`` requests, its step records kept
    for ``window_s`` seconds.  Greedy, and no EOS: every request yields
    exactly its budget."""
    import flexflow_tpu_torch as ft

    s = cfg["serving"]
    return ft.GenerationEngine(
        model, slots=s["slots"], max_seq=s["max_seq"],
        page_size=s["page_size"], num_pages=s["num_pages"],
        prefill_chunk=s["prefill_chunk"], prefix_cache=s["prefix_cache"],
        eos_id=cfg["eos_token_id"], max_queue_requests=queue,
        metrics_window_s=window_s)
