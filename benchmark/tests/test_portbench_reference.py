"""The plain references hold the port to them at a tiny size on the CPU:
the encoder's training steps (embedding, attention, LayerNorm, Linear,
GELU, the loss and Adam) and the causal LM's forward, and the tokens the
generation engine serves through chunked prefill and the paged cache.
Both sides get the benchmark's weights and inputs; in float32 they agree
to rounding, in the configuration's bf16 to bf16's."""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

import conftest  # noqa: E402
from portbench import cell as cell_mod, check, train, weights  # noqa: E402


def _cell(root, name, compute="float32"):
    c = cell_mod.load(name, root)
    c.config["precision"] = dict(c.config["precision"], compute=compute)
    return c


def test_encoder_training_steps_equal_the_reference(tiny_copy):
    c = _cell(tiny_copy, conftest.TRAIN)
    _, _, prog = train.program_steps(c, 7, "cpu")
    ref = train.reference_steps(c, 7, "cpu")
    assert np.allclose(prog["losses"], ref["losses"], rtol=1e-5)
    nums = check.train_gaps(prog, ref)
    assert nums["loss_gap"] < 1e-5
    assert nums["grad_gap"] < 1e-4
    assert nums["change_gap"] < 1e-3


def test_encoder_bf16_steps_stay_near_the_float32_reference(tiny_copy):
    c = _cell(tiny_copy, conftest.TRAIN, "bfloat16")
    _, _, prog = train.program_steps(c, 7, "cpu")
    ref = train.reference_steps(c, 7, "cpu")
    nums = check.train_numbers(prog, ref,
                               train.reference_steps(c, 7, "cpu", "bf16"))
    # bf16 keeps 8 bits: the loss to a few parts in a thousand
    assert nums["loss_gap"] < 1e-2
    assert nums["grad_gap"] < 0.5
    # and the first step's gradient within a few times a plain bf16
    # computation's
    assert nums["grad_ratio"] < 10


def test_lm_forward_equals_the_reference(tiny_copy):
    c = _cell(tiny_copy, conftest.GEN)
    fam, geo = c.family, c.geometry
    model = fam.build(c.config, "cpu")
    w = weights.make(fam.weight_spec(c.config), 3, "cpu")
    weights.install(model, w)
    tokens = torch.randint(0, geo["vocab"], (1, geo["max_seq"]),
                           generator=torch.Generator().manual_seed(0),
                           dtype=torch.int32)
    got = torch.as_tensor(model.predict(tokens.numpy()))[0].float()
    ref = c.reference.logits(w, geo, tokens[0])
    assert torch.allclose(got, ref, atol=1e-5, rtol=1e-5)


def test_served_tokens_are_the_reference_argmax(tiny_copy):
    c = _cell(tiny_copy, conftest.GEN)
    fam, geo = c.family, c.geometry
    model = fam.build(c.config, "cpu")
    w = weights.make(fam.weight_spec(c.config), 5, "cpu")
    weights.install(model, w)
    rng = np.random.default_rng(1)
    # prompts across the chunk of 16, so prefill takes several chunks
    prompts = [rng.integers(0, geo["vocab"], n).astype(np.int32)
               for n in (3, 16, 17, 40)]
    with fam.engine(model, c.config, 8, 30.0) as eng:
        outs = [eng.submit(p, max_new_tokens=12) for p in prompts]
        outs = [s.result(timeout=120) for s in outs]
    for p, out in zip(prompts, outs):
        seq = torch.as_tensor(np.concatenate([p, out[:-1]]))
        lg = c.reference.logits(w, geo, seq)[len(p) - 1:]
        assert check.logit_gap(lg, torch.as_tensor(out)) < 1e-5
        assert out.tolist() == lg.argmax(-1).tolist()


@pytest.mark.parametrize("family", ["encoder_classifier", "causal_lm"])
def test_reference_imports_nothing_of_the_program(family):
    import subprocess
    code = ("import sys; sys.path.insert(0, %r); import reference.%s; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0].startswith('flexflow')))"
            % (os.path.dirname(HERE), family))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120).stdout
    assert out.strip() == "[]"
