"""The C API's functions as a running Python calls them: the library
loaded with ``ctypes.PyDLL`` (the interpreter lock held through each
call, and a Python exception the C layer left set raised at once), each
function's argument and return types declared from ``flexflow_tpu_c.h``.

The library embeds no interpreter of its own: in a running Python,
``flexflow_init`` imports this process's ``flexflow_tpu_torch``.
``transformer_block`` builds ``test_capi.c``'s transformer block through
these functions at any width.
"""

from __future__ import annotations

import ctypes
from ctypes import (POINTER, c_char_p, c_double, c_float, c_int, c_int64,
                    c_void_p)
from typing import Dict, Optional, Tuple

from .build import build_library

H = c_void_p   # every opaque handle
BUF = POINTER(c_void_p)

# flexflow_tpu_c.h's enums
FF_DT_FLOAT, FF_DT_INT32 = 0, 1
FF_AC_NONE, FF_AC_RELU, FF_AC_GELU = 0, 1, 4
FF_OPT_SGD, FF_OPT_ADAM = 0, 1
FF_LOSS_SPARSE_CCE = 0

# name -> (return type, argument types), in the header's order
SIGNATURES: Dict[str, Tuple] = {
    "flexflow_init": (c_int, []),
    "flexflow_finalize": (None, []),
    "flexflow_last_error": (c_char_p, []),
    "flexflow_config_create": (H, [c_int, POINTER(c_char_p)]),
    "flexflow_config_destroy": (None, [H]),
    "flexflow_config_get_batch_size": (c_int, [H]),
    "flexflow_config_get_epochs": (c_int, [H]),
    "flexflow_model_create": (H, [H]),
    "flexflow_model_destroy": (None, [H]),
    "flexflow_model_create_tensor": (H, [H, c_int, POINTER(c_int64), c_int,
                                         c_char_p]),
    "flexflow_tensor_destroy": (None, [H]),
    "flexflow_tensor_get_ndims": (c_int, [H]),
    "flexflow_tensor_get_dim": (c_int64, [H, c_int]),
    "flexflow_model_dense": (H, [H, H, c_int, c_int, c_int, c_char_p]),
    "flexflow_model_embedding": (H, [H, H, c_int, c_int, c_char_p,
                                     c_char_p]),
    "flexflow_model_softmax": (H, [H, H, c_char_p]),
    "flexflow_model_binary": (H, [H, c_char_p, H, H, c_char_p]),
    "flexflow_model_layer_norm": (H, [H, H, c_char_p]),
    "flexflow_model_reshape": (H, [H, H, c_int, POINTER(c_int64),
                                   c_char_p]),
    "flexflow_model_multihead_attention": (H, [H, H, H, H, c_int, c_int,
                                               c_float, c_int, c_int,
                                               c_char_p]),
    "flexflow_model_position_embedding": (H, [H, H, c_char_p]),
    "flexflow_model_lstm": (H, [H, H, c_int, H, H, POINTER(H), POINTER(H),
                                c_char_p]),
    "flexflow_sgd_optimizer_create": (H, [c_double, c_double, c_int,
                                          c_double]),
    "flexflow_adam_optimizer_create": (H, [c_double] * 5),
    "flexflow_optimizer_destroy": (None, [H]),
    "flexflow_model_compile": (c_int, [H, c_int, c_double, c_int, H]),
    "flexflow_model_compile_opt": (c_int, [H, H, c_int, H]),
    "flexflow_model_init_layers": (c_int, [H, c_int]),
    "flexflow_model_train_batch": (c_double, [H, c_int, BUF, c_void_p]),
    "flexflow_model_set_batch": (c_int, [H, c_int, BUF, c_void_p]),
    "flexflow_model_forward": (c_int, [H]),
    "flexflow_model_zero_gradients": (c_int, [H]),
    "flexflow_model_backward": (c_double, [H]),
    "flexflow_model_update": (c_int, [H]),
    "flexflow_model_get_weights": (c_int64, [H, c_char_p, POINTER(c_float),
                                             c_int64]),
    "flexflow_model_set_weights": (c_int, [H, c_char_p, POINTER(c_float),
                                           c_int64]),
    "flexflow_model_import_strategies": (c_int, [H, c_char_p]),
    "flexflow_model_export_strategies": (c_int, [H, c_char_p]),
    "flexflow_model_save_checkpoint": (c_int, [H, c_char_p]),
    "flexflow_model_load_checkpoint": (c_int, [H, c_char_p]),
}


def load(path: Optional[str] = None) -> ctypes.PyDLL:
    """The library (built on first use when ``path`` is None) with every
    function of :data:`SIGNATURES` declared."""
    lib = ctypes.PyDLL(path or build_library())
    for name, (restype, argtypes) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def last_error(lib) -> str:
    return lib.flexflow_last_error().decode()


def config(lib, *argv: str) -> int:
    """``flexflow_config_create`` over ``argv``; raises on NULL."""
    args = (c_char_p * len(argv))(*(a.encode() for a in argv))
    cfg = lib.flexflow_config_create(len(argv), args)
    if not cfg:
        raise RuntimeError(f"flexflow_config_create: {last_error(lib)}")
    return cfg


def dims(*shape: int):
    return (c_int64 * len(shape))(*shape)


def batch(*arrays) -> "ctypes.Array":
    """The ``const void**`` of host arrays (C-contiguous; the caller
    keeps them alive through the call)."""
    return (c_void_p * len(arrays))(*(a.ctypes.data for a in arrays))


def py_object(handle: int):
    """The Python object a handle owns (a handle is a struct whose one
    field is the ``PyObject*``)."""
    return ctypes.cast(handle, POINTER(ctypes.py_object))[0]


def check(lib, handle, what: str):
    """``handle``, or a RuntimeError with the C layer's error when it is
    NULL (the C functions dereference the handles they are given, so a
    NULL must stop the caller before the next call)."""
    if not handle:
        raise RuntimeError(f"{what}: {last_error(lib)}")
    return handle


def transformer_block(lib, cfg: int, batch_size: int, seq: int, d: int,
                      heads: int, ffn: int, vocab: int, classes: int):
    """``test_capi.c``'s transformer block through the C functions:
    token and position embeddings, causal self-attention, two residual
    LayerNorms around a gelu FFN, and a dense head over the flattened
    sequence.  Returns ``(model, logits)`` handles; the tensor handles
    of the layers between are released."""
    def ck(h, what):
        made.append(check(lib, h, what))
        return h

    made = []
    m = check(lib, lib.flexflow_model_create(cfg), "model")
    tok = ck(lib.flexflow_model_create_tensor(m, 2, dims(batch_size, seq),
                                              FF_DT_INT32, b"tokens"),
             "tokens")
    emb = ck(lib.flexflow_model_embedding(m, tok, vocab, d, b"none",
                                          b"tok_embed"), "tok_embed")
    pos = ck(lib.flexflow_model_position_embedding(m, emb, b"pos_embed"),
             "pos_embed")
    attn = ck(lib.flexflow_model_multihead_attention(
        m, pos, None, None, d, heads, 0.0, 1, 1, b"attn"), "attn")
    res1 = ck(lib.flexflow_model_binary(m, b"add", pos, attn, b"res1"),
              "res1")
    ln1 = ck(lib.flexflow_model_layer_norm(m, res1, b"ln1"), "ln1")
    up = ck(lib.flexflow_model_dense(m, ln1, ffn, FF_AC_GELU, 1,
                                     b"ffn_up"), "ffn_up")
    dn = ck(lib.flexflow_model_dense(m, up, d, FF_AC_NONE, 1, b"ffn_down"),
            "ffn_down")
    res2 = ck(lib.flexflow_model_binary(m, b"add", ln1, dn, b"res2"),
              "res2")
    ln2 = ck(lib.flexflow_model_layer_norm(m, res2, b"ln2"), "ln2")
    fl = ck(lib.flexflow_model_reshape(m, ln2, 2, dims(batch_size, seq * d),
                                       b"fl"), "fl")
    logits = check(lib, lib.flexflow_model_dense(m, fl, classes, FF_AC_NONE,
                                                 1, b"cls"), "cls")
    for t in made:
        lib.flexflow_tensor_destroy(t)
    return m, logits
