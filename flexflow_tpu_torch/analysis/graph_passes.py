"""Static graph checks over an FFModel layer list, the JAX package's
``analysis/graph_passes.py``.

The builders construct shapes eagerly, so these passes re-derive: each
op's recorded output is recomputed from its inputs where the op type has
a closed-form rule, and structural invariants (unique names,
reachability, parameter ownership) are checked over the whole graph.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

from ..op import Op, OpType
from ..tensor import Tensor
from .diagnostics import Diagnostic, Severity, make

# Ops whose output shape equals their (first) input shape.
_SHAPE_PRESERVING = {
    OpType.SOFTMAX, OpType.DROPOUT, OpType.BATCHNORM, OpType.LAYERNORM,
    OpType.RMSNORM, OpType.ELEMENT_UNARY, OpType.ELEMENT_BINARY,
}

# Ops whose output only reorganizes the input values (volume preserved).
_VOLUME_PRESERVING = {OpType.RESHAPE, OpType.TRANSPOSE, OpType.FLAT}

# Prediction-head op types that are legitimately outside the loss cone
# when the loss reads logits (the reference's fused softmax-CE contract,
# model.py compile): dead-op findings on these demote to INFO.
_HEAD_OPS = {OpType.SOFTMAX, OpType.MSELOSS}


def _reinfer_shape(op: Op) -> Optional[List[Diagnostic]]:
    """Closed-form shape re-inference for op types with a structural rule;
    None when the type has no rule (checked elsewhere or op-specific)."""
    if not op.outputs or not op.inputs:
        return None
    out = op.outputs[0]
    ins = op.inputs
    diags: List[Diagnostic] = []
    if op.op_type in _SHAPE_PRESERVING:
        want = ins[0].shape
        if op.op_type == OpType.ELEMENT_BINARY and len(ins) == 2 \
                and ins[0].shape != ins[1].shape:
            diags.append(make(
                "FF001", op.name,
                f"element-binary inputs disagree: {ins[0].shape} vs "
                f"{ins[1].shape}",
                hint="elementwise ops need equal input shapes"))
        if tuple(out.shape) != tuple(want):
            diags.append(make(
                "FF001", op.name,
                f"recorded output {out.shape} != re-inferred {want} "
                f"(shape-preserving {op.op_type.value})"))
        return diags
    if op.op_type in _VOLUME_PRESERVING:
        if out.volume != ins[0].volume:
            diags.append(make(
                "FF001", op.name,
                f"output {out.shape} (volume {out.volume}) does not "
                f"conserve input volume {ins[0].volume} "
                f"({op.op_type.value})"))
        return diags
    if op.op_type == OpType.CONCAT:
        axis = getattr(op, "axis", None)
        if axis is None or not all(t.num_dims == out.num_dims for t in ins):
            return diags
        axis %= out.num_dims
        want = list(ins[0].shape)
        want[axis] = sum(t.shape[axis] for t in ins)
        for i in range(out.num_dims):
            if i != axis and any(t.shape[i] != want[i] for t in ins):
                diags.append(make(
                    "FF001", op.name,
                    f"concat inputs disagree on non-concat dim {i}: "
                    f"{[t.shape for t in ins]}"))
                return diags
        if tuple(out.shape) != tuple(want):
            diags.append(make(
                "FF001", op.name,
                f"recorded output {out.shape} != re-inferred "
                f"{tuple(want)} (concat over axis {axis})"))
        return diags
    if op.op_type == OpType.SPLIT:
        axis = getattr(op, "axis", None)
        if axis is None:
            return diags
        axis %= ins[0].num_dims
        got = sum(t.shape[axis] for t in op.outputs)
        if got != ins[0].shape[axis]:
            diags.append(make(
                "FF001", op.name,
                f"split outputs cover {got} of input extent "
                f"{ins[0].shape[axis]} on axis {axis}"))
        return diags
    if op.op_type == OpType.LINEAR:
        if tuple(out.shape[:-1]) != tuple(ins[0].shape[:-1]):
            diags.append(make(
                "FF001", op.name,
                f"linear must preserve leading dims: input "
                f"{ins[0].shape} -> output {out.shape}"))
        return diags
    return None


def _dtype_checks(op: Op) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    if op.op_type == OpType.EMBEDDING and op.inputs:
        # only table-lookup embeddings take id inputs; PositionEmbedding
        # (same op_type) consumes float activations
        from ..ops.linear import Embedding
        if isinstance(op, Embedding) \
                and not op.inputs[0].dtype.startswith("int"):
            diags.append(make(
                "FF002", op.name,
                f"embedding ids must be integer, got "
                f"{op.inputs[0].dtype!r}",
                hint="feed an int32 id tensor"))
    if op.op_type == OpType.ELEMENT_BINARY and len(op.inputs) == 2:
        a, b = op.inputs
        if a.dtype != b.dtype:
            diags.append(make(
                "FF002", op.name,
                f"element-binary inputs disagree on dtype: "
                f"{a.dtype!r} vs {b.dtype!r}"))
    return diags


def graph_diagnostics(layers: List[Op],
                      input_tensors: Iterable[Tensor] = (),
                      final_tensors: Iterable[Tensor] = (),
                      parameters: Iterable = ()) -> List[Diagnostic]:
    """All graph passes: duplicate names, shape/dtype re-inference,
    dangling inputs, dead ops (outside the final tensor's producer cone),
    unused parameters.  ``final_tensors`` defaults to the last layer's
    outputs (the FFModel.compile default)."""
    diags: List[Diagnostic] = []
    if not layers:
        return diags

    # FF003 — duplicate op names: strategies, checkpoints and the measure
    # cache all key by name, so a duplicate silently merges two ops.
    seen: Dict[str, int] = {}
    for op in layers:
        seen[op.name] = seen.get(op.name, 0) + 1
    for name, n in seen.items():
        if n > 1:
            diags.append(make(
                "FF003", name,
                f"{n} ops share the name {name!r}; strategies and "
                f"checkpoints key by name and would collide",
                hint="pass a unique name= to the builder"))

    # FF001 / FF002 — re-inference.
    for op in layers:
        r = _reinfer_shape(op)
        if r:
            diags.extend(r)
        diags.extend(_dtype_checks(op))

    # consumer map
    consumed = set()
    for op in layers:
        for t in op.inputs:
            consumed.add(t.uid)

    # FF004 — model inputs nothing reads (fit() still requires an array
    # for every declared input, positionally).
    for t in input_tensors:
        if t.uid not in consumed:
            diags.append(make(
                "FF004", t.name,
                f"input tensor {t.name!r} {t.shape} is never consumed "
                f"by any op (fit() still expects an array for it)",
                hint="drop the create_tensor or wire it into the graph"))

    # FF005 — dead ops: not in the producer cone of the final tensor(s).
    roots = list(final_tensors) or list(layers[-1].outputs)
    by_uid = {t.uid: op for op in layers for t in op.outputs}
    live = set()
    stack = [t.uid for t in roots]
    while stack:
        uid = stack.pop()
        op = by_uid.get(uid)
        if op is None or op.name in live:
            continue
        live.add(op.name)
        stack.extend(t.uid for t in op.inputs)
    for op in layers:
        if op.name in live:
            continue
        # a dead op FEEDING a live op via any output is live enough
        if any(t.uid in consumed for t in op.outputs):
            continue
        sev = Severity.INFO if op.op_type in _HEAD_OPS else Severity.WARN
        diags.append(make(
            "FF005", op.name,
            f"{op.op_type.value} op does not reach the final tensor "
            f"and nothing consumes its outputs",
            hint="remove it, or point final_tensor/loss at it",
            severity=sev))

    # FF006 — parameters registered on the model but owned by no layer
    # (a share_weights or manual-surgery leak: init_layers would allocate
    # and checkpoint them, the step never reads them).
    if parameters:
        owned = {id(w) for op in layers for w in op.weights}
        for p in parameters:
            if id(p) not in owned:
                diags.append(make(
                    "FF006", p.name,
                    f"parameter {p.name!r} {p.shape} belongs to no layer; "
                    f"it is allocated and checkpointed but never read"))
    return diags
