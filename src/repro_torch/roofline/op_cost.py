"""Trip-count-aware cost accounting of eager PyTorch — the port's
counterpart of the reference's jaxpr walk (``roofline/jaxpr_cost.py``).

Eager PyTorch has no jaxpr.  The counter is a ``TorchDispatchMode`` (the
mechanism of ``analysis/op_lint.py``, with which it nests: a path run under
both gives both their records) that sees every op one call dispatches:

  flops — a product (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``mv``,
          ``dot``, ``convolution``) counts 2·batch·M·N·K; a layout op
          (``LAYOUT_OPS``, and every view) counts nothing; any other op 1
          flop per output element.
  bytes — a product's or any other op's inputs plus outputs, layout ops
          none: a fusion-blind upper bound on memory traffic.

Loops count as many times as they run, since the ops run eagerly, and an
activation checkpoint's recompute counts when the backward runs inside the
counter — the reference's ``scan`` and ``checkpoint`` cases.

The hand-written kernels launch through ``ctypes`` and dispatch no op.  Each
kernel wrapper records one entry instead (:func:`kernel`), from its kernel's
formula below (``PERF.md`` §6's operation and byte counts), and the counter
ignores the ops dispatched while the wrapper runs — so a kernel counts the
same work whether the CUDA kernel ran, its plain version on the CPU, or
nothing (a ``meta`` tensor: the wrapper returns empty outputs of the
kernel's shapes).  The reference counts a ``pallas_call`` as its output
bytes and no flops.

The formulas count float32 operations (#11: fp32 instructions) and bytes:
each operand read once and each output written once.  Where the work
depends on the data — the survivor words a walk touches — a formula takes
the count as an argument and, from shapes alone, counts one word a step.

The numbers are global: divide by the devices for per-device terms.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

#: bytes of a float32 value or an int32 word, the kernels' only element types
WORD = 4
#: steps packed into one survivor word
PACK_BITS = 32

#: ops that cost nothing: no flops, no memory traffic of their own after
#: fusion (the reference's ``_LAYOUT_PRIMS``), by their aten name
LAYOUT_OPS = frozenset({
    # views and reshapes (any op whose schema is a view counts nothing too)
    "view", "_unsafe_view", "reshape", "view_as", "squeeze", "unsqueeze", "flatten",
    "unflatten", "t", "transpose", "permute", "expand", "expand_as", "as_strided",
    "movedim", "_reshape_alias",
    # slices and selects
    "slice", "select", "narrow", "split", "split_with_sizes", "chunk", "unbind",
    "diagonal",
    # copies and dtype conversions (``convert_element_type``, ``copy``, a
    # ``dynamic_update_slice`` of a slice assignment)
    "_to_copy", "to", "clone", "contiguous", "copy_", "_copy_from",
    "_copy_from_and_resize",
    # concatenation, padding, repeats and reversal
    "cat", "stack", "constant_pad_nd", "pad", "repeat", "repeat_interleave", "flip",
    # gathers
    "gather", "index", "index_select", "take", "take_along_dim", "embedding",
    # ranges, constants and fills (``iota``, a ``broadcast_in_dim`` of a literal)
    "arange", "zeros", "ones", "full", "empty", "empty_like", "zeros_like", "ones_like",
    "full_like", "empty_strided", "new_zeros", "new_ones", "new_full", "new_empty",
    "scalar_tensor", "fill_", "zero_", "eye",
    # bookkeeping: aliases, detaching, host data wrapped as a tensor or staged
    # for an upload, scalar reads
    "alias", "detach", "detach_", "lift_fresh", "lift_fresh_copy", "_pin_memory",
    "_local_scalar_dense",
})

#: products: 2·batch·M·N·K flops
PRODUCT_OPS = frozenset({"mm", "bmm", "addmm", "baddbmm", "mv", "addmv", "dot", "vdot"})
#: (operand index of the left factor) of each product, whose last dim is K
_LEFT = {"mm": 0, "bmm": 0, "mv": 0, "dot": 0, "vdot": 0, "addmm": 1, "baddbmm": 1,
         "addmv": 1}


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def tensor_bytes(tree) -> int:
    """Bytes of the tensors in a tree of arguments."""
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _conv_reduction(weight: torch.Tensor, transposed: bool, groups: int) -> int:
    """Multiply-adds per output element: the filter's elements over its
    output features (the reference's ``rhs elems / out-features``)."""
    out_features = weight.shape[1] * groups if transposed else weight.shape[0]
    return weight.numel() // max(1, out_features)


def op_cost(func, args, kwargs, out) -> Tuple[int, int]:
    """(flops, bytes) of one dispatched op (see the module doc)."""
    name = func.overloadpacket.__name__
    if name in LAYOUT_OPS or func.is_view:
        return 0, 0
    outs = _tensors(out)
    nbytes = tensor_bytes((args, kwargs)) + sum(t.numel() * t.element_size() for t in outs)
    if name in PRODUCT_OPS:
        k = args[_LEFT[name]].shape[-1]
        return 2 * outs[0].numel() * k, nbytes
    if name == "convolution":
        weight, transposed, groups = args[1], args[6], args[8]
        return 2 * outs[0].numel() * _conv_reduction(weight, transposed, groups), nbytes
    if name == "convolution_backward":
        # grad_input and grad_weight: one product each over grad_output's
        # elements; grad_bias: one add per grad_output element
        grad_out, weight, transposed, groups, mask = args[0], args[2], args[7], args[9], args[10]
        red = _conv_reduction(weight, transposed, groups)
        return (2 * grad_out.numel() * red * (int(mask[0]) + int(mask[1]))
                + grad_out.numel() * int(mask[2])), nbytes
    return sum(t.numel() for t in outs), nbytes


#: the counters now counting, innermost last (a kernel records on each)
_ACTIVE: List["CostCounter"] = []


class CostCounter(TorchDispatchMode):
    """Counts the flops and bytes of everything run while it is active: the
    dispatched ops by :func:`op_cost`, each kernel launch by its formula.

    Attributes:
      flops, bytes: the totals.
      launches: one ``(kernel name, flops, bytes)`` a kernel wrapper call.
    """

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.launches: List[Tuple[str, int, int]] = []
        self._muted = 0

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._muted:
            return func(*args, **kwargs)
        # a composite op (einsum, matmul, linear, ...) reaches the mode as
        # itself where autograd is off (inference mode): count its aten
        # parts, as every other mode dispatches them
        super().__enter__()
        try:
            out = func.decompose(*args, **kwargs)
        finally:
            super().__exit__(None, None, None)
        if out is not NotImplemented:
            return out
        out = func(*args, **kwargs)
        flops, nbytes = op_cost(func, args, kwargs, out)
        self.flops += flops
        self.bytes += nbytes
        return out


class _Launch:
    """The context a kernel wrapper runs in while a counter is active: its
    entry recorded on every active counter, their op counting muted."""

    def __init__(self, name: str, flops: int, nbytes: int):
        self.entry = (name, int(flops), int(nbytes))
        self.counters = list(_ACTIVE)

    def __enter__(self):
        for c in self.counters:
            c.launches.append(self.entry)
            c.flops += self.entry[1]
            c.bytes += self.entry[2]
            c._muted += 1
        return self

    def __exit__(self, *exc):
        for c in self.counters:
            c._muted -= 1
        return False


_NO_COUNT = contextlib.nullcontext()


def kernel(name: str, cost, *args, **kwargs):
    """The context a kernel wrapper runs in: with a counter active, records
    ``name`` with ``cost(*args, **kwargs)`` = (flops, bytes) and mutes the
    counting of the ops dispatched inside; otherwise does nothing (the
    formula is not evaluated)."""
    if not _ACTIVE:
        return _NO_COUNT
    return _Launch(name, *cost(*args, **kwargs))


def count_fn_costs(fn, *args, **kwargs) -> Dict[str, float]:
    """Run ``fn(*args, **kwargs)`` once under a :class:`CostCounter` and
    return ``{"flops", "bytes", "input_bytes"}`` (the reference's keys);
    ``input_bytes`` counts reading every tensor argument once.  On ``meta``
    tensors nothing is computed or allocated."""
    with CostCounter() as c:
        fn(*args, **kwargs)
    return {"flops": float(c.flops), "bytes": float(c.bytes),
            "input_bytes": float(tensor_bytes((args, kwargs)))}


# --------------------------------------------------------------------------- #
# The kernels' formulas (PERF.md §6's operation and byte counts)               #
# --------------------------------------------------------------------------- #


def scan_cost(B: int, T: int, F: int, S: int, M: int, *, seeded: bool, packed: bool,
              window: bool = False, steps: Optional[int] = None) -> Tuple[int, int]:
    """#1, #3, #4, #6, #7: the forward ACS scan over B lanes and T steps of
    F inputs, S states, M output symbols.  Per lane-step M branch metrics of
    F multiply-adds each, then per state the two adds of (pm + m_j) + rb_j
    twice, the compare, the select and the clamp.  Bytes: the inputs, pm0
    (``seeded``), lo and hi (``window``), the (S, F) weights twice and the
    (S, 2) bias read; the final metrics and the survivors (packed words or
    one select a step) written.  ``steps``: lane-steps inside the windows
    when the caller knows them (default every one)."""
    rows = -(-T // PACK_BITS) if packed else T
    nbytes = WORD * (B * T * F + (2 if seeded else 1) * B * S + (2 * B if window else 0)
                     + rows * B * S + 2 * S * F + 2 * S)
    lane_steps = B * T if steps is None else steps
    return lane_steps * (M * 2 * F + 7 * S), nbytes


def traceback_cost(B: int, T: int, words: Optional[int] = None) -> Tuple[int, int]:
    """#2: the walk of B lanes over T steps — 6 operations a step (shift,
    mask, bit read, emit, next state).  Bytes: the survivor words read
    (``words`` distinct ones; default one a step), the start states read,
    the bits written."""
    words = B * T if words is None else words
    return 6 * B * T, WORD * (words + B + B * T)


def traceback_window_cost(lanes: int, W: int, steps: Optional[int] = None,
                          words: Optional[int] = None) -> Tuple[int, int]:
    """#5: the windowed walk of ``lanes`` lanes over W words (32·W steps);
    6 operations a step inside the windows (``steps``, default every one).
    Bytes: the words read (default one a step inside the windows), the start
    states, lo and hi read, the bits and entry states written."""
    steps = lanes * PACK_BITS * W if steps is None else steps
    words = steps if words is None else words
    return 6 * steps, WORD * (words + lanes * PACK_BITS * W + 4 * lanes)


def texpand_cost(B: int, S: int, M: int) -> Tuple[int, int]:
    """#8: one ACS step — per (lane, state) two adds, the compare, the
    select.  Bytes: pm and bm read, the (S, 2) symbols read, pm and the
    selects written."""
    return 4 * B * S, WORD * (3 * B * S + B * M + 2 * S)


def bcjr_alpha_cost(B: int, T: int, F: int, S: int, R: int) -> Tuple[int, int]:
    """#9: per (lane, step) R distinct F-term branch costs, then per state
    two adds, a min, the renorm min, the subtract and the clamp.  Bytes:
    features read, every A_t and the final metrics written, the (S, F)
    weights twice read."""
    return B * T * (R * 2 * F + 6 * S), WORD * (T * F * B + T * S * B + S * B + 2 * S * F)


def bcjr_beta_cost(B: int, T: int, F: int, S: int, R: int) -> Tuple[int, int]:
    """#10: per (lane, step) R branch costs; the LLR's two costs, two mins
    per state and one subtract; the beta retire's two adds, min and renorm.
    Bytes: the alphas and features read, the LLRs written, four (S, F)
    weight tables and the (S, 2) next states read."""
    return (B * T * (R * 2 * F + 12 * S + 1),
            WORD * (T * S * B + T * F * B + T * B + 4 * S * F + 2 * S))


def minplus_cost(N: int, I: int, K: int, J: int) -> Tuple[int, int]:
    """#11: N (I, K) x (K, J) (min,+) products — one add and one min per
    (n, i, j, k), each an issued fp32 instruction.  Bytes: each operand
    matrix read once, each product written once."""
    return 2 * N * I * J * K, WORD * N * (I * K + K * J + I * J)
