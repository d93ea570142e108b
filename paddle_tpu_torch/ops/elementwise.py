"""The generic elementwise kernel of the static-program fusion pass
(counterpart of paddle_tpu/jit/fusion_cc.py:_generic_kernel).

`generic_elementwise(prog, *operands)` computes a region program that
``jit.fusion_cc`` reports for an elementwise region: a list of
instructions ``{"op": name, "ins": [...], "out": id}`` in program order,
whose inputs are ``"#k"`` (operand k), the ``out`` id of an earlier
instruction, or a number (an immediate). The op names are the pass's
instruction set `EW_OPS`, the JAX package's names (``fusion_cc._EW_IMPL``):
add, subtract, multiply, divide, maximum, minimum, exponential, log, tanh,
logistic, rsqrt, sqrt, negate, abs, power. The last instruction's value
is the result.

The operands share one floating dtype (f32, bf16 or f16) and broadcast
to the result's shape, which is their broadcast shape; strided views
(slices, expanded tables) are read in place. Each instruction is
computed in f32 and rounded to that dtype before the next reads it: the
values of the region's unfused PyTorch ops, one after the other, which
is what the plain version `generic_elementwise_reference` runs.

On CUDA tensors the wrapper launches ONE hand-written kernel
(``csrc/elementwise.cu``) that interprets the program, so every region
shares one compiled kernel; on CPU tensors it runs the plain version. A
program over the kernel's limits (`MAX_OPS` instructions, `MAX_OPERANDS`
operands, `MAX_RANK` dimensions after merging) raises on CUDA; the pass
refuses such regions beforehand. ``generic_elementwise.launches`` /
``.plain_calls`` count the routes.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import torch

from . import _build
from .oracles import register_oracle

__all__ = ["generic_elementwise", "generic_elementwise_reference",
           "compile_program", "EW_OPS", "MAX_OPS", "MAX_OPERANDS",
           "MAX_RANK", "DTYPES"]

_P, _I = ctypes.c_void_p, ctypes.c_int

#: the instruction set, in the kernel's opcode order (elementwise.cu EwOp)
EW_OPS = ("add", "subtract", "multiply", "divide", "maximum", "minimum",
          "exponential", "log", "tanh", "logistic", "rsqrt", "sqrt",
          "negate", "abs", "power")
_UNARY = frozenset(("exponential", "log", "tanh", "logistic", "rsqrt",
                    "sqrt", "negate", "abs"))
#: the kernel's fixed limits (elementwise.cu kEwMaxOps / kEwMaxIn /
#: kEwMaxRank)
MAX_OPS, MAX_OPERANDS, MAX_RANK = 32, 8, 8
#: dtypes the kernel computes in, by its dtype code
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_REG, _IN, _IMM = 0, 1, 2

_TORCH = {
    "add": torch.add, "subtract": torch.sub, "multiply": torch.mul,
    "divide": torch.div, "maximum": torch.maximum,
    "minimum": torch.minimum, "exponential": torch.exp, "log": torch.log,
    "tanh": torch.tanh, "logistic": torch.sigmoid, "rsqrt": torch.rsqrt,
    "sqrt": torch.sqrt, "negate": torch.neg, "abs": torch.abs,
    "power": torch.pow,
}


def _is_num(a) -> bool:
    return isinstance(a, (int, float)) and not isinstance(a, bool)


def compile_program(prog: Sequence[dict], n_operands: int
                    ) -> List[Tuple[str, Tuple[Tuple[int, object], ...]]]:
    """The program as [(op, ((kind, index or immediate), ...))], kinds
    register / operand / immediate; raises ValueError on an unknown op,
    a wrong arity, an undefined input or an operand out of range."""
    regs: Dict[str, int] = {}
    out = []
    for j, st in enumerate(prog):
        op = st["op"]
        if op not in _TORCH:
            raise ValueError(f"generic_elementwise: unknown op {op!r}; the "
                             f"instruction set is {EW_OPS}")
        ins = list(st["ins"])
        if len(ins) != (1 if op in _UNARY else 2):
            raise ValueError(f"generic_elementwise: {op} takes "
                             f"{1 if op in _UNARY else 2} inputs, got "
                             f"{ins}")
        srcs = []
        for tok in ins:
            if _is_num(tok):
                srcs.append((_IMM, float(tok)))
            elif isinstance(tok, str) and tok.startswith("#"):
                k = int(tok[1:])
                if not 0 <= k < n_operands:
                    raise ValueError(f"generic_elementwise: operand {tok} "
                                     f"of {n_operands}")
                srcs.append((_IN, k))
            elif tok in regs:
                srcs.append((_REG, regs[tok]))
            else:
                raise ValueError(f"generic_elementwise: input {tok!r} of "
                                 f"{op} is not defined before it")
        regs[st["out"]] = j
        out.append((op, tuple(srcs)))
    if not out:
        raise ValueError("generic_elementwise: empty program")
    return out


def generic_elementwise_reference(prog, *operands):
    """Plain version: the program's ops one after the other, in PyTorch,
    each in the operands' dtype (immediates as Python numbers, as the
    unfused ops took them)."""
    code = compile_program(prog, len(operands))
    dtype = operands[0].dtype
    regs = []
    for op, srcs in code:
        args = []
        for kind, v in srcs:
            if kind == _IMM:
                # maximum / minimum take tensors only
                args.append(torch.tensor(v, dtype=dtype) if op in (
                    "maximum", "minimum") else v)
            else:
                args.append(operands[v] if kind == _IN else regs[v])
        regs.append(_TORCH[op](*args))
    shape = torch.broadcast_shapes(*(t.shape for t in operands))
    return regs[-1].expand(shape).to(dtype).contiguous()


def _merged(shape, strides):
    """(shape, per-operand strides) with size-1 dimensions dropped and
    neighbouring dimensions merged wherever every operand (and the
    contiguous result) walks them as one."""
    dims = [(n, [s[d] for s in strides]) for d, n in enumerate(shape)
            if n != 1]
    out: List[Tuple[int, List[int]]] = []
    for n, ss in dims:
        if out:
            pn, ps = out[-1]
            if all(p == s * n for p, s in zip(ps, ss)):
                out[-1] = (pn * n, ss)
                continue
        out.append((n, ss))
    return [n for n, _ in out], [[ss[k] for _, ss in out]
                                 for k in range(len(strides))]


def _launch(code, operands, shape, dtype):
    name = "generic_elementwise"
    dev = operands[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    for t in operands:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
    if len(code) > MAX_OPS or len(operands) > MAX_OPERANDS:
        raise ValueError(f"{name}: {len(code)} instructions over "
                         f"{len(operands)} operands; the kernel takes "
                         f"{MAX_OPS} and {MAX_OPERANDS}")
    out = torch.empty(shape, dtype=dtype, device=dev)
    strides = [list(t.expand(shape).stride()) for t in operands]
    mshape, mstrides = _merged(list(shape), strides)
    if len(mshape) > MAX_RANK:
        raise ValueError(f"{name}: {len(mshape)} dimensions after merging; "
                         f"the kernel takes {MAX_RANK}")
    rank, n_in, n_ops = len(mshape), len(operands), len(code)
    prog = (ctypes.c_int * (5 * n_ops))()
    imms = (ctypes.c_float * (2 * n_ops))()
    for j, (op, srcs) in enumerate(code):
        prog[5 * j] = EW_OPS.index(op)
        for s in range(2):
            kind, v = srcs[s] if s < len(srcs) else (_IMM, 0.0)
            prog[5 * j + 1 + 2 * s] = kind
            prog[5 * j + 2 + 2 * s] = 0 if kind == _IMM else v
            imms[2 * j + s] = v if kind == _IMM else 0.0
    ins = (ctypes.c_longlong * max(n_in, 1))(
        *[t.data_ptr() for t in operands])
    st = (ctypes.c_longlong * max(n_in * rank, 1))(
        *[s for ss in mstrides for s in ss])
    shp = (ctypes.c_longlong * max(rank, 1))(*mshape)
    fn = _build.kernel("ptt_generic_elementwise",
                       [_I, _P, _P, _I, _P, _P, _I, _P, _P, _I, _I, _P])
    err = fn(n_ops, ctypes.addressof(prog), ctypes.addressof(imms), n_in,
             ctypes.addressof(ins), ctypes.addressof(st), rank,
             ctypes.addressof(shp), out.data_ptr(), DTYPES[dtype],
             dev.index or 0, _build.stream(out))
    _build.check(name, err)
    generic_elementwise.launches += 1
    return out


def generic_elementwise(prog, *operands):
    """The region program `prog` over `operands` (see the module
    docstring): the result, contiguous, in the operands' dtype and their
    broadcast shape. CUDA tensors launch the kernel or raise; CPU tensors
    run the plain version."""
    if not operands:
        raise ValueError("generic_elementwise: a region reads at least one "
                         "operand")
    if _build.faked(*operands):
        return generic_elementwise_reference(prog, *operands)
    dtype = operands[0].dtype
    if dtype not in DTYPES or any(t.dtype != dtype for t in operands):
        raise TypeError(f"generic_elementwise: operands share one dtype of "
                        f"{tuple(DTYPES)}, got "
                        f"{[t.dtype for t in operands]}")
    code = compile_program(prog, len(operands))
    if all(t.device.type == "cpu" for t in operands):
        generic_elementwise.plain_calls += 1
        return generic_elementwise_reference(prog, *operands)
    shape = torch.broadcast_shapes(*(t.shape for t in operands))
    return _launch(code, operands, shape, dtype)


generic_elementwise.launches = 0
generic_elementwise.plain_calls = 0


# the one kernel outside the JAX registry: JAX's register_oracle never
# names _generic_kernel, which the pass synthesizes per region
register_oracle(
    "generic_elementwise", kernel=generic_elementwise,
    reference=generic_elementwise_reference,
    parity_test="tests/test_torch_inference.py::TestGenericKernelPlain")
