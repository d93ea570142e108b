"""Static-program fusion pass (counterpart of paddle_tpu/jit/fusion_cc.py
and the C++ matcher it drives, paddle_tpu/csrc/fusion_pass.cc): the
inference path's CINN ApplyCinnPass.

The JAX pass lowers the program to StableHLO text and matches it in C++
(that sandbox had no MLIR bindings). Here the static program is the
core-ATen graph of ``torch.export`` (``run_decompositions()``: the
counterpart of StableHLO), already an fx data structure, so the matcher
is Python. The pipeline of `fuse_compile`:

1. export the function (or take an ``ExportedProgram``: the
   ``inference.Predictor`` hands in the artifact it loaded) and take its
   module's graph; the export's ``_assert_tensor_metadata`` checks go,
   they are not part of the computation;
2. match sdpa, rmsnorm and swiglu, then the generic elementwise regions,
   which never overlap a named match (fusion_pass.cc:712-737); a match is
   kept only when its chain is closed (`chain_is_closed`, :666);
3. gate each match on the Hopper kernel it would call (below): a match
   the gate refuses stays as the program's own ops and is counted in
   ``.refused``;
4. replace each accepted match by one call (the kernels' wrappers:
   ``ops.flash_sdpa``, ``ops.fused_rms_norm``, ``ops.swiglu`` through
   ``jit.fusion``'s executors, and ``ops.generic_elementwise``) and drop
   the interior nodes nothing else reads;
5. return the rewritten module as a callable: ``.matches`` (the report),
   ``.n_fused``, ``.refused`` and ``.module_text`` (the rewritten graph's
   code). With no match the exported module runs as it is.

The matchers key on what core ATen holds (the forms differ from
StableHLO's):

- ``sdpa``: bmm(view(softmax([convert] [scale *] view(bmm(q', k'^T)))
  [convert]), v') with q', k', v' movement chains (view / permute /
  expand / clone / ...) of [B, H, S, D] or [B, S, H, D] tensors; the
  chains are read by replaying them on index tensors, so any layout the
  decomposition of einsum or matmul produces is recognised. The kernel
  writes the [B*H, Sq, D] product the final bmm wrote;
- ``rmsnorm``: [convert(]x32 * rsqrt(mean.dim(x32 * x32 | pow(x32, 2),
  [-1], keepdim) + eps)[)] * w, x32 = _to_copy(x, f32) or x, w [H];
- ``swiglu``: mul(mul(g, sigmoid(g)) | silu(g), up), g and up of one
  shape;
- ``generic``: maximal regions grown along single-use interior edges of
  elementwise ops of one result type (:579-600), at least 3 ops (:602),
  exactly one escaping value (:604-617). The instruction set is
  fusion_pass.cc's ew_ops() (:545-556), under fusion_cc._EW_IMPL's names
  (`EW_ATEN`); a scalar argument becomes an immediate of the program.

The gates, re-derived for Hopper (the TPU's tiling gates do not
transfer): sdpa -> ``ops.flash_kernel_eligible`` and the kernels'
dtypes; rmsnorm and swiglu -> the kernels' dtypes; generic -> a floating
result, every operand of the result's dtype and broadcastable to its
shape (stride-0 broadcasts and strided slices are read in place: JAX's
rope operands are full-shape only because StableHLO makes broadcasts and
slices explicit ops), at least 1024 elements ("worth a launch"; the TPU's
% 128 lane rule goes), within the kernel's operand, instruction and rank
limits.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Set

import torch
from torch import fx
from torch.utils import _pytree as pytree

from .. import ops
from ..ops import elementwise as _ew
from . import fusion as _fusion

__all__ = ["fuse_compile", "analyze", "EW_ATEN", "PATTERNS",
           "GENERIC_MIN_ELEMENTS", "type_str", "export_program"]

_A = torch.ops.aten

#: the generic regions' instruction set: aten overload -> the JAX pass's
#: op name (fusion_cc._EW_IMPL)
EW_ATEN = {
    _A.add.Tensor: "add", _A.sub.Tensor: "subtract",
    _A.mul.Tensor: "multiply", _A.div.Tensor: "divide",
    _A.maximum.default: "maximum", _A.minimum.default: "minimum",
    _A.exp.default: "exponential", _A.log.default: "log",
    _A.tanh.default: "tanh", _A.sigmoid.default: "logistic",
    _A.rsqrt.default: "rsqrt", _A.sqrt.default: "sqrt",
    _A.neg.default: "negate", _A.abs.default: "abs",
    _A.pow.Tensor_Scalar: "power", _A.pow.Tensor_Tensor: "power",
}
PATTERNS = ("sdpa", "rmsnorm", "swiglu", "generic")
#: a generic region below this many elements is not worth a launch
GENERIC_MIN_ELEMENTS = 1024

#: pure movement ops: the layout chains between a tensor and a bmm
_MOVES = {_A.view.default, _A._unsafe_view.default, _A.reshape.default,
          _A.permute.default, _A.transpose.int, _A.unsqueeze.default,
          _A.squeeze.dim, _A.squeeze.dims, _A.squeeze.default,
          _A.expand.default, _A.clone.default, _A.alias.default,
          _A.t.default}
_VIEWS = {_A.view.default, _A._unsafe_view.default}
_TYPES = {torch.float32: "f32", torch.float16: "f16",
          torch.bfloat16: "bf16", torch.float64: "f64",
          torch.int64: "i64", torch.int32: "i32", torch.int16: "i16",
          torch.int8: "i8", torch.uint8: "ui8", torch.bool: "i1"}


# ---------------------------------------------------------------------------
# graph helpers
# ---------------------------------------------------------------------------

def _val(n):
    return n.meta.get("val") if isinstance(n, fx.Node) else None


def _tensor(n) -> Optional[torch.Tensor]:
    v = _val(n)
    return v if isinstance(v, torch.Tensor) else None


def _ttype(n):
    """(shape, dtype) of a tensor-valued node, else None."""
    t = _tensor(n)
    return None if t is None else (tuple(t.shape), t.dtype)


def type_str(n) -> str:
    """The StableHLO-style type of a node's value, ``tensor<2x64xf32>``
    (the JAX report's notation)."""
    t = _tensor(n)
    if t is None:
        return ""
    dims = "".join(f"{d}x" for d in t.shape)
    return f"tensor<{dims}{_TYPES.get(t.dtype, str(t.dtype))}>"


def _call(n, *targets) -> bool:
    return isinstance(n, fx.Node) and n.op == "call_function" and \
        n.target in targets


def _uses(n) -> int:
    """Operand slots that read `n` (mul(x, x) reads x twice), the output
    included."""
    return sum(sum(1 for a in pytree.tree_leaves((u.args, u.kwargs))
                   if a is n) for u in n.users)


def _is_num(a) -> bool:
    return isinstance(a, (int, float)) and not isinstance(a, bool)


def _ew_name(n) -> Optional[str]:
    """The instruction `n` is, or None: an op of EW_ATEN whose arguments
    are tensors or numbers (add / sub with alpha 1)."""
    if not isinstance(n, fx.Node) or n.op != "call_function":
        return None
    name = EW_ATEN.get(n.target)
    if name is None or _tensor(n) is None:
        return None
    if n.kwargs.get("alpha", 1) != 1 or set(n.kwargs) - {"alpha"}:
        return None
    if not all(isinstance(a, fx.Node) or _is_num(a) for a in n.args):
        return None
    return name


def _convert(n) -> bool:
    """A dtype-only ``_to_copy``."""
    return _call(n, _A._to_copy.default) and \
        set(n.kwargs) <= {"dtype"} and len(n.args) == 1


def _single_user(n):
    return next(iter(n.users)) if len(n.users) == 1 else None


class _Match:
    """One match: its report (JSON-able, the JAX report's keys), the
    final node it replaces, the interior it deletes, the nodes it must
    find closed, and the executor's arguments."""

    def __init__(self, pattern, final, chain, operands, executor, args,
                 *, closed=None, scale=1.0, eps=0.0, prog=None):
        self.final = final
        self.chain = set(chain)
        self.closed = set(chain if closed is None else closed)
        self.executor = executor
        self.args = args
        self.report = {
            "pattern": pattern,
            "operands": [o.name for o in operands],
            "operand_types": [type_str(o) for o in operands],
            "result": final.name, "result_type": type_str(final),
            "scale": scale, "eps": eps}
        if prog is not None:
            self.report["prog"] = prog

    @property
    def pattern(self) -> str:
        return self.report["pattern"]


def _chain_is_closed(m: _Match) -> bool:
    """Every interior value is read only inside the match
    (fusion_pass.cc chain_is_closed)."""
    span = m.closed | {m.final}
    return all(u in span for n in m.closed for u in n.users)


# ---------------------------------------------------------------------------
# sdpa
# ---------------------------------------------------------------------------

def _movement_source(n):
    """(source, chain) of n: the first node behind a run of movement
    ops, and those ops (last first)."""
    chain = []
    while _call(n, *_MOVES):
        chain.append(n)
        n = n.args[0]
    return n, chain


def _replay(chain, idx):
    """The movement chain (last op first) applied to an index tensor;
    views become reshapes (the index tensor's layout is not the real
    one)."""
    for n in reversed(chain):
        if n.target in _VIEWS:
            idx = idx.reshape(n.args[1])
        elif n.target is _A.clone.default:
            idx = idx.clone()
        else:
            idx = n.target(idx, *n.args[1:], **n.kwargs)
    return idx


_PERM = {"bhsd": (0, 1, 2, 3), "bshd": (0, 2, 1, 3)}


def _operand(src, chain, B, H, rows, D, transposed=False):
    """(node, layout, its chain) of the 4-D tensor nearest `src` along
    `chain` (last op first) that the rest of the chain reads as [B*H,
    rows, D] (as [B*H, D, rows] when `transposed`) under a layout "bhsd" /
    "bshd", else None: the source itself may be 3-D (a projection before
    its reshape to heads)."""
    for i in range(len(chain), -1, -1):
        node = src if i == len(chain) else chain[i]
        lay = _layout(node, chain[:i], B, H, rows, D, transposed)
        if lay is not None:
            return node, lay, chain[:i]
    return None


def _layout(src, chain, B, H, rows, D, transposed=False):
    """The layout ("bhsd" / "bshd") under which the chain reads the 4-D
    `src` as [B*H, rows, D] (as [B*H, D, rows] when `transposed`), else
    None."""
    t = _tensor(src)
    if t is None or t.dim() != 4 or t.numel() != B * H * rows * D:
        return None
    ar = torch.arange(t.numel(), dtype=torch.int64).reshape(t.shape)
    try:
        got = _replay(chain, ar)
    except (RuntimeError, TypeError, ValueError, IndexError):
        return None
    for lay, perm in _PERM.items():
        want_shape = (B, H, rows, D)
        if tuple(t.shape[i] for i in perm) != want_shape:
            continue
        want = ar.permute(perm).reshape(B * H, rows, D)
        if transposed:
            want = want.transpose(1, 2)
        if tuple(got.shape) == tuple(want.shape) and torch.equal(got, want):
            return lay
    return None


def _grouped(chain, B, H, rows, cols, to_groups: bool) -> bool:
    """The chain maps [B*H, rows, cols] onto [B, H, rows, cols]
    (`to_groups` False) or back (True), element for element."""
    shape = (B * H, rows, cols) if not to_groups else (B, H, rows, cols)
    ar = torch.arange(B * H * rows * cols, dtype=torch.int64).reshape(shape)
    try:
        got = _replay(chain, ar)
    except (RuntimeError, TypeError, ValueError, IndexError):
        return False
    want_shape = (B, H, rows, cols) if not to_groups else \
        (B * H, rows, cols)
    return tuple(got.shape) == want_shape and torch.equal(
        got, ar.reshape(want_shape))


def _exec_sdpa_bmm(q, k, v, scale, layouts, dtype):
    """The flash kernel (jit.fusion's executor) written as the [B*H, Sq,
    D] product the final bmm produced."""
    o = _fusion._exec_sdpa(q, k, v, scale, layouts + ("bhsd",), dtype)
    return o.reshape(-1, o.shape[2], o.shape[3])


def _match_sdpa(nodes) -> List[_Match]:
    out = []
    for fin in nodes:
        if not _call(fin, _A.bmm.default):
            continue
        p3, v3 = fin.args
        interior: List = []
        p4, pchain = _movement_source(p3)
        interior += pchain
        if _convert(p4):
            interior.append(p4)
            p4 = p4.args[0]
        if not _call(p4, _A._softmax.default) or p4.args[2]:
            continue
        sm = p4
        st = _tensor(sm)
        if st is None or st.dim() != 4 or p4.args[1] not in (-1, 3):
            continue
        interior.append(sm)
        B, H, Sq, Sk = st.shape
        lg = sm.args[0]
        if _convert(lg):
            interior.append(lg)
            lg = lg.args[0]
        scale = 1.0
        if _call(lg, _A.mul.Tensor, _A.div.Tensor) and _is_num(lg.args[1]):
            s = float(lg.args[1])
            if s == 0.0:
                continue
            scale = s if lg.target is _A.mul.Tensor else 1.0 / s
            interior.append(lg)
            lg = lg.args[0]
        l3, lchain = _movement_source(lg)
        if not _call(l3, _A.bmm.default):
            continue
        interior += lchain + [l3]
        if not _grouped(lchain, B, H, Sq, Sk, False) or \
                not _grouped(pchain, B, H, Sq, Sk, True):
            continue
        a3, b3 = l3.args
        D = _tensor(a3).shape[-1]
        qo = _operand(*_movement_source(a3), B, H, Sq, D)
        ko = _operand(*_movement_source(b3), B, H, Sk, D, transposed=True)
        vo = _operand(*_movement_source(v3), B, H, Sk, _tensor(v3).shape[-1])
        if None in (qo, ko, vo):
            continue
        (q, ql, qchain), (k, kl, kchain), (v, vl, vchain) = qo, ko, vo
        out.append(_Match("sdpa", fin, interior + qchain + kchain + vchain,
                          [q, k, v], _exec_sdpa_bmm,
                          (q, k, v, scale, (ql, kl, vl), _tensor(fin).dtype),
                          closed=interior, scale=scale))
    return out


def _sdpa_ok(m: _Match) -> bool:
    q, k, v = (_tensor(a) for a in m.args[:3])

    def bshd(t, lay):
        return tuple(t.shape) if lay == "bshd" else \
            (t.shape[0], t.shape[2], t.shape[1], t.shape[3])
    qs, ks, vs = (bshd(t, lay) for t, lay in zip((q, k, v), m.args[4]))
    return (q.dtype == k.dtype == v.dtype
            and q.dtype in _fusion._KERNEL_DTYPES
            and qs[3] == ks[3] == vs[3]
            and ops.flash_kernel_eligible(qs[1], ks[1], qs[3]))


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------

def _match_rmsnorm(nodes) -> List[_Match]:
    out = []
    for r in nodes:
        if not _call(r, _A.rsqrt.default):
            continue
        add = r.args[0]
        if not _call(add, _A.add.Tensor) or not _is_num(add.args[1]) or \
                _uses(add) != 1 or add.kwargs:
            continue
        eps = float(add.args[1])
        mean = add.args[0]
        if not _call(mean, _A.mean.dim) or _uses(mean) != 1 or \
                mean.kwargs.get("dtype") is not None:
            continue
        dims = mean.args[1]
        keep = mean.args[2] if len(mean.args) > 2 else \
            mean.kwargs.get("keepdim", False)
        sq = mean.args[0]
        st = _tensor(sq)
        if st is None or not keep or list(dims) not in ([-1],
                                                        [st.dim() - 1]):
            continue
        if _call(sq, _A.mul.Tensor) and sq.args[0] is sq.args[1]:
            x32 = sq.args[0]
        elif _call(sq, _A.pow.Tensor_Scalar) and sq.args[1] == 2:
            x32 = sq.args[0]
        else:
            continue
        if _uses(sq) != 1 or _uses(r) != 1:
            continue
        norm = _single_user(r)
        if not _call(norm, _A.mul.Tensor) or x32 not in norm.args or \
                r not in norm.args or _uses(norm) != 1:
            continue
        chain = [r, add, mean, sq, norm]
        nxt = _single_user(norm)
        if _convert(nxt):
            if _uses(nxt) != 1:
                continue
            chain.append(nxt)
            nv, nxt = nxt, _single_user(nxt)
        else:
            nv = norm
        if not _call(nxt, _A.mul.Tensor):
            continue
        w = [a for a in nxt.args if a is not nv]
        H = _tensor(x32).shape[-1]
        if len(w) != 1 or not isinstance(w[0], fx.Node) or \
                _ttype(w[0]) is None or _ttype(w[0])[0] != (H,):
            continue
        w = w[0]
        # x: the value before the f32 cast, which joins the chain when the
        # square and the product are its only readers
        x = x32
        if _convert(x32) and set(x32.users) == {sq, norm}:
            chain.append(x32)
            x = x32.args[0]
        out.append(_Match("rmsnorm", nxt, chain, [x, w],
                          _fusion._exec_rmsnorm,
                          (x, w, eps, _tensor(nxt).dtype), eps=eps))
    return out


def _rms_ok(m: _Match) -> bool:
    return all(_tensor(a).dtype in _fusion._KERNEL_DTYPES
               for a in m.args[:2])


# ---------------------------------------------------------------------------
# swiglu
# ---------------------------------------------------------------------------

def _silu_of(n):
    """(gate, chain) when n computes silu(gate): aten.silu, or core
    ATen's mul(g, sigmoid(g)) with the sigmoid read only there; a bf16 /
    f16 gate's silu is that in f32 between two converts."""
    if _call(n, _A.silu.default):
        return n.args[0], [n]
    chain = []
    if _convert(n):
        chain.append(n)
        n = n.args[0]
        if _uses(n) != 1:
            return None, None
    if _call(n, _A.mul.Tensor):
        for g, s in ((n.args[0], n.args[1]), (n.args[1], n.args[0])):
            if _call(s, _A.sigmoid.default) and s.args[0] is g and \
                    _uses(s) == 1:
                chain += [n, s]
                if chain[0] is not n:       # the f32 silu of a cast gate
                    if not _convert(g) or set(g.users) != {n, s}:
                        return None, None
                    chain.append(g)
                    g = g.args[0]
                return g, chain
    return None, None


def _match_swiglu(nodes) -> List[_Match]:
    out = []
    for m in nodes:
        if not _call(m, _A.mul.Tensor) or not all(
                isinstance(a, fx.Node) for a in m.args):
            continue
        for a, up in ((m.args[0], m.args[1]), (m.args[1], m.args[0])):
            if a is up or _uses(a) != 1:
                continue
            g, chain = _silu_of(a)
            if g is None or _ttype(g) != _ttype(up):
                continue
            out.append(_Match("swiglu", m, chain, [g, up],
                              _fusion._exec_swiglu,
                              (g, up, _tensor(m).dtype)))
            break
    return out


def _swiglu_ok(m: _Match) -> bool:
    return _tensor(m.args[0]).dtype in _fusion._KERNEL_DTYPES


# ---------------------------------------------------------------------------
# generic elementwise regions
# ---------------------------------------------------------------------------

def _match_generic(nodes, taken: Set) -> List[_Match]:
    order = {n: i for i, n in enumerate(nodes)}
    visited: Set = set()
    out = []
    for seed in nodes:
        if seed in visited or seed in taken or _ew_name(seed) is None:
            continue
        T = _ttype(seed)
        region = {seed}
        work = [seed]
        while work:
            op = work.pop()
            for p in op.all_input_nodes:      # grow towards producers
                if p in region or p in taken or _ew_name(p) is None or \
                        _ttype(p) != T or _uses(p) != 1:
                    continue
                region.add(p)
                work.append(p)
            if _uses(op) != 1:
                continue
            for q in op.users:                # grow towards consumers
                if q in region or q in taken or _ew_name(q) is None or \
                        _ttype(q) != T:
                    continue
                region.add(q)
                work.append(q)
        visited |= region
        if len(region) < 3:                   # not worth a kernel call
            continue
        escaping = [n for n in region
                    if any(u not in region for u in n.users)]
        # one escaping value, computed last (the program's result)
        if len(escaping) != 1 or order[escaping[0]] != max(
                order[n] for n in region):
            continue
        fin = escaping[0]
        ext: List = []
        prog = []
        for n in sorted(region, key=order.__getitem__):
            ins = []
            for a in n.args:
                if _is_num(a):
                    ins.append(float(a))
                elif a in region:
                    ins.append(a.name)
                else:
                    if a not in ext:
                        ext.append(a)
                    ins.append(f"#{ext.index(a)}")
            prog.append({"op": _ew_name(n), "ins": ins, "out": n.name})
        out.append(_Match("generic", fin, region - {fin}, ext,
                          ops.generic_elementwise, (prog, *ext), prog=prog))
    return out


def _generic_ok(m: _Match) -> bool:
    res = _tensor(m.final)
    if res.dtype not in _ew.DTYPES or res.numel() < GENERIC_MIN_ELEMENTS:
        return False
    opnds = [_tensor(a) for a in m.args[1:]]
    if any(t is None or t.dtype != res.dtype for t in opnds):
        return False
    try:
        if torch.broadcast_shapes(*(t.shape for t in opnds)) != res.shape:
            return False
    except RuntimeError:
        return False
    # the kernel's fixed limits; a merged rank only lowers the count
    return (len(m.report["prog"]) <= _ew.MAX_OPS
            and len(opnds) <= _ew.MAX_OPERANDS
            and sum(d != 1 for d in res.shape) <= _ew.MAX_RANK)


# ---------------------------------------------------------------------------
# the pass
# ---------------------------------------------------------------------------

_GATES = {"sdpa": _sdpa_ok, "rmsnorm": _rms_ok, "swiglu": _swiglu_ok,
          "generic": _generic_ok}


def _ops(gm: fx.GraphModule) -> List:
    return [n for n in gm.graph.nodes if n.op == "call_function"]


def _strip_checks(gm: fx.GraphModule) -> None:
    """Drop the export's tensor-metadata assertions: checks of dtypes
    the program already fixes, each a reader of the value it checks."""
    for n in list(gm.graph.nodes):
        if _call(n, _A._assert_tensor_metadata.default) and not n.users:
            gm.graph.erase_node(n)
    gm.recompile()


def analyze(gm: fx.GraphModule) -> List[_Match]:
    """Every match of the program, named patterns first (sdpa, rmsnorm,
    swiglu), then the generic regions, none overlapping another, each
    with its chain closed (fusion_pass.cc ptpu_fusion_analyze). The
    export's metadata checks are dropped from `gm` first."""
    _strip_checks(gm)
    nodes = _ops(gm)
    named = _match_sdpa(nodes) + _match_rmsnorm(nodes) + \
        _match_swiglu(nodes)
    claimed: Set = set()
    found = []

    def take(ms):
        for m in ms:
            span = m.closed | {m.final}
            if not _chain_is_closed(m) or span & claimed:
                continue
            claimed.update(span)
            found.append(m)
    take(named)
    take(_match_generic(nodes, claimed))
    for i, m in enumerate(found):
        m.report["id"] = i
    return found


def _rewrite(gm: fx.GraphModule, matches: List[_Match]) -> None:
    g = gm.graph
    replaced: Dict[Any, Any] = {}   # a rewritten final -> its call
    for m in matches:
        args = fx.node.map_arg(m.args, lambda a: replaced.get(a, a))
        with g.inserting_before(m.final):
            call = g.call_function(m.executor, args)
        call.meta["val"] = _val(m.final)
        m.final.replace_all_uses_with(call)
        g.erase_node(m.final)
        replaced[m.final] = call
    # interior nodes no longer read by anything go, readers first
    dead = set().union(*(m.chain for m in matches)) if matches else set()
    for n in reversed(list(g.nodes)):
        if n in dead and not n.users:
            g.erase_node(n)
    g.lint()
    gm.recompile()


def export_program(fn, *example_args):
    """``torch.export`` of `fn` (a module or a function) at the example
    arguments, without autograd, decomposed to core ATen."""
    mod = fn if isinstance(fn, torch.nn.Module) else _Fn(fn)
    with torch.no_grad():
        ep = torch.export.export(mod, tuple(example_args), strict=False)
    return ep.run_decompositions()


class _Fn(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def fuse_compile(fn, *example_args) -> Callable:
    """Run `fn`'s static program through the pass (see the module
    docstring). `fn` is a module or a function (exported at
    `example_args`) or an ``ExportedProgram``. Returns a callable over
    the rewritten module with ``.matches`` (the accepted matches'
    reports), ``.n_fused``, ``.found`` / ``.refused`` (counts by pattern)
    and ``.module_text``; with no match it runs the exported module as it
    is."""
    if isinstance(fn, torch.export.ExportedProgram):
        ep = fn
    else:
        ep = export_program(fn, *example_args)
    gm = ep.module()
    found = analyze(gm)
    counts = {p: 0 for p in PATTERNS}
    refused = {p: 0 for p in PATTERNS}
    accepted = []
    for m in found:
        counts[m.pattern] += 1
        if _GATES[m.pattern](m):
            accepted.append(m)
        else:
            refused[m.pattern] += 1
    for i, m in enumerate(accepted):
        m.report["id"] = i
    if accepted:
        _rewrite(gm, accepted)

    def run(*args):
        with torch.no_grad():
            return gm(*args)

    run.module = gm
    run.module_text = gm.code
    run.matches = [m.report for m in accepted]
    run.n_fused = len(accepted)
    run.found = counts
    run.refused = refused
    return run
