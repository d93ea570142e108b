"""Pattern-fusion pass (counterpart of paddle_tpu/jit/fusion.py, the
FLAGS_use_cinn-parity rewrites behind FLAGS_use_fusion_compiler).

The JAX pass matches jaxpr equations. Here the program is the graph that
TorchDynamo captures (``torch.compile(fn, backend=<this pass>)``): torch
functions and tensor methods on fake tensors, one graph per captured
region. The backend finds the five patterns of `PATTERNS`, replaces each
match by one call of a hand-written kernel's wrapper, removes the
interior nodes nothing else reads, and returns the rewritten graph to run
eagerly. Autograd flows through the rewritten calls (the kernels'
autograd Functions) and through everything else as usual; Inductor,
AOTAutograd and code generation are never invoked.

Every kernel wrapper a program can reach is one opaque node of the graph
(``torch._dynamo.allow_in_graph``, registered on first use): given the
capture's fake tensors it returns its plain version's result, so the
pass never sees a kernel's plain version as a pattern.

The patterns, the JAX matchers' rules carried over:

- ``sdpa``: product(softmax(product(q, k) [* scale]), v), unmasked and
  non-causal, einsum or matmul on [B, H, S, D] or [B, S, H, D] operands,
  converts skipped -> ``ops.flash_sdpa(causal=False)`` where
  ``ops.flash_kernel_eligible`` holds;
- ``rmsnorm``: (x32 * rsqrt(mean(x32^2) + eps)) [-> cast] * w ->
  ``ops.fused_rms_norm``;
- ``swiglu``: silu(gate) * up -> ``ops.swiglu``;
- ``bias_residual_ln``: LayerNorm([x + bias] + residual) [* w] [+ lb],
  the centred variance -> ``ops.fused_bias_residual_layer_norm``;
- ``moe_dispatch``: the GShard gate's pair einsum(keep, oh) and
  einsum(gv, keep, oh) -> ``ops.fused_moe_dispatch_combine`` (two
  outputs).

A chain whose interior values are read elsewhere is left alone when
nothing of it would go (fusing would only add work), as in the JAX pass.
Under autograd the JAX pass leaves the norm chains alone: its eager tape
computes rsqrt's derivative from rsqrt's output inside the program, a
second reader. The port reads that condition off the captured values: a
``rmsnorm`` whose result requires grad (``ops.fused_rms_norm`` has no
backward here) and a ``bias_residual_ln`` whose rsqrt requires grad are
not matched. ``moe_dispatch`` matches at every capacity: the JAX matcher
finds the pair only where ``jnp.einsum``'s contraction path scales the
one-hots by the gates (C < E), a fault of the reference that the port
does not copy (ROADMAP.md queue C, C6).

Each pattern's gate is the Hopper kernel's own limit; a match the gate
refuses is left as the program's own ops and counted in
``fuse.refused``. ``fuse.found`` / ``fuse.rewritten`` count matches by
pattern over every captured graph, ``fuse.graphs`` the graphs captured,
and ``fuse.untraced`` the calls that ran with no graph captured (the
capture failed or was given up): they ran as written.
"""

from __future__ import annotations

import functools
import operator
from typing import Any, Callable, Dict, List, Optional, Set

import torch
from torch import fx
from torch.nn import functional as F

from .. import ops

__all__ = ["fuse", "capture", "PATTERNS", "reset_stats", "stats",
           "match_sdpa_patterns", "match_rmsnorm_patterns",
           "match_swiglu_patterns", "match_bias_residual_ln_patterns",
           "match_moe_dispatch_patterns"]


# ---------------------------------------------------------------------------
# graph helpers: torch functions and methods as canonical op kinds
# ---------------------------------------------------------------------------

_FN_KIND = {
    operator.mul: "mul", torch.mul: "mul",
    operator.add: "add", torch.add: "add",
    operator.sub: "sub", torch.sub: "sub",
    operator.truediv: "div", torch.div: "div", torch.true_divide: "div",
    operator.pow: "pow", torch.pow: "pow",
    torch.rsqrt: "rsqrt", torch.square: "square",
    torch.mean: "mean", torch.sum: "sum",
    F.silu: "silu", torch.softmax: "softmax", F.softmax: "softmax",
    torch.einsum: "einsum", operator.matmul: "matmul",
    torch.matmul: "matmul", torch.transpose: "transpose",
    torch.unsqueeze: "unsqueeze",
}
_METHOD_KIND = {
    "mul": "mul", "add": "add", "sub": "sub", "div": "div",
    "true_divide": "div", "pow": "pow", "rsqrt": "rsqrt",
    "square": "square", "mean": "mean", "sum": "sum",
    "softmax": "softmax", "matmul": "matmul", "transpose": "transpose",
    "unsqueeze": "unsqueeze", "float": "convert", "double": "convert",
    "half": "convert", "bfloat16": "convert", "to": "convert",
    "type": "convert", "view": "view", "reshape": "view",
    "expand": "view",
}


def _kind(n) -> Optional[str]:
    if not isinstance(n, fx.Node):
        return None
    if n.op == "call_function":
        k = _FN_KIND.get(n.target)
        if k is None and n.target is operator.getitem:
            return "getitem"
    elif n.op == "call_method":
        k = _METHOD_KIND.get(n.target)
    else:
        return None
    if k in ("add", "sub") and "alpha" in n.kwargs:
        return None
    if k == "div" and n.kwargs.get("rounding_mode") is not None:
        return None
    if k == "pow" and len(n.args) == 2 and n.args[1] == 2:
        return "square"
    if k == "mul" and len(n.args) == 2 and _same(n.args[0], n.args[1]):
        return "square"
    if k == "convert" and n.target == "to" and not _dtype_only(n):
        return None
    return k


def _dtype_only(n) -> bool:
    """A ``to`` call that changes at most the dtype."""
    args = list(n.args[1:]) + [v for k, v in n.kwargs.items()
                               if k in ("dtype", "device")]
    return all(isinstance(a, torch.dtype) for a in args)


def _val(n):
    return n.meta.get("example_value") if isinstance(n, fx.Node) else None


def _shape(n):
    v = _val(n)
    return tuple(v.shape) if isinstance(v, torch.Tensor) else None


def _requires_grad(n) -> bool:
    v = _val(n)
    return isinstance(v, torch.Tensor) and v.requires_grad


def _same(a, b) -> bool:
    """The same value: one node, or two nodes of one op on the same
    operands (captured programs repeat ``x - mean`` as separate nodes)."""
    if a is b:
        return isinstance(a, fx.Node)
    if not (isinstance(a, fx.Node) and isinstance(b, fx.Node)):
        return False
    return (a.op == b.op and a.op in ("call_function", "call_method")
            and a.target == b.target and a.args == b.args
            and a.kwargs == b.kwargs)


def _through_converts(n, chain: Optional[Set] = None):
    """The value behind dtype casts, adding the casts to `chain`."""
    while _kind(n) == "convert":
        if chain is not None:
            chain.add(n)
        n = n.args[0]
    return n


def _is_num(a) -> bool:
    return isinstance(a, (int, float)) and not isinstance(a, bool)


def _mean_last(n, chain: Set):
    """mean(src, -1, keepdim=True), or sum(src, -1, keepdim=True) / N with
    N the last dim: src, else None."""
    k = _kind(n)
    if k == "div" and _is_num(n.args[1]):
        s = n.args[0]
        if _kind(s) != "sum" or not _last_keepdim(s):
            return None
        src = s.args[0]
        if float(n.args[1]) != float(_shape(src)[-1]):
            return None
        chain.update((n, s))
        return src
    if k == "mean" and _last_keepdim(n):
        chain.add(n)
        return n.args[0]
    return None


def _last_keepdim(n) -> bool:
    args = list(n.args[1:])
    dim = n.kwargs.get("dim", args[0] if args else None)
    keep = n.kwargs.get("keepdim", args[1] if len(args) > 1 else False)
    src = _shape(n.args[0])
    if src is None or not keep:
        return False
    if isinstance(dim, (tuple, list)):
        if len(dim) != 1:
            return False
        dim = dim[0]
    return dim in (-1, len(src) - 1)


def _vec_of(n, H: int):
    """The 1-D [H] node behind n (n itself, or its broadcast view [1, ..,
    1, H] / expansion): the JAX matchers' broadcast_in_dim of a
    vector."""
    if not isinstance(n, fx.Node):
        return None, None
    shape = _shape(n)
    if shape == (H,):
        return n, None
    src = n.args[0] if _kind(n) in ("unsqueeze", "view", "getitem") \
        else None
    if isinstance(src, fx.Node) and _shape(src) == (H,) and shape and \
            shape[-1] == H and (n.target == "expand"
                                or all(d == 1 for d in shape[:-1])):
        return src, n
    return None, None


def _removable(chain: Set, finals: Set) -> Set:
    """Interior nodes that go when the finals are replaced: those whose
    every reader is in the chain or a final, transitively (a kept node
    keeps the chain nodes it reads)."""
    keep = {n for n in chain
            if any(u not in chain and u not in finals for u in n.users)}
    changed = True
    while changed:
        changed = False
        for n in list(keep):
            for a in n.all_input_nodes:
                if a in chain and a not in keep:
                    keep.add(a)
                    changed = True
    return chain - keep


def _order(gm: fx.GraphModule) -> Dict[Any, int]:
    return {n: i for i, n in enumerate(gm.graph.nodes)}


# ---------------------------------------------------------------------------
# matchers: each returns matches {"pattern", "finals": [nodes], "chain":
# removable interior nodes, operands...}
# ---------------------------------------------------------------------------

def _einsum_spec(n):
    """(input subscripts, output subscript, operand nodes) of an einsum
    node without ellipses, else None."""
    if _kind(n) != "einsum" or not isinstance(n.args[0], str):
        return None
    ops_ = list(n.args[1:])
    if len(ops_) == 1 and isinstance(ops_[0], (list, tuple)):
        ops_ = list(ops_[0])
    eq = n.args[0].replace(" ", "")
    if "->" not in eq or "." in eq:
        return None
    lhs, out = eq.split("->")
    ins = lhs.split(",")
    if len(ins) != len(ops_):
        return None
    return ins, out, ops_


def _layout(sub: str, b: str, h: str, s: str, d: str) -> Optional[str]:
    if sub == b + h + s + d:
        return "bhsd"
    if sub == b + s + h + d:
        return "bshd"
    return None


def _final_product(n):
    """p @ v as (p, v, v layout, output layout) for an einsum or matmul
    node, else None."""
    spec = _einsum_spec(n)
    if spec is not None:
        ins, out, opnds = spec
        if len(opnds) != 2 or len(ins[0]) != 4:
            return None
        p, v = opnds
        b, h, q, k = ins[0]
        d = [c for c in ins[1] if c not in (b, h, k)]
        if len(d) != 1 or len(set(ins[0])) != 4:
            return None
        vl = _layout(ins[1], b, h, k, d[0])
        ol = _layout(out, b, h, q, d[0])
        if vl is None or ol is None:
            return None
        return p, v, vl, ol
    if _kind(n) == "matmul" and len(n.args) == 2:
        p, v = n.args
        if _shape(p) is not None and len(_shape(p)) == 4 and \
                _shape(v) is not None and len(_shape(v)) == 4:
            return p, v, "bhsd", "bhsd"
    return None


def _logits_product(n):
    """q @ k^T as (q, k, q layout, k layout) for the logits [B, H, Sq,
    Sk] node, else None."""
    spec = _einsum_spec(n)
    if spec is not None:
        ins, out, opnds = spec
        if len(opnds) != 2 or len(out) != 4 or len(set(out)) != 4:
            return None
        b, h, q, k = out
        d = [c for c in ins[0] if c not in (b, h, q)]
        if len(d) != 1:
            return None
        ql = _layout(ins[0], b, h, q, d[0])
        kl = _layout(ins[1], b, h, k, d[0])
        if ql is None or kl is None:
            return None
        return opnds[0], opnds[1], ql, kl
    if _kind(n) == "matmul" and len(n.args) == 2:
        q, kt = n.args
        if _kind(kt) == "transpose" and len(kt.args) == 3 and \
                _shape(q) is not None and len(_shape(q)) == 4 and \
                sorted(d % 4 for d in kt.args[1:]) == [2, 3]:
            return q, kt.args[0], "bhsd", "bhsd"
    return None


def match_sdpa_patterns(gm: fx.GraphModule) -> List[dict]:
    """Unmasked, non-causal softmax attention chains (see the module
    docstring)."""
    matches = []
    for fin in gm.graph.nodes:
        fp = _final_product(fin)
        if fp is None:
            continue
        p, v, vl, ol = fp
        chain: Set = set()
        sm = _through_converts(p, chain)
        if _kind(sm) != "softmax":
            continue
        dim = sm.kwargs.get("dim", sm.args[1] if len(sm.args) > 1 else None)
        if dim not in (-1, 3):
            continue
        chain.add(sm)
        lg = _through_converts(sm.args[0], chain)
        scale = 1.0
        if _kind(lg) == "mul":
            a, b = lg.args
            if _is_num(b) and isinstance(a, fx.Node):
                scale, inner = float(b), a
            elif _is_num(a) and isinstance(b, fx.Node):
                scale, inner = float(a), b
            else:
                continue
            chain.add(lg)
            lg = inner
        lp = _logits_product(lg)
        if lp is None:
            continue
        chain.add(lg)
        q, k, ql, kl = lp
        if _kind(lg) == "matmul":
            chain.add(lg.args[1])  # the transpose of k
        kept = _removable(chain, {fin})
        if not kept:
            continue
        matches.append({"pattern": "sdpa", "finals": [fin], "chain": kept,
                        "q": q, "k": k, "v": v, "scale": scale,
                        "layouts": (ql, kl, vl, ol)})
    return matches


def match_rmsnorm_patterns(gm: fx.GraphModule) -> List[dict]:
    """(x32 * rsqrt(mean(square(x32)) + eps)) [-> cast] * w, w [H]."""
    matches = []
    for r in gm.graph.nodes:
        if _kind(r) != "rsqrt":
            continue
        chain: Set = {r}
        add = r.args[0]
        if _kind(add) != "add":
            continue
        lits = [a for a in add.args if _is_num(a)]
        var = [a for a in add.args if isinstance(a, fx.Node)]
        if len(lits) != 1 or len(var) != 1:
            continue
        eps = float(lits[0])
        chain.add(add)
        sq = _mean_last(var[0], chain)
        if sq is None or _kind(sq) != "square":
            continue
        chain.add(sq)
        x32 = sq.args[0]
        x = _through_converts(x32, chain)
        H = _shape(x)[-1] if _shape(x) else None
        if len(r.users) != 1:
            continue
        mul = next(iter(r.users))
        if _kind(mul) != "mul":
            continue
        other = [a for a in mul.args if a is not r]
        if len(other) != 1 or _through_converts(other[0], chain) is not x:
            continue
        chain.add(mul)
        nv = mul
        if len(nv.users) != 1:
            continue
        nxt = next(iter(nv.users))
        if _kind(nxt) == "convert":
            chain.add(nxt)
            nv = nxt
            if len(nv.users) != 1:
                continue
            nxt = next(iter(nv.users))
        if _kind(nxt) != "mul":
            continue
        side = [a for a in nxt.args if a is not nv]
        if len(side) != 1:
            continue
        w, bc = _vec_of(side[0], H)
        if w is None:
            continue
        if bc is not None:
            chain.add(bc)
        if _requires_grad(nxt):
            continue  # under autograd: see the module docstring
        kept = _removable(chain, {nxt})
        if not kept:
            continue
        matches.append({"pattern": "rmsnorm", "finals": [nxt],
                        "chain": kept, "x": x, "w": w, "eps": eps})
    return matches


def match_swiglu_patterns(gm: fx.GraphModule) -> List[dict]:
    """silu(gate) * up, both of one shape."""
    matches = []
    for m in gm.graph.nodes:
        if _kind(m) != "mul" or len(m.args) != 2:
            continue
        for a, b in ((m.args[0], m.args[1]), (m.args[1], m.args[0])):
            if _kind(a) != "silu" or not isinstance(b, fx.Node) or \
                    a.kwargs.get("inplace", False):
                continue
            if _shape(a) != _shape(b):
                continue
            kept = _removable({a}, {m})
            if not kept:
                continue
            matches.append({"pattern": "swiglu", "finals": [m],
                            "chain": kept, "gate": a.args[0], "up": b})
            break
    return matches


def match_bias_residual_ln_patterns(gm: fx.GraphModule) -> List[dict]:
    """LayerNorm(h) [* w] [+ lb] with h = [x + bias] + residual: the
    eval form of paddle's fused_bias_dropout_residual_layer_norm."""
    matches = []
    for r in gm.graph.nodes:
        if _kind(r) != "rsqrt":
            continue
        chain: Set = {r}
        add = r.args[0]
        if _kind(add) != "add":
            continue
        lits = [a for a in add.args if _is_num(a)]
        var = [a for a in add.args if isinstance(a, fx.Node)]
        if len(lits) != 1 or len(var) != 1:
            continue
        eps = float(lits[0])
        chain.add(add)
        sq = _mean_last(var[0], chain)
        if sq is None or _kind(sq) != "square":
            continue
        chain.add(sq)
        c = sq.args[0]
        if _kind(c) != "sub":
            continue
        h, mu = c.args
        if not isinstance(h, fx.Node) or not isinstance(mu, fx.Node):
            continue
        chain.update(a for a in sq.args if isinstance(a, fx.Node))
        if _mean_last(mu, chain) is not h:
            continue
        if len(r.users) != 1:
            continue
        mul = next(iter(r.users))
        if _kind(mul) != "mul":
            continue
        other = [a for a in mul.args if a is not r]
        if len(other) != 1 or not _same(other[0], c):
            continue
        if _requires_grad(r):
            continue  # under autograd: see the module docstring
        chain.update((other[0], mul))
        H = _shape(h)[-1]
        final = nv = mul
        w = lb = None
        if len(nv.users) == 1 and _kind(next(iter(nv.users))) == "mul":
            e = next(iter(nv.users))
            side = [a for a in e.args if a is not nv]
            wv, bc = _vec_of(side[0], H) if len(side) == 1 else (None, None)
            if wv is not None:
                w = wv
                chain.add(e)
                if bc is not None:
                    chain.add(bc)
                final = nv = e
        if len(nv.users) == 1 and _kind(next(iter(nv.users))) == "add":
            e = next(iter(nv.users))
            side = [a for a in e.args if a is not nv]
            bv, bc = _vec_of(side[0], H) if len(side) == 1 else (None, None)
            if bv is not None:
                lb = bv
                chain.add(e)
                if bc is not None:
                    chain.add(bc)
                final = e
        # upstream: h = add(g, residual), g = add(x, bias) optional
        if _kind(h) != "add":
            continue
        a0, a1 = h.args
        if not isinstance(a0, fx.Node) or not isinstance(a1, fx.Node) or \
                _shape(a0) != _shape(a1):
            continue
        chain.add(h)
        x, res, bias = a0, a1, None
        if _kind(a0) == "add" and all(isinstance(a, fx.Node)
                                      for a in a0.args):
            bv, bc = _vec_of(a0.args[1], H)
            other_side = a0.args[0]
            if bv is None:
                bv, bc = _vec_of(a0.args[0], H)
                other_side = a0.args[1]
            if bv is not None:
                x, bias = other_side, bv
                chain.add(a0)
                if bc is not None:
                    chain.add(bc)
        chain.discard(final)
        kept = _removable(chain, {final})
        if not kept:
            continue
        matches.append({"pattern": "bias_residual_ln", "finals": [final],
                        "chain": kept, "x": x, "residual": res,
                        "bias": bias, "w": w, "lnb": lb, "eps": eps})
    return matches


def _pair_roles(ins, out, opnds):
    """(keep, oh) of a two-operand "tke,tkc->tec" einsum, else None."""
    if len(opnds) != 2 or len(ins) != 2 or len(out) != 3:
        return None
    a, b = ins
    if len(a) != 3 or len(b) != 3 or a[:2] != b[:2] or a[2] == b[2] \
            or out != a[0] + a[2] + b[2] or a[0] == a[1]:
        return None
    return opnds[0], opnds[1]


def match_moe_dispatch_patterns(gm: fx.GraphModule) -> List[dict]:
    """dispatch = einsum("tke,tkc->tec", keep, oh) beside combine =
    einsum over keep, oh and the gates gv [T, k]: the three-operand
    einsum, or the pair einsum on keep and gv[..., None] * oh."""
    order = _order(gm)
    pairs, combines = [], []
    for n in gm.graph.nodes:
        spec = _einsum_spec(n)
        if spec is None:
            continue
        ins, out, opnds = spec
        roles = _pair_roles(ins, out, opnds)
        if roles is not None:
            pairs.append((n, roles))
        if len(opnds) == 3 and len(out) == 3:
            two = [i for i, s in enumerate(ins) if len(s) == 2]
            three = [i for i, s in enumerate(ins) if len(s) == 3]
            if len(two) == 1 and len(three) == 2:
                t, k = ins[two[0]]
                a, b = (ins[i] for i in three)
                r = _pair_roles([a, b], out, [opnds[i] for i in three])
                if r is not None and a[:2] == t + k:
                    combines.append((n, r[0], r[1], opnds[two[0]], None))
    for n, (keep, s) in pairs:
        # the two-step combine: gv[..., None] * oh as the pair's rhs
        if _kind(s) != "mul" or len(s.args) != 2:
            continue
        for oh, g in ((s.args[0], s.args[1]), (s.args[1], s.args[0])):
            if not isinstance(g, fx.Node) or _kind(g) not in \
                    ("unsqueeze", "getitem", "view"):
                continue
            gv = g.args[0]
            if isinstance(gv, fx.Node) and _shape(gv) is not None and \
                    len(_shape(gv)) == 2 and _shape(g) == _shape(gv) + (1,):
                combines.append((n, keep, oh, gv, s))
                break
    matches = []
    for cmb, keep, oh, gv, scale in combines:
        for disp, (k2, o2) in pairs:
            if disp is cmb or k2 is not keep or o2 is not oh:
                continue
            first = min(order[disp], order[cmb])
            if isinstance(gv, fx.Node) and order.get(gv, -1) > first:
                continue  # the kernel runs at the first final
            chain: Set = set()
            if scale is not None:
                if set(scale.users) != {cmb}:
                    continue
                chain = {scale}
            matches.append({"pattern": "moe_dispatch",
                            "finals": [disp, cmb], "chain": chain,
                            "keep": keep, "ohk": oh, "gv": gv})
            break
    return matches


# ---------------------------------------------------------------------------
# the Hopper gates and the executors (run eagerly by the rewritten graph)
# ---------------------------------------------------------------------------

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _dtypes_ok(*nodes) -> bool:
    return all(_val(n) is None or _val(n).dtype in _KERNEL_DTYPES
               for n in nodes if isinstance(n, fx.Node))


def _sdpa_ok(m) -> bool:
    q, k, v = (_val(m[x]) for x in ("q", "k", "v"))
    if any(t is None or t.dim() != 4 for t in (q, k, v)):
        return False
    ql, kl, vl, _ = m["layouts"]

    def bshd(t, lay):
        return tuple(t.shape) if lay == "bshd" else \
            (t.shape[0], t.shape[2], t.shape[1], t.shape[3])
    qs, ks, vs = bshd(q, ql), bshd(k, kl), bshd(v, vl)
    return (q.dtype == k.dtype == v.dtype and q.dtype in _KERNEL_DTYPES
            and qs[0] == ks[0] == vs[0] and qs[2] == ks[2] == vs[2]
            and ks[1] == vs[1] and qs[3] == ks[3] == vs[3]
            and ops.flash_kernel_eligible(qs[1], ks[1], qs[3]))


def _rms_ok(m) -> bool:
    return _dtypes_ok(m["x"], m["w"])


def _swiglu_ok(m) -> bool:
    g, u = _val(m["gate"]), _val(m["up"])
    return g is not None and u is not None and g.dtype == u.dtype \
        and g.dtype in _KERNEL_DTYPES


def _brln_ok(m) -> bool:
    x, r = _val(m["x"]), _val(m["residual"])
    return (x is not None and r is not None and x.dtype == r.dtype
            and _dtypes_ok(m["x"], m["bias"], m["w"], m["lnb"]))


def _moe_ok(m) -> bool:
    keep, oh = _shape(m["keep"]), _shape(m["ohk"])
    return (_dtypes_ok(m["keep"], m["ohk"], m["gv"])
            and ops.moe_dc_eligible(keep[1], keep[2], oh[2]))


def _to_bshd(t, lay):
    return t if lay == "bshd" else t.transpose(1, 2)


def _exec_sdpa(q, k, v, scale, layouts, dtype):
    ql, kl, vl, ol = layouts
    o = ops.flash_sdpa(_to_bshd(q, ql), _to_bshd(k, kl), _to_bshd(v, vl),
                       causal=False, scale=scale)
    return _to_bshd(o, ol).to(dtype)


def _exec_rmsnorm(x, w, eps, dtype):
    return ops.fused_rms_norm(x, w, eps=eps).to(dtype)


def _exec_swiglu(gate, up, dtype):
    return ops.swiglu(gate, up).to(dtype)


def _exec_brln(x, residual, bias, w, lnb, eps, dtype):
    return ops.fused_bias_residual_layer_norm(
        x, residual, bias=bias, weight=w, ln_bias=lnb, eps=eps).to(dtype)


def _exec_moe_dispatch(keep, ohk, gv, dtypes):
    d, c = ops.fused_moe_dispatch_combine(keep, ohk, gv)
    return d.to(dtypes[0]), c.to(dtypes[1])


def _args_sdpa(m):
    return (m["q"], m["k"], m["v"], m["scale"], m["layouts"])


def _args_rms(m):
    return (m["x"], m["w"], m["eps"])


def _args_swiglu(m):
    return (m["gate"], m["up"])


def _args_brln(m):
    return (m["x"], m["residual"], m["bias"], m["w"], m["lnb"], m["eps"])


def _args_moe(m):
    return (m["keep"], m["ohk"], m["gv"])


# The pattern table (the JAX package's PATTERNS, jit/fusion.py:685-695):
# matcher, Hopper gate, executor, executor operands. Extending the pass =
# adding a row; the first pattern wins on overlapping regions.
PATTERNS: Dict[str, tuple] = {
    "sdpa": (match_sdpa_patterns, _sdpa_ok, _exec_sdpa, _args_sdpa),
    "rmsnorm": (match_rmsnorm_patterns, _rms_ok, _exec_rmsnorm, _args_rms),
    "swiglu": (match_swiglu_patterns, _swiglu_ok, _exec_swiglu,
               _args_swiglu),
    "bias_residual_ln": (match_bias_residual_ln_patterns, _brln_ok,
                         _exec_brln, _args_brln),
    "moe_dispatch": (match_moe_dispatch_patterns, _moe_ok,
                     _exec_moe_dispatch, _args_moe),
}


# ---------------------------------------------------------------------------
# the rewrite and the capture
# ---------------------------------------------------------------------------

def _new_counts() -> Dict[str, int]:
    return {name: 0 for name in PATTERNS}


def reset_stats() -> None:
    """Set every count of `fuse` to 0."""
    fuse.found = _new_counts()
    fuse.rewritten = _new_counts()
    fuse.refused = _new_counts()
    fuse.graphs = 0
    fuse.untraced = 0


def stats() -> Dict[str, Any]:
    """A copy of `fuse`'s counts."""
    return {"found": dict(fuse.found), "rewritten": dict(fuse.rewritten),
            "refused": dict(fuse.refused), "graphs": fuse.graphs,
            "untraced": fuse.untraced}


def _rewrite(gm: fx.GraphModule) -> fx.GraphModule:
    """Match every pattern, replace each accepted match by its executor,
    drop the interior nodes nothing else reads."""
    claimed: Set = set()
    interior: Set = set()
    accepted = []
    for name, (matcher, eligible, _, operands) in PATTERNS.items():
        for m in matcher(gm):
            fuse.found[name] += 1
            span = set(m["chain"]) | set(m["finals"])
            if span & claimed or interior.intersection(operands(m)):
                # the first match wins on overlapping regions, and a match
                # cannot read a value an earlier one removes
                continue
            if not eligible(m):
                fuse.refused[name] += 1
                continue
            claimed |= span
            interior |= set(m["chain"])
            accepted.append(m)
    order = _order(gm)
    g = gm.graph
    replaced: Dict[Any, Any] = {}  # a rewritten final -> its new node

    def current(a):
        while a in replaced:
            a = replaced[a]
        return a

    for m in accepted:
        name = m["pattern"]
        _, _, executor, operands = PATTERNS[name]
        finals = m["finals"]
        first = min(finals, key=lambda n: order[n])
        dtypes = [_val(f).dtype for f in finals]
        extra = (tuple(dtypes),) if len(finals) > 1 else (dtypes[0],)
        args = tuple(current(a) if isinstance(a, fx.Node) else a
                     for a in operands(m))
        with g.inserting_before(first):
            call = g.call_function(executor, args + extra)
            outs = [call]
            if len(finals) > 1:
                outs = [g.call_function(operator.getitem, (call, i))
                        for i in range(len(finals))]
        for f, o in zip(finals, outs):
            o.meta["example_value"] = _val(f)
            f.replace_all_uses_with(o)
            replaced[f] = o
        for n in sorted(set(finals) | set(m["chain"]),
                        key=lambda n: -order[n]):
            if not n.users:
                g.erase_node(n)
        fuse.rewritten[name] += 1
    gm.recompile()
    return gm


def _register_opaque() -> None:
    """Every kernel wrapper a captured program can reach becomes one
    opaque graph node (each returns its plain version's result on the
    capture's fake tensors)."""
    import torch._dynamo
    for fn in (ops.fused_rms_norm, ops.fused_layer_norm, ops.flash_sdpa,
               ops.flashmask_sdpa, ops.gmm, ops.weight_only_linear,
               ops.swiglu, ops.fused_rope,
               ops.fused_bias_residual_layer_norm,
               ops.fused_moe_dispatch_combine):
        torch._dynamo.allow_in_graph(fn)


class _Backend:
    """The capture's backend: counts the graph, rewrites it when `enabled`
    (a callable read at each capture) says so, returns it to run
    eagerly."""

    def __init__(self, enabled: Callable[[], bool]):
        self.enabled = enabled
        self.captured = 0

    def __call__(self, gm: fx.GraphModule, example_inputs):
        self.captured += 1
        fuse.graphs += 1
        if self.enabled():
            gm = _rewrite(gm)
        return gm.forward


def _recompile_limit():
    """A patch of Dynamo's per-code recompile limit, high enough for a
    program captured under several backends and grad modes."""
    import torch._dynamo
    cfg = torch._dynamo.config
    name = "recompile_limit" if hasattr(cfg, "recompile_limit") \
        else "cache_size_limit"
    return cfg.patch(**{name: max(getattr(cfg, name), 64)})


def capture(fn, enabled: Callable[[], bool]):
    """`fn` under TorchDynamo capture with the pass as its backend; the
    returned callable counts `fuse.untraced` when a call captured no
    graph and ran `fn` as written."""
    backend = _Backend(enabled)
    compiled = None

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        nonlocal compiled
        import torch._dynamo
        if compiled is None:
            _register_opaque()
            compiled = torch.compile(fn, backend=backend, dynamic=False)
        before = backend.captured
        first = before == 0
        try:
            with _recompile_limit():
                out = compiled(*args, **kwargs)
        except torch._dynamo.exc.TorchDynamoException:
            # as the JAX pass runs fn untouched when tracing fails
            fuse.untraced += 1
            return fn(*args, **kwargs)
        if first and backend.captured == before:
            fuse.untraced += 1
        return out

    return wrapped


def fuse(fn):
    """Transform: rewrite the recognised patterns of `fn`'s captured
    program into the hand-written kernels (the CINN "replace a fused group
    with a kernel op" step); everything else runs as written. Counts in
    ``fuse.found`` / ``rewritten`` / ``refused`` (by pattern),
    ``fuse.graphs`` and ``fuse.untraced``."""
    return capture(fn, lambda: True)


reset_stats()
