#!/usr/bin/env python3
"""Readings of the bf16 megadecode kernels (fused_oproj_norm, fused_ffn)
on one NVIDIA card: for the sound kernels, for planted faults and for
another commit's kernels.

    python3 mega_limits.py [--faults DIR] [--parent DIR] [--out FILE]

``chip_smoke.py`` phase 2 holds each bf16 site of the two kernels to its
plain version by two relative errors (`chip_smoke.row_rel_errors` over
`chip_smoke.quant_site_rows`: over the whole output and the largest
over each token's row) within ``QSITE_BF16_LIMITS``. This script draws
phase 2's shapes (`CASES`: the Llama-3-8B step, T = 132, swiglu fp /
int8 / int4 and the rms o-proj fp / int8 / int4; GPT-3 6.7B's gelu FFN
with b1 / b2 and its layer-norm o-proj with a bias; the same 8B fp
sites at four decode rows) and prints, for each, those two errors, the
largest absolute error, whether the output is finite and whether phase
2's check passes. Timed (``--parent``), each case also
reads the kernel's time (median of 25 after the L2 scrub) beside its
bound, its plain version's and the split chain's calls' time, the CUDA
kernels one call launches (counted by torch.profiler), and, from the
launch plan (csrc/megadecode_sm90.cu's ``ptt_md_plan``; arithmetic, not a
reading), the activation bytes an SM asks of L2 per weight byte it
streams. Beside them, the card tests of the two kernels
(``tests/test_torch_megakernels.py -m cuda -k "oproj or ffn or Bf16"``),
passed and failed.

With ``--faults DIR``, each fault of `FAULTS` (text substitutions in
``paddle_tpu_torch/ops/csrc/megadecode_sm90.cu``) is planted in a copy
of the package made under DIR, built there, and read the same way in a
process of its own (untimed). With ``--parent DIR``, DIR holds a
checkout of another commit (``git archive``): this script is copied into
it, and the timed readings are taken there and here in the order parent,
this, this, parent, each in a process of its own. The checkout itself
is never changed. One JSON
object per line on stdout, and all of them in ``--out`` when given.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

import flash_limits

KERNEL = "paddle_tpu_torch/ops/csrc/megadecode_sm90.cu"
TEST = ("tests/test_torch_megakernels.py", "oproj or ffn or Bf16")
FILES = ("chip_smoke.py", "flash_limits.py", "mega_limits.py",
         "pytest.ini", TEST[0])
INT8, INT4 = "weight_only_int8", "weight_only_int4"
#: name -> (kernel, algo, act / norm, T, K, N of the site's products)
CASES = {
    "ffn_swiglu_fp": ("ffn", None, "swiglu", 132, 4096, 14336),
    "ffn_swiglu_int8": ("ffn", INT8, "swiglu", 132, 4096, 14336),
    "ffn_swiglu_int4": ("ffn", INT4, "swiglu", 132, 4096, 14336),
    "ffn_gelu_fp": ("ffn", None, "gelu", 132, 4096, 16384),
    "oproj_rms_fp": ("oproj", None, "rms", 132, 4096, 4096),
    "oproj_rms_int8": ("oproj", INT8, "rms", 132, 4096, 4096),
    "oproj_rms_int4": ("oproj", INT4, "rms", 132, 4096, 4096),
    "oproj_layer_fp": ("oproj", None, "layer", 132, 4096, 4096),
    "ffn_swiglu_fp_t4": ("ffn", None, "swiglu", 4, 4096, 14336),
    "oproj_rms_fp_t4": ("oproj", None, "rms", 4, 4096, 4096),
}
#: name -> (what it breaks, then (text, replacement, which occurrence
#: (0-based)) substitutions)
FAULTS = {
    "k_slice_dropped": (
        "the last arrival sums every slab of its item but the first (K "
        "slice 0's sums, of gate where gate and up are slabs)",
        "            if (s0 + k >= slabs) break;",
        "            if (s0 + k >= slabs) break;\n"
        "            if (s0 + k == 0) continue;", 0),
    "lo_plane_dropped": (
        "C2 back: the activation reaches the down product as its bf16 hi "
        "plane alone (the lo plane stored as zeros)",
        "*reinterpret_cast<uint2*>(out + plane + at) = make_uint2(lo[0], "
        "lo[1]);",
        "*reinterpret_cast<uint2*>(out + plane + at) = make_uint2(0u, 0u);",
        0),
    "scale_folded_into_bf16_weight": (
        "int8 and int4: each column's scale multiplies the bf16 weight "
        "pairs built in registers (bf16(q * s)) and not the f32 sums",
        "template <int WQ, int NT, int NA, int GS, int TPW>\n"
        "__device__ __forceinline__ void group(uint32_t (&a)[GS][TPW][4],",
        "template <int WQ, int NT, int NA, int GS, int TPW>\n"
        "__device__ __forceinline__ void group(const uint32_t (&sf)[TPW][2],"
        "\n                                      uint32_t (&a)[GS][TPW][4],",
        0,
        "    build<WQ == kInt4, TPW>(a[s], wb, s0 + s, c, o0, o1);\n"
        "  wg_fence();",
        "    build<WQ == kInt4, TPW>(a[s], wb, s0 + s, c, o0, o1);\n"
        "#pragma unroll\n  for (int s = 0; s < GS; ++s)\n"
        "#pragma unroll\n    for (int t = 0; t < TPW; ++t)\n"
        "#pragma unroll\n      for (int i = 0; i < 4; ++i) {\n"
        "        __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>("
        "&a[s][t][i]);\n"
        "        v = __hmul2(v, *reinterpret_cast<const __nv_bfloat162*>("
        "&sf[t][i & 1]));\n"
        "        a[s][t][i] = *reinterpret_cast<uint32_t*>(&v);\n      }\n"
        "  wg_fence();", 0,
        "    const int c0 = ks * p.per, c1 = min(c0 + p.per, p.nk);\n"
        "    int prev = -1;",
        "    const int c0 = ks * p.per, c1 = min(c0 + p.per, p.nk);\n"
        "    int prev = -1;\n    uint32_t sf[TPW][2];\n"
        "    for (int tl = 0; tl < TPW; ++tl)\n"
        "      for (int h = 0; h < 2; ++h) {\n"
        "        const int n = ct * G::BN + lw * G::WCOLS + colw + "
        "coff(tl, h);\n"
        "        const float* scm = e.scale[DUAL ? mm : mt];\n"
        "        const float s = scm && n < p.N ? scm[n] : 1.f;\n"
        "        const __nv_bfloat162 v = __floats2bfloat162_rn(s, s);\n"
        "        sf[tl][h] = *reinterpret_cast<const uint32_t*>(&v);\n"
        "      }", 0,
        "group<WQ, NT, NA, GS, TPW>(a0,", "group<WQ, NT, NA, GS, TPW>(sf, a0,",
        0,
        "group<WQ, NT, NA, GS, TPW>(a1,", "group<WQ, NT, NA, GS, TPW>(sf, a1,",
        0,
        "    for (int k = 0; k < 4; ++k) v[k] *= __ldg(s0 + n + k);",
        "    for (int k = 0; k < 4; ++k) v[k] *= 1.f;", 0,
        "const float uk = s1 ? u[k] * __ldg(s1 + n + k) : u[k];",
        "const float uk = u[k];", 0),
    "norm_on_rounded_x_new": (
        "the o-proj's norm is taken on the rounded x_new, not on the f32 "
        "sum",
        "      const float s = __bfloat162float(xb[i]) + v;",
        "      const float s = __bfloat162float(\n"
        "          __float2bfloat16(__bfloat162float(xb[i]) + v));", 0),
    "last_token_tile_unwritten": (
        "rows of the last token tile (past the first) are never stored",
        "  const size_t at = (size_t)tok * p.N + n;\n"
        "  const float* s0 = e.scale[0];",
        "  const size_t at = (size_t)tok * p.N + n;\n"
        "  if (p.n_tt > 1 && tok >= 136 * (p.n_tt - 1)) return;\n"
        "  const float* s0 = e.scale[0];", 0),
}


def _rnd(g, *shape, scale=1.0, shift=0.0, dtype=torch.bfloat16):
    return (torch.randn(*shape, device="cuda", generator=g) * scale
            + shift).to(dtype)


def build_case(name, g):
    """(call, plain version, split chain's calls, bound (ms, by), product
    shapes) of case `name`, drawn from `g` as chip_smoke phase 2 draws its
    sites (weights at scale K^-0.5)."""
    import chip_smoke as cs
    from paddle_tpu_torch import ops
    kind, algo, what, T, K, N = CASES[name]
    F = torch.nn.functional

    def quantized(k, n):
        w = torch.randn(k, n, device="cuda", generator=g) * k ** -0.5
        if algo is None:
            return w.to(torch.bfloat16), None
        return ops.weight_quantize(w, algo)

    def dq(w, s):
        return w if algo is None else \
            ops.weight_dequantize(w, s, algo).to(torch.bfloat16)

    if kind == "oproj":
        layer = what == "layer"
        x = _rnd(g, T, N, shift=3.0 if layer else 0.0)
        o, nw = _rnd(g, T, K), _rnd(g, N)
        w, s = quantized(K, N)
        b, nb = (_rnd(g, N), _rnd(g, N)) if layer else (None, None)
        kw = dict(eps=1e-5, norm=what, algo=algo)
        args = (o, x, w, s, b, nw, nb)

        def call():
            return ops.fused_oproj_norm(*args, **kw)

        def plain():
            return ops.oproj_norm_reference(*args, **kw)

        wd = dq(w, s)
        if layer:
            def split():
                return ops.fused_layer_norm(x + (o @ wd + b), nw, nb, 1e-5)
        else:
            def split():
                return ops.fused_rms_norm(x + o @ wd, nw, 1e-5)
        bnd = cs.bound(cs.nbytes(*(t for t in args if t is not None))
                       + 2 * cs.nbytes(x), 2 * T * K * N)
        return call, plain, split, bnd, [(N, K, False, 1)]
    gelu = what == "gelu"
    hh, x = _rnd(g, T, K), _rnd(g, T, K)
    I = N
    wg, sg = quantized(K, I)
    wu, su = (None, None) if gelu else quantized(K, I)
    wdn, sd = quantized(I, K)
    b1, b2 = (_rnd(g, I), _rnd(g, K)) if gelu else (None, None)
    args = (hh, x, wg, sg, wu, su, wdn, sd, b1, b2)
    kw = dict(act=what, algo=algo)

    def call():
        return ops.fused_ffn(*args, **kw)

    def plain():
        return ops.megadecode_ffn_reference(*args, **kw)

    g_, u_, d_ = dq(wg, sg), None if gelu else dq(wu, su), dq(wdn, sd)
    if gelu:
        def split():
            return x + (F.gelu(hh @ g_ + b1, approximate="tanh") @ d_ + b2)
    else:
        def split():
            return x + (F.silu(hh @ g_) * (hh @ u_)) @ d_
    bnd = cs.bound(cs.nbytes(*(t for t in args if t is not None))
                   + cs.nbytes(x), (1 if gelu else 2) * 2 * T * K * I
                   + 2 * T * I * K)
    return call, plain, split, bnd, [(I, K, not gelu, 1), (K, I, False, 2)]


def cuda_launches(fn) -> int:
    """CUDA kernels of the port's libraries (namespace ptt) that one call
    of `fn` launches, counted by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "ptt" in e.name)


def l2_act_per_weight_byte(T, products, algo):
    """From the launch plan: each product's activation bytes an SM asks
    of L2 (its token tile's rows, every plane) per weight byte it
    streams; None where this tree has no plan entry."""
    from paddle_tpu_torch.ops import megadecode as md
    from paddle_tpu_torch.ops.quant import WFMT
    if not hasattr(md, "md_plan"):
        return None
    wbytes = {None: 2.0, INT8: 1.0, INT4: 0.5}[algo]
    out = []
    for N, K, pair, planes in products:
        nt = md.md_plan(
            T, N, K, WFMT[algo], pair, planes, torch.device("cuda"))[0]
        # a CTA's weight columns over every matrix it streams (csrc note):
        # 256 below the 136-row tile and for fp's gate / up pair, else 128
        cols = 256 if nt <= 64 or (algo is None and pair) else 128
        out.append(round(nt * 2.0 * planes / (cols * wbytes), 4))
    return out


def read_case(name, g, timer=None):
    import chip_smoke as cs
    kind = CASES[name][0]
    site = "fused_ffn" if kind == "ffn" else "fused_oproj_norm"
    call, plain, split, (bnd, by), products = build_case(name, g)
    got = call()
    torch.cuda.synchronize()
    want = plain()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    a, w = torch.cat(got, 1), torch.cat(want, 1)
    tensor, row = cs.row_rel_errors(a, w)
    lt, lr = cs.QSITE_BF16_LIMITS[site]
    finite = bool(torch.isfinite(a).all())
    r = {"tensor": tensor, "row": row, "max_abs_err": cs.max_err(a, w),
         "finite": finite,
         "phase2_passes": finite and tensor <= lt and row <= lr}
    if timer is not None:
        r["ms"] = timer.ms(call)
        r["bound_ms"], r["bound_by"] = bnd, by
        r["plain_ms"] = timer.ms(plain)
        r["split_ms"] = timer.ms(split)
        r["cuda_launches"] = cuda_launches(call)
        r["l2_act_per_weight_byte"] = l2_act_per_weight_byte(
            CASES[name][3], products, CASES[name][1])
    return r


def readings(timed: bool = False) -> dict:
    """Every reading of the checkout this process runs in."""
    import chip_smoke as cs
    from paddle_tpu_torch import card_report, ops
    from paddle_tpu_torch.ops import _build

    cs.DEV = "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.library()
    out = {"package": str(Path(ops.__file__).resolve().parent.parent),
           "card": card_report()["nvidia_smi"], "cases": {}}
    timer = cs.Timer() if timed else None
    for name in CASES:
        g = torch.Generator("cuda").manual_seed(sorted(CASES).index(name))
        out["cases"][name] = read_case(name, g, timer)
    out["phase2_passes"] = all(c["phase2_passes"]
                               for c in out["cases"].values())
    return out


def card_tests(cwd: Path) -> dict:
    return {f"{TEST[0]} -k {TEST[1]}": flash_limits.card_tests(cwd, *TEST)}


def run_readings(cwd: Path, *flags: str) -> dict:
    """`readings` in a process of its own, in checkout `cwd`."""
    r = subprocess.run([sys.executable, "mega_limits.py",
                        "--readings-only", *flags], cwd=cwd,
                       capture_output=True, text=True, timeout=900)
    if r.returncode != 0:
        return {"rc": r.returncode, "stderr_tail": r.stderr[-2000:]}
    return json.loads(r.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--faults", type=Path, default=None,
                    help="plant each fault in a copy under this directory")
    ap.add_argument("--only", default=None, nargs="+",
                    choices=sorted(FAULTS), help="plant these faults only")
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout of another commit to time against")
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--readings-only", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--timed", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("mega_limits.py: no CUDA device", file=sys.stderr)
        return 2
    if args.readings_only:
        print(json.dumps(readings(args.timed)), flush=True)
        return 0
    here = flash_limits.HERE
    lines = []

    def put(res):
        lines.append(res)
        print(json.dumps(res), flush=True)

    if args.parent is not None:
        parent = args.parent.resolve()
        shutil.copy2(here / "mega_limits.py", parent / "mega_limits.py")
        for tag, cwd in (("parent", parent), ("this", here),
                         ("this", here), ("parent", parent)):
            put(dict(name=f"timed_{tag}", **run_readings(cwd, "--timed")))
    if args.parent is None:
        put(dict(name="sound", **run_readings(here),
                 card_tests=card_tests(here)))
    for name in ((args.only or FAULTS) if args.faults else ()):
        cwd = flash_limits.plant(name, args.faults.resolve(), FAULTS,
                                 KERNEL, FILES)
        put(dict(name=name, breaks=FAULTS[name][0], **run_readings(cwd),
                 card_tests=card_tests(cwd)))
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
