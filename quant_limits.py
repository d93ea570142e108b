#!/usr/bin/env python3
"""Readings of the bf16 weight_only_linear, quantized megakernel and MLA
kernel checks on one NVIDIA card, for the sound kernels and for planted
faults.

    python3 quant_limits.py [--faults DIR [--only FAULT ...]] [--out FILE]
    python3 quant_limits.py --splits [--out FILE]

``chip_smoke.py`` holds the bf16 weight_only_linear kernel, and the
megakernels' int8 / int4 sites, to their plain versions by two relative
errors (`chip_smoke.row_rel_errors`: over the whole output, and the
largest over each output row). This script prints what those measures
read at the shapes phase 2 runs (weight_only_linear at T = 132 x [4096
-> 14336], M = 5 x [4096 -> 128256], M = 4 x [4096 -> 14336] (a K
split), 7 x [4096 -> 1000]; the three megakernels at the 8B step), int8
and int4, and the MLA slice's kernels as `chip_smoke.check_mla_kernels`
reads them at DeepSeek-V2-Lite's shapes (int4_dequantize, the MLA site
of fused_qkv_rope_append, mla_decode_attention, ragged at D 576, flash
at D 192, not held), plus the share of mla_decode_attention's bf16
outputs that differ from the plain version's where both round p against
the same maximum (`MLA_P_CASE`), so that each limit can sit between the
sound kernel's readings and a wrong kernel's, and the card tests each
fault's source reaches (`CARD_TESTS`: tests/test_torch_quant.py,
tests/test_torch_megakernels.py, tests/test_torch_deepseek.py, ``-m
cuda``), passed and failed.

With ``--faults DIR``, each fault of `FAULTS` (``--only``: those named;
text substitutions in ``paddle_tpu_torch/ops/csrc/megakernels.cu`` (the
GEMM core's weight conversion that the three megakernels and
weight_only_linear's f32 route share, its int4_dequantize and its MLA
finisher), in ``wol_sm90.cu`` (weight_only_linear's bf16 kernel), in
``wq_sm90.cuh`` (the register conversions it shares with the bf16
megakernels of ``megadecode_sm90.cu``) or in ``mla.cu``, as
`FAULT_KERNELS` names) is planted in a copy of the package
made under DIR, built there, and read the same way in a process of its
own. The checkout itself is never changed. One JSON object per line on
stdout, and all of them in ``--out`` when given.

With ``--splits``, `split_sweep` times the bf16 weight_only_linear kernel
at forced K splits instead (the readings its split plan stands on).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

import flash_limits

KERNEL = "paddle_tpu_torch/ops/csrc/megakernels.cu"
WOL = "paddle_tpu_torch/ops/csrc/wol_sm90.cu"
WQ = "paddle_tpu_torch/ops/csrc/wq_sm90.cuh"
MLA = "paddle_tpu_torch/ops/csrc/mla.cu"
TESTS = ("tests/test_torch_quant.py", "tests/test_torch_megakernels.py",
         "tests/test_torch_deepseek.py")
#: mla_decode_attention's single-tile case (B, T, nh, r, dr, seed): one
#: 16-row tile and one split a sequence, so that the kernel rounds p
#: against the plain version's maximum
MLA_P_CASE = (8, 16, 16, 512, 64, 3)
FILES = ("chip_smoke.py", "flash_limits.py", "quant_limits.py",
         "pytest.ini", *TESTS)

#: name -> (what it breaks, then one or more (text, replacement, which
#: occurrence (0-based)) substitutions)
FAULTS = {
    "int4_nibble_order_swapped": (
        "int4: the high nibble is taken for the even source row and the "
        "low one for the odd row",
        "(dst + 2 * r * C::LDW + n) = lo;\n"
        "        *reinterpret_cast<Vec4<T>*>(dst + (2 * r + 1) * C::LDW + n) "
        "= hi;",
        "(dst + 2 * r * C::LDW + n) = hi;\n"
        "        *reinterpret_cast<Vec4<T>*>(dst + (2 * r + 1) * C::LDW + n) "
        "= lo;", 0),
    "int4_sign_extension_dropped": (
        "int4: nibbles are read as 0..15, not sign-extended to -8..7",
        "__device__ __forceinline__ int snib(unsigned v) {\n"
        "  return (int)((v & 0xFu) ^ 0x8u) - 0x8;",
        "__device__ __forceinline__ int snib(unsigned v) {\n"
        "  return (int)(v & 0xFu);", 0),
    "int8_sign_extension_dropped": (
        "int8: bytes are read as 0..255, not sign-extended to -128..127",
        "return (int)((v & 0xFFu) ^ 0x80u) - 0x80;",
        "return (int)(v & 0xFFu);", 0),
    "scale_folded_into_bf16_weight": (
        "int8 and int4: the conversion writes bf16(q * scale) and the "
        "finishing passes drop the scale, a lower-precision function than "
        "the f32 q * scale",
        "const float* scale[2];  // [N]",
        "const float* wscale[2];\n  const float* scale[2];  // [N]", 0,
        "    p.scale[b] = wq == kWFp ? nullptr : static_cast<const float*>"
        "(scale[b]);\n    if (wq != kWFp && !p.scale[b]) return false;",
        "    p.wscale[b] = wq == kWFp ? nullptr : static_cast<const float*>"
        "(scale[b]);\n    p.scale[b] = nullptr;\n"
        "    if (wq != kWFp && !p.wscale[b]) return false;", 0,
        "T* conv) {", "T* conv, const Args& p, int n0) {", 0,
        "convert_stage<T, C, NB, WQ>(st + C::A_BYTES, conv);",
        "convert_stage<T, C, NB, WQ>(st + C::A_BYTES, conv, p, n0);", 0,
        "const unsigned byte = v >> (8 * e);",
        "const unsigned byte = v >> (8 * e);\n"
        "        const float sc = p.wscale[b][min(n0 + n + e, p.N - 1)];", 0,
        "from_f32<T>((float)sbyte(byte));",
        "from_f32<T>((float)sbyte(byte) * sc);", 0,
        "from_f32<T>((float)snib(byte));",
        "from_f32<T>((float)snib(byte) * sc);", 0,
        "from_f32<T>((float)snib(byte >> 4));",
        "from_f32<T>((float)snib(byte >> 4) * sc);", 0),
    "int4_dequantize_nibble_order_swapped": (
        "int4_dequantize: the high nibble lands in the even source row and "
        "the low one in the odd row",
        "out[2 * k * N + n] = (float)snib(v) * s;\n"
        "    out[(2 * k + 1) * N + n] = (float)snib(v >> 4) * s;",
        "out[2 * k * N + n] = (float)snib(v >> 4) * s;\n"
        "    out[(2 * k + 1) * N + n] = (float)snib(v) * s;", 0),
    "mla_latent_normed_after_bf16_round": (
        "the MLA site: the latent's f32 sum is rounded to the working type "
        "before its RMSNorm (the norm of the stored row, not of the sum)",
        "    row[n] = v;\n    if (n >= nq && n < nq + r) ss += v * v;",
        "    if (n >= nq && n < nq + r) v = to_f32(from_f32<T>(v));\n"
        "    row[n] = v;\n    if (n >= nq && n < nq + r) ss += v * v;", 0),
    "mla_dead_rows_not_zeroed": (
        "mla_decode_attention (bf16): cache rows past a sequence's length "
        "are staged from the cache (garbage) instead of zero-filled",
        "const bool ok = t + row < live;", "const bool ok = t + row < Tc;",
        1),
    "mla_scores_rounded_between_reads": (
        "mla_decode_attention (bf16): the scores are rounded to the cache "
        "dtype before the softmax, as the two-einsum composite's score "
        "tensor is between its two reads of the latent cache",
        "        sv[n][e] = tt + row < live ? v * scale : -INFINITY;",
        "        v = __bfloat162float(__float2bfloat16_rn(v));\n"
        "        sv[n][e] = tt + row < live ? v * scale : -INFINITY;", 0),
    # weight_only_linear's bf16 kernel (wol_sm90.cu)
    "wol_int4_nibbles_swapped": (
        "weight_only_linear bf16, int4: the high nibble is taken for the "
        "even source row and the low one for the odd row",
        "  const uint32_t y = __byte_perm(v, 0u, 0x4440u | j) * 0x1001u;",
        "  const uint32_t y0 = __byte_perm(v, 0u, 0x4440u | j);\n"
        "  const uint32_t y = (y0 >> 4) | (y0 << 16);", 0),
    "wol_sign_extension_dropped": (
        "weight_only_linear bf16: int4 nibbles read as 0..15 and int8 "
        "bytes as 0..255, not sign-extended",
        '"r"(0x43084308u)', '"r"(0x43004300u)', 0,
        "const uint32_t k136 = 0x43084308u;",
        "const uint32_t k136 = 0x43004300u;", 0,
        "0x80808080u;", "0u;", 0, "0x80808080u;", "0u;", 0,
        "0x80808080u;", "0u;", 0, "0x80808080u;", "0u;", 0,
        "      8388736.f;", "      8388608.f;", 0,
        "      8388736.f;", "      8388608.f;", 0),
    "wol_scale_from_wrong_column": (
        "weight_only_linear bf16: rows g and g + 8 of each 64-row tile "
        "take each other's column scale",
        "v[i] *= sc[i];", "v[i] *= sc[i ^ 1];", 0),
    "wol_last_k_box_dropped": (
        "weight_only_linear bf16: the products of the last 64-wide box of "
        "K are skipped",
        "      const int kb_live = min(G::KB, (p.K - kc * G::SK + 63) / 64);",
        "      const int kb_live =\n"
        "          min(G::KB, (p.K - kc * G::SK + 63) / 64) - "
        "(kc == p.nk - 1);", 1),
    "wol_rows_past_m_stored": (
        "weight_only_linear bf16: the token tile's rows past M (zeros) are "
        "stored",
        "        if (tok >= p.M) continue;\n        float v[CPT];\n",
        "        float v[CPT];\n", 0),
    "wol_split_partial_lost": (
        "weight_only_linear bf16: the finishing slice sums every slice's "
        "partial but the first",
        "      for (int k = 0; k < p.n_ks; ++k) {",
        "      for (int k = 1; k < p.n_ks; ++k) {", 0),
    # mla_decode_attention's bf16 kernel (mla.cu, namespace tc)
    "mla_p_not_rounded": (
        "mla_decode_attention bf16: p enters the product with c_lat "
        "unrounded (bf16 hi + lo planes, two products), not rounded to "
        "the cache dtype as the TPU kernel's p.astype(cl.dtype)",
        "    pa[3] = pack_bf16(sv[1][2], sv[1][3]);",
        "    pa[3] = pack_bf16(sv[1][2], sv[1][3]);\n"
        "    auto res = [](float a, float b) {\n"
        "      return pack_bf16(a - __bfloat162float(__float2bfloat16_rn(a)),"
        "\n                       b - __bfloat162float("
        "__float2bfloat16_rn(b)));\n    };\n"
        "    uint32_t pl[4] = {res(sv[0][0], sv[0][1]), res(sv[0][2], "
        "sv[0][3]),\n                      res(sv[1][0], sv[1][1]), "
        "res(sv[1][2], sv[1][3])};", 0,
        "        mma_bf16(o[n], pa, vb[0], vb[1]);\n"
        "        mma_bf16(o[n + 1], pa, vb[2], vb[3]);",
        "        mma_bf16(o[n], pa, vb[0], vb[1]);\n"
        "        mma_bf16(o[n + 1], pa, vb[2], vb[3]);\n"
        "        mma_bf16(o[n], pl, vb[0], vb[1]);\n"
        "        mma_bf16(o[n + 1], pl, vb[2], vb[3]);", 0,
        "      mma_bf16(o[0], pa, vb[0], vb[1]);",
        "      mma_bf16(o[0], pa, vb[0], vb[1]);\n"
        "      mma_bf16(o[0], pl, vb[0], vb[1]);", 0),
    "mla_dead_split_not_skipped": (
        "mla_decode_attention: the merge does not skip a split whose l is "
        "0 (no live row; its acc unwritten)",
        "      if (ml_in[2 * at + 1] > 0.f) M = fmaxf(M, ml_in[2 * at]);",
        "      M = fmaxf(M, ml_in[2 * at]);", 0,
        "      const float e = ls > 0.f ? expf(ml_in[2 * at] - M) : 0.f;",
        "      const float e = expf(ml_in[2 * at] - M);", 0),
    "mla_head_rows_past_nh_stored": (
        "mla_decode_attention bf16: the m16 tile's head rows past nh "
        "(zero queries) are stored as if they were heads",
        "  const bool hv[2] = {hr[0] < nh, hr[1] < nh};",
        "  const bool hv[2] = {true, true};", 0),
}
#: the source a fault edits, where it is not KERNEL (the conversions
#: that wol_sm90.cu and megadecode_sm90.cu share live in wq_sm90.cuh)
FAULT_KERNELS = {
    **{n: WOL for n in FAULTS if n.startswith("wol_")},
    **{n: WQ for n in ("wol_int4_nibbles_swapped",
                       "wol_sign_extension_dropped")},
    **{n: MLA for n in ("mla_dead_rows_not_zeroed",
                        "mla_scores_rounded_between_reads",
                        "mla_p_not_rounded", "mla_dead_split_not_skipped",
                        "mla_head_rows_past_nh_stored")}}
#: the card tests a fault's readings run ((file, -k expression or None));
#: every test file where unnamed
CARD_TESTS = {
    **{n: (("tests/test_torch_quant.py", None),) for n in FAULTS
       if n.startswith("wol_")},
    **{n: (("tests/test_torch_deepseek.py", "mla_decode"),)
       for n in FAULTS if n.startswith("mla_") and n != "mla_latent_normed_after_bf16_round"}}


def readings() -> dict:
    """Every reading of the sound or planted checkout this process runs
    in."""
    import chip_smoke as cs
    from paddle_tpu_torch import card_report, ops
    from paddle_tpu_torch.ops import _build

    cs.DEV = "cuda"
    _build.library()
    out = {"package": str(Path(ops.__file__).resolve().parent.parent),
           "card": card_report()["nvidia_smi"], "cases": {}}
    g = torch.Generator("cuda").manual_seed(4)
    shapes = {"layer": (cs.SLOTS + cs.CHUNK, cs.H, cs.FFN),
              "head": (cs.SLOTS + 1, cs.H, cs.VOCAB),
              "decode": (cs.SLOTS, cs.H, cs.FFN),
              "ragged": (7, cs.H, 1000)}
    for algo in (cs.INT8, cs.INT4):
        for shape, (M, K, N) in shapes.items():
            qw, sw = ops.weight_quantize(torch.randn(
                K, N, device="cuda", generator=g) * K ** -0.5, algo)
            x = torch.randn(M, K, device="cuda", generator=g).to(
                torch.bfloat16)
            got = ops.weight_only_linear(x, qw, sw, algo=algo)
            torch.cuda.synchronize()
            want = ops.weight_only_linear_reference(x, qw, sw, algo=algo)
            tensor, row = cs.row_rel_errors(got, want)
            out["cases"][f"{algo[12:]}/{shape}"] = {
                "tensor": tensor, "row": row,
                "max_abs_err": cs.max_err(got, want),
                "finite": bool(torch.isfinite(got).all())}
    wol_passes = all(c["finite"] and c["tensor"] <= cs.WOL_BF16_TENSOR_LIMIT
                     and c["row"] <= cs.WOL_BF16_ROW_LIMIT
                     for c in out["cases"].values())
    # the megakernels' int8 / int4 sites at the 8B step, read as phase 2
    # reads them (bf16, not held)
    mb = cs.mixed_batch(torch.Generator().manual_seed(0))
    cos_t, sin_t = cs.precompute_rope(cs.D, 8192, 500000.0, "cuda")
    rows = {}
    cs.check_quantized_megakernels(
        None, mb, cos_t[mb["positions"]], sin_t[mb["positions"]], rows,
        torch.bfloat16, None, torch.Generator("cuda").manual_seed(0),
        hold=False)
    out["sites"] = {f"{name}/{q}": r[q]["rel_err_bf16"]
                    for name, r in rows.items() for q in r}
    sites_pass = all(
        e["tensor"] <= cs.QSITE_BF16_LIMITS[k.split("/")[0]][0]
        and e["row"] <= cs.QSITE_BF16_LIMITS[k.split("/")[0]][1]
        for k, e in out["sites"].items())
    # the MLA kernels at DeepSeek-V2-Lite's shapes, read, not held
    mla = {"ragged_paged_attention": {}, "flash_sdpa": {}}
    cs.check_mla_kernels(None, mla, hold=False)
    out["mla"] = {
        "int4_dequantize": {k: mla["int4_dequantize"][k] for k in (
            "max_abs_err", "rel_err", "odd_n")},
        **{f"fused_qkv_rope_append/{k}": {
            "rel_err_bf16": mla["fused_qkv_rope_append"][k]["rel_err_bf16"],
            "max_abs_err_f32": mla["fused_qkv_rope_append"][k][
                "max_abs_err_f32"]} for k in ("mla", "mla_int8")},
        **{f"mla_decode_attention/{k}": v for k, v in
           mla["mla_decode_attention"]["cases"].items()},
        **{f"ragged_576/{k}": {f: v.get(f) for f in (
            "rel_err_bf16", "max_abs_err_f32", "max_abs_err_bf16")}
           for k, v in mla["ragged_paged_attention"]["mla_576"].items()
           if isinstance(v, dict)},
        "flash_192": {f: mla["flash_sdpa"]["d192"].get(f) for f in (
            "rel_err_bf16", "max_abs_err_f32", "max_abs_err_bf16")}}
    out["mla"]["p_rounding_differ"] = p_rounding_differ()
    out["smoke_check_passes"] = {"weight_only_linear": wol_passes,
                                 "megakernel_sites": sites_pass,
                                 "mla": mla_passes(mla, cs)}
    return out


def p_rounding_differ() -> float:
    """The share of mla_decode_attention's bf16 outputs that differ from
    the plain version's at `MLA_P_CASE` (the card test
    test_mla_decode_rounds_p_as_the_plain_version holds it)."""
    from paddle_tpu_torch import ops
    B, T, nh, r, dr, seed = MLA_P_CASE
    g = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, device="cuda",  # noqa: E731
                                 generator=g).to(torch.bfloat16)
    qe, qp, cl, cp = rnd(B, nh, r), rnd(B, nh, dr), rnd(B, T, r), \
        rnd(B, T, dr)
    lens = torch.full((B,), T, device="cuda", dtype=torch.int32)
    got = ops.mla_decode_attention(qe, qp, cl, cp, lens, scale=192 ** -0.5)
    want = ops.mla_decode_reference(qe, qp, cl, cp, lens,
                                    scale=192 ** -0.5)
    return float((got.float() != want.float()).float().mean())


def mla_passes(mla: dict, cs) -> bool:
    """Whether chip_smoke.py's MLA checks pass on these readings."""
    import math
    lim = cs.MLA_BF16_LIMITS
    ok = mla["int4_dequantize"]["max_abs_err"] == 0.0 \
        and mla["int4_dequantize"]["odd_n"]["max_abs_err"] == 0.0

    def within(rel, limits):
        vals = [rel["tensor"], rel.get("row", rel.get("tile"))]
        return all(math.isfinite(v) for v in vals) and \
            vals[0] <= limits[0] and vals[1] <= limits[1]

    for k in ("mla", "mla_int8"):
        r = mla["fused_qkv_rope_append"][k]
        ok &= within(r["rel_err_bf16"], lim["fused_qkv_rope_append_mla"])
        ok &= math.isfinite(r["max_abs_err_f32"])
    for c in mla["mla_decode_attention"]["cases"].values():
        ok &= within(c["rel_err_bf16"], lim["mla_decode_attention"])
        ok &= math.isfinite(c.get("max_abs_err_f32", 0.0))
    for v in mla["ragged_paged_attention"]["mla_576"].values():
        if isinstance(v, dict):
            ok &= within(v["rel_err_bf16"], lim["ragged_576"])
    ok &= within(mla["flash_sdpa"]["d192"]["rel_err_bf16"], lim["flash_192"])
    return bool(ok)


#: the split chain's products at the 8B serving step (T 132) and at four
#: decode rows (generate_cached, the alternating path): (K, N)
SPLIT_SHAPES = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096))
SPLIT_SLICES = (1, 2, 4, 8, 16)


def split_sweep() -> list:
    """weight_only_linear's bf16 kernel (csrc/wol_sm90.cu) timed at each K
    split of `SPLIT_SLICES` on the split chain's products, int8 and int4,
    at T = 132 and M = 4 (chip_smoke.Timer: median of 25 after the L2
    scrub), beside the slice count its plan (ptt_wol_plan) takes: the
    readings the plan's finish and read costs stand on. One line a
    product."""
    import ctypes
    import chip_smoke as cs
    from paddle_tpu_torch.ops import _build, quant

    cs.DEV = "cuda"
    timer = cs.Timer()
    fn = _build.kernel("ptt_wol_sm90", [ctypes.c_void_p] * 6
                       + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    g = torch.Generator("cuda").manual_seed(5)
    lines = []
    for algo in (cs.INT8, cs.INT4):
        for M in (cs.SLOTS + cs.CHUNK, cs.SLOTS):
            for K, N in SPLIT_SHAPES:
                qw, sw = ops_quantize(K, N, algo, g)
                x = torch.randn(M, K, device="cuda", generator=g).to(
                    torch.bfloat16)
                want = quant.weight_only_linear_reference(x, qw, sw,
                                                          algo=algo)
                dev = x.device
                plan_ks = quant._plan(M, N, K, algo, dev)[1]
                out = {"algo": algo[12:], "m": M, "k": K, "n": N,
                       "plan_slices": plan_ks, "ms": {}, "rel_err": {}}
                for want_ks in SPLIT_SLICES:
                    # the forced split's buffers as the library sizes them
                    _, n_ks, per, n_cnt, n_part = quant._plan(
                        M, N, K, algo, dev, want_ks)
                    part = torch.empty(max(1, n_part), dtype=torch.float32,
                                       device=dev)
                    cnt = quant._split_counters(max(1, n_cnt), x)
                    got = torch.empty(M, N, dtype=torch.bfloat16,
                                      device=dev)

                    def run():
                        _build.check("ptt_wol_sm90", fn(
                            x.data_ptr(), qw.data_ptr(), sw.data_ptr(),
                            part.data_ptr(), cnt.data_ptr(), got.data_ptr(),
                            M, N, K, quant.WFMT[algo], per, n_ks,
                            dev.index or 0, _build.stream(x)))

                    run()
                    torch.cuda.synchronize()
                    out["rel_err"][n_ks] = cs.row_rel_errors(got, want)[0]
                    out["ms"][n_ks] = timer.ms(run)
                print(json.dumps(out), flush=True)
                lines.append(out)
    return lines


def ops_quantize(K: int, N: int, algo: str, g):
    from paddle_tpu_torch import ops
    qw, sw = ops.weight_quantize(torch.randn(
        K, N, device="cuda", generator=g) * K ** -0.5, algo)
    return qw, sw.float().contiguous()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--faults", type=Path, default=None,
                    help="plant each fault in a copy under this directory")
    ap.add_argument("--only", default=None, nargs="+",
                    choices=sorted(FAULTS), help="plant these faults only")
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--splits", action="store_true",
                    help="time weight_only_linear's bf16 kernel at each K "
                         "split instead (split_sweep)")
    ap.add_argument("--readings-only", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("quant_limits.py: no CUDA device", file=sys.stderr)
        return 2
    if args.readings_only:
        print(json.dumps(readings()), flush=True)
        return 0
    if args.splits:
        lines = split_sweep()
        if args.out is not None:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            args.out.write_text("".join(json.dumps(x) + "\n"
                                        for x in lines))
        return 0

    def card_tests(cwd, name=None):
        out = {}
        for t, k in CARD_TESTS.get(name, [(t, None) for t in TESTS]):
            if k is None:
                out[t] = flash_limits.card_tests(cwd, t)
            else:
                out[f"{t} -k {k}"] = flash_limits.card_tests(cwd, t, k)
        return out

    here = flash_limits.HERE
    lines = [dict(name="sound", **readings(), card_tests=card_tests(here))]
    print(json.dumps(lines[-1]), flush=True)
    for name in ((args.only or FAULTS) if args.faults else ()):
        cwd = flash_limits.plant(name, args.faults.resolve(), FAULTS,
                                 FAULT_KERNELS.get(name, KERNEL), FILES)
        r = subprocess.run([sys.executable, "quant_limits.py",
                            "--readings-only"], cwd=cwd, capture_output=True,
                           text=True, timeout=900)
        res = {"name": name, "breaks": FAULTS[name][0], "rc": r.returncode}
        if r.returncode == 0:
            res.update(json.loads(r.stdout.strip().splitlines()[-1]))
        else:
            res["stderr_tail"] = r.stderr[-2000:]
        res["card_tests"] = card_tests(cwd, name)
        lines.append(res)
        print(json.dumps(res), flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
