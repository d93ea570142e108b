#!/usr/bin/env python3
"""Readings of the bf16 weight_only_linear and quantized megakernel checks
on one NVIDIA card, for the sound kernel and for planted faults.

    python3 quant_limits.py [--faults DIR [--only FAULT]] [--out FILE]

``chip_smoke.py`` holds the bf16 weight_only_linear kernel, and the
megakernels' int8 / int4 sites, to their plain versions by two relative
errors (`chip_smoke.row_rel_errors`: over the whole output, and the
largest over each output row). This script prints what those measures
read at the shapes phase 2 runs (weight_only_linear at T = 132 x [4096
-> 14336], M = 5 x [4096 -> 128256], 7 x [4096 -> 1000]; the three
megakernels at the 8B step), int8 and int4, so that each limit can sit
between the sound kernel's readings and a wrong kernel's, and the card
tests of tests/test_torch_quant.py and tests/test_torch_megakernels.py
(``-m cuda``), passed and failed.

With ``--faults DIR``, each fault of `FAULTS` (``--only``: one of them;
text substitutions in ``paddle_tpu_torch/ops/csrc/megakernels.cu``, the
GEMM core's weight conversion that weight_only_linear and the three
megakernels share) is planted in a copy of the package made under DIR,
built there, and read the same way in a process of its own. The checkout itself is never
changed. One JSON object per line on stdout, and all of them in
``--out`` when given.
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
TESTS = ("tests/test_torch_quant.py", "tests/test_torch_megakernels.py")
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
        "convert_stage<T, C, NB, WQ>(st + NA * C::A_BYTES, conv);",
        "convert_stage<T, C, NB, WQ>(st + NA * C::A_BYTES, conv, p, n0);",
        0,
        "const unsigned byte = v >> (8 * e);",
        "const unsigned byte = v >> (8 * e);\n"
        "        const float sc = p.wscale[b][min(n0 + n + e, p.N - 1)];", 0,
        "from_f32<T>((float)sbyte(byte));",
        "from_f32<T>((float)sbyte(byte) * sc);", 0,
        "from_f32<T>((float)snib(byte));",
        "from_f32<T>((float)snib(byte) * sc);", 0,
        "from_f32<T>((float)snib(byte >> 4));",
        "from_f32<T>((float)snib(byte >> 4) * sc);", 0),
}


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
    out["smoke_check_passes"] = {"weight_only_linear": wol_passes,
                                 "megakernel_sites": sites_pass}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--faults", type=Path, default=None,
                    help="plant each fault in a copy under this directory")
    ap.add_argument("--only", default=None, choices=sorted(FAULTS),
                    help="plant this fault alone")
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--readings-only", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("quant_limits.py: no CUDA device", file=sys.stderr)
        return 2
    if args.readings_only:
        print(json.dumps(readings()), flush=True)
        return 0

    def card_tests(cwd):
        return {t: flash_limits.card_tests(cwd, t) for t in TESTS}

    here = flash_limits.HERE
    lines = [dict(name="sound", **readings(), card_tests=card_tests(here))]
    print(json.dumps(lines[-1]), flush=True)
    for name in (([args.only] if args.only else FAULTS) if args.faults
                 else ()):
        cwd = flash_limits.plant(name, args.faults.resolve(), FAULTS,
                                 KERNEL, FILES)
        r = subprocess.run([sys.executable, "quant_limits.py",
                            "--readings-only"], cwd=cwd, capture_output=True,
                           text=True, timeout=900)
        res = {"name": name, "breaks": FAULTS[name][0], "rc": r.returncode}
        if r.returncode == 0:
            res.update(json.loads(r.stdout.strip().splitlines()[-1]))
        else:
            res["stderr_tail"] = r.stderr[-2000:]
        res["card_tests"] = card_tests(cwd)
        lines.append(res)
        print(json.dumps(res), flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
