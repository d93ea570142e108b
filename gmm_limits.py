#!/usr/bin/env python3
"""Readings of the bf16 gmm checks on one NVIDIA card, forward and
backward, for the sound kernels and for planted faults.

    python3 gmm_limits.py [--faults DIR [--only FAULT]] [--variants DIR]
                          [--parent CHECKOUT DIR] [--out FILE]

``chip_smoke.py`` holds the bf16 gmm kernel to its plain version by two
relative errors (`chip_smoke.row_rel_errors`: over the whole output, and
the largest over each output row) at ERNIE-4.5-21B-A3B's expert shapes
(GMM_BF16_LIMITS), and its edge cases by the first alone
(GMM_EDGE_TENSOR_LIMIT); the backward kernels (dlhs, tgmm) the same way
at the training routing and the edge cases (GMM_BWD_BF16_LIMITS,
GMM_BWD_EDGE_TENSOR_LIMIT), with dlhs's tail rows and the empty groups'
drhs slabs exactly zero. This script prints what those measures read at
the cases phase 2 runs (`chip_smoke.check_gmm`: the decode step, the
mixed step, the prefill, the edge cases; `chip_smoke.check_gmm_backward`:
training's gate / up and down products, the edge cases), so that each
limit can sit between the sound kernels' readings and a wrong kernel's,
and the card tests of tests/test_torch_moe.py (``-m cuda``), passed and
failed.

With ``--faults DIR``, each fault of `FAULTS` (``--only``: one of them;
text substitutions in ``paddle_tpu_torch/ops/csrc/gmm.cu``) is planted
in a copy of the package made under DIR, built there, and read the same
way in a process of its own. With ``--parent CHECKOUT DIR``, the
package of another checkout (``git archive`` of the parent commit) is
copied under DIR beside this checkout's scripts, and both packages are
read with phase 2's timings in turns (parent, this, this, parent). With
``--variants DIR``, each tile variant
of `VARIANTS` is planted the same way, and every reading (the sound
kernels, each variant, the sound kernels again) carries phase 2's
timings. The checkout itself is never changed. One JSON object per
line on stdout, and all of them in ``--out`` when given.
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

KERNEL = "paddle_tpu_torch/ops/csrc/gmm.cu"
TEST = "tests/test_torch_moe.py"
FILES = ("chip_smoke.py", "flash_limits.py", "gmm_limits.py", "pytest.ini",
         TEST)

def _rounded(indent: str) -> str:
    """A chunk's products waited for, then every f32 accumulator rounded
    to bf16 (a lower-precision sum than one rounding at the end)."""
    return (f"{indent}wg_wait<0>();\n{indent}fence_regs(acc);\n"
            f"#pragma unroll\n{indent}for (int i = 0; i < BN / 2; ++i)\n"
            f"{indent}  acc[i] = __bfloat162float(__float2bfloat16(acc[i]));"
            "\n")


#: name -> (what it breaks, then one or more (text, replacement, which
#: occurrence (0-based)) substitutions, made in order)
FAULTS = {
    "partial_sums_bf16_per_k_chunk": (
        "bf16: the forward's and dlhs's f32 accumulators are rounded to "
        "bf16 after every 64-deep K chunk",
        "        wg_wait<1>();\n        fence_regs(acc);\n",
        _rounded(" " * 8), 0),
    "tgmm_partial_sums_bf16_per_row_chunk": (
        "bf16: tgmm's f32 accumulators are rounded to bf16 after every "
        "64-row chunk of the group",
        "      wg_wait<1>();\n      fence_regs(acc);\n", _rounded(" " * 6), 0),
    "last_k_chunk_dropped": (
        "the forward's and dlhs's last K chunk of every item is loaded but "
        "never multiplied",
        "      mbar_wait(full + st, ph);\n      if (live) {",
        "      mbar_wait(full + st, ph);\n      if (live && kc < nk - 1) {", 0),
    "epilogue_drops_group_last_row": (
        "forward / dlhs: the masked epilogue's row bound is off by one: "
        "the last row of every group whose last tile ends past the group "
        "is never stored, and keeps what the torch.empty output held",
        "if (row0 + row < gr.y && c0 + cc * 8 < N)",
        "if (row0 + row < gr.y - 1 && c0 + cc * 8 < N)", 0),
    "schedule_drops_last_row_tile": (
        "the work-item walk counts a group's full 128-row tiles only: a "
        "group's partial last row tile (and a group of fewer rows whole) "
        "is never computed nor stored",
        "n = (r.y - r.x + BM - 1) / BM;", "n = (r.y - r.x) / BM;", 0),
    "dlhs_transpose_bit_flipped": (
        "dlhs: the [N, K] weight rows read by wgmma with the forward's "
        "MN-major transpose bit",
        "mma_ss<0, 0>(acc, desc_k(a, BM, kk), desc_k(b, BN, kk),",
        "mma_ss<0, 1>(acc, desc_k(a, BM, kk), desc_k(b, BN, kk),", 0),
    "tgmm_last_chunk_not_zeroed": (
        "tgmm: the rows of the next group in a group's last 64-row chunk "
        "are not zeroed, so they add to this group's slab",
        "if (live < 64) {", "if (live < 0) {", 0),
    "tgmm_group_start_shifted": (
        "tgmm: each group's rows start one row late (its first row adds to "
        "no slab)",
        "const int2 gr = group_rows(ends, g, M);",
        "const int2 gr = make_int2(min(group_rows(ends, g, M).x + 1, "
        "group_rows(ends, g, M).y), group_rows(ends, g, M).y);", 0,
        "const int2 gr = group_rows(ends, g, M);",
        "const int2 gr = make_int2(min(group_rows(ends, g, M).x + 1, "
        "group_rows(ends, g, M).y), group_rows(ends, g, M).y);", 0),
}


#: tile variants of the bf16 kernels, planted like a fault and read with
#: the timings of phase 2 (``--variants``): name -> (what it changes,
#: substitutions)
VARIANTS = {
    "bn128": ("BN 128: items of 128 columns (wgmma m64n128k16, 32 KB "
              "stages) in place of 256",
              "constexpr int BN = 256;", "constexpr int BN = 128;", 0),
}


def readings(timed: bool = False) -> dict:
    """Every reading of the sound or planted checkout this process runs
    in."""
    import chip_smoke as cs
    from paddle_tpu_torch import card_report, ops
    from paddle_tpu_torch.ops import _build

    cs.DEV = "cuda"
    _build.library()
    out = {"package": str(Path(ops.__file__).resolve().parent.parent),
           "card": card_report()["nvidia_smi"]}
    rows = {}
    timer = cs.Timer() if timed else None
    cs.check_gmm(timer, rows, hold=False)
    cs.check_gmm_backward(timer, rows, hold=False)
    keep = ("max_abs_err", "tail_zero", "zero_where_due", "finite",
            "close_2e-5", "groups_with_rows", "largest_group", "ms",
            "plain_ms", "bound_ms", "library_ms")
    limits = {"gmm": (cs.GMM_BF16_LIMITS, cs.GMM_EDGE_TENSOR_LIMIT),
              **{n: (cs.GMM_BWD_BF16_LIMITS[n], cs.GMM_BWD_EDGE_TENSOR_LIMIT)
                 for n in ("gmm_dlhs", "tgmm")}}

    def passes(name, k, v):
        (lt, lr), edge = limits[name]
        if not (v.get("tail_zero", v.get("zero_where_due")) and v["finite"]):
            return False
        if k.endswith("f32"):
            return v["close_2e-5"]
        if k.startswith("edge"):
            return v["tensor"] <= edge
        return v["tensor"] <= lt and v["row"] <= lr

    for name in limits:
        cases = {k: dict(v.get("rel_err_bf16", {}),
                         **{f: v[f] for f in keep if f in v})
                 for k, v in rows[name]["cases"].items()}
        out[name] = {"cases": cases, "smoke_check_passes": {
            k: passes(name, k, v) for k, v in cases.items()}}
    return out


def read_in(cwd: Path, timed: bool) -> dict:
    """The readings of the package in `cwd`, in a process of its own."""
    r = subprocess.run([sys.executable, "gmm_limits.py", "--readings-only"]
                       + (["--timed"] if timed else []), cwd=cwd,
                       capture_output=True, text=True, timeout=900)
    if r.returncode != 0:
        return {"rc": r.returncode, "stderr_tail": r.stderr[-2000:]}
    return {"rc": 0, **json.loads(r.stdout.strip().splitlines()[-1])}


def planted(name: str, root: Path, table: dict, timed: bool) -> dict:
    """Readings of a copy under `root` with entry `name` of `table`
    (FAULTS or VARIANTS) planted; the card tests too for a fault."""
    cwd = flash_limits.plant(name, root, table, KERNEL, FILES)
    res = {"name": name, "breaks": table[name][0], **read_in(cwd, timed)}
    if table is FAULTS:
        res["card_tests"] = flash_limits.card_tests(cwd, TEST)
    return res


def against(parent: Path, root: Path) -> list:
    """The package of another checkout (`parent`, e.g. ``git archive`` of
    the parent commit) and this one's, timed in turns (parent, this,
    this, parent), each read by this checkout's scripts: the parent's
    package is copied under root with them."""
    dst = root / "parent"
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(parent / "paddle_tpu_torch", dst / "paddle_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for f in FILES:
        (dst / f).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy2(flash_limits.HERE / f, dst / f)
    return [dict(name=name, **read_in(cwd, True)) for name, cwd in (
        ("parent", dst), ("this", flash_limits.HERE),
        ("this again", flash_limits.HERE), ("parent again", dst))]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--faults", type=Path, default=None,
                    help="plant each fault in a copy under this directory")
    ap.add_argument("--only", default=None, choices=sorted(FAULTS),
                    help="plant this fault alone")
    ap.add_argument("--variants", type=Path, default=None,
                    help="time the sound kernels, each of VARIANTS planted "
                         "in a copy under this directory, then the sound "
                         "kernels again")
    ap.add_argument("--parent", type=Path, nargs=2, default=None,
                    metavar=("CHECKOUT", "DIR"),
                    help="time another checkout's kernels and this one's "
                         "in turns, the other's copied under DIR")
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--readings-only", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--timed", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gmm_limits.py: no CUDA device", file=sys.stderr)
        return 2
    if args.readings_only:
        print(json.dumps(readings(args.timed)), flush=True)
        return 0

    if args.parent is not None:
        lines = against(args.parent[0].resolve(), args.parent[1].resolve())
        for x in lines:
            print(json.dumps(x), flush=True)
        if args.out is not None:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            args.out.write_text("".join(json.dumps(x) + "\n" for x in lines))
        return 0
    timed = args.variants is not None
    lines = [dict(name="sound", **readings(timed),
                  card_tests=flash_limits.card_tests(flash_limits.HERE,
                                                     TEST))]
    print(json.dumps(lines[-1]), flush=True)
    jobs = [(n, args.faults, FAULTS) for n in (
        ([args.only] if args.only else FAULTS) if args.faults else ())]
    jobs += [(n, args.variants, VARIANTS) for n in (VARIANTS if timed
                                                    else ())]
    for name, root, table in jobs:
        lines.append(planted(name, root.resolve(), table, timed))
        print(json.dumps(lines[-1]), flush=True)
    if timed:
        lines.append(dict(name="sound again", **readings(True)))
        print(json.dumps(lines[-1]), flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
