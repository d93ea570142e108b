#!/usr/bin/env python3
"""Readings of the bf16 gmm checks on one NVIDIA card, forward and
backward, for the sound kernels and for planted faults.

    python3 gmm_limits.py [--faults DIR [--only FAULT]] [--out FILE]

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
way in a process of its own. The checkout itself is never changed. One
JSON object per line on stdout, and all of them in ``--out`` when given.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

import flash_limits

KERNEL = "paddle_tpu_torch/ops/csrc/gmm.cu"
TEST = "tests/test_torch_moe.py"
FILES = ("chip_smoke.py", "flash_limits.py", "gmm_limits.py", "pytest.ini",
         TEST)

#: the end of an AccBf16 stage loop, then every accumulator rounded to bf16
_ROUND_ACC = ("    }\n#pragma unroll\n    for (int i = 0; i < MT; ++i)\n"
              "#pragma unroll\n      for (int j = 0; j < 4; ++j)\n"
              "#pragma unroll\n        for (int e = 0; e < 4; ++e)\n"
              "          acc[i][j][e] = "
              "__bfloat162float(__float2bfloat16(acc[i][j][e]));\n")
#: name -> (what it breaks, then one or more (text, replacement, which
#: occurrence (0-based)) substitutions)
FAULTS = {
    "partial_sums_bf16_per_k_chunk": (
        "bf16: the forward's and dlhs's f32 accumulators are rounded to "
        "bf16 after every 64-deep K chunk, a lower-precision sum than one "
        "rounding at the end",
        "    }\n  }\n\n  // One stage of tgmm", _ROUND_ACC
        + "  }\n\n  // One stage of tgmm", 0),
    "tgmm_partial_sums_bf16_per_row_chunk": (
        "bf16: tgmm's f32 accumulators are rounded to bf16 after every "
        "64-row chunk of the group",
        "    }\n  }\n\n  __device__ void store(bf16* out", _ROUND_ACC
        + "  }\n\n  __device__ void store(bf16* out", 0),
    "last_k_chunk_dropped": (
        "the last K chunk of every row tile is loaded but never multiplied",
        "for (int kc = 0; kc < nk; ++kc) {",
        "for (int kc = 0; kc < nk - 1; ++kc) {", 0),
    "tgmm_empty_group_not_zeroed": (
        "tgmm: an empty group's blocks return without writing their zero "
        "slab (its torch.empty output keeps what the memory held)",
        "  // an empty group walks no chunk and writes its zero "
        "accumulators\n",
        "  if (row_end <= row_start) return;\n", 0),
    "tgmm_row_chunk_dropped": (
        "tgmm: the last reduction chunk of every group's rows (64 in bf16) "
        "is loaded but never multiplied",
        "for (int rc = 0; rc < nr; ++rc) {",
        "for (int rc = 0; rc < nr - 1; ++rc) {", 0),
    "tgmm_group_start_shifted": (
        "tgmm: each group's rows start one row late (its first row adds to "
        "no slab)",
        "min(max(ends[g - 1], 0), row_end)",
        "min(max(ends[g - 1] + 1, 0), row_end)", 0),
    "dlhs_b_fragments_trans": (
        "dlhs: the [N, K] weight chunk's B fragments read with the "
        "forward's ldmatrix .trans",
        "ldsm_x4(bfr[jp], w + jp * 16 * G::LDW + kk);",
        "ldsm_x4_trans(bfr[jp], w + jp * 16 * G::LDW + kk);", 0),
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
           "card": card_report()["nvidia_smi"]}
    rows = {}
    cs.check_gmm(None, rows, hold=False)
    cs.check_gmm_backward(None, rows, hold=False)
    keep = ("max_abs_err", "tail_zero", "zero_where_due", "finite",
            "close_2e-5", "groups_with_rows", "largest_group")
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
        print("gmm_limits.py: no CUDA device", file=sys.stderr)
        return 2
    if args.readings_only:
        print(json.dumps(readings()), flush=True)
        return 0

    here = flash_limits.HERE
    lines = [dict(name="sound", **readings(),
                  card_tests=flash_limits.card_tests(here, TEST))]
    print(json.dumps(lines[-1]), flush=True)
    for name in (([args.only] if args.only else FAULTS) if args.faults
                 else ()):
        cwd = flash_limits.plant(name, args.faults.resolve(), FAULTS,
                                 KERNEL, FILES)
        r = subprocess.run([sys.executable, "gmm_limits.py",
                            "--readings-only"], cwd=cwd, capture_output=True,
                           text=True, timeout=900)
        res = {"name": name, "breaks": FAULTS[name][0], "rc": r.returncode}
        if r.returncode == 0:
            res.update(json.loads(r.stdout.strip().splitlines()[-1]))
        else:
            res["stderr_tail"] = r.stderr[-2000:]
        res["card_tests"] = flash_limits.card_tests(cwd, TEST)
        lines.append(res)
        print(json.dumps(res), flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
