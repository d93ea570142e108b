#!/usr/bin/env python3
"""Readings of the bf16 gmm checks on one NVIDIA card, for the sound
kernel and for planted faults.

    python3 gmm_limits.py [--faults DIR [--only FAULT]] [--out FILE]

``chip_smoke.py`` holds the bf16 gmm kernel to its plain version by two
relative errors (`chip_smoke.row_rel_errors`: over the whole output, and
the largest over each output row) at ERNIE-4.5-21B-A3B's expert shapes
(GMM_BF16_LIMITS), and its edge cases by the first alone
(GMM_EDGE_TENSOR_LIMIT). This script prints what those measures read at
the cases phase 2 runs (`chip_smoke.check_gmm`: the decode step, the
mixed step, the prefill, the edge cases), so that each limit can sit
between the sound kernel's readings and a wrong kernel's, and the card
tests of tests/test_torch_moe.py (``-m cuda``), passed and failed.

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

#: name -> (what it breaks, then one or more (text, replacement, which
#: occurrence (0-based)) substitutions)
FAULTS = {
    "partial_sums_bf16_per_k_chunk": (
        "bf16: the f32 accumulators are rounded to bf16 after every 64-deep "
        "K chunk, a lower-precision sum than one rounding at the end",
        "    }\n  }\n\n  __device__ void store(bf16* out",
        "    }\n#pragma unroll\n    for (int i = 0; i < MT; ++i)\n"
        "#pragma unroll\n      for (int j = 0; j < 4; ++j)\n#pragma unroll\n"
        "        for (int e = 0; e < 4; ++e)\n          acc[i][j][e] = "
        "__bfloat162float(__float2bfloat16(acc[i][j][e]));\n  }\n\n"
        "  __device__ void store(bf16* out", 0),
    "last_k_chunk_dropped": (
        "the last K chunk of every row tile is loaded but never multiplied",
        "for (int kc = 0; kc < nk; ++kc) {",
        "for (int kc = 0; kc < nk - 1; ++kc) {", 0),
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
    cases = rows["gmm"]["cases"]
    keep = ("max_abs_err", "tail_zero", "finite", "close_2e-5",
            "groups_with_rows", "largest_group")
    out["cases"] = {k: dict(v.get("rel_err_bf16", {}),
                            **{f: v[f] for f in keep if f in v})
                    for k, v in cases.items()}
    lt, lr = cs.GMM_BF16_LIMITS

    def passes(k, v):
        if not (v["tail_zero"] and v["finite"]):
            return False
        if k.endswith("f32"):
            return v["close_2e-5"]
        if k.startswith("edge"):
            return v["tensor"] <= cs.GMM_EDGE_TENSOR_LIMIT
        return v["tensor"] <= lt and v["row"] <= lr

    out["smoke_check_passes"] = {k: passes(k, v)
                                 for k, v in out["cases"].items()}
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
