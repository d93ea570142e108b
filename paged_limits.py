#!/usr/bin/env python3
"""Readings of the bf16 paged decode checks on one NVIDIA card, for the
sound kernels and for planted faults.

    python3 paged_limits.py [--faults DIR] [--out FILE]

``chip_smoke.py`` holds the bf16 paged decode kernels (v1 and v2) to
their plain version by two relative errors (`chip_smoke.paged_rel_errors`:
over the whole [B, H, D] output, and the largest over each (sequence,
head)). This script prints what those measures read at the shapes phase 2
runs (the 8B alternating decode step: 4 slots at 300 / 1024 / 517 tokens
and an idle slot of length 1, 64-page tables with a -1 entry; the long
context: 8 sequences with 8192-token tables), so that each limit can sit
between the sound kernels' readings and a wrong kernel's. Beside them:
the largest absolute error, whether the absolute bar these checks
replaced (atol = rtol = 2e-2) passes, and the card tests of
tests/test_torch_paged.py (``-m cuda``), passed and failed.

With ``--faults DIR``, each fault of `FAULTS` (one text substitution in
``paddle_tpu_torch/ops/csrc/paged_attention.cu``) is planted in a copy of
the package made under DIR, built there, and read the same way in a
process of its own. The checkout itself is never changed. One JSON
object per line on stdout, and all of them in ``--out`` when given.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

import flash_limits

KERNEL = "paddle_tpu_torch/ops/csrc/paged_attention.cu"
FILES = ("chip_smoke.py", "flash_limits.py", "paged_limits.py",
         "pytest.ini", "tests/test_torch_paged.py")
TESTS = "tests/test_torch_paged.py"

_LEN = "const int len = min(max(lengths[b], 0), nj * psz);"

#: name -> (what it breaks, text, replacement, which occurrence (0-based))
FAULTS = {
    "v2_skips_last_group": (
        "v2 (bf16 mma): a sequence of more than one page group stops one "
        "group short",
        "const int n_groups = (len + TK - 1) / TK;",
        "const int n_groups = (len + TK - 1) / TK - (len > TK);", 1),
    "v2_drops_tail_page": (
        "v2 (bf16 mma): a sequence of more than one page loses its last "
        "page",
        _LEN,
        "const int len = min(max(lengths[b], 0), nj * psz) - (lengths[b] "
        "> psz ? (lengths[b] - 1) % psz + 1 : 0);", 2),
    "v2_drops_tail_row": (
        "v2 (bf16 mma): the last row of a sequence of more than one row "
        "gets no probability",
        "const int nk = min(TK, len - gi * TK), nk16 = round16(nk);",
        "const int nk = min(TK, len - gi * TK) - (gi + 1 == n_groups && "
        "len > 1), nk16 = round16(nk);", 0),
    "v2_stale_rescale": (
        "v2 (bf16 mma): the output is not rescaled after the first group "
        "when the running max grows (the running sum still is)",
        "const float alpha = qr < rep ? st.alpha[qr] : 0.f;",
        "const float alpha = qr < rep ? (gi == 0 ? st.alpha[qr] : 1.f) "
        ": 0.f;", 0),
    "v1_drops_tail_row": (
        "v1: the last row of a sequence of more than one row is never read",
        _LEN,
        "const int len = min(max(lengths[b], 0), nj * psz) - (lengths[b] "
        "> 1);", 0),
    "v1_stale_rescale": (
        "v1: the output is not rescaled after the first tile when the "
        "running max grows (the running sum still is)",
        "rescale<T, D, REP>(acc, &st, rep);",
        "if (t0 == 0) rescale<T, D, REP>(acc, &st, rep);", 0),
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
    g = torch.Generator().manual_seed(0)
    gc = torch.Generator("cuda").manual_seed(0)
    shapes = {
        "step_8b": cs.decode_batch(g, cs.SLOTS, cs.MAX_CTX // cs.PSZ,
                                   [300, 1024, 517, 1], idle=3),
        "long": cs.long_context_batch(g),
    }
    for tag, batch in shapes.items():
        args = cs.paged_batch(gc, torch.bfloat16, *batch)
        want = ops.paged_decode_reference(*args)
        for fn in (ops.paged_decode_attention,
                   ops.paged_decode_attention_v2):
            got = fn(*args)
            torch.cuda.synchronize()
            tensor, head = cs.paged_rel_errors(got, want)
            a, w = got.float(), want.float()
            out["cases"][f"{tag}/{fn.__name__}"] = {
                "tensor": tensor, "head": head,
                "max_abs_err": cs.max_err(got, want),
                "finite": bool(torch.isfinite(got).all()),
                "old_bar_passes": bool(((a - w).abs()
                                        <= 2e-2 + 2e-2 * w.abs()).all())}
    out["smoke_check_passes"] = all(
        c["finite"] and c["tensor"] <= cs.PAGED_BF16_TENSOR_LIMIT
        and c["head"] <= cs.PAGED_BF16_HEAD_LIMIT
        for c in out["cases"].values())
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--faults", type=Path, default=None,
                    help="plant each fault in a copy under this directory")
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--readings-only", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("paged_limits.py: no CUDA device", file=sys.stderr)
        return 2
    if args.readings_only:
        print(json.dumps(readings()), flush=True)
        return 0
    here = flash_limits.HERE
    lines = [dict(name="sound", **readings(),
                  card_tests=flash_limits.card_tests(here, TESTS))]
    print(json.dumps(lines[-1]), flush=True)
    for name in FAULTS if args.faults else ():
        cwd = flash_limits.plant(name, args.faults.resolve(), FAULTS,
                                 KERNEL, FILES)
        r = subprocess.run([sys.executable, "paged_limits.py",
                            "--readings-only"], cwd=cwd, capture_output=True,
                           text=True, timeout=900)
        res = {"name": name, "breaks": FAULTS[name][0], "rc": r.returncode}
        if r.returncode == 0:
            res.update(json.loads(r.stdout.strip().splitlines()[-1]))
        else:
            res["stderr_tail"] = r.stderr[-2000:]
        res["card_tests"] = flash_limits.card_tests(cwd, TESTS)
        lines.append(res)
        print(json.dumps(res), flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
