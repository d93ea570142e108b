#!/usr/bin/env python3
"""Readings of the bf16 ragged attention checks on one NVIDIA card: for
the sound kernel, for planted faults, for another commit's kernel and at
other key splits.

    python3 ragged_limits.py [--faults DIR] [--parent DIR] [--splits]
                             [--out FILE]

``chip_smoke.py`` phase 2 holds the bf16 ragged kernel to its plain
version by relative errors within ``MLA_BF16_LIMITS["ragged_576"]`` over
the Llama-3-8B step (4 slots and a 128-token chunk, and the same step
with the chunk idle), over GPT-3 6.7B's and Qwen2-7B's heads (rep 1 / 7)
and over 8 decode rows with 8192-token tables, each also at atol = rtol
= 2e-2, and at DeepSeek-V2's latent row (KV 1, D 576, rep 16, one pool
as K and V: a decode step and a 128-row chunk). This script draws those
cases at phase 2's shapes and prints, for each, the relative errors over
the whole output and over each (row, head) of the rows some sequence
owns (`chip_smoke.row_rel_errors`), the largest absolute error, whether
the output is finite and the unowned rows zero, whether phase 2's check
passes, and the kernel's time (median of 25 after the L2 scrub) beside
its bytes bound and the host's time a call (the median of 200 calls
launched back to back, none waited for). Beside them, the ragged card tests
(``tests/test_torch_ops.py -k ragged``, ``tests/test_torch_deepseek.py
-k ragged_576``, ``-m cuda``), passed and failed.

With ``--faults DIR``, each fault of `FAULTS` (text substitutions in
``paddle_tpu_torch/ops/csrc/ragged_attention.cu``) is planted in a copy
of the package made under DIR, built there, and read the same way in a
process of its own (untimed). With ``--parent DIR``, DIR holds a checkout
of another commit (``git archive``): this script is copied into it, and
the readings are taken there and here in the order parent, this, this,
parent, each in a process of its own. With ``--splits``, the bf16 kernel
is timed at every case with keys a split forced to each of `SPLITS`
beside `ops.ragged.ragged_split_plan`'s. The checkout itself is never
changed. One JSON object per line on stdout, and all of them in
``--out`` when given.
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

import flash_limits

KERNEL = "paddle_tpu_torch/ops/csrc/ragged_attention.cu"
TESTS = (("tests/test_torch_ops.py", "ragged"),
         ("tests/test_torch_deepseek.py", "ragged_576"))
FILES = ("chip_smoke.py", "flash_limits.py", "ragged_limits.py",
         "pytest.ini", *(t for t, _ in TESTS))
#: keys a split that --splits forces
SPLITS = (64, 128, 192, 256, 384, 512, 1024, 2048)

#: name -> (what it breaks, then (text, replacement, which occurrence
#: (0-based)) substitutions)
FAULTS = {
    "split_dropped_from_merge": (
        "the last split of a tile is left out of the merge (its keys "
        "still count in the maximum)",
        "    for (int s2 = 0; s2 < ns; ++s2) {\n"
        "      const float* ml = a.pml + (size_t)(first + s2) * 32;\n"
        "      float es[2];",
        "    for (int s2 = 0; s2 < ns - 1; ++s2) {\n"
        "      const float* ml = a.pml + (size_t)(first + s2) * 32;\n"
        "      float es[2];", 0),
    "p_unrounded": (
        "p carried into O += P V unrounded (bf16 hi + lo planes, two "
        "products), not rounded to V's dtype as the TPU kernel's "
        "p.astype(v.dtype)",
        "      pa[3] = pack_bf16(sv[1][2], sv[1][3]);",
        "      pa[3] = pack_bf16(sv[1][2], sv[1][3]);\n"
        "      auto res = [](float a, float b) {\n"
        "        return pack_bf16(a - __bfloat162float(__float2bfloat16_rn(a)),"
        "\n                         b - __bfloat162float("
        "__float2bfloat16_rn(b)));\n      };\n"
        "      uint32_t pl[4] = {res(sv[0][0], sv[0][1]), res(sv[0][2], "
        "sv[0][3]),\n                        res(sv[1][0], sv[1][1]), "
        "res(sv[1][2], sv[1][3])};", 0,
        "        mma_bf16(o[n], pa, vb[0], vb[1]);\n"
        "        mma_bf16(o[n + 1], pa, vb[2], vb[3]);",
        "        mma_bf16(o[n], pa, vb[0], vb[1]);\n"
        "        mma_bf16(o[n + 1], pa, vb[2], vb[3]);\n"
        "        mma_bf16(o[n], pl, vb[0], vb[1]);\n"
        "        mma_bf16(o[n + 1], pl, vb[2], vb[3]);", 0),
    "limit_off_by_one_at_split_boundary": (
        "a split's keys end one past the next split's first key, which "
        "both splits then count",
        "const int k1 = ns == 1 ? tile_hi : min(k0 + a.split, tile_hi);",
        "const int k1 = ns == 1 ? tile_hi : min(k0 + a.split + 1, tile_hi);",
        0),
    "sentinel_unclamped": (
        "a -1 table entry is not clamped to page 0 (it reads the page "
        "before the head's first)",
        "min(max(a.tab[(size_t)i * a.nj + j0 + x], 0), a.P - 1);",
        "min(a.tab[(size_t)i * a.nj + j0 + x], a.P - 1);", 0),
    "rows_past_length_staged": (
        "key rows past the split's last visible key are staged from the "
        "pool up to the end of that key's page instead of zero-filled",
        "const bool ok = p < k1;",
        "const bool ok = p < ((k1 - 1) / a.psz + 1) * a.psz;", 0),
}


def cases(cs, g, gc):
    """(name, operands, scale, check) of phase 2's ragged cases, drawn
    from `g` (tables) and `gc` (tensors): check "bar" is phase 2's 2e-2
    bar beside its relative limits, "mla" those limits alone."""
    rnd = lambda *s: torch.randn(*s, device="cuda",  # noqa: E731
                                 generator=gc).to(torch.bfloat16)
    mb = cs.mixed_batch(g)
    T, P = mb["T"], mb["P"]
    tabs = (mb["seq_start"], mb["num_tokens"], mb["kv_lengths"],
            mb["tables"])
    dec = (tabs[0], tabs[1] * (tabs[1] == 1), tabs[2] * (tabs[1] == 1),
           tabs[3])
    out = []
    qa, kp, vp = rnd(T, cs.HQ, cs.D), rnd(cs.KV, P, cs.PSZ, cs.D), \
        rnd(cs.KV, P, cs.PSZ, cs.D)
    out.append(("step_8b", (qa, kp, vp, *tabs), None, "bar"))
    out.append(("decode_only_8b", (qa, kp, vp, *dec), None, "bar"))
    for tag, (hq, kv) in cs.REP_SHAPES.items():
        out.append((tag, (rnd(T, hq, cs.D), rnd(kv, P, cs.PSZ, cs.D),
                          rnd(kv, P, cs.PSZ, cs.D), *tabs), None, "bar"))
    Pl, lens, tables = cs.long_context_batch(g)
    B = lens.shape[0]
    ltabs = (torch.arange(B, dtype=torch.int32, device="cuda"),
             torch.ones(B, dtype=torch.int32, device="cuda"), lens, tables)
    out.append(("long", (rnd(B, cs.HQ, cs.D), rnd(cs.KV, Pl, cs.PSZ, cs.D),
                         rnd(cs.KV, Pl, cs.PSZ, cs.D), *ltabs), None, "bar"))
    # DeepSeek-V2's latent row, as check_mla_kernels draws it
    nh, D_lat = cs.MLA_HEADS, cs.MLA_R + cs.MLA_ROPE
    scale = (cs.MLA_NOPE + cs.MLA_ROPE) ** -0.5
    Pp = 96
    tab = (torch.randperm(Pp - 1, generator=g)[:5 * 16].reshape(5, 16)
           .to(torch.int32) + 1).cuda()
    ss = torch.arange(cs.SLOTS + 1, dtype=torch.int32, device="cuda")
    for case, nt_, kvl_ in (("mla_decode", [1, 1, 0, 1, 0],
                             [200, 17, 0, 255, 0]),
                            ("mla_chunk", [1, 1, 0, 1, cs.CHUNK],
                             [200, 17, 0, 255, 64 + cs.CHUNK])):
        pool = rnd(1, Pp, cs.PSZ, D_lat)
        out.append((case, (rnd(T, nh, D_lat), pool, pool, ss,
                           torch.tensor(nt_, dtype=torch.int32,
                                        device="cuda"),
                           torch.tensor(kvl_, dtype=torch.int32,
                                        device="cuda"), tab), scale, "mla"))
    return out


def host_us(fn, n: int = 200) -> float:
    """The host's time of one call of `fn`, in us: the median over `n`
    calls launched back to back (the card runs behind; the queue holds
    them all)."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return 1e6 * statistics.median(ts)


def read_case(cs, ops, args, scale, check, timer=None, split=None):
    """One case's readings (and time with `timer`)."""
    if split is None:
        got = ops.ragged_paged_attention(*args, scale=scale)
    else:
        got = ops.ragged._launch(*args, scale=scale, split=split)
    torch.cuda.synchronize()
    want = ops.ragged_attention_reference(*args, scale=scale)
    q, kp, vp, ss, nt, kvl, _ = args
    owned = torch.zeros(q.shape[0], dtype=torch.bool)
    for a, n in zip(ss.tolist(), nt.tolist()):
        owned[a:a + n] = True
    owned = owned.cuda()
    D = q.shape[-1]
    tensor, row = cs.row_rel_errors(got[owned].reshape(-1, D),
                                    want[owned].reshape(-1, D))
    a, w = got.float(), want.float()
    r = {"tensor": tensor, "row": row, "max_abs_err": cs.max_err(got, want),
         "finite": bool(torch.isfinite(a).all()),
         "unowned_zero": float(a[~owned].abs().sum()) == 0.0,
         "bar_passes": bool(((a - w).abs() <= 2e-2 + 2e-2 * w.abs()).all())}
    lim = cs.MLA_BF16_LIMITS["ragged_576"]
    r["phase2_passes"] = r["finite"] and r["unowned_zero"] and \
        tensor <= lim[0] and row <= lim[1] and \
        (r["bar_passes"] or check != "bar")
    if timer is not None:
        live = sum(k for k, n in zip(kvl.tolist(), nt.tolist()) if n)
        kv_bytes = live * kp.shape[0] * D * kp.element_size() * (
            1 if kp.data_ptr() == vp.data_ptr() else 2)
        if split is None:
            r["ms"] = timer.ms(lambda: ops.ragged_paged_attention(
                *args, scale=scale))
            r["host_us"] = host_us(lambda: ops.ragged_paged_attention(
                *args, scale=scale))
        else:
            r["ms"] = timer.ms(lambda: ops.ragged._launch(
                *args, scale=scale, split=split))
        r["bound_ms"] = cs.bound(kv_bytes + cs.nbytes(q, got, ss, nt, kvl,
                                                      args[6]))[0]
    return r


def readings(timed: bool = False, splits: bool = False) -> dict:
    """Every reading of the checkout this process runs in."""
    import chip_smoke as cs
    from paddle_tpu_torch import card_report, ops
    from paddle_tpu_torch.ops import _build

    cs.DEV = "cuda"
    _build.library()
    out = {"package": str(Path(ops.__file__).resolve().parent.parent),
           "card": card_report()["nvidia_smi"], "cases": {}}
    timer = cs.Timer() if timed or splits else None
    g = torch.Generator().manual_seed(0)
    gc = torch.Generator("cuda").manual_seed(0)
    for name, args, scale, check in cases(cs, g, gc):
        out["cases"][name] = read_case(cs, ops, args, scale, check, timer)
        if splits:
            out["cases"][name]["splits"] = {
                k: read_case(cs, ops, args, scale, check, timer, k)["ms"]
                for k in SPLITS}
        del args
    out["phase2_passes"] = all(c["phase2_passes"]
                               for c in out["cases"].values())
    return out


def card_tests(cwd: Path) -> dict:
    return {f"{t}::{k}": flash_limits.card_tests(cwd, t, k)
            for t, k in TESTS}


def run_readings(cwd: Path, *flags: str) -> dict:
    """`readings` in a process of its own, in checkout `cwd`."""
    r = subprocess.run([sys.executable, "ragged_limits.py",
                        "--readings-only", *flags], cwd=cwd,
                       capture_output=True, text=True, timeout=900)
    if r.returncode != 0:
        return {"rc": r.returncode, "stderr_tail": r.stderr[-2000:]}
    return json.loads(r.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--faults", type=Path, default=None,
                    help="plant each fault in a copy under this directory")
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout of another commit to time against")
    ap.add_argument("--splits", action="store_true",
                    help="time forced key splits beside the plan's")
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--readings-only", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--timed", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ragged_limits.py: no CUDA device", file=sys.stderr)
        return 2
    if args.readings_only:
        print(json.dumps(readings(args.timed, args.splits)), flush=True)
        return 0
    here = flash_limits.HERE
    lines = []

    def put(res):
        lines.append(res)
        print(json.dumps(res), flush=True)

    if args.parent is not None:
        parent = args.parent.resolve()
        shutil.copy2(here / "ragged_limits.py", parent / "ragged_limits.py")
        for tag, cwd in (("parent", parent), ("this", here),
                         ("this", here), ("parent", parent)):
            put(dict(name=f"timed_{tag}", **run_readings(cwd, "--timed")))
    if args.splits:
        put(dict(name="splits", **run_readings(here, "--splits")))
    if args.parent is None and not args.splits:
        put(dict(name="sound", **run_readings(here),
                 card_tests=card_tests(here)))
    for name in FAULTS if args.faults else ():
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
