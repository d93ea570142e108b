#!/usr/bin/env python3
"""Readings of the bf16 flash checks on one NVIDIA card, for the sound
kernels and for planted faults.

    python3 flash_limits.py [--faults DIR] [--out FILE]

``chip_smoke.py`` holds the bf16 flash kernels (the forward and the
fused backward: o, dq, dk, dv) to their plain version by two relative
errors per tensor
(`chip_smoke.flash_rel_errors`: over the tensor, and the largest over
its 64-position tiles of a head) and the tiny bf16 pretraining run on
the card to the CPU's (phase 6). This script prints what those measures
read, so that each limit can sit between the sound kernels' readings and
a wrong kernel's. Beside them it prints the largest error of a single
row (one head's D values at one position, its norm floored at 1% of the
median row norm), where it sits and, for that row, the largest
probability of its softmax:

- o, dq, dk, dv at the training shape (B 1, S 8192, 32 heads x 128,
  causal), as phase 2 runs it, and at the card tests' small shapes
  (B 2, 3 heads, D 64 and 128; causal and not, ragged tiles with and
  without the causal mask, segments, Sq < Sk, Sq > Sk);
- the tiny pretraining run's largest relative distance from the CPU in
  losses and grad norms, in f32 and bf16 (phase 6);
- the card tests of tests/test_torch_flash.py (``-m cuda``), passed and
  failed.

With ``--faults DIR``, each fault of `FAULTS` (one text substitution in
``paddle_tpu_torch/ops/csrc/flash_attention.cu``) is planted in a copy of
the package made under DIR, built there, and read the same way in a
process of its own. The checkout itself is never changed. One JSON
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

HERE = Path(__file__).resolve().parent
KERNEL = "paddle_tpu_torch/ops/csrc/flash_attention.cu"

#: name -> (what it breaks, text, replacement, which occurrence (0-based))
FAULTS = {
    "fwd_skips_last_kv_tile": (
        "forward: each q tile's loop stops one K / V tile short (causal: "
        "the diagonal tile; otherwise the last, ragged one)",
        "const int n_kt = kv_end > 0 ? (kv_end + BKV - 1) / BKV : 0;",
        "const int n_kt = kv_end > 0 ? (kv_end + BKV - 1) / BKV - 1 : 0;",
        0),
    "fwd_stale_rescale": (
        "forward: the accumulator is no longer rescaled after the 4th K / V "
        "tile when the row max grows (the row sum still is)",
        "for (int e = 0; e < 4; ++e) o[4 * j + e] *= alpha[e >> 1];",
        "for (int e = 0; e < 4; ++e) o[4 * j + e] *= kt < 4 ? "
        "alpha[e >> 1] : 1.f;", 0),
    "fwd_diagonal_unmasked": (
        "forward: causal tiles inside the ragged edges skip the mask, so "
        "the diagonal tile's keys above the diagonal are seen",
        "if (!tile_visible(p, r0, 64, k0, BKV)) {",
        "if (!tile_visible(p, r0, 64, k0, BKV) && !(p.causal && "
        "p.seg_q == nullptr && k0 + BKV <= p.Sk && r0 + 64 <= p.Sq)) {", 0),
    "bwd_skips_last_q_tile": (
        "backward: each key tile's loop stops one 64-row Q / dO tile short",
        "const int n_it = max(0, (p.Sq + BQ - 1) / BQ - qt0);",
        "const int n_it = max(0, (p.Sq + BQ - 1) / BQ - qt0 - 1);", 0),
    "dq_drops_first_tile_add": (
        "dq: the bulk add of each key tile's first q tile (causal: the "
        "diagonal one) into the f32 workspace is dropped",
        "bulk_reduce_add(dq_g + (size_t)r0 * D, dq_s, G::DQ_BYTES);",
        "if (it > 0) bulk_reduce_add(dq_g + (size_t)r0 * D, dq_s, "
        "G::DQ_BYTES);", 0),
    "ds_drops_di": (
        "backward: ds = p dp scale, the di term dropped (dk and dq; dv "
        "untouched)",
        "da[kk][r] = pack_bf16(s[x] * (dp[x] - di2.x) * p.scale,\n"
        "                                s[x + 1] * (dp[x + 1] - di2.y) * "
        "p.scale);",
        "da[kk][r] = pack_bf16(s[x] * dp[x] * p.scale,\n"
        "                                s[x + 1] * dp[x + 1] * p.scale);",
        0),
    "dk_stale_accumulation": (
        "dk: each q tile's product overwrites the accumulator instead of "
        "adding to it (dk keeps the last tile's share only)",
        "mma_rs<1>(dk, da[kk], desc_mn(qb, BQ, kk), 1);",
        "mma_rs<1>(dk, da[kk], desc_mn(qb, BQ, kk), kk > 0);", 0),
    "keys_past_the_edge_visible": (
        "every kernel: keys past Sk (the zero-filled rows of a ragged "
        "last tile) are no longer hidden",
        "if (col >= p.Sk || row >= p.Sq) return true;",
        "if (row >= p.Sq) return true;", 0),
}

#: the card tests' shapes (TestFlashOnCard.test_kernel_matches_plain)
SMALL = [(256, 256, True, False), (256, 256, False, False),
         (200, 200, True, True), (200, 200, False, True),
         (96, 160, True, False), (96, 160, False, False),
         (160, 96, True, False)]


def _worst_row(got, want, q, k, causal, scale):
    """The row error's largest value (each row's norm floored at 1% of
    the median row norm), where it sits (b, s, h), that row's norm over
    the median, and, for a q row (o, dq; k given), the largest
    probability of its softmax (causal masking only)."""
    B, Sq, H, D = want.shape
    w = want.detach().float().reshape(-1, D)
    d = got.detach().float().reshape(-1, D) - w
    wn = w.norm(dim=1)
    med = float(wn.median())
    err = d.norm(dim=1) / wn.clamp_min(1e-2 * med)
    i = int(err.argmax())
    b, s, h = i // (Sq * H), (i // H) % Sq, i % H
    p_max = None
    if k is not None:
        Sk = k.shape[1]
        sc = (k[b, :, h].float() @ q[b, s, h].float()) * scale
        if causal:
            sc[s + Sk - Sq + 1:] = float("-inf")
        p_max = float(torch.softmax(sc, 0).max())
    return {"row": float(err[i]), "at": [b, s, h],
            "norm_over_median": float(wn[i]) / med, "p_max": p_max}


def plant(name: str, root: Path, faults=FAULTS, kernel: str = KERNEL,
          files=("chip_smoke.py", "flash_limits.py", "pytest.ini",
                 "tests/test_torch_flash.py")) -> Path:
    """A copy of what the readings run (the package without its build,
    and `files`: the card scripts and tests) under root/name, with fault
    `name` of `faults` planted in the kernel source `kernel`: each
    (text, replacement, occurrence) triple after the fault's description
    is one substitution, made in order."""
    _, *edits = faults[name]
    dst = root / name
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(HERE / "paddle_tpu_torch", dst / "paddle_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for f in files:
        (dst / f).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy2(HERE / f, dst / f)
    src = dst / kernel
    text = src.read_text()
    for i in range(0, len(edits), 3):
        old, new, which = edits[i:i + 3]
        parts = text.split(old)
        if len(parts) < which + 2:
            raise RuntimeError(f"fault {name}: text not found in {kernel}")
        text = old.join(parts[:which + 1]) + new + old.join(parts[which + 1:])
    src.write_text(text)
    return dst


def card_tests(cwd: Path, test_file: str = "tests/test_torch_flash.py",
               k: str = None):
    """Pass / fail summary of a card-only test file run in `cwd` (``k``: a
    pytest -k expression selecting some of its tests)."""
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-q", "-m", "cuda",
         "-p", "no:cacheprovider", test_file, *(["-k", k] if k else [])],
        cwd=cwd, capture_output=True, text=True, timeout=600)
    tail = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
    return {"rc": r.returncode, "summary": tail}


def readings() -> dict:
    """Every reading of the sound or planted checkout this process runs
    in."""
    import chip_smoke as cs
    from paddle_tpu_torch import card_report, ops
    from paddle_tpu_torch.ops import _build

    cs.DEV = "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.library()
    fwd_ref = ops.flash_sdpa_reference
    out = {"package": str(Path(ops.__file__).resolve().parent.parent),
           "card": card_report()["nvidia_smi"], "cases": {}}

    def one(tag, B, Sq, Sk, H, D, causal, seg, seed, by_heads):
        g = torch.Generator("cuda").manual_seed(seed)
        r = lambda S: torch.randn(B, S, H, D, device="cuda",  # noqa: E731
                                  generator=g).to(torch.bfloat16)
        q, k, v, do = r(Sq), r(Sk), r(Sk), r(Sq)
        kw = dict(causal=causal)
        if seg:
            s = torch.randint(0, 3, (B, Sq), device="cuda", generator=g)
            kw.update(segment_ids_q=s, segment_ids_kv=s)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        o = ops.flash_sdpa(*leaves, **kw)
        o.backward(do)
        if by_heads:        # the dense plain version, 4 heads at a time
            with torch.no_grad():
                want_o = cs.by_heads(lambda a, b, c: fwd_ref(a, b, c, **kw),
                                     q, k, v)
            want_g = cs.by_heads(
                lambda a, b, c, d: ops.flash_sdpa_bwd_reference(a, b, c, d,
                                                                **kw),
                q, k, v, do)
        else:
            ref = [t.clone().requires_grad_() for t in (q, k, v)]
            want_o = fwd_ref(*ref, **kw)
            want_o.backward(do)
            want_g = [t.grad for t in ref]
        got = {"o": o, "dq": leaves[0].grad, "dk": leaves[1].grad,
               "dv": leaves[2].grad}
        want = dict(zip(("o", "dq", "dk", "dv"), (want_o, *want_g)))
        res = {}
        for n in got:
            finite = bool(torch.isfinite(got[n]).all())
            t, tile = cs.flash_rel_errors(got[n], want[n])
            # the bar these checks replaced: 2e-2 of the largest value
            a, w = got[n].detach().float(), want[n].detach().float()
            old = bool(((a - w).abs() <= 2e-2 * w.abs().max()
                        + 2e-2 * w.abs()).all())
            res[n] = {"tensor": t, "tile": tile, "finite": finite,
                      "old_bar_passes": old,
                      **_worst_row(got[n], want[n], q,
                                   k if n in ("o", "dq") and not seg
                                   else None, causal, D ** -0.5)}
        out["cases"][tag] = res

    one("train_S8192_D128_causal", 1, cs.TRAIN_SEQ, cs.TRAIN_SEQ, cs.HQ,
        cs.D, True, False, 1, True)
    torch.cuda.empty_cache()
    for D in (64, 128):
        for Sq, Sk, causal, seg in SMALL:
            one(f"small_D{D}_{Sq}x{Sk}_{'causal' if causal else 'full'}"
                f"{'_seg' if seg else ''}", 2, Sq, Sk, 3, D, causal, seg,
                Sq + Sk + D, False)
    lim_t, lim_r = cs.FLASH_BF16_TENSOR_LIMIT, cs.FLASH_BF16_TILE_LIMIT
    out["smoke_check_passes"] = all(
        v["finite"] and v["tensor"] <= lim_t and v["tile"] <= lim_r
        for v in out["cases"]["train_S8192_D128_causal"].values())
    out["small_max"] = {
        m: max(c[n][m] for tag, c in out["cases"].items()
               if tag.startswith("small") for n in c)
        for m in ("tensor", "tile", "row")}
    for dt, lim in cs.TINY_TRAIN_LIMITS.items():
        r = cs.tiny_train_readings(dt)
        out[f"tiny_train_{dt}"] = {
            "loss_rel": r["loss_rel"], "grad_norm_rel": r["grad_norm_rel"],
            "passes": r["loss_rel"] <= lim["loss"]
            and r["grad_norm_rel"] <= lim["grad_norm"]}
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
        print("flash_limits.py: no CUDA device", file=sys.stderr)
        return 2
    if args.readings_only:
        print(json.dumps(readings()), flush=True)
        return 0
    lines = []
    sound = dict(name="sound", **readings(), card_tests=card_tests(HERE))
    lines.append(sound)
    print(json.dumps(sound), flush=True)
    torch.cuda.empty_cache()
    for name in FAULTS if args.faults else ():
        cwd = plant(name, args.faults.resolve())
        r = subprocess.run([sys.executable, "flash_limits.py",
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
