"""K5 (flash attention) on the card, from a given source tree, on the
bf16 layouts that pick its kernel: at the prefill's shape (B=2, S=4096,
Hq=32, Hkv=2, d=128, causal) the TMA-able layout (``main``), v's base one
element past a 16-byte boundary (``shifted``) and q, k, v the first 128
columns of (B, S, H, 132) buffers (``staged``). For each: the path, ms
a ``flash_attention`` call by CUDA events (20 calls after a warm-up, in
turns over the three, twice; the smaller of the two; on ``wgmma_staged``
the copies that TMA can read are part of the call, and where the tree
has ``tma_ready`` their own time is ``copy_ms``), the largest difference
from the plain version and whether it holds the bf16 tolerance (2^-7
relative, 1e-5 absolute), and whether the output equals, bit for bit,
that of the same launch on clones of the inputs.

Before that, at small shapes: a base 1-7 elements off on q, k or v alone
and on all three (bit for bit against aligned clones), and layouts that
TMA cannot read at tile edges, their rows on every 4-byte or every
2-byte boundary (against the plain version).

Run it from the tree whose kernels it measures, or give another tree (a
``git archive`` of another commit, say) to measure that one's; compare
two trees only within one machine session, in turns (A, B, B, A):

    PYTHONPATH=src python3 tools/fa_layouts.py [TREE]

Needs a card and nvcc (builds into TREE/build/kernels). Prints the
build's ptxas lines for ``flash_attention``, the card's name and power
limit, then one JSON line.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

RTOL, ATOL = 2 ** -7, 1e-5
PREFILL = (2, 4096, 32, 2, 128)
STAGED_WIDTH = 132


def main(tree: Path) -> int:
    sys.path.insert(0, str(tree / "src"))
    import torch
    if not torch.cuda.is_available():
        print("fa_layouts: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fa
    assert Path(fa.__file__).resolve().is_relative_to(tree.resolve())
    for line in build.build(["flash_attention"]).get(
            "flash_attention", "").splitlines():
        if ("registers" in line or "spill" in line or "Compiling" in line
                or "serialized" in line):
            print("ptxas:", line.strip())
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    g = torch.Generator(device="cuda").manual_seed(3)
    bf = torch.bfloat16

    def draw(B, S, Hq, Hkv, d, width=None):
        return [torch.randn(B, S, h, width or d, generator=g,
                            device="cuda").to(bf)[..., :d]
                for h in (Hq, Hkv, Hkv)]

    def offset(t, n):
        return torch.cat([t.new_zeros(n), t.flatten()])[n:].view(t.shape)

    def error(got, q, k, v, **kw):
        ref = fa.flash_attention_ref(q, k, v, **kw).float()
        diff = (got.float() - ref).abs()
        return float(diff.max()), bool((diff <= ATOL + RTOL * ref.abs())
                                       .all())

    out = {"tree": str(tree), "paths": list(fa.PATHS)}
    # offset bases: bit for bit against aligned clones
    mismatched = []
    for n in range(1, 8):
        base = draw(1, 300, 8, 2, 128 if n % 2 else 64)
        want = fa.flash_attention(*base, window=130)
        for which in ("q", "k", "v", "qkv"):
            moved = [offset(t, n) if x in which else t
                     for x, t in zip("qkv", base)]
            got = fa.flash_attention(*moved, window=130)
            if not torch.equal(got, want):
                mismatched.append(f"{which}+{n}")
    out["offset_bases"] = {"cases": 28, "path":
                            fa.kernel_path(*moved), "mismatched":
                            mismatched}
    # staged tile edges against the plain version
    edges = []
    for n, (B, S, Hq, Hkv, d, window, causal) in enumerate((
            (1, 1, 4, 2, 128, 0, True), (2, 65, 8, 2, 72, 0, True),
            (1, 129, 4, 1, 100, 0, True), (1, 129, 4, 4, 20, 0, False),
            (1, 4095, 16, 1, 128, 0, True), (1, 300, 4, 2, 128, 1, True),
            (1, 300, 4, 2, 72, 130, True),
            (1, 300, 16, 1, 100, 130, False))):
        # rows on every 4-byte (odd n) or 2-byte (even n) boundary mod 16
        q, k, v = draw(B, S, Hq, Hkv, d, d + 2 + n % 2)
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        err, ok = error(got, q, k, v, causal=causal, window=window)
        edges.append({"case": [B, S, Hq, Hkv, d, window, causal],
                      "path": fa.kernel_path(q, k, v), "err": err, "ok": ok})
    out["staged_edges"] = edges

    # the prefill's shape on the three layouts
    main_l = draw(*PREFILL)
    shifted = main_l[:2] + [offset(main_l[2], 1)]
    staged = draw(*PREFILL, STAGED_WIDTH)
    layouts = {"main": main_l, "shifted": shifted, "staged": staged}
    rows = {}
    for name, (q, k, v) in layouts.items():
        got = fa.flash_attention(q, k, v)
        err, ok = error(got, q, k, v)
        clones = fa.flash_attention(q.clone(), k.clone(), v.clone())
        rows[name] = {"path": fa.kernel_path(q, k, v), "err": err,
                      "within_tol": ok,
                      "equals_clones": bool(torch.equal(got, clones)),
                      "ms": []}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def time_ms(fn):
        fn()
        start.record()
        for _ in range(20):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 20

    for _ in range(2):
        for name, (q, k, v) in layouts.items():
            rows[name]["ms"].append(time_ms(
                lambda: fa.flash_attention(q, k, v)))
            if hasattr(fa, "tma_ready"):
                rows[name].setdefault("copy_ms", []).append(time_ms(
                    lambda: [fa.tma_ready(t) for t in (q, k, v)]))
    for row in rows.values():
        row["min_ms"] = min(row["ms"])
    out["prefill"] = rows
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(Path(sys.argv[1] if len(sys.argv) > 1
                       else Path(__file__).resolve().parents[1])))
