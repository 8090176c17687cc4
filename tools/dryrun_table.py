"""Print the dry run's per-device memory as a markdown table.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results/dryrun_torch
    python3 tools/dryrun_table.py [results/dryrun_torch] [--card-gb 80]

One row per (arch, shape), the single- and multi-pod meshes side by side:
one device's argument / output / temp GB (1e9 bytes) from each record of
``launch/dryrun.py`` (the CPU stand-in: no device metric), the step's
seconds, and a mark where argument + output + temp exceeds ``--card-gb``
(an H100's 80 GB). Skipped cells are listed under the table; a cell that
failed prints its status.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

MESHES = ("single", "multi")


def cell(rec, card_gb):
    if rec is None:
        return "—"
    if rec["status"] != "OK":
        return rec["status"]
    a, o, t = (rec[k] / 1e9 for k in ("argument_size_in_bytes", "output_size_in_bytes",
                                      "temp_size_in_bytes"))
    mark = " **>**" if a + o + t > card_gb else ""
    return f"{a:.2f} / {o:.2f} / {t:.2f}{mark} ({rec['step_s']} s)"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out", nargs="?", default="results/dryrun_torch")
    ap.add_argument("--card-gb", type=float, default=80.0)
    args = ap.parse_args(argv)
    recs = {}
    for path in sorted(Path(args.out).glob("*.json")):
        rec = json.loads(path.read_text())
        if path.stem.endswith("__smoke"):
            continue
        recs[(rec["arch"], rec["shape"], path.stem.split("__")[2])] = rec
    rows = sorted({(a, s) for a, s, _ in recs})
    print("| Arch | Shape | single: args / out / temp GB (step) | multi: args / out / temp GB (step) |")
    print("|---|---|---|---|")
    skipped, over, total = [], 0, {m: 0.0 for m in MESHES}
    for arch, shape in rows:
        got = [recs.get((arch, shape, m)) for m in MESHES]
        if all(r is not None and r["status"] == "SKIP" for r in got):
            skipped.append(f"{arch}/{shape}")
            continue
        for m, r in zip(MESHES, got):
            if r is not None and r["status"] == "OK":
                total[m] += r["step_s"]
                over += sum(r[k] for k in ("argument_size_in_bytes", "output_size_in_bytes",
                                           "temp_size_in_bytes")) > args.card_gb * 1e9
        print(f"| {arch} | {shape} | " + " | ".join(cell(r, args.card_gb) for r in got) + " |")
    n_ok = sum(r["status"] == "OK" for r in recs.values())
    print(f"\n{n_ok} cells OK, {over} over {args.card_gb:g} GB (**>**); step seconds "
          + ", ".join(f"{m} {total[m]:.1f}" for m in MESHES)
          + f"; skipped on both meshes: {', '.join(skipped) or 'none'}")


if __name__ == "__main__":
    main()
