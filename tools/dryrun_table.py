"""Print the dry run's per-device memory as a markdown table.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results/dryrun_torch
    python3 tools/dryrun_table.py [results/dryrun_torch] [--card-gb 80]

One row per (arch, shape), the single- and multi-pod meshes side by side:
one device's argument / output / temp GB (1e9 bytes) from each record of
``launch/dryrun.py`` (the CPU stand-in: no device metric), the step's
seconds, and a mark where argument + output + temp exceeds ``--card-gb``
(an H100's 80 GB). Skipped cells are listed under the table; a cell that
failed prints its status.

    python3 tools/dryrun_table.py NEW --before OLD

adds each cell's temp GB in OLD's records beside NEW's, and under the
table compares the two runs cell by cell: ``flops_global`` and the
``fallbacks`` counts (equal or not), one device's flops and collective
bytes (the ratio OLD / NEW), and NEW's ``fallback_replicated`` summed by
op and kind, with the cells where an ``aten.view`` fallback replicated
``data`` or ``all``.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

MESHES = ("single", "multi")


def cell(rec, card_gb, before=None):
    if rec is None:
        return "—"
    if rec["status"] != "OK":
        return rec["status"]
    a, o, t = (rec[k] / 1e9 for k in ("argument_size_in_bytes", "output_size_in_bytes",
                                      "temp_size_in_bytes"))
    mark = " **>**" if a + o + t > card_gb else ""
    was = "" if before is None else f" [{before['temp_size_in_bytes'] / 1e9:.2f}]"
    return f"{a:.2f} / {o:.2f} / {t:.2f}{was}{mark} ({rec['step_s']} s)"


def load(out):
    recs = {}
    for path in sorted(Path(out).glob("*.json")):
        rec = json.loads(path.read_text())
        if path.stem.endswith("__smoke"):
            continue
        recs[(rec["arch"], rec["shape"], path.stem.split("__")[2])] = rec
    return recs


def compare(recs, before):
    """The cell-by-cell comparison printed under the table."""
    both = [k for k, r in recs.items()
            if r["status"] == "OK" and before.get(k, {}).get("status") == "OK"]
    name = lambda k: "/".join(k)
    diff = lambda key: [name(k) for k in both if recs[k][key] != before[k][key]]
    print(f"\ncompared with the earlier run in {len(both)} cells: flops_global differs in "
          f"{diff('flops_global') or 'none'}; fallbacks differ in {diff('fallbacks') or 'none'}")
    for key, what in (("flops", "flops per device"),
                      ("collective_bytes", "collective bytes per device")):
        value = (lambda r: r[key]) if key == "flops" else (lambda r: sum(r[key].values()))
        ratios = sorted((value(before[k]) / value(recs[k]), name(k)) for k in both
                        if value(recs[k]))
        if ratios:
            mid = ratios[len(ratios) // 2][0]
            print(f"{what}, earlier / now: {ratios[0][0]:.3g} ({ratios[0][1]}) to "
                  f"{ratios[-1][0]:.3g} ({ratios[-1][1]}), median {mid:.3g}")
    kinds, wide = {}, []
    for k, r in sorted(recs.items()):
        for op, how in r.get("fallback_replicated", {}).items():
            for dim, n in how.items():
                kinds[(op, dim)] = kinds.get((op, dim), 0) + n
                if op == "aten.view" and dim != "model":
                    wide.append(f"{name(k)} ({dim} {n})")
    print("fallback_replicated, summed: "
          + (", ".join(f"{op} {dim} {n}" for (op, dim), n in sorted(kinds.items())) or "none")
          + f"; aten.view fallbacks that replicated more than model: {', '.join(wide) or 'none'}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out", nargs="?", default="results/dryrun_torch")
    ap.add_argument("--card-gb", type=float, default=80.0)
    ap.add_argument("--before", default=None,
                    help="an earlier run's records: its temp GB beside, and the comparison")
    args = ap.parse_args(argv)
    recs = load(args.out)
    before = {} if args.before is None else load(args.before)
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
        was = [before.get((arch, shape, m)) if before else None for m in MESHES]
        print(f"| {arch} | {shape} | "
              + " | ".join(cell(r, args.card_gb, w) for r, w in zip(got, was)) + " |")
    n_ok = sum(r["status"] == "OK" for r in recs.values())
    print(f"\n{n_ok} cells OK, {over} over {args.card_gb:g} GB (**>**); step seconds "
          + ", ".join(f"{m} {total[m]:.1f}" for m in MESHES)
          + f"; skipped on both meshes: {', '.join(skipped) or 'none'}")
    if before:
        compare(recs, before)


if __name__ == "__main__":
    main()
