"""The largest tensors live at a dry-run cell's memory peak.

    PYTHONPATH=src python3 tools/dryrun_peak.py --arch internlm2-1.8b --shape prefill_32k \\
        --layers 3 [--mesh single|multi] [--microbatches 1] [--top 8]

Steps one cell of ``launch/dryrun.py`` on the production mesh's fake
256 / 512 ranks (CPU, meta tensors, no device metric) at full width and
``--layers`` layers, with ``memory.LiveBytes`` wrapped to remember each
storage's shape, dtype and the op that made it, and prints the tensors
live at the peak of step-made bytes, largest first (for a train cell of
A > 1 microbatches, the peak of its one microbatch's run, before the
reckoning; ``--microbatches`` sets A).
"""
from __future__ import annotations

import argparse
import dataclasses

import torch
from torch.utils._pytree import tree_leaves

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch import memory as M
from repro_torch.launch.mesh import make_production_mesh


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--top", type=int, default=8)
    args = ap.parse_args(argv)

    made_by = {}  # sid -> (shape, dtype, op)
    op = [None]
    made, dispatch = M.LiveBytes.made, D.CellCounter.__torch_dispatch__

    def remember(self, out):
        first = self._next
        made(self, out)
        tensors = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        for sid, t in zip(range(first, self._next), tensors):
            made_by[sid] = (tuple(t.shape), str(t.dtype).split(".")[-1], op[0])

    def named(self, func, types, args=(), kwargs=None):
        op[0] = str(func)
        return dispatch(self, func, types, args, kwargs)

    M.LiveBytes.made, D.CellCounter.__torch_dispatch__ = remember, named
    if args.microbatches is not None:
        D.microbatches_for = lambda cfg, shape: args.microbatches
    cfg = get_config(args.arch)
    kw = {"n_layers": args.layers}
    if cfg.n_encoder_layers:
        kw["n_encoder_layers"] = args.layers
    cfg = dataclasses.replace(cfg, **kw)
    multi = args.mesh == "multi"
    D._world(512 if multi else 256)
    lay = D.Layout(make_production_mesh(multi_pod=multi, device_type="cpu"))
    peak = {}
    summary = M.LiveBytes.summary

    def at_peak(self, out):
        live, run, best = {}, 0, 0
        for sid, d in self.deltas():
            live[sid] = live.get(sid, 0) + d
            if not live[sid]:
                del live[sid]
            run += d
            if run > best:
                best, peak["live"] = run, dict(live)
        peak["bytes"] = best
        return summary(self, out)

    M.LiveBytes.summary = at_peak
    reckon = D.reckon_train

    def reckon_after_peak(tcfg, state, counter, out, context):
        counter.live.summary(out)
        return reckon(tcfg, state, counter, out, context)

    D.reckon_train = reckon_after_peak
    rec = D.step_cell(cfg, SHAPES[args.shape], lay, args.mesh)
    print(f"{args.arch} {args.shape} {args.mesh}, {args.layers} layers, microbatches "
          f"{rec.get('microbatches', 1)}: temp {rec['temp_size_in_bytes']:,} B, output "
          f"{rec['output_size_in_bytes']:,} B, step {rec['step_s']} s")
    print(f"peak of step-made bytes {peak['bytes']:,} B; the largest live there:")
    for sid, b in sorted(peak["live"].items(), key=lambda kv: -kv[1])[:args.top]:
        print(f"  {b / 1e9:10.3f} GB  {made_by.get(sid)}")


if __name__ == "__main__":
    main()
