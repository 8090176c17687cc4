"""The largest tensors live at a dry-run cell's memory peak, and where the
port's code made them.

    PYTHONPATH=src python3 tools/dryrun_peak.py --arch internlm2-1.8b --shape prefill_32k \\
        --layers 3 [--mesh single|multi] [--microbatches 1] [--top 8]

Steps one cell of ``launch/dryrun.py`` on the production mesh's fake
256 / 512 ranks (CPU, meta tensors, no device metric) at full width and
``--layers`` layers, with ``memory.LiveBytes`` wrapped to remember each
storage's shape, dtype, the op that made it and the line of
``src/repro_torch/`` that called it (the innermost frame of the port's
model, train or sharding code on the stack at the op, and the autograd
node's name where the op runs in a backward pass), and prints the tensors live
at the peak of step-made bytes, largest first (for a train cell of A > 1
microbatches, the peak of its one microbatch's run, before the reckoning;
``--microbatches`` sets A). ``Tracer`` does the same for any step run
under a ``CellCounter`` (the CPU tests' small meshes).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

import torch
from torch.utils._pytree import tree_leaves

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch import memory as M
from repro_torch.launch.mesh import make_production_mesh

PORT = str(Path(D.__file__).resolve().parents[1]).replace("\\", "/") + "/"
MACHINERY = ("launch/dryrun.py", "launch/memory.py")


def caller_line() -> str:
    """The innermost frame of the port's own code on the stack (not the dry
    run's counting), as ``path:line`` under ``src/repro_torch/``, or
    ``"?"``; with the autograd node's name after it for an op the engine
    runs in a backward pass."""
    frame, line = sys._getframe(1), "?"
    while frame is not None:
        name = frame.f_code.co_filename.replace("\\", "/")
        if name.startswith(PORT) and not name.endswith(MACHINERY):
            line = f"{name[len(PORT):]}:{frame.f_lineno}"
            break
        frame = frame.f_back
    node = torch._C._current_autograd_node()
    return line if node is None else f"{line} (backward: {node.name()})"


class Tracer:
    """While installed (``with Tracer() as t:``), every storage a
    ``CellCounter`` counts is remembered as ``t.made_by[sid] = (shape,
    dtype, op, line)``, and each ``LiveBytes.summary`` keeps the live set
    at its peak of step-made bytes in ``t.peak`` ({"bytes", "live": {sid:
    bytes}})."""

    def __init__(self):
        self.made_by, self.peak = {}, {}
        self._op = None

    def __enter__(self):
        tracer = self
        made, dispatch, summary = M.LiveBytes.made, D.CellCounter.__torch_dispatch__, \
            M.LiveBytes.summary
        self._saved = made, dispatch, summary

        def remember(live, out):
            first = live._next
            made(live, out)
            tensors = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
            for sid, t in zip(range(first, live._next), tensors):
                tracer.made_by[sid] = (tuple(t.shape), str(t.dtype).split(".")[-1], tracer._op,
                                       caller_line())

        def named(counter, func, types, args=(), kwargs=None):
            tracer._op = str(func)
            return dispatch(counter, func, types, args, kwargs)

        def at_peak(live, out):
            cur, run, best = {}, 0, 0
            for sid, d in live.deltas():
                cur[sid] = cur.get(sid, 0) + d
                if not cur[sid]:
                    del cur[sid]
                run += d
                if run > best:
                    best, tracer.peak["live"] = run, dict(cur)
            tracer.peak["bytes"] = best
            tracer.peak.setdefault("live", {})
            return summary(live, out)

        M.LiveBytes.made, D.CellCounter.__torch_dispatch__, M.LiveBytes.summary = \
            remember, named, at_peak
        return self

    def __exit__(self, *exc):
        M.LiveBytes.made, D.CellCounter.__torch_dispatch__, M.LiveBytes.summary = self._saved

    def largest(self, top: int):
        """The ``top`` largest storages live at the last peak: (bytes,
        (shape, dtype, op, line))."""
        live = sorted(self.peak.get("live", {}).items(), key=lambda kv: -kv[1])[:top]
        return [(b, self.made_by.get(sid)) for sid, b in live]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--top", type=int, default=8)
    args = ap.parse_args(argv)

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
    reckon = D.reckon_train

    def reckon_after_peak(tcfg, state, counter, out, context):
        counter.live.summary(out)
        return reckon(tcfg, state, counter, out, context)

    D.reckon_train = reckon_after_peak
    with Tracer() as tracer:
        rec = D.step_cell(cfg, SHAPES[args.shape], lay, args.mesh)
    print(f"{args.arch} {args.shape} {args.mesh}, {args.layers} layers, microbatches "
          f"{rec.get('microbatches', 1)}: temp {rec['temp_size_in_bytes']:,} B, output "
          f"{rec['output_size_in_bytes']:,} B, step {rec['step_s']} s")
    print(f"peak of step-made bytes {tracer.peak['bytes']:,} B; the largest live there:")
    for b, made in tracer.largest(args.top):
        shape, dtype, op, line = made or ("?",) * 4
        print(f"  {b / 1e9:10.3f} GB  {shape} {dtype} {op}  {line}")


if __name__ == "__main__":
    main()
