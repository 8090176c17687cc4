#!/usr/bin/env python3
"""Run some of chip_smoke.py's phases alone, after building the kernels.

    python3 tools/chip_phases.py zoo train [chip_smoke.py's flags]   # on a card
    python3 tools/chip_phases.py zoo train --device cpu --zoo-smoke --zoo-batch 2 \\
        --zoo-prompt 32 --zoo-gen 8 --zoo-requests 6 --zoo-slots 3 \\
        --zoo-req-prompt 8,24 --zoo-docs 320 --moe-batch 2 --moe-prompt 32 --moe-gen 6

Phases, in the order given: ``zoo`` (12: the LLM zoo's serving path, MoE,
Zamba2 and Whisper included), ``train`` (13: the training path; runs
``zoo`` first if it was not given, since 13c prints 12c's accuracy beside
its own), ``families`` (12e-12g alone: Zamba2, its long_500k decode,
Whisper), ``launcher`` (13d alone: both trained through the launcher),
``baselines`` (11), ``live`` (10). Every other argument is chip_smoke.py's.
"""
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
import chip_smoke as smoke  # noqa: E402

PHASES = ("zoo", "train", "families", "launcher", "baselines", "live")


def main(argv):
    names = [a for a in argv if a in PHASES]
    args = smoke.parse_args([a for a in argv if a not in PHASES])
    dev = torch.device(args.device)
    if dev.type == "cuda":
        from repro_torch.kernels import _build

        _build.build()
    t0 = time.perf_counter()
    zoo = None
    for name in names:
        if name == "zoo" or (name == "train" and zoo is None):
            zoo = smoke.phase_zoo(dev, args)
        if name == "train":
            smoke.phase_train(dev, args, zoo)
        elif name == "families":
            smoke.phase_families(dev, args)
        elif name == "launcher":
            smoke.train_launcher(dev, args)
        elif name == "baselines":
            smoke.phase_baselines(dev, args)
        elif name == "live":
            smoke.phase_live(dev, args, None)
    print(f"phases {', '.join(names)}: {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main(sys.argv[1:])
