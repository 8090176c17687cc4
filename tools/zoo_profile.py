#!/usr/bin/env python3
"""Where a prefill and a decode step of the LLM zoo's dense path spend
their time, on one CUDA card.

    python3 tools/zoo_profile.py                 # on a machine with a CUDA card
    python3 tools/zoo_profile.py --smoke --device cpu   # the smoke config, a dry run

chip_smoke.py phase 12a's configuration: internlm2-1.8b at its published
widths (bf16, random weights from --seed), a batch of 8 prompts of 512
tokens in a cache of 576 positions. After a warm-up, one prefill and
--steps decode steps run under ``torch.profiler`` (CPU and CUDA
activities). Prints, for the prefill and for a decode step: the host's wall
ms (ending in a synchronize), the device's busy ms (the sum of the kernels'
times), the kernel launches, and the kernels that took most of the device
time, grouped by name. On the CPU there is no device time; the dry run
only checks that the script runs.
"""
import argparse
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_summary(prof, top):
    """(busy ms, launches, [(name, ms, count)]) of the profiled device kernels."""
    rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    launches = sum(e.count for e in rows)
    heavy = sorted(rows, key=lambda e: -e.self_device_time_total)[:top]
    return busy, launches, [(e.key, e.self_device_time_total / 1e3, e.count) for e in heavy]


def main(argv=None):
    import torch_serve
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=512)
    ap.add_argument("--gen", type=int, default=64)
    ap.add_argument("--steps", type=int, default=8, help="decode steps profiled")
    ap.add_argument("--top", type=int, default=8)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        sys.exit("zoo_profile.py: no CUDA card")

    cfg = get_config(args.arch, smoke=args.smoke)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    batch = torch_serve.make_batch(cfg, args.batch, args.prompt, args.seed, dev)
    max_len = args.prompt + args.gen
    torch_serve.serve(model, params, batch, 3)  # warm-up

    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out = {}
    with torch.profiler.profile(activities=acts) as prof:
        sync(dev)
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, {**batch, "max_len": max_len})
        sync(dev)
        wall = time.perf_counter() - t0
    out["prefill"] = (wall * 1e3, *device_summary(prof, args.top))
    toks = torch.argmax(logits, -1)[:, None].to(torch.int32)
    logits, cache = model.decode_step(params, cache, toks)  # the decode shapes' first call
    with torch.profiler.profile(activities=acts) as prof:
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(args.steps):
            toks = torch.argmax(logits, -1)[:, None].to(torch.int32)
            logits, cache = model.decode_step(params, cache, toks)
        sync(dev)
        wall = time.perf_counter() - t0
    busy, launches, heavy = device_summary(prof, args.top)
    out["decode step"] = (wall * 1e3 / args.steps, busy / args.steps, launches / args.steps,
                          [(n, ms / args.steps, c / args.steps) for n, ms, c in heavy])
    name = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
    print(f"{cfg.name} on {name}: batch {args.batch}, prompt {args.prompt}, cache {max_len}")
    for what, (wall_ms, busy_ms, n, heavy) in out.items():
        print(f"  {what}: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
              f"({busy_ms / wall_ms * 100 if wall_ms else 0:.1f} %), {n:.0f} kernel launches")
        for kname, ms, c in heavy:
            print(f"    {ms:9.4f} ms  x{c:<6.0f} {kname[:110]}")
    return out


if __name__ == "__main__":
    main()
