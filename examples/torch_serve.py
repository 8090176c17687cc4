"""Batched serving on the PyTorch/CUDA port: prefill + greedy decode with a
KV cache.

    PYTHONPATH=src python examples/torch_serve.py --full          # on a card: the published widths
    PYTHONPATH=src python examples/torch_serve.py --device cpu    # the smoke config, CPU

The flow of examples/serve.py on the port: a static batch of random prompts
is prefilled into a cache of ``prompt_len + gen`` positions, then decoded
greedily one token a step, the cache written in place. ``--full`` takes the
architecture's published config (random weights from ``--seed``), else its
reduced smoke config. Every family serves: the decoders, Zamba2 (its SSM
and conv states beside the shared block's KV cache) and Whisper (``frames``
drawn from ``--seed``, encoded once at the prefill). ``main(argv)`` returns
the numbers it prints;
``serve`` is the path itself (chip_smoke.py phase 12 drives it).
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import build_model


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def make_batch(cfg, batch, prompt_len, seed, device):
    """Random prompt tokens from ``seed``; zero image embeddings for a vlm;
    for an encdec, audio frames (B, encoder_seq, d_model) drawn N(0, 0.1^2)
    from the same generator after the tokens, as examples/serve.py draws
    them."""
    rng = np.random.default_rng(seed)
    out = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab, (batch, prompt_len)), dtype=torch.int32, device=device)}
    if cfg.family == "vlm":
        out["image_embeds"] = torch.zeros(
            (batch, cfg.n_patches, cfg.d_model), dtype=torch.bfloat16, device=device)
    if cfg.family == "encdec":
        out["frames"] = torch.as_tensor(
            rng.normal(size=(batch, cfg.encoder_seq, cfg.d_model)) * 0.1, dtype=torch.float32,
            device=device)
    return out


def serve(model, params, batch, gen, keep_logits=False):
    """Prefill ``batch`` into a cache of prompt + ``gen`` positions, then
    decode ``gen - 1`` greedy steps. Returns the generated tokens (B, gen) on
    the device, the prefill's and the decode loop's seconds (host clock,
    ending in a synchronize) and, with ``keep_logits``, every step's logits
    (prefill's first). The decode loop never synchronizes: each step's
    tokens stay on the device as the next step's input."""
    dev = batch["tokens"].device
    max_len = batch["tokens"].shape[1] + gen
    sync(dev)
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, {**batch, "max_len": max_len})
    sync(dev)
    t_prefill = time.perf_counter() - t0

    kept = [logits] if keep_logits else None
    toks = torch.argmax(logits, -1)[:, None].to(torch.int32)
    out = [toks]
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        logits, cache = model.decode_step(params, cache, toks)
        toks = torch.argmax(logits, -1)[:, None].to(torch.int32)
        out.append(toks)
        if keep_logits:
            kept.append(logits)
    sync(dev)
    t_decode = time.perf_counter() - t0
    return {"tokens": torch.cat(out, dim=1), "prefill_s": t_prefill, "decode_s": t_decode,
            "logits": kept}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full", action="store_true",
                    help="the published config (default: the reduced smoke config)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    cfg = get_config(args.arch, smoke=not args.full)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    B, P = args.batch, args.prompt_len
    res = serve(model, params, make_batch(cfg, B, P, args.seed, dev), args.gen)

    gen = res["tokens"].cpu().numpy()
    n_dec = max(args.gen - 1, 1)
    out = {
        "arch": cfg.name,
        "tokens": gen,
        "prefill_ms": res["prefill_s"] * 1e3,
        "decode_ms_per_token": res["decode_s"] * 1e3 / n_dec,
        "decode_tokens_per_s": (args.gen - 1) * B / max(res["decode_s"], 1e-12),
    }
    print(f"arch={cfg.name} batch={B} prompt={P} generated={gen.shape[1]} device={dev}")
    print(f"prefill: {out['prefill_ms']:.1f} ms   decode: {out['decode_ms_per_token']:.1f} "
          f"ms/token  ({out['decode_tokens_per_s']:.1f} tok/s)")
    print("sample tokens:", gen[0, :12].tolist())
    return out


if __name__ == "__main__":
    main()
