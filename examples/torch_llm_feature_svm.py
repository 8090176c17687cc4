"""A one-pass StreamSVM head over LM backbone features, on the PyTorch/CUDA
port.

    PYTHONPATH=src python examples/torch_llm_feature_svm.py               # on the card
    PYTHONPATH=src python examples/torch_llm_feature_svm.py --device cpu --steps 10 --n-train 256 --n-test 64

The twin of examples/llm_feature_svm.py. A small LM backbone (feat-lm) is
pretrained with the LM objective for 60 steps on a mixed two-style corpus
(``make_train_step``), then embeds documents as multi-level features:
mean-pooled token embeddings beside mean-pooled final hidden states, each
L2-normalised, centred on the first chunk's mean (frozen after it: one
pass) and L2-normalised again. The StreamSVM head learns the style in ONE
pass over the streamed features, with O(d_model) state: fit_chunked with
lookahead 10 (the reference's setting: Algorithm 2 on the qp engine) and
with lookahead 1 (Algorithm 1, kernel B4 on the card). ``main(argv)``
returns the pretraining losses and both heads' held-out accuracy.
"""
import argparse
import time

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import accuracy, fit_chunked
from repro_torch.data import styled_corpus
from repro_torch.models import build_model
from repro_torch.train import TrainCfg, init_state, make_train_step

FEAT_LM = ArchConfig(
    name="feat-lm", family="dense", n_layers=4, d_model=256,
    n_heads=4, n_kv_heads=2, d_ff=1024, vocab=8192, mlp="swiglu",
)


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def pretrain(model, dev, steps=60, seed=0):
    """The reference's pretraining: batches of 8 documents of 64 tokens
    from styled_corpus(vocab, 256, 65, seed=42), TrainCfg(peak_lr=1e-3,
    warmup_steps=10, total_steps=60). Returns (params, losses)."""
    vocab = model.cfg.vocab
    pre_toks, _ = styled_corpus(vocab, 256, 65, seed=42)
    tcfg = TrainCfg(peak_lr=1e-3, warmup_steps=10, total_steps=60)
    state = init_state(model, torch.Generator(device=dev).manual_seed(seed), tcfg)
    step = make_train_step(model, tcfg)
    losses = []
    for i in range(steps):
        sl = torch.as_tensor(pre_toks[(i * 8) % 248 : (i * 8) % 248 + 8], device=dev)
        state, m = step(state, {"tokens": sl[:, :-1], "targets": sl[:, 1:]})
        losses.append(m["loss"])
    return state["params"], [float(x) for x in losses]


def embed_docs(model, params, tokens, center):
    """Multi-level features (ELMo-style): mean-pooled token embeddings
    concatenated with mean-pooled final hidden states, centred and
    L2-normalised (K(x, x) = 1, the reduction's kernel assumption)."""
    with torch.inference_mode():
        e = model._embed(params, {"tokens": tokens})
        h, _ = model._stack(params, e)

        def pool(x):
            f = x.float().mean(1)
            return f / torch.clamp(f.norm(dim=-1, keepdim=True), min=1e-8)

        feats = torch.cat([pool(e), pool(h)], dim=-1) - center
        return feats / torch.clamp(feats.norm(dim=-1, keepdim=True), min=1e-8)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=60, help="pretraining steps")
    ap.add_argument("--n-train", type=int, default=1024)
    ap.add_argument("--n-test", type=int, default=256)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    cfg = FEAT_LM
    model = build_model(cfg)
    t0 = time.time()
    params, losses = pretrain(model, dev, args.steps)
    sync(dev)
    print(f"backbone pretrain: {args.steps} steps, final LM loss {losses[-1]:.3f} "
          f"({time.time() - t0:.1f}s)")

    n_train, n_test, seq, B = args.n_train, args.n_test, 64, 128
    toks, labels = styled_corpus(cfg.vocab, n_train + n_test, seq, seed=0)
    toks = torch.as_tensor(toks, device=dev)
    y = torch.as_tensor(labels, device=dev)

    # streaming-compatible centring: the feature mean of the FIRST chunk only
    # (O(d) state, no second pass), frozen thereafter
    zero = torch.zeros(2 * cfg.d_model, device=dev)
    center = embed_docs(model, params, toks[:B], zero).mean(0)

    def chunks():  # embed a chunk of docs -> feed the one-pass SVM -> discard
        for lo in range(0, n_train, B):
            yield embed_docs(model, params, toks[lo : lo + B], center), y[lo : lo + B]

    feats_te = embed_docs(model, params, toks[n_train:], center)
    out = {"losses": losses, "acc": {}, "m": {}, "seconds": {}}
    for la in (10, 1):
        sync(dev)
        t0 = time.time()
        res = fit_chunked(chunks(), c=10.0, lookahead=la)
        sync(dev)
        t = time.time() - t0
        acc = float(accuracy(res.ball, feats_te, y[n_train:])) * 100
        out["acc"][la], out["m"][la], out["seconds"][la] = acc, int(res.ball.m), t
        print(f"one-pass StreamSVM head (lookahead {la}) on {n_train} streamed docs: test acc "
              f"{acc:.1f}%  ({t:.2f}s, state={res.ball.w.numel() * 4 + 12} bytes, core vectors "
              f"{int(res.ball.m)})")
    return out


if __name__ == "__main__":
    main()
