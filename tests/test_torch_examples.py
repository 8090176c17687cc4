"""The port's example twins run end to end on the CPU at their smallest
sizes: examples/torch_serve_bank.py (train -> checkpoint -> serve -> hot
swap), examples/torch_kernel_bank.py (the RBF core-set bank on two rings),
examples/torch_svm_distributed.py (2 spawned gloo ranks),
examples/torch_quickstart.py (Algorithms 1 and 2 against the perceptron and
Pegasos, the C-grid in one pass, the bank through both residencies, served),
examples/torch_serve.py (prefill and greedy decode with a KV cache on
smoke configs, Zamba2 and Whisper included), examples/torch_train_lm.py (training with a checkpoint, a
preemption and a resume) and examples/torch_llm_feature_svm.py (a pretrained
backbone's features through the one-pass head).
Each asserts its own claims (served == direct readout bit for bit, s_tile bit-exact,
every rank the same bits); the test checks what ``main`` returns."""
import importlib
import sys
from pathlib import Path

import pytest

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _example(name):
    if str(EXAMPLES) not in sys.path:  # spawned ranks import the module by name
        sys.path.insert(0, str(EXAMPLES))
    return importlib.import_module(name)


def test_serve_bank_twin():
    out = _example("torch_serve_bank").main(
        ["--device", "cpu", "--n-train", "400", "--n-test", "120", "--d", "16", "--classes", "8"])
    assert out["steps"] >= 1


def test_kernel_bank_twin():
    out = _example("torch_kernel_bank").main(
        ["--device", "cpu", "--n-train", "400", "--n-test", "150", "--coreset", "32"])
    assert out["best_rbf"] > 0.9


def test_svm_distributed_twin():
    out = _example("torch_svm_distributed").main(
        ["--device", "cpu", "--ranks", "2", "--n-train", "600", "--n-bank", "300",
         "--classes", "20"])
    assert out["same"] and out["acc_dist"] > 0.5 and len(out["bank_acc"]) == 3


def test_live_bank_twin():
    out = _example("torch_live_bank").main(
        ["--device", "cpu", "--n-chunks", "20", "--chunk", "64", "--d", "16", "--classes", "4",
         "--ring-chunks", "6", "--ring-chunk", "64", "--coreset", "16"])
    assert out["restarts"] == 4 and out["quarantined"] == [15]
    assert out["remeshes"] == 1 and out["kernel_restarts"] == 3


def test_quickstart_twin():
    out = _example("torch_quickstart").main(
        ["--device", "cpu", "--n-train", "2000", "--classes", "8", "--bank-n", "300",
         "--bank-d", "16"])
    assert min(out["acc"].values()) > 80.0 and out["bank_models"] == 24
    assert out["served_steps"] >= 1 and len(out["served_acc"]) == 3


def test_serve_twin():
    out = _example("torch_serve").main(
        ["--device", "cpu", "--arch", "gemma3-27b", "--batch", "2", "--prompt-len", "20",
         "--gen", "5"])
    assert out["tokens"].shape == (2, 5) and out["arch"] == "gemma3-27b-smoke"
    assert ((out["tokens"] >= 0) & (out["tokens"] < 512)).all()
    assert out["decode_tokens_per_s"] > 0


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "whisper-base"])
def test_serve_twin_hybrid_and_encdec(arch):
    """Zamba2 (17 prompt tokens: the sequential SSD) and Whisper (frames
    drawn from the seed) through the same path."""
    out = _example("torch_serve").main(
        ["--device", "cpu", "--arch", arch, "--batch", "2", "--prompt-len", "17", "--gen", "4"])
    assert out["tokens"].shape == (2, 4) and out["arch"] == f"{arch}-smoke"
    assert ((out["tokens"] >= 0) & (out["tokens"] < 512)).all()


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_train_lm_twin_resumes_to_the_uninterrupted_run(tmp_path):
    """Preempted at step 21 and resumed from the step-20 checkpoint: every
    loss and every leaf of the state equal an uninterrupted run's bit for
    bit (the CPU's operations are deterministic)."""
    mod = _example("torch_train_lm")
    kw = ["--device", "cpu", "--steps", "23", "--batch", "2", "--seq", "16", "--quiet"]
    crashed = mod.main(kw + ["--crash-at", "21", "--ckpt-dir", str(tmp_path / "a")])
    clean = mod.main(kw + ["--crash-at", "0", "--ckpt-dir", str(tmp_path / "b")])
    assert crashed["resumed_at"] == 20 and clean["resumed_at"] is None
    assert crashed["arch"] == "lm-15m" and len(crashed["losses"]) == 23
    assert crashed["losses"] == clean["losses"]
    assert crashed["losses"][-1] < crashed["losses"][0]
    a, b = _leaves(crashed["state"]), _leaves(clean["state"])
    assert len(a) == len(b) and all(x.dtype == y.dtype and x.equal(y) for x, y in zip(a, b))
    assert int(crashed["state"]["opt"].step) == 23


def test_llm_feature_svm_twin():
    """The example's 60 pretraining steps on 256 streamed documents: the
    loss falls and both heads clear 75 % held out on 64 documents (measured
    on the CPU: 85.9 % with lookahead 10 and 79.7 % with lookahead 1; the
    untrained backbone gives 62.5 % and 53.1 %, 20 steps 71.9 % and 64.1 %)."""
    out = _example("torch_llm_feature_svm").main(
        ["--device", "cpu", "--n-train", "256", "--n-test", "64"])
    assert len(out["losses"]) == 60 and out["losses"][-1] < out["losses"][0]
    assert set(out["acc"]) == {1, 10} and min(out["acc"].values()) > 75.0
    assert out["m"][1] >= 1 and out["m"][10] >= 1


def test_llm_feature_svm_features_match_the_reference():
    """The twin's embed_docs and first-chunk centring against the
    reference's on the same f32 feat-lm parameters (the reference's init,
    carried across by ``lm_params_from_numpy``) and 256 documents: the
    centre and every feature (unit vectors) within atol 1e-6, f32 rounding
    through 4 layers (1.0e-7 measured). The reference's embed_docs is local to
    examples/llm_feature_svm.py's main, so its lines are restated here over
    the reference's model."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    import repro.configs.base as rbase
    from repro.models import build_model as ref_build
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.data import styled_corpus
    from repro_torch.models import build_model

    mod = _example("torch_llm_feature_svm")
    f32 = dict(act_dtype="float32", param_dtype="float32")
    cfg_t = dataclasses.replace(mod.FEAT_LM, **f32)
    cfg_r = rbase.ArchConfig(**{f.name: getattr(cfg_t, f.name)
                                for f in dataclasses.fields(rbase.ArchConfig)})
    ref = ref_build(cfg_r)
    params_r = jax.jit(ref.init)(jax.random.PRNGKey(0))
    params_t = lm_params_from_numpy(cfg_t, jax.tree.map(np.asarray, params_r), device="cpu")

    @jax.jit
    def ref_embed(params, tokens, center):
        e = ref._embed(params, {"tokens": tokens})
        h, _, _ = ref._stack(params, e)

        def pool(x):
            f = jnp.mean(x.astype(jnp.float32), axis=1)
            return f / jnp.maximum(jnp.linalg.norm(f, axis=-1, keepdims=True), 1e-8)

        feats = jnp.concatenate([pool(e), pool(h)], axis=-1) - center
        return feats / jnp.maximum(jnp.linalg.norm(feats, axis=-1, keepdims=True), 1e-8)

    toks, _ = styled_corpus(cfg_t.vocab, 256, 64, seed=0)
    zero = np.zeros(2 * cfg_t.d_model, np.float32)
    c_r = np.asarray(jnp.mean(ref_embed(params_r, jnp.asarray(toks[:128]), zero), axis=0))
    model = build_model(cfg_t)
    tt = torch.as_tensor(toks)
    c_t = mod.embed_docs(model, params_t, tt[:128], torch.as_tensor(zero)).mean(0)
    np.testing.assert_allclose(c_t.numpy(), c_r, rtol=0, atol=1e-6)
    f_r = np.asarray(ref_embed(params_r, jnp.asarray(toks), jnp.asarray(c_r)))
    f_t = mod.embed_docs(model, params_t, tt, c_t).numpy()
    np.testing.assert_allclose(f_t, f_r, rtol=0, atol=1e-6)
    assert np.allclose(np.linalg.norm(f_t, axis=1), 1.0, atol=1e-5)
