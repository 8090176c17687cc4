"""The port's example twins run end to end on the CPU at their smallest
sizes: examples/torch_serve_bank.py (train -> checkpoint -> serve -> hot
swap), examples/torch_kernel_bank.py (the RBF core-set bank on two rings),
examples/torch_svm_distributed.py (2 spawned gloo ranks),
examples/torch_quickstart.py (Algorithms 1 and 2 against the perceptron and
Pegasos, the C-grid in one pass, the bank through both residencies, served)
and examples/torch_serve.py (prefill and greedy decode with a KV cache on a
smoke config).
Each asserts its own claims (served == direct readout bit for bit, s_tile bit-exact,
every rank the same bits); the test checks what ``main`` returns."""
import importlib
import sys
from pathlib import Path

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
