"""The port's launch package on the CPU: the meta-tensor input specs
against the reference's ShapeDtypeStructs, the training launcher (a
preemption resumed bit for bit, for Zamba2 and Whisper at smoke size), and
the dry run on a small fake world, in a subprocess: torch's fake process
group is global to its process, and a test worker that initialised it
could break the gloo tests that follow it there.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch

import repro.configs as rcfg
import repro.launch.specs as RS
from repro.models import build_model as ref_build

import repro_torch.configs as tcfg
import repro_torch.launch.specs as TS
from repro_torch._tree import leaves
from repro_torch.launch import train as launch_train
from repro_torch.launch.dryrun import microbatches_for
from repro_torch.models import build_model

ROOT = Path(__file__).resolve().parents[1]


def _same_shapes(got, want):
    g = sorted((k, tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in got.items())
    w = sorted((k, tuple(v.shape), str(v.dtype)) for k, v in want.items())
    assert g == w
    assert all(v.device.type == "meta" for v in got.values())


@pytest.mark.parametrize("arch", ["llava-next-mistral-7b", "whisper-base", "zamba2-1.2b"])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_input_specs_equal_the_reference(arch, shape):
    cfg_r, cfg_t = rcfg.get_config(arch), tcfg.get_config(arch)
    sr, st = rcfg.SHAPES[shape], tcfg.SHAPES[shape]
    if sr.kind == "decode":
        cache_r, tok_r = RS.decode_specs(ref_build(cfg_r), cfg_r, sr)
        cache_t, tok_t = TS.decode_specs(build_model(cfg_t), cfg_t, st)
        _same_shapes({"t": tok_t}, {"t": tok_r})
        want = [(tuple(x.shape), str(x.dtype)) for x in jax.tree.leaves(cache_r)]
        got = [(tuple(x.shape), str(x.dtype).split(".")[-1]) if isinstance(x, torch.Tensor)
               else ((), "int32") for x in leaves(cache_t)]  # the position: a Python int
        assert got == want
    else:
        fn = "train_batch_specs" if sr.kind == "train" else "prefill_batch_specs"
        _same_shapes(getattr(TS, fn)(cfg_t, st), getattr(RS, fn)(cfg_r, sr))


def test_microbatches_for_follows_the_reference_rule():
    train, dec = tcfg.SHAPES["train_4k"], tcfg.SHAPES["decode_32k"]
    want = {"internlm2-1.8b": 8, "nemotron-4-340b": 16, "zamba2-1.2b": 16, "whisper-base": 16,
            "qwen3-moe-30b-a3b": 16, "llava-next-mistral-7b": 8}
    for arch, a in want.items():
        assert microbatches_for(tcfg.get_config(arch), train) == a, arch
        assert microbatches_for(tcfg.get_config(arch), dec) == 1


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "whisper-base"])
def test_launcher_resumes_a_preempted_run_bit_for_bit(arch, tmp_path):
    """--smoke --device cpu: 4 steps with a checkpoint every 2, preempted
    after step 3 and resumed from step 2, against the run uninterrupted:
    every loss and every state leaf equal bit for bit, the loss finite."""
    base = ["--arch", arch, "--smoke", "--steps", "4", "--batch", "2", "--seq", "32",
            "--device", "cpu", "--ckpt-every", "2", "--quiet"]
    cut = launch_train.main(base + ["--ckpt-dir", str(tmp_path / "a"), "--stop-after", "3"])
    resumed = launch_train.main(base + ["--ckpt-dir", str(tmp_path / "a"), "--resume"])
    clean = launch_train.main(base + ["--ckpt-dir", str(tmp_path / "b")])
    assert cut["steps_run"] == 3 and resumed["start"] == 2 and clean["steps_run"] == 4
    assert cut["losses"][:2] + resumed["losses"] == clean["losses"]
    assert cut["losses"][2] == resumed["losses"][0]
    a, b = leaves(resumed["state"]), leaves(clean["state"])
    assert len(a) == len(b) and all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))
    assert all(torch.isfinite(torch.tensor(clean["losses"] + clean["grad_norms"])))


def test_dryrun_on_a_small_fake_world(tmp_path):
    """The dry run over smoke cells on 8 fake ranks, both meshes' dims
    ((2, 4) and (2, 1, 4)), in its own process: every cell OK, products
    counted per device below their global count, collectives launched, and
    the argument bytes one device's shards."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--smoke", "--world", "8",
           "--arch", "internlm2-1.8b,zamba2-1.2b", "--shape", "train_4k,decode_32k",
           "--out", str(tmp_path), "--cell-timeout", "300"]
    res = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    recs = [json.loads(p.read_text()) for p in sorted(tmp_path.glob("*.json"))]
    assert len(recs) == 8 and all(r["status"] == "OK" for r in recs)
    for r in recs:
        assert 0 < r["flops"] < r["flops_global"]
        assert r["devices"] == 8 and sum(r["collective_counts"].values()) > 0
        assert r["argument_size_in_bytes"] > 0 and r["temp_size_in_bytes"] is None
    again = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=600)
    assert again.returncode == 0 and again.stdout.count("[skip cached]") == 8
