"""Checkpoints: one on-disk format for both packages.

A bank saved by ``repro.checkpoint.ckpt`` restores in the port and the other
way round, bit for bit, bf16 included; the commit protocol's guarantees (a
torn payload refuses to restore, stale payloads are collected) hold in the
port.
"""
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.core.meb import Ball as JBall
from repro_torch.checkpoint import ckpt
from repro_torch.convert import ball_to_numpy
from repro_torch.core.meb import Ball


def _bank(seed, b=5, d=7):
    rng = np.random.default_rng(seed)
    return (
        rng.normal(size=(b, d)).astype(np.float32),
        rng.random(b).astype(np.float32),
        rng.random(b).astype(np.float32),
        rng.integers(1, 50, size=b).astype(np.int32),
    )


def test_jax_checkpoint_restores_in_port(tmp_path):
    src = _bank(0)
    jckpt.save(str(tmp_path), JBall(*(jnp.asarray(a) for a in src)), meta={"n_classes": 5})
    manifest = ckpt.load_manifest(str(tmp_path))
    target = Ball(*ckpt.zeros_like_manifest(manifest, device="cpu"))
    got = ckpt.restore(str(tmp_path), target)
    assert isinstance(got, Ball)
    for a, b in zip(ball_to_numpy(got), src):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert ckpt.load_meta(str(tmp_path)) == {"n_classes": 5}


def test_port_checkpoint_restores_in_jax(tmp_path):
    src = _bank(1)
    ckpt.save(str(tmp_path), Ball(*(torch.from_numpy(a) for a in src)), meta={"position": 9})
    assert ckpt.exists(str(tmp_path))
    target = JBall(*(jnp.zeros_like(jnp.asarray(a)) for a in src))
    got = jckpt.restore(str(tmp_path), target)
    for a, b in zip(got, src):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert jckpt.load_meta(str(tmp_path)) == {"position": 9}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_bf16_leaves_cross_packages(tmp_path, writer):
    vals = np.random.default_rng(2).normal(size=(4, 3)).astype(np.float32)
    as_bf16 = torch.from_numpy(vals).to(torch.bfloat16)
    if writer == "jax":
        jckpt.save(str(tmp_path), {"x": jnp.asarray(vals, jnp.bfloat16)})
        assert ckpt.load_manifest(str(tmp_path))["dtypes"] == ["bfloat16"]
        got = ckpt.restore(str(tmp_path), {"x": torch.zeros(4, 3, dtype=torch.bfloat16)})
        assert got["x"].dtype == torch.bfloat16
        assert torch.equal(got["x"], as_bf16)
    else:
        ckpt.save(str(tmp_path), {"x": as_bf16})
        assert jckpt.load_manifest(str(tmp_path))["dtypes"] == ["bfloat16"]
        got = jckpt.restore(str(tmp_path), {"x": jnp.zeros((4, 3), jnp.bfloat16)})
        np.testing.assert_array_equal(np.asarray(got["x"], np.float32), as_bf16.float().numpy())


def test_dict_trees_flatten_in_the_same_order(tmp_path):
    tree = {"b": np.arange(3, dtype=np.int32), "a": np.ones(2, np.float32)}
    ckpt.save(str(tmp_path), tree)
    got = jckpt.restore(str(tmp_path), {k: jnp.zeros_like(jnp.asarray(v)) for k, v in tree.items()})
    for k in tree:
        np.testing.assert_array_equal(np.asarray(got[k]), tree[k])


def test_torn_payload_raises_value_error(tmp_path):
    ckpt.save(str(tmp_path), Ball(*(torch.from_numpy(a) for a in _bank(3))))
    manifest = ckpt.load_manifest(str(tmp_path))
    path = os.path.join(str(tmp_path), manifest["arrays_file"])
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)
    target = Ball(*ckpt.zeros_like_manifest(manifest, device="cpu"))
    with pytest.raises(ValueError, match="torn or corrupt"):
        ckpt.restore(str(tmp_path), target)
    with pytest.raises(ValueError, match="torn or corrupt"):
        jckpt.restore(str(tmp_path), JBall(*(jnp.zeros(s) for s in manifest["shapes"])))


def test_recommit_collects_stale_payloads_and_wrong_targets_raise(tmp_path):
    for seed in range(3):
        ckpt.save(str(tmp_path), Ball(*(torch.from_numpy(a) for a in _bank(seed))))
    arrays = [n for n in os.listdir(tmp_path) if n.startswith("arrays")]
    assert arrays == [ckpt.load_manifest(str(tmp_path))["arrays_file"]]
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(str(tmp_path), (torch.zeros(1),))


def test_zero_d_leaves_keep_their_shape(tmp_path):
    """A 0-d leaf (a single ball's r, AdamW's step) restores as 0-d in both
    packages, as it was saved."""
    tree = {"step": torch.tensor(7, dtype=torch.int32), "r": torch.tensor(0.25),
            "w": torch.arange(3, dtype=torch.float32)}
    ckpt.save(str(tmp_path), tree)
    got = ckpt.restore(str(tmp_path), {k: torch.zeros_like(v) for k, v in tree.items()})
    for k, v in tree.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype and torch.equal(got[k], v)
    back = jckpt.restore(str(tmp_path), {k: jnp.zeros(v.shape) for k, v in tree.items()})
    assert back["step"].shape == () and int(back["step"]) == 7
