"""Linear ball algebra in the port, against repro.core.meb.

The same seeded numpy balls go through the JAX functions and the port's on
the CPU; results agree within f32 tolerance and ``m`` exactly.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import meb as jmeb
from repro_torch.convert import ball_from_numpy, ball_to_numpy
from repro_torch.core import meb

TOL = dict(rtol=2e-5, atol=2e-6)


def _np_ball(rng, shape=(), d=6, r_scale=1.0):
    return (
        rng.normal(size=shape + (d,)).astype(np.float32),
        (rng.random(shape) * r_scale).astype(np.float32),
        rng.random(shape).astype(np.float32),
        rng.integers(1, 9, size=shape).astype(np.int32),
    )


def _jball(t):
    return jmeb.Ball(*(jnp.asarray(a) for a in t))


def _assert_ball(port, ref):
    for p, r in zip(ball_to_numpy(port), (np.asarray(a) for a in ref)):
        if np.issubdtype(r.dtype, np.integer):
            np.testing.assert_array_equal(p, r)
        else:
            np.testing.assert_allclose(p, r, **TOL)


def test_make_ball_fields_and_dtypes():
    b = meb.make_ball(torch.ones(4), r=2.0, xi2=0.5, m=3)
    assert b._fields == ("w", "r", "xi2", "m")
    assert b.m.dtype == torch.int32 and b.r.dtype == torch.float32
    assert b.dim == 4


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_distances_match(seed):
    rng = np.random.default_rng(seed)
    a, b = _np_ball(rng), _np_ball(rng)
    yx = rng.normal(size=6).astype(np.float32)
    pa, pb = ball_from_numpy(a, "cpu"), ball_from_numpy(b, "cpu")
    np.testing.assert_allclose(
        meb.center_distance(pa, pb).numpy(),
        np.asarray(jmeb.center_distance(_jball(a), _jball(b))), **TOL)
    np.testing.assert_allclose(
        meb.point_distance(pa, torch.from_numpy(yx), 0.3).numpy(),
        np.asarray(jmeb.point_distance(_jball(a), jnp.asarray(yx), 0.3)), **TOL)


@pytest.mark.parametrize("variant", ["exact", "paper-listing"])
def test_enclose_point_matches(variant):
    rng = np.random.default_rng(4)
    a = _np_ball(rng)
    yx = rng.normal(size=6).astype(np.float32)
    port = meb.enclose_point(ball_from_numpy(a, "cpu"), torch.from_numpy(yx), 0.25, variant=variant)
    ref = jmeb.enclose_point(_jball(a), jnp.asarray(yx), 0.25, variant=variant)
    _assert_ball(port, ref)


@pytest.mark.parametrize("case", ["overlap", "one_in_two", "two_in_one", "same"])
def test_merge_balls_matches(case):
    rng = np.random.default_rng(7)
    a, b = _np_ball(rng), _np_ball(rng)
    if case == "one_in_two":
        b = (b[0], np.float32(100.0), b[2], b[3])
    elif case == "two_in_one":
        a = (a[0], np.float32(100.0), a[2], a[3])
    elif case == "same":
        b = a
    port = meb.merge_balls(ball_from_numpy(a, "cpu"), ball_from_numpy(b, "cpu"))
    _assert_ball(port, jmeb.merge_balls(_jball(a), _jball(b)))


def test_merge_banks_matches_model_by_model():
    rng = np.random.default_rng(9)
    a, b = _np_ball(rng, (5,), r_scale=3.0), _np_ball(rng, (5,), r_scale=3.0)
    port = meb.merge_banks(ball_from_numpy(a, "cpu"), ball_from_numpy(b, "cpu"))
    _assert_ball(port, jmeb.merge_banks(_jball(a), _jball(b)))


@pytest.mark.parametrize("live", [None, [True, True, True], [False, True, False, True],
                                  [True, False, False, False]])
def test_fold_banks_and_live_mask_match(live):
    rng = np.random.default_rng(11)
    k = 3 if live is None or len(live) == 3 else 4
    banks = [_np_ball(rng, (4,), r_scale=2.0) for _ in range(k)]
    port = meb.fold_banks([ball_from_numpy(x, "cpu") for x in banks], live=live)
    ref = jmeb.fold_banks([_jball(x) for x in banks], live=live)
    _assert_ball(port, ref)


def test_stack_and_fold_merge_of_single_balls():
    rng = np.random.default_rng(12)
    balls = [_np_ball(rng) for _ in range(4)]
    port = meb.fold_merge(meb.stack_banks([ball_from_numpy(x, "cpu") for x in balls]))
    ref = jmeb.fold_merge(jmeb.stack_banks([_jball(x) for x in balls]))
    _assert_ball(port, ref)
    assert meb.stack_banks([ball_from_numpy(x, "cpu") for x in balls]).w.shape == (4, 6)


def test_single_bank_passes_through_fold():
    rng = np.random.default_rng(13)
    only = ball_from_numpy(_np_ball(rng, (3,)), "cpu")
    assert meb.fold_banks([only]) is only


def test_nonfinite_rows_matches():
    rng = np.random.default_rng(14)
    w, r, xi2, m = _np_ball(rng, (5,))
    w[1, 2] = np.nan
    r[3] = np.inf
    port = meb.nonfinite_rows(ball_from_numpy((w, r, xi2, m), "cpu"))
    ref = jmeb.nonfinite_rows(_jball((w, r, xi2, m)))
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


def test_errors():
    with pytest.raises(ValueError):
        meb.stack_banks([])
    with pytest.raises(ValueError):
        meb.fold_banks([])
    rng = np.random.default_rng(15)
    banks = [ball_from_numpy(_np_ball(rng, (2,)), "cpu") for _ in range(2)]
    with pytest.raises(ValueError):
        meb.fold_banks(banks, live=[False, False])

    class KernelBankLike:
        points = coef = None

    with pytest.raises(ValueError, match="merge_kernel_banks"):
        meb.merge_banks(banks[0], KernelBankLike())


def test_conversion_round_trip_keeps_dtypes():
    rng = np.random.default_rng(16)
    src = _np_ball(rng, (3,))
    port = ball_from_numpy(_jball(src), device="cpu")  # any object with w, r, xi2, m
    assert [t.dtype for t in port] == [torch.float32] * 3 + [torch.int32]
    for a, b in zip(ball_to_numpy(port), src):
        np.testing.assert_array_equal(a, b)
