"""The port's data helpers against the reference's ``repro.data``.

The port keeps its own numpy-only copies of the dataset generators,
preprocessing and stream utilities (it imports nothing of ``repro``). For
the same seed they must give the same arrays, bit for bit.
"""
import numpy as np
import pytest

import repro.data as jdata
import repro_torch.data as tdata


@pytest.mark.parametrize("name", sorted(jdata.DATASETS))
def test_datasets_and_preprocessing_equal_the_reference(name):
    ref = jdata.load_dataset(name, seed=3)
    port = tdata.load_dataset(name, seed=3)
    for a, b in zip(port, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tdata.preprocess_for(name, port[0], port[2]),
                    jdata.preprocess_for(name, ref[0], ref[2])):
        np.testing.assert_array_equal(a, b)


def test_tables_and_policies_equal_the_reference():
    assert tdata.POLICY == jdata.POLICY
    assert tdata.PAPER_TABLE1 == jdata.PAPER_TABLE1
    assert sorted(tdata.DATASETS) == sorted(jdata.DATASETS)


def test_stream_helpers_equal_the_reference():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(1001, 5)).astype(np.float32)
    y = np.sign(rng.normal(size=1001)).astype(np.float32)
    for a, b in zip(tdata.permuted(X, y, seed=7), jdata.permuted(X, y, seed=7)):
        np.testing.assert_array_equal(a, b)
    port = list(tdata.chunk_stream(X, y, 300, start=100))
    ref = list(jdata.chunk_stream(X, y, 300, start=100))
    assert len(port) == len(ref) == 4  # rows 100-399, 400-699, 700-999, 1000
    for (px, py), (rx, ry) in zip(port, ref):
        np.testing.assert_array_equal(px, rx)
        np.testing.assert_array_equal(py, ry)
    for n, k in ((10, 3), (7, 8), (1000, 4)):
        assert tdata.shard_ranges(n, k) == jdata.shard_ranges(n, k)
