"""Datasets and stream utilities of the port: numpy-only copies of the
reference's ``repro/data`` generators, preprocessing, stream helpers and LM
token streams (the port imports nothing of ``repro``). Same seed, same
arrays."""
from .synthetic import DATASETS, PAPER_TABLE1, load_dataset, mnist89_like
from .stream import chunk_stream, permuted, shard_ranges
from .tokens import styled_corpus, token_batches
from .preprocess import POLICY, preprocess, preprocess_for

__all__ = [
    "DATASETS",
    "PAPER_TABLE1",
    "POLICY",
    "chunk_stream",
    "load_dataset",
    "mnist89_like",
    "permuted",
    "preprocess",
    "preprocess_for",
    "shard_ranges",
    "styled_corpus",
    "token_batches",
]
