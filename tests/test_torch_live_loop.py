"""The port's live loop (``repro_torch.live``), single-shard path, on the CPU.

Against the reference (``repro.live``) on the same ``ArraySource``, for both
bank kinds and both retirements: the serving bank within the engine
tolerance (rtol 2e-4, atol 2e-5) with ``m`` and ``idx`` exact, the durable
stats equal (``merge_dropped_mass``, a float summed from f32 sums in another
order, within the same tolerance). A checkpoint either package writes
resumes in the other. Port against port, bit for bit: a crash at every
phase of ``PHASES``, repeated crashes, retry and quarantine, the non-finite
publish guard, ``rotate_on`` across a crash, the resume configuration
checks, server survival and the kernel-config guards, and
``BankServer.from_checkpoint`` on a live checkpoint. The reference's sizes
(``tests/test_live_bank.py``): D = 8, B = 3, 32-row chunks, 10 chunks.
"""
import functools
import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.core import (
    fit_bank,
    fit_kernel_bank,
    kernel_bank_decision,
    merge_banks,
    merge_kernel_banks,
    nonfinite_rows,
)
from repro_torch.live import (
    PHASES,
    ArraySource,
    FlakySource,
    LiveBank,
    TransientSourceError,
    run_live_with_restarts,
)
from repro_torch.runtime import InjectedFailure, RetryPolicy
from repro_torch.serve import BankServer

D, B, CHUNK, N_CHUNKS = 8, 3, 32, 10
CS = np.asarray([0.5, 2.0, 8.0], np.float32)
_NOSLEEP = lambda s: None
BANK_KINDS = ("linear", "kernel")
# S = 6 < CHUNK forces eviction and merge re-compression on every chunk
KERNEL_KW = dict(kernel="rbf", gamma=0.7, coreset_size=6, block_n=32)
TOL = dict(rtol=2e-4, atol=2e-5)  # the engine tolerance


def _stream(n_chunks=N_CHUNKS, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n_chunks * CHUNK, D)).astype(np.float32)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    y = np.sign(rng.normal(size=X.shape[0]) + X[:, 0]).astype(np.float32)
    return X, np.tile(y, (B, 1))


def _kw(bank_kind, kw):
    kw.setdefault("n_sub_banks", 2)
    kw.setdefault("rotate_every", 3)
    kw.setdefault("swap_every", 2)
    kw.setdefault("sleep", _NOSLEEP)
    if bank_kind == "kernel":
        for key, val in KERNEL_KW.items():
            kw.setdefault(key, val)
    return kw


def _make(source, ckpt_dir, bank_kind="linear", **kw):
    kw = _kw(bank_kind, kw)
    kw.setdefault("device", "cpu")
    return LiveBank(source, CS, ckpt_dir=str(ckpt_dir), bank_kind=bank_kind, **kw)


def _ref_make(source, ckpt_dir, bank_kind="linear", **kw):
    import jax.numpy as jnp
    from repro.live import LiveBank as RefLiveBank

    return RefLiveBank(source, jnp.asarray(CS), ckpt_dir=str(ckpt_dir), bank_kind=bank_kind,
                       **_kw(bank_kind, kw))


def _ref_source(X, Y):
    from repro.live import ArraySource as RefArraySource

    return RefArraySource(X, Y, CHUNK)


def _bank_eq(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _close_to_reference(got, want):
    """A port bank against a reference bank: integer leaves (m, idx) exact,
    float leaves within the engine tolerance."""
    for name, x, y in zip(got._fields, got, want):
        y = np.asarray(y)
        x = x.numpy()
        if np.issubdtype(y.dtype, np.integer):
            np.testing.assert_array_equal(x, y, err_msg=name)
        else:
            np.testing.assert_allclose(x, y, err_msg=name, **TOL)


def _stats_match_reference(got: dict, want: dict):
    got, want = dict(got), dict(want)
    mass, ref_mass = got.pop("merge_dropped_mass"), want.pop("merge_dropped_mass")
    assert got == want
    assert mass == pytest.approx(ref_mass, rel=TOL["rtol"], abs=TOL["atol"])


_QUERIES = _stream(1, seed=99)[0][:16]


def _served_scores(bank) -> torch.Tensor:
    """Decision scores on fixed queries, by bank kind (the served readout)."""
    q = torch.from_numpy(_QUERIES)
    if hasattr(bank, "coef"):
        return kernel_bank_decision(bank, q, kernel=KERNEL_KW["kernel"],
                                    gamma=KERNEL_KW["gamma"], device="cpu")
    return q @ bank.w.T


def test_exported_names_match_the_reference():
    import repro.live as ref

    import repro_torch.live as port

    assert sorted(port.__all__) == sorted(ref.__all__)
    for name in ref.__all__ + ["run_live_with_restarts"]:
        assert hasattr(port, name), name
    assert port.PHASES == ref.PHASES
    assert port.LiveStats._DURABLE == ref.LiveStats._DURABLE


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    """The reference's clean runs, one per (bank kind, retirement), made on
    first use: the serving bank and the durable stats."""
    cache = {}

    def get(kind, retire="merge"):
        if (kind, retire) not in cache:
            X, Y = _stream()
            live = _ref_make(_ref_source(X, Y), tmp_path_factory.mktemp(f"ref_{kind}_{retire}"),
                             bank_kind=kind, retire=retire)
            stats = live.run()
            cache[kind, retire] = (live.serving_bank(), stats.durable())
        return cache[kind, retire]

    return get


@pytest.mark.parametrize("retire", ["merge", "drop"])
@pytest.mark.parametrize("kind", BANK_KINDS)
def test_loop_matches_the_reference(tmp_path, reference_runs, kind, retire):
    ref_bank, ref_stats = reference_runs(kind, retire)
    X, Y = _stream()
    live = _make(ArraySource(X, Y, CHUNK), tmp_path / "c", bank_kind=kind, retire=retire)
    stats = live.run()
    _close_to_reference(live.serving_bank(), ref_bank)
    _stats_match_reference(stats.durable(), ref_stats)
    assert stats.retirements == 2


@pytest.mark.parametrize("kind", BANK_KINDS)
def test_resume_from_a_reference_checkpoint(tmp_path, reference_runs, kind):
    """The reference writes a live checkpoint mid-stream (4 chunks); the port
    resumes from it, finishes, and lands within tolerance of the reference's
    uninterrupted run, with the durable stats carried across."""
    ref_bank, ref_stats = reference_runs(kind)
    X, Y = _stream()
    _ref_make(_ref_source(X, Y), tmp_path / "c", bank_kind=kind).run(max_chunks=4)
    assert ckpt.load_meta(str(tmp_path / "c"))["chunk_idx"] == 4
    live = _make(ArraySource(X, Y, CHUNK), tmp_path / "c", bank_kind=kind)
    stats = live.run()
    assert stats.remeshes == 0 and live.chunk_idx == N_CHUNKS
    _close_to_reference(live.serving_bank(), ref_bank)
    _stats_match_reference(stats.durable(), ref_stats)


@pytest.mark.parametrize("kind", BANK_KINDS)
def test_reference_resumes_from_a_port_checkpoint(tmp_path, reference_runs, kind):
    ref_bank, ref_stats = reference_runs(kind)
    X, Y = _stream()
    _make(ArraySource(X, Y, CHUNK), tmp_path / "c", bank_kind=kind).run(max_chunks=6)
    live = _ref_make(_ref_source(X, Y), tmp_path / "c", bank_kind=kind)
    stats = live.run()
    for name, x, y in zip(ref_bank._fields, live.serving_bank(), ref_bank):
        x, y = np.asarray(x), np.asarray(y)
        if np.issubdtype(y.dtype, np.integer):
            np.testing.assert_array_equal(x, y, err_msg=name)
        else:
            np.testing.assert_allclose(x, y, err_msg=name, **TOL)
    _stats_match_reference(stats.durable(), ref_stats)


@pytest.mark.parametrize("kind", BANK_KINDS)
def test_serve_from_a_reference_live_checkpoint(tmp_path, reference_runs, kind):
    """BankServer.from_checkpoint folds a live checkpoint the reference wrote
    into the reference's last pushed bank (within tolerance)."""
    ref_bank, _ = reference_runs(kind)
    X, Y = _stream()
    _ref_make(_ref_source(X, Y), tmp_path / "c", bank_kind=kind).run()
    srv = BankServer.from_checkpoint(str(tmp_path / "c"), q_block=16, device="cpu")
    assert srv.kernel == (KERNEL_KW["kernel"] if kind == "kernel" else None)
    want = _served_scores(type(ref_bank)(*(torch.from_numpy(np.array(x)) for x in ref_bank)))
    torch.testing.assert_close(torch.from_numpy(srv.score(_QUERIES)), want, **TOL)


# ---------------------------------------------------------------------------
# training semantics
# ---------------------------------------------------------------------------


def test_single_slot_matches_sequential_fit_bank(tmp_path):
    """K = 1 with no rotation is the chunked one-pass bank fit, bit for bit:
    each chunk continues the active slot inside the engine."""
    X, Y = _stream()
    live = _make(ArraySource(X, Y, CHUNK), tmp_path / "c", n_sub_banks=1,
                 rotate_every=10**9, swap_every=1)
    live.run()
    ref = None
    for i in range(N_CHUNKS):
        lo = i * CHUNK
        ref = fit_bank(torch.from_numpy(X[lo:lo + CHUNK]), torch.from_numpy(Y[:, lo:lo + CHUNK]),
                       torch.from_numpy(CS), ref)
    assert _bank_eq(live.serving_bank(), ref)


def test_kernel_single_slot_matches_chunkwise_merge(tmp_path):
    """K = 1 kernel loop: each chunk fits fresh, its core-set ids lift to
    absolute stream coordinates, and it Sec-4.3-merges into the prior."""
    X, Y = _stream()
    live = _make(ArraySource(X, Y, CHUNK), tmp_path / "c", bank_kind="kernel", n_sub_banks=1,
                 rotate_every=10**9, swap_every=1)
    stats = live.run()
    fit_kw = {k: KERNEL_KW[k] for k in ("kernel", "gamma", "coreset_size", "block_n")}
    merge_kw = dict(kernel=KERNEL_KW["kernel"], gamma=KERNEL_KW["gamma"])
    ref, mass = None, 0.0
    for i in range(N_CHUNKS):
        lo = i * CHUNK
        chunk = fit_kernel_bank(torch.from_numpy(X[lo:lo + CHUNK]),
                                torch.from_numpy(Y[:, lo:lo + CHUNK]), torch.from_numpy(CS),
                                **fit_kw)
        chunk = chunk._replace(idx=torch.where(chunk.idx >= 0, chunk.idx + lo, chunk.idx))
        if ref is None:
            ref = chunk
        else:
            ref, dropped = merge_kernel_banks(ref, chunk, return_dropped=True, **merge_kw)
            mass += float(torch.sum(dropped))
    assert _bank_eq(live.serving_bank(), ref)
    assert stats.merge_dropped_mass == mass > 0.0
    idx = live.serving_bank().idx
    assert int(idx.max()) >= CHUNK and int(idx[idx >= 0].max()) < N_CHUNKS * CHUNK


def test_hbm_loop_equals_vmem(tmp_path):
    """bank_resident="hbm" (the ring) trains the same bits as "vmem"."""
    X, Y = _stream()
    banks = []
    for res in ("vmem", "hbm"):
        live = _make(ArraySource(X, Y, CHUNK), tmp_path / res, bank_resident=res)
        live.run()
        banks.append(live.serving_bank())
    assert _bank_eq(*banks)


def test_rotation_retirement_exact():
    """K = 2, rotate_every = 2 over 8 chunks: "drop" serves only the last
    epoch's bank, "merge" the left merge of all four epochs, bit for bit."""
    import tempfile

    X, Y = _stream(8, seed=3)

    def fit_epoch(e):
        ref = None
        for c in (2 * e, 2 * e + 1):
            lo = c * CHUNK
            ref = fit_bank(torch.from_numpy(X[lo:lo + CHUNK]),
                           torch.from_numpy(Y[:, lo:lo + CHUNK]), torch.from_numpy(CS), ref)
        return ref

    epochs = [fit_epoch(e) for e in range(4)]
    banks = {}
    for retire in ("drop", "merge"):
        with tempfile.TemporaryDirectory() as td:
            live = _make(ArraySource(X, Y, CHUNK), td, rotate_every=2, swap_every=8,
                         retire=retire)
            stats = live.run()
            assert stats.rotations == 4 and stats.retirements == 3
            banks[retire] = live.serving_bank()
    assert _bank_eq(banks["drop"], epochs[3])
    assert _bank_eq(banks["merge"], functools.reduce(merge_banks, epochs))


def test_clean_run_stats_accounting(tmp_path):
    X, Y = _stream()
    stats = _make(ArraySource(X, Y, CHUNK), tmp_path / "c").run()
    assert stats.chunks_ingested == N_CHUNKS and stats.rows_ingested == N_CHUNKS * CHUNK
    assert stats.rotations == 3 and stats.retirements == 2
    assert stats.folds == stats.swaps == stats.checkpoints == 5
    assert stats.last_swap_chunk == N_CHUNKS
    assert stats.bank_age_chunks == 0 and stats.quarantined == []


def test_constructor_validation(tmp_path):
    X, Y = _stream(1)
    src = ArraySource(X, Y, CHUNK)
    for kw, match in (
        (dict(n_sub_banks=0), "n_sub_banks"), (dict(rotate_every=0), "rotate_every"),
        (dict(swap_every=0), "swap_every"), (dict(retire="evict"), "retire"),
        (dict(failpoints=[("pre_train", 3)]), "unknown failpoint phase"),
        (dict(bank_kind="quadratic"), "bank_kind"),
        (dict(bank_kind="kernel", kernel="poly"), "unknown kernel"),
        (dict(bank_kind="kernel", eviction="lru"), "unknown eviction"),
        (dict(bank_kind="kernel", coreset_size=0), "coreset_size"),
        (dict(n_stream_shards=0), "n_stream_shards"),
    ):
        with pytest.raises(ValueError, match=match):
            _make(src, tmp_path, **kw)
    with pytest.raises(ValueError, match="chunk_size"):
        ArraySource(X, Y, 0)
    with pytest.raises(TypeError, match="DeviceMesh"):
        _make(src, tmp_path, mesh=object())


# ---------------------------------------------------------------------------
# crash equivalence, port against port
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=BANK_KINDS)
def clean_run(request, tmp_path_factory):
    """Per bank kind: the uninterrupted run every crashy variant must
    reproduce bit for bit: bank leaves, served scores, durable stats."""
    kind = request.param
    X, Y = _stream()
    live = _make(ArraySource(X, Y, CHUNK), tmp_path_factory.mktemp(f"clean_{kind}") / "c",
                 bank_kind=kind)
    stats = live.run()
    bank = live.serving_bank()
    return kind, bank, _served_scores(bank), stats.durable()


@pytest.mark.parametrize("phase", PHASES)
def test_crash_equivalence_at_every_phase(tmp_path, phase, clean_run):
    """A crash at each phase boundary of chunk 5 (where rotation, fold, swap
    and checkpoint all fire): one restart later the bank, the served scores
    and the durable stats are bit-identical to the uninterrupted run."""
    kind, ref_bank, ref_scores, ref_stats = clean_run
    X, Y = _stream()
    live = _make(ArraySource(X, Y, CHUNK), tmp_path / "c", bank_kind=kind,
                 failpoints=[(phase, 5)])
    stats = run_live_with_restarts(live, sleep=_NOSLEEP)
    assert stats.restarts == 1, f"failpoint {phase!r} never fired"
    assert _bank_eq(live.serving_bank(), ref_bank)
    assert torch.equal(_served_scores(live.serving_bank()), ref_scores)
    assert stats.durable() == ref_stats
    # recovery swept up the mid-commit debris (mid_checkpoint drops a torn
    # .tmp first; the next commit's clean-up removes it)
    assert [f for f in os.listdir(tmp_path / "c") if f.endswith(".tmp")] == []


def test_repeated_crashes_still_converge(tmp_path, clean_run):
    kind, ref_bank, ref_scores, ref_stats = clean_run
    X, Y = _stream()
    fps = [("fetch", 1), ("post_train", 3), ("post_fold", 5), ("mid_checkpoint", 7),
           ("post_swap", 9)]
    live = _make(ArraySource(X, Y, CHUNK), tmp_path / "c", bank_kind=kind, failpoints=fps)
    stats = run_live_with_restarts(live, sleep=_NOSLEEP)
    assert stats.restarts == 5
    assert _bank_eq(live.serving_bank(), ref_bank)
    assert torch.equal(_served_scores(live.serving_bank()), ref_scores)
    assert stats.durable() == ref_stats


def test_serve_from_live_checkpoint(tmp_path, clean_run):
    """BankServer.from_checkpoint on a live checkpoint folds the live slots
    into the loop's last pushed bank, bit for bit, and serves its scores."""
    kind, ref_bank, _, _ = clean_run
    X, Y = _stream()
    live = _make(ArraySource(X, Y, CHUNK), tmp_path / "c", bank_kind=kind)
    live.run()
    manifest = ckpt.load_manifest(str(tmp_path / "c"))
    folded = BankServer._fold_live_checkpoint(str(tmp_path / "c"), manifest, manifest["meta"],
                                              {}, torch.device("cpu"))
    assert _bank_eq(folded, live.serving_bank()) and _bank_eq(folded, ref_bank)
    srv = BankServer.from_checkpoint(str(tmp_path / "c"), q_block=16, device="cpu")
    if kind == "kernel":
        assert (srv.kernel, srv.gamma) == (KERNEL_KW["kernel"], KERNEL_KW["gamma"])
        direct = BankServer(live.serving_bank(), kernel="rbf", gamma=KERNEL_KW["gamma"],
                            q_block=16)
    else:
        assert srv.kernel is None
        direct = BankServer(live.serving_bank(), q_block=16)
    np.testing.assert_array_equal(srv.score(_QUERIES), direct.score(_QUERIES))


@pytest.mark.parametrize("kind", BANK_KINDS)
def test_real_server_through_crashes(tmp_path, kind):
    """A BankServer built by server_factory outlives three trainer crashes;
    afterwards it serves the crash-free run's bits."""
    X, Y = _stream()
    kw = dict(kernel="rbf", gamma=KERNEL_KW["gamma"]) if kind == "kernel" else {}
    factory = lambda bank: BankServer(bank, q_block=16, **kw)
    clean = _make(ArraySource(X, Y, CHUNK), tmp_path / "a", bank_kind=kind,
                  server_factory=factory)
    clean.run()
    crashy = _make(ArraySource(X, Y, CHUNK), tmp_path / "b", bank_kind=kind,
                   server_factory=factory,
                   failpoints=[("post_swap", 3), ("post_fold", 5), ("mid_checkpoint", 7)])
    stats = run_live_with_restarts(crashy, sleep=_NOSLEEP)
    assert stats.restarts == 3
    np.testing.assert_array_equal(crashy.server.score(_QUERIES), clean.server.score(_QUERIES))
    # the swaps the crashed windows replayed reached the same server object
    assert crashy.server.stats.bank_swaps > clean.server.stats.bank_swaps


def test_run_live_nonretryable_propagates(tmp_path):
    def bad_source(i):
        raise TypeError("a bug, not infrastructure")

    live = _make(bad_source, tmp_path / "c")
    with pytest.raises(TypeError, match="a bug"):
        run_live_with_restarts(live, sleep=_NOSLEEP)
    assert live.stats.restarts == 0 and live.stats.retries == 0


def test_resume_rejects_mismatched_configuration(tmp_path):
    X, Y = _stream(4)
    _make(ArraySource(X, Y, CHUNK), tmp_path / "c").run()
    with pytest.raises(ValueError, match="K=2"):
        _make(ArraySource(X, Y, CHUNK), tmp_path / "c", n_sub_banks=3).run()


def test_resume_rejects_mismatched_bank_kind_and_kernel_config(tmp_path):
    X, Y = _stream(4)
    _make(ArraySource(X, Y, CHUNK), tmp_path / "lin").run()
    with pytest.raises(ValueError, match="bank_kind='linear'.*'kernel'"):
        _make(ArraySource(X, Y, CHUNK), tmp_path / "lin", bank_kind="kernel").run()
    _make(ArraySource(X, Y, CHUNK), tmp_path / "ker", bank_kind="kernel").run()
    with pytest.raises(ValueError, match="bank_kind='kernel'.*'linear'"):
        _make(ArraySource(X, Y, CHUNK), tmp_path / "ker").run()
    for drift in ({"gamma": 0.9}, {"kernel": "linear"}, {"coreset_size": 7},
                  {"eviction": "farthest-point"}):
        with pytest.raises(ValueError, match="kernel config"):
            _make(ArraySource(X, Y, CHUNK), tmp_path / "ker", bank_kind="kernel",
                  **drift).run()


def test_checkpointing_disabled(tmp_path):
    X, Y = _stream(4)
    stats = _make(ArraySource(X, Y, CHUNK), tmp_path / "c", checkpoint_every_folds=0).run()
    assert stats.checkpoints == 0
    assert not ckpt.exists(str(tmp_path / "c"))


# ---------------------------------------------------------------------------
# retry / quarantine
# ---------------------------------------------------------------------------


def test_fetch_retry_backoff_and_quarantine(tmp_path):
    """A transient chunk delivers after its faults; a poison chunk exhausts
    the budget into quarantine; the sleeps are the capped exponential."""
    X, Y = _stream()
    delays = []
    live = _make(ArraySource(X, Y, CHUNK), tmp_path / "c", sleep=delays.append,
                 retry=RetryPolicy(retryable=(TransientSourceError,), max_retries=2,
                                   backoff_base=0.1, backoff_cap=0.15))
    live.source = FlakySource(live.source, {1: 2, 4: FlakySource.POISON})
    stats = live.run()
    assert stats.retries == 4
    assert delays == [0.1, 0.15, 0.1, 0.15]
    assert stats.quarantined == [4]
    assert stats.chunks_ingested == N_CHUNKS - 1
    assert stats.rows_ingested == (N_CHUNKS - 1) * CHUNK
    assert live.chunk_idx == N_CHUNKS


@pytest.mark.parametrize("kind", BANK_KINDS)
def test_source_faults_with_crashes_match_the_clean_run(tmp_path, kind):
    """Transient faults and a poison chunk, with crashes on top: bit-identical
    to the crash-free run with the same source faults."""
    X, Y = _stream()
    plan = {1: 2, 4: FlakySource.POISON, 6: 1}

    def make(name, **kw):
        live = _make(ArraySource(X, Y, CHUNK), tmp_path / name, bank_kind=kind, **kw)
        live.source = FlakySource(live.source, plan)
        return live

    clean = make("a")
    ref_stats = clean.run()
    crashy = make("b", failpoints=[("post_train", 3), ("fetch", 6), ("post_checkpoint", 7)])
    stats = run_live_with_restarts(crashy, sleep=_NOSLEEP)
    assert stats.restarts == 3 and stats.quarantined == [4]
    assert _bank_eq(crashy.serving_bank(), clean.serving_bank())
    assert stats.durable() == ref_stats.durable()


def test_fetch_nonretryable_propagates(tmp_path):
    X, Y = _stream()
    live = _make(ArraySource(X, Y, CHUNK), tmp_path / "c")
    live.source = FlakySource(live.source, {2: 1}, exc=ZeroDivisionError)
    with pytest.raises(ZeroDivisionError):
        live.run()
    assert live.stats.retries == 0


# ---------------------------------------------------------------------------
# server decoupling and the kernel-config guards
# ---------------------------------------------------------------------------


class _RecordingServer:
    """Stand-in hot-swap target: remembers every bank it was handed."""

    def __init__(self):
        self.banks = []

    def swap_bank(self, bank):
        self.banks.append(bank)


def test_server_survives_trainer_crash(tmp_path):
    X, Y = _stream()
    clean_srv = _RecordingServer()
    _make(ArraySource(X, Y, CHUNK), tmp_path / "a", server=clean_srv).run()
    srv = _RecordingServer()
    live = _make(ArraySource(X, Y, CHUNK), tmp_path / "b", server=srv,
                 failpoints=[("post_train", 5)])
    with pytest.raises(InjectedFailure):
        live.run()
    # the trainer is down; the server holds the chunk-4 bank and knows how
    # stale it is (chunk 5 ingested since the swap)
    assert len(srv.banks) == 2
    assert _bank_eq(srv.banks[-1], clean_srv.banks[1])
    assert live.stats.bank_age_chunks == 1
    live.run()
    assert len(srv.banks) == len(clean_srv.banks) == 5
    assert all(_bank_eq(a, b) for a, b in zip(srv.banks, clean_srv.banks))


def test_attach_server_pushes_current_bank(tmp_path):
    X, Y = _stream(4)
    live = _make(ArraySource(X, Y, CHUNK), tmp_path / "c")
    live.run()
    srv = _RecordingServer()
    live.attach_server(srv)
    assert len(srv.banks) == 1 and _bank_eq(srv.banks[0], live.serving_bank())


def test_live_loop_rejects_mismatched_server_kernel_config(tmp_path):
    X, Y = _stream(4)
    klive = _make(ArraySource(X, Y, CHUNK), tmp_path / "k", bank_kind="kernel")
    klive.run()
    with pytest.raises(ValueError, match="kernel='rbf'.*kernel=None"):
        klive.attach_server(BankServer(torch.zeros(B, D)))
    bank = klive.serving_bank()
    with pytest.raises(ValueError, match="gamma=0.7.*gamma=9.9"):
        klive.attach_server(BankServer(bank, kernel="rbf", gamma=9.9))
    llive = _make(ArraySource(X, Y, CHUNK), tmp_path / "l")
    llive.run()
    with pytest.raises(ValueError, match="kernel=None.*kernel='rbf'"):
        llive.attach_server(BankServer(bank, kernel="rbf", gamma=0.7))
    mlive = _make(ArraySource(X, Y, CHUNK), tmp_path / "m", bank_kind="kernel",
                  server_factory=lambda b: BankServer(b, kernel="rbf", gamma=9.9))
    with pytest.raises(ValueError, match="gamma=0.7.*gamma=9.9"):
        mlive.run()


# ---------------------------------------------------------------------------
# the non-finite publish guard
# ---------------------------------------------------------------------------


def _poisoned_stream():
    X, Y = _stream()
    X = X.copy()
    X[CHUNK:2 * CHUNK] = np.nan
    return X, Y


def test_nonfinite_fold_quarantined_by_default(tmp_path):
    """Folds holding the NaN-poisoned epoch are quarantined (counted, not
    pushed); once that epoch is dropped the loop publishes again."""
    X, Y = _poisoned_stream()
    srv = _RecordingServer()
    live = _make(ArraySource(X, Y, CHUNK), tmp_path / "c", server=srv, retire="drop")
    stats = live.run()
    assert stats.folds_quarantined == 2 and stats.folds == 3 and len(srv.banks) == 3
    for bank in srv.banks + [live.serving_bank()]:
        assert not bool(nonfinite_rows(bank).any())
    assert "folds_quarantined" in stats.durable()


def test_nonfinite_fold_strict_raises_naming_rows(tmp_path):
    X, Y = _poisoned_stream()
    live = _make(ArraySource(X, Y, CHUNK), tmp_path / "c", strict_finite=True)
    with pytest.raises(ValueError, match=r"non-finite serving fold at chunk 2.*\[0, 1, 2\]"):
        live.run()
    assert live.serving_bank() is None


def test_nonfinite_guard_matches_the_reference(tmp_path):
    X, Y = _poisoned_stream()
    ref = _ref_make(_ref_source(X, Y), tmp_path / "r", retire="drop").run()
    port = _make(ArraySource(X, Y, CHUNK), tmp_path / "p", retire="drop").run()
    _stats_match_reference(port.durable(), ref.durable())


# ---------------------------------------------------------------------------
# rotate_on
# ---------------------------------------------------------------------------


def test_rotate_on_matches_epoch_referent(tmp_path):
    X, Y = _stream()
    cadence = _make(ArraySource(X, Y, CHUNK), tmp_path / "a", rotate_every=3)
    ref_stats = cadence.run()
    custom = _make(ArraySource(X, Y, CHUNK), tmp_path / "b", rotate_every=10**9,
                   rotate_on=lambda s: s.chunks_ingested % 3 == 0)
    stats = custom.run()
    assert stats.rotations == ref_stats.rotations == 3
    assert _bank_eq(custom.serving_bank(), cadence.serving_bank())
    assert stats.durable() == ref_stats.durable()


def test_rotate_on_composes_with_rotate_every(tmp_path):
    X, Y = _stream()
    stats = _make(ArraySource(X, Y, CHUNK), tmp_path / "c", rotate_every=4,
                  rotate_on=lambda s: s.chunks_ingested % 3 == 0).run()
    assert stats.rotations == 5


@pytest.mark.parametrize("kind", BANK_KINDS)
def test_rotate_on_replay_stable_across_crash(tmp_path, kind):
    X, Y = _stream()
    trigger = lambda s: s.chunks_ingested % 3 == 0
    clean = _make(ArraySource(X, Y, CHUNK), tmp_path / "a", bank_kind=kind,
                  rotate_every=10**9, rotate_on=trigger)
    ref_stats = clean.run()
    crashy = _make(ArraySource(X, Y, CHUNK), tmp_path / "b", bank_kind=kind,
                   rotate_every=10**9, rotate_on=trigger,
                   failpoints=[("post_rotate", 5), ("post_fold", 7)])
    stats = run_live_with_restarts(crashy, sleep=_NOSLEEP)
    assert stats.restarts == 2
    assert _bank_eq(crashy.serving_bank(), clean.serving_bank())
    assert stats.durable() == ref_stats.durable()


def test_merge_dropped_mass_audit(tmp_path):
    X, Y = _stream()
    assert _make(ArraySource(X, Y, CHUNK), tmp_path / "l").run().merge_dropped_mass == 0.0
    lossy = _make(ArraySource(X, Y, CHUNK), tmp_path / "k", bank_kind="kernel").run()
    assert lossy.merge_dropped_mass > 0.0
    roomy = _make(ArraySource(X, Y, CHUNK), tmp_path / "e", bank_kind="kernel",
                  coreset_size=N_CHUNKS * CHUNK + 8).run()
    assert roomy.merge_dropped_mass == 0.0
