"""The port's transfer layer (sina_tpu_torch/ops/transfer.py) and the
profile wire, against the JAX package.

The wire: the port writes a profile launch's inputs into one buffer
with the JAX package's segments in its order, each starting at a
multiple of 256 bytes; every segment must equal the JAX package's
(``_build_wire`` as its ``profile_dp_dispatch`` calls it, padding
included) byte for byte.  A launch through the wire must equal the
direct multi-array launch and the JAX package's ``profile_dp_batch``.
The graph bucket's bank of planes must not be handed out again before
its fetch has returned.  On the CPU nothing is pinned and nothing is
copied; the pool's reuse rules run here on plain buffers, the pinned
copies on the card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

import sina_tpu.ops.profile as jprof
from sina_tpu.ops.align_kernel import DpParams as JaxDpParams
from sina_tpu_torch import align as talign
from sina_tpu_torch import testing
from sina_tpu_torch.align import AlignerConfig, align_dispatch, align_finalize
from sina_tpu_torch.ops import profile as tprof
from sina_tpu_torch.ops import profile_kernel as pk
from sina_tpu_torch.ops import transfer
from sina_tpu_torch.ops.align_kernel import DpParams

CPU = torch.device("cpu")


def _inputs(seed: int, B: int, U: int, C: int, M: int):
    """Quantised profiles (U rows), masks, lens, fam_idx and budgets of
    B queries, as the JAX package's wire tests make them."""
    rng = np.random.default_rng(seed)
    p = DpParams()
    freqs = rng.random((U, C, 4)).astype(np.float32)
    freqs /= freqs.sum(axis=2, keepdims=True) * 1.25
    gapcost = (rng.random((U, C)) * 2).astype(np.float32)
    fg = tprof._pack_fgq(freqs, gapcost, p)
    qmask = (1 << rng.integers(0, 4, (B, M), dtype=np.uint8)).astype(np.uint8)
    qlen = rng.integers(M // 2, M + 1, B).astype(np.int32)
    cr = rng.integers(C // 2, C + 1, B).astype(np.int32)
    for b in range(B):
        qmask[b, qlen[b]:] = 0
    fam_idx = rng.integers(0, U, B).astype(np.int32)
    budget = rng.integers(0, 4, (B, C)).astype(np.int32)
    return p, fg, qmask, qlen, cr, fam_idx, budget


class _Captured(Exception):
    pass


def _jax_wire(monkeypatch, fg, qmask, qlen, cr, p, fam_idx, budget):
    """The wire the JAX package's profile_dp_dispatch builds (after its
    own padding), captured at its _build_wire; nothing is launched."""
    seen = {}
    build = jprof._build_wire

    def capture(*args, **kw):
        seen["wire"] = build(*args, **kw)
        seen["U"] = args[0].shape[0]
        raise _Captured

    monkeypatch.setattr(jprof, "_build_wire", capture)
    with pytest.raises(_Captured):
        jprof.profile_dp_dispatch(
            None, None, qmask, qlen, cr,
            JaxDpParams(p.match, p.mismatch, p.gap_open, p.gap_ext),
            budget=budget, fam_idx=fam_idx, _prepacked=fg)
    return seen["wire"], seen["U"]


@pytest.mark.parametrize("B", [16, 11], ids=["bucket", "padded"])
@pytest.mark.parametrize("aspace", [False, True], ids=["shift", "aspace"])
@pytest.mark.parametrize("dedup", [False, True], ids=["rows", "dedup"])
def test_wire_segments_equal_the_jax_wire(monkeypatch, dedup, aspace, B):
    C, M = 40, 56
    U = 4 if dedup else B
    p, fg, qmask, qlen, cr, fam_idx, budget = _inputs(3, B, U, C, M)
    fam_idx = fam_idx if dedup else None
    budget = budget if aspace else None
    jwire, jU = _jax_wire(monkeypatch, fg, qmask, qlen, cr, p, fam_idx, budget)
    B_pad = tprof._bucket_rows(B)
    sizes = jprof._wire_layout(B_pad, jU, C, M, dedup, aspace)
    names = ("lens", "fam_idx", "budget", "fgq", "qmask")

    segs, total = tprof._wire_layout(B_pad, jU, C, M, dedup, aspace)
    wire = np.full(total, 0xAB, np.uint8)  # _build_wire must zero the gaps
    lens = np.stack([qlen, cr], axis=1)
    tprof._build_wire(wire, segs, fg, qmask, lens, fam_idx, budget)

    o = 0
    covered = np.zeros(total, bool)
    for name, n in zip(names, sizes):
        if n == 0:
            assert name not in segs
            continue
        at, length = segs[name]
        assert at % tprof.WIRE_ALIGN == 0 and length == n, name
        np.testing.assert_array_equal(wire[at:at + n], jwire[o:o + n], err_msg=name)
        covered[at:at + n] = True
        o += n
    assert o == len(jwire)
    assert (wire[~covered] == 0).all()


def test_split_wire_reads_each_segment():
    """The device's views of the wire (narrow + a view as int32) are
    the arrays _build_wire wrote, with padding rows."""
    p, fg, qmask, qlen, cr, fam_idx, budget = _inputs(4, 11, 4, 40, 56)
    segs, total = tprof._wire_layout(16, 4, 40, 56, True, True)
    wire = np.zeros(total, np.uint8)
    lens = np.stack([qlen, cr], axis=1)
    tprof._build_wire(wire, segs, fg, qmask, lens, fam_idx, budget)
    f, q, ln, fi, bd = tprof._split_wire(torch.from_numpy(wire), segs, 40, 56)
    np.testing.assert_array_equal(f.numpy(), fg)
    np.testing.assert_array_equal(q.numpy()[:11], qmask)
    assert (q.numpy()[11:] == 0).all()
    np.testing.assert_array_equal(ln.numpy()[:11], lens)
    assert (ln.numpy()[11:] == 1).all()
    np.testing.assert_array_equal(fi.numpy(), np.r_[fam_idx, np.zeros(5, np.int32)])
    np.testing.assert_array_equal(bd.numpy()[:11], budget)
    assert (bd.numpy()[11:] == 0).all()
    base = f.untyped_storage().data_ptr()
    for t in (f, q, ln, fi, bd):
        assert t.is_contiguous() and (t.data_ptr() - base) % tprof.WIRE_ALIGN == 0


def _direct(p, fg, qmask, lens, fam_idx=None, budget=None):
    """The launch on separate arrays (no wire): numpy (emit, best_c,
    best_i, raw)."""
    t = torch.from_numpy
    bp, bc, bi, raw = pk.profile_dp(
        t(fg), t(qmask), t(lens.astype(np.int32)), p,
        None if fam_idx is None else t(fam_idx),
        None if budget is None else t(budget))
    emit = pk.chain_traceback(bp, bc, bi)
    return emit.numpy(), bc.numpy(), bi.numpy(), raw.numpy()


def _equal(got, want):
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a).view(np.int32),
                                      np.asarray(b).view(np.int32))


def test_wire_dispatch_matches_direct_arrays():
    """tests/test_profile.py test_wire_dispatch_matches_direct_arrays,
    on the port: the wire dispatch reproduces the direct multi-array
    launch exactly, in the plain, dedup (fam_idx gather) and aspace
    (budget) modes."""
    B, C, M = 16, 40, 56  # B == bucket so no padding ambiguity
    p, fg, qmask, qlen, cr, _, budget = _inputs(11, B, B, C, M)
    lens = np.stack([qlen, cr], axis=1)
    direct = _direct(p, fg, qmask, lens)
    wired = tprof.profile_dp_fetch(
        tprof.profile_dp_dispatch(fg, qmask, qlen, cr, p, CPU))
    _equal(wired, direct)

    # dedup: all queries share profile row 0 == row 0 replicated
    ded = tprof.profile_dp_fetch(tprof.profile_dp_dispatch(
        fg[:1], qmask, qlen, cr, p, CPU, fam_idx=np.zeros(B, np.int32)))
    rep = tprof.profile_dp_fetch(tprof.profile_dp_dispatch(
        np.repeat(fg[:1], B, 0), qmask, qlen, cr, p, CPU))
    _equal(ded, rep)

    asp = tprof.profile_dp_fetch(tprof.profile_dp_dispatch(
        fg, qmask, qlen, cr, p, CPU, budget=budget))
    _equal(asp, _direct(p, fg, qmask, lens, budget=budget))


@pytest.mark.parametrize("aspace", [False, True], ids=["shift", "aspace"])
@pytest.mark.parametrize("B", [16, 5], ids=["bucket", "padded"])
def test_profile_dp_batch_equals_the_jax_package(B, aspace):
    """A launch through the port's wire on the CPU against the JAX
    package's profile_dp_batch (its wire and XLA path on the CPU) on
    the same unpacked profiles: emit, best_c, best_i and raw exact."""
    C, M = 48, 64
    rng = np.random.default_rng(5 + B)
    freqs = rng.random((B, C, 4)).astype(np.float32)
    freqs /= freqs.sum(axis=2, keepdims=True) * 1.25
    gapcost = (rng.random((B, C)) * 2).astype(np.float32)
    qmask = (1 << rng.integers(0, 4, (B, M), dtype=np.uint8)).astype(np.uint8)
    qlen = rng.integers(M // 2, M + 1, B).astype(np.int32)
    cr = rng.integers(C // 2, C + 1, B).astype(np.int32)
    for b in range(B):
        qmask[b, qlen[b]:] = 0
    budget = rng.integers(0, 6, (B, C)).astype(np.int32) if aspace else None
    p = DpParams()
    want = jprof.profile_dp_batch(
        freqs, gapcost, qmask, qlen, cr,
        JaxDpParams(p.match, p.mismatch, p.gap_open, p.gap_ext), budget=budget)
    got = tprof.profile_dp_batch(freqs, gapcost, qmask, qlen, cr, p,
                                 budget=budget, device="cpu")
    _equal(got, want)


def test_cpu_transfers_copy_nothing():
    """On the CPU the caller asked for the CPU: upload wraps the array,
    a fetch is its values at once, nothing is pinned or counted."""
    transfer.reset_counts()
    a = np.arange(12, dtype=np.int32).reshape(3, 4)
    t = transfer.upload(a, CPU)
    assert t.dtype == torch.int32 and np.array_equal(t.numpy(), a)
    assert not t.is_pinned()
    buf = transfer.host_buffer(100, CPU)
    assert buf.numel() == 100 and not buf.is_pinned()
    transfer.release(buf, CPU)
    np.testing.assert_array_equal(transfer.fetch_async(t * 2).result(), a * 2)
    assert transfer.counts == {"h2d": 0, "d2h": 0}
    assert transfer.pool_bytes() == 0


class _Event:
    def __init__(self, done=False):
        self.done = done
        self.waited = False

    def query(self):
        return self.done

    def synchronize(self):
        self.waited = self.done = True


def _plain_pool(cap):
    return transfer._Pool(alloc=lambda n: torch.empty(n, dtype=torch.uint8), cap=cap)


def test_pool_reuses_a_buffer_only_after_its_event():
    pool = _plain_pool(1 << 30)
    a = pool.lend(1000)
    assert a.host.numel() == 1 << 16  # the smallest size class
    b = pool.lend(1000)
    assert b is not a  # a is lent
    ev = _Event()
    pool.give_back(a.host[:1000], ev)
    assert pool.lend(70_000).host.numel() == 1 << 17  # another class
    c = pool.lend(10)
    assert c is not a  # a's copy has not run
    ev.done = True
    assert pool.lend(10) is a
    assert pool.nbytes == 3 * (1 << 16) + (1 << 17)
    with pytest.raises(ValueError):
        pool.give_back(torch.empty(4, dtype=torch.uint8), None)


def test_pool_stays_under_its_cap():
    """Past the cap the pool drops idle buffers, then waits for guarded
    ones; with every byte lent it raises."""
    pool = _plain_pool(1 << 17)
    a, b = pool.lend(1), pool.lend(1)
    pool.give_back(a.host, None)                 # idle
    ev = _Event()
    pool.give_back(b.host, ev)                   # copy in flight
    big = pool.lend(1 << 17)                     # drops a, waits for b
    assert ev.waited and pool.nbytes == 1 << 17
    with pytest.raises(RuntimeError, match="cap"):
        pool.lend(1)
    assert big.lent and pool.nbytes == 1 << 17


def _graph_case():
    db = testing.make_reference(n_seqs=40, n_core=150, width=240, seed=3)
    qs = testing.make_queries(db, n=6, seed=4, branch_len=0.4)
    queries = [testing.unaligned_copy(q) for q in qs]
    fams = []
    for q in qs:
        pid = db.index_of(q.get_attr("parent"))
        fams.append([(1.0, db.sequences[(pid + k) % len(db)]) for k in range(6)])
    return queries, fams


def test_graph_bank_is_released_only_after_the_fetch(monkeypatch):
    """A graph bucket's bank of planes goes back to the arena only after
    its fetch's result() has returned, never at dispatch."""
    arena = talign._StackArena()
    monkeypatch.setattr(talign, "_stack_arena", arena)
    taken, pending = [], []
    acquire = arena.acquire

    def acquiring():
        bank = acquire()
        taken.append(bank)
        return bank

    monkeypatch.setattr(arena, "acquire", acquiring)

    class Held:
        """A fetch whose result() is called by the test's finalize."""

        def __init__(self, t):
            self.value = t.numpy()
            self.bank = taken[-1]  # the bucket's bank, taken at its stack
            self.done = False
            pending.append(self)

        def result(self):
            # the bank is not free while its fetch is unread
            assert not any(f is self.bank for f in arena._free)
            self.done = True
            return self.value

    monkeypatch.setattr(transfer, "fetch_async", Held)
    queries, fams = _graph_case()
    cfg = AlignerConfig(engine="graph")
    state = align_dispatch(queries, [list(f) for f in fams], cfg, device="cpu")
    assert taken and pending and arena._free == []
    # a second dispatch while the first is in flight gets new banks
    first = list(taken)
    state2 = align_dispatch(queries, [list(f) for f in fams], cfg, device="cpu")
    assert all(b is not f for b in taken[len(first):] for f in first)
    out = align_finalize(state)
    assert all(h.done for h in pending[: len(first)])
    assert all(any(b is f for b in arena._free) for f in first)
    out2 = align_finalize(state2)
    assert len(arena._free) == len(taken)
    assert [a.get_bases() for a in out] == [a.get_bases() for a in out2]


@pytest.mark.parametrize("weighted", [False, True], ids=["ones", "weights"])
def test_graph_bucket_column_weights_equal_the_jax_package(weighted):
    """The graph bucket's column weights: made on the device when every
    query has the shared ones, else a bank plane that crosses; either
    way the aligned rows equal the JAX package's."""
    import numpy as np

    from sina_tpu import testing as jax_testing
    from sina_tpu.align import AlignerConfig as JaxAlignerConfig
    from sina_tpu.align import align_batch as jax_align_batch
    from sina_tpu_torch.align import align_batch

    args = dict(n_seqs=40, n_core=150, width=240, seed=3)
    db, jdb = testing.make_reference(**args), jax_testing.make_reference(**args)
    qs = testing.make_queries(db, n=6, seed=4, branch_len=0.4)
    jqs = jax_testing.make_queries(jdb, n=6, seed=4, branch_len=0.4)
    fams, jfams = [], []
    for q in qs:
        pid = db.index_of(q.get_attr("parent"))
        fams.append([(1.0, db.sequences[(pid + k) % len(db)]) for k in range(6)])
        jfams.append([(1.0, jdb.sequences[(pid + k) % len(jdb)]) for k in range(6)])
    rng = np.random.default_rng(8)
    weights = [rng.uniform(0.5, 2.0, db.width).astype(np.float32) if weighted and i % 2 == 0
               else None for i in range(len(qs))]
    got = align_batch([testing.unaligned_copy(q) for q in qs], fams,
                      AlignerConfig(engine="graph"), weights, device="cpu")
    want = jax_align_batch([jax_testing.unaligned_copy(q) for q in jqs], jfams,
                           JaxAlignerConfig(engine="graph"), weights)
    assert all(a is not None for a in got)
    assert [a.get_aligned() for a in got] == [a.get_aligned() for a in want]
