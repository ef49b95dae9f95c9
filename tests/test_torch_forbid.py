"""--insertion forbid on the profile engine against the JAX package.

The reference runs forbid mode only through the XLA chain_dp (its
aspace branch, sina_tpu/ops/profile.py:399-520), on every backend: no
edge seed, insertion runs bounded by a trailing-window minimum of the
column's budget, and an `ins_opened` test that also takes
`Irow + 1e-4 < Iprev + ge`.  The port's plain DP follows it in its f32
order, so every backpointer bit, the end cell and the raw score are
compared exactly, and so are the traceback's emit, the dispatch (with
padding rows and dedup) and the CLI's bytes.
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sina_tpu.align import AlignerConfig as JaxAlignerConfig
from sina_tpu.align import align_sequence as jax_align_sequence
from sina_tpu.ops import profile as jax_profile
from sina_tpu.ops.align_kernel import _windowed_min
from sina_tpu.ops.profile import _device_unpack_fgq, _profile_batched_fn, chain_dp
from sina_tpu.ops.profile import profile_dp_dispatch as jax_dispatch
from sina_tpu.ops.profile import profile_dp_fetch as jax_fetch
from sina_tpu.sequence import Sequence as JaxSequence
from sina_tpu_torch.align import AlignerConfig, align_sequence
from sina_tpu_torch.ops import profile_kernel as pk
from sina_tpu_torch.ops.profile import profile_dp_dispatch, profile_dp_fetch
from sina_tpu_torch.sequence import Sequence
from test_torch_profile import _case, _jax_params
from test_torch_slice import CASES as PROFILE_CASES
from test_torch_slice import run_both_clis


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain DP is a loop of small tensor operations: under the test
    run's parallel workers, torch's intra-op threads would only contend
    for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _budgets(seed: int, B: int, C: int, M: int) -> np.ndarray:
    """(B, C) int32 insertion budgets: row 0 all 0 (no insertion
    anywhere), row 1 all 1, row 2 small (0-3), row 3 above M, the rest
    a mix of 0, 1, small, mid-size, M, above M and 10**6."""
    rng = np.random.default_rng(seed)
    choices = np.array([0, 0, 1, 2, 3, 5, 9, 17, M - 1, M, M + 3, 10**6])
    bud = choices[rng.integers(0, len(choices), (B, C))]
    bud[0] = 0
    bud[1] = 1
    bud[2] = rng.integers(0, 4, C)
    bud[3] = M + 1 + rng.integers(0, 50, C)
    return bud.astype(np.int32)


def _reference_core(C: int, M: int, jp, dedup: bool):
    """The per-row core of the reference's forbid route
    (_profile_batched_fn(aspace=True), sina_tpu/ops/profile.py:568-600):
    its own unpack, substitution costs, chain_dp and traceback, taken
    out of a freshly built copy of the jitted function."""
    packed = _profile_batched_fn.__wrapped__(C, M, jp, True, dedup).__wrapped__
    vm = dict(zip(packed.__code__.co_freevars, packed.__closure__))["vm"].cell_contents
    return vm.__wrapped__


def _xla_chain_dp(p, fgq, qmask, lens, budget, fam_idx=None):
    """The reference's forbid-mode DP with its backpointer plane: the
    reference's own per-row core, with chain_dp's bp plane recorded on
    its way to the traceback.  Returns (bp (C, B, M) uint8 in the
    port's bit layout, best_c, best_i, raw, emit (B, M))."""
    jp = _jax_params(p)
    fq, gc = _device_unpack_fgq(jnp.asarray(fgq), jp)
    if fam_idx is not None:
        fq, gc = fq[fam_idx], gc[fam_idx]
    C, M = fgq.shape[1], qmask.shape[1]
    core = _reference_core(C, M, jp, fam_idx is not None)
    planes = []

    def recording_chain_dp(*args, **kwargs):
        out = chain_dp(*args, **kwargs)
        planes.append(out[0])
        return out

    def row(*args):
        emit, bc, bi, raw = core(*args)
        return planes.pop(), emit, bc, bi, raw

    with mock.patch.object(jax_profile, "chain_dp", recording_chain_dp):
        bp, emit, bc, bi, raw = jax.jit(jax.vmap(row))(
            fq, gc, jnp.asarray(qmask), jnp.asarray(lens[:, 0]),
            jnp.asarray(lens[:, 1]), jnp.asarray(budget))
    x = np.asarray(bp).astype(np.int64)
    bp8 = (x & 3) | (((x >> 8) & 1) << 2) | (((x >> 9) & 1) << 3)
    return (bp8.transpose(1, 0, 2).astype(np.uint8), np.asarray(bc), np.asarray(bi),
            np.asarray(raw), np.asarray(emit))


def _port_dp(p, fgq, qmask, lens, budget, fam_idx=None):
    t = torch.from_numpy
    return pk.profile_dp(t(fgq), t(qmask), t(lens), p,
                         None if fam_idx is None else t(fam_idx), t(budget))


@pytest.mark.parametrize("dedup", [False, True])
@pytest.mark.parametrize("seed", [3, 17])
def test_plain_forbid_dp_matches_xla_chain_dp(seed, dedup):
    """Every bp bit (code, deletion opened, insertion opened with the
    XLA term), best_c, best_i and raw bit for bit, and the traceback's
    emit through the port's chain traceback on the forbid plane."""
    p, fgq, qmask, lens = _case(seed, B=9, C=60, M=64)
    B, C, M = qmask.shape[0], fgq.shape[1], qmask.shape[1]
    budget = _budgets(seed, B, C, M)
    fam_idx = None
    if dedup:
        # the budget stays per query row while rows share profiles
        fam_idx = np.array([2, 0, 2, 1, 0, 1, 0, 2, 1], np.int32)[:B]
        fgq = fgq[:3].copy()
    want = _xla_chain_dp(p, fgq, qmask, lens, budget, fam_idx)
    got = _port_dp(p, fgq, qmask, lens, budget, fam_idx)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    np.testing.assert_array_equal(got[3].numpy().view(np.int32), want[3].view(np.int32))
    # the budgets bind: no insertion anywhere in the all-0 row, some in
    # the row whose budgets exceed M
    code = got[0].numpy() & 3
    assert not (code[:, 0] == 3).any()
    assert (code[:, 3] == 3).any()
    np.testing.assert_array_equal(pk.chain_traceback(*got[:3]).numpy(), want[4])


@pytest.mark.parametrize("dedup", [False, True])
def test_forbid_dispatch_matches_reference(dedup):
    """profile_dp_dispatch with a budget: the batch pads to its row
    bucket (padding rows get zero budgets) and the fetched (emit,
    best_c, best_i, raw) equal the reference's XLA forbid path with
    the same padding, dedup or not."""
    p, fgq, qmask, lens = _case(13, B=7, C=48, M=56)
    B, C, M = qmask.shape[0], fgq.shape[1], qmask.shape[1]
    budget = _budgets(5, B, C, M)
    fam_idx = np.array([1, 0, 1, 1, 0, 2, 2], np.int32) if dedup else None
    if dedup:
        fgq = fgq[:3].copy()
    want = jax_fetch(jax_dispatch(
        None, None, qmask, lens[:, 0], lens[:, 1], _jax_params(p),
        budget=budget, fam_idx=fam_idx, _prepacked=fgq))
    handle = profile_dp_dispatch(fgq, qmask, lens[:, 0], lens[:, 1], p,
                                 torch.device("cpu"), fam_idx=fam_idx, budget=budget)
    assert handle[0].shape == (16, M + 3)
    got = profile_dp_fetch(handle)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a).view(np.int32),
                                      np.asarray(b).view(np.int32))


def _fam(seq_cls, *rows):
    return [(1.0, seq_cls.from_string(f"r{k}", r)) for k, r in enumerate(rows)]


@pytest.mark.parametrize(
    "refs,query",
    [
        # no free column: the extra base must not become an insertion
        (("AGACGUCA", "AGACGUCA"), "AGACUGUCA"),
        # two free columns take the insertion
        (("AGA--CGUCA", "AGA--CGUCA"), "AGAUCGUCA"),
    ],
    ids=["no_room", "room"],
)
def test_forbid_alignments_equal_reference(refs, query):
    """The two hand-built cases of tests/test_insertion_forbid.py on
    the profile engine: the port's aligned row equals the JAX
    package's, and holds the reference test's expectations."""
    cfg = dict(realign=True, insertion="forbid", engine="profile")
    want = jax_align_sequence(JaxSequence.from_string("q", query),
                              _fam(JaxSequence, *refs), JaxAlignerConfig(**cfg))
    got = align_sequence(Sequence.from_string("q", query), _fam(Sequence, *refs),
                         AlignerConfig(**cfg), device="cpu")
    np.testing.assert_array_equal(got.positions, want.positions)
    np.testing.assert_array_equal(got.masks, want.masks)
    stamp = "aligned_slv"
    assert ({k: v for k, v in got.attrs.items() if k != stamp}
            == {k: v for k, v in want.attrs.items() if k != stamp})
    assert got.get_bases() == query
    assert got.width == len(refs[0])
    if "-" in refs[0]:
        assert got.get_aligned(dots=False) == "AGA-UCGUCA"


def test_forbid_accuracy_equal_reference():
    """tests/test_insertion_forbid.py's accuracy case: five queries
    against 12-member families of a generated reference (the port's
    testing module makes the same data from the same seeds), aligned
    rows equal to the JAX package's and above its 0.8 identity bar."""
    from sina_tpu import testing
    from sina_tpu.comparator import COVER_QUERY, IUPAC_EXACT, Comparator
    from sina_tpu_torch import testing as ttesting

    cfg = dict(realign=True, insertion="forbid", engine="profile")
    cmp_exact = Comparator(IUPAC_EXACT, "none", COVER_QUERY, False)
    out = []
    for mod, align, acfg in ((testing, jax_align_sequence, JaxAlignerConfig(**cfg)),
                             (ttesting, align_sequence, AlignerConfig(**cfg))):
        kw = {} if mod is testing else {"device": "cpu"}
        db = mod.make_reference(n_seqs=60, n_core=300, width=500, seed=13)
        rows = []
        for true_q in mod.make_queries(db, n=5, seed=8, branch_len=0.4):
            pid = db.index_of(true_q.get_attr("parent"))
            fam = [(1.0, db.sequences[(pid + k) % len(db)]) for k in range(12)]
            got = align(mod.unaligned_copy(true_q), fam, acfg, **kw)
            assert got.get_bases().upper() == true_q.get_bases().upper()
            if mod is testing:
                assert cmp_exact(true_q, got) > 0.8
            rows.append(got.get_aligned(dots=False))
        out.append(rows)
    assert out[0] == out[1]


CLI_CASES = {
    "forbid_verify": dict(PROFILE_CASES["verify"], extra=["--insertion", "forbid"]),
    "forbid_fs_no_graph": dict(PROFILE_CASES["verify"],
                               extra=["--fs-no-graph", "--insertion", "forbid"]),
    # col-trimmed amplicon windows: rows whose window ends before the
    # family's last occupied column take the last-slot budget from the
    # next column outside the window
    "forbid_amplicon_col_trim": dict(
        PROFILE_CASES["amplicon_col_trim"],
        extra=PROFILE_CASES["amplicon_col_trim"]["extra"] + ["--insertion", "forbid"]),
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_forbid_cli_output_is_byte_identical(case, tmp_path, monkeypatch):
    """The port's CLI (--device cpu) writes the JAX package's bytes.  In
    the col-trim case some rows' windows fill their bucket (c_real ==
    C): they stop at or before the family's last occupied column, where
    the last slot's budget is the gap to the next column outside."""
    from sina_tpu_torch.ops import profile as tprofile

    seen = []
    dispatch = tprofile.profile_dp_dispatch

    def recording(fgq, qmask, qlen, c_real, params, device, fam_idx=None, budget=None):
        assert budget is not None and budget.shape == (len(c_real), fgq.shape[1])
        seen.append(np.asarray(c_real) == fgq.shape[1])
        return dispatch(fgq, qmask, qlen, c_real, params, device, fam_idx, budget)

    monkeypatch.setattr(tprofile, "profile_dp_dispatch", recording)
    dumps, _ = run_both_clis(CLI_CASES[case], tmp_path)
    assert not dumps
    assert seen
    if "amplicon" in case:
        assert any(full.any() for full in seen)


# --- the forbid kernel's one-barrier window algebra, modelled in numpy ---
#
# csrc/profile_dp.cu (forbid_prefix) computes each lane's trailing-window
# minimum min(cand[x-R+1 .. x]) with one block barrier a column: lanes in
# threads of K, threads in warps of 32, segments of R lanes from multiples
# of R, warp-local forward and backward minima P and S before the barrier
# (S written to a shared row behind a guard of BIG, the warps' edge values
# to slots), and
# the carries from the warps to the left after it.  The model below takes
# the same steps on numpy arrays, one row per column (each with its own R),
# shuffles included, so a carry or index bug shows here before a chip run.
# Nothing in the port uses it.

_KBIG = np.float32(1e6)
_INF = np.float32(np.inf)


def _shfl_up(v, off):
    """__shfl_up_sync over (n, T) thread values: a lane below `off`
    keeps its own value."""
    i = np.arange(v.shape[1])
    return v[:, np.where(i % 32 >= off, i - off, i)]


def _shfl_down(v, off):
    i = np.arange(v.shape[1])
    return v[:, np.where(i % 32 + off < 32, i + off, i)]


def _shfl_idx(v, src):
    """__shfl_sync from lane `src` (n, T) of each thread's warp."""
    base = np.arange(v.shape[1]) // 32 * 32
    return np.take_along_axis(v, base + src, axis=1)


def _magic_div(n, R, rdiv):
    """n / R as the kernel takes it: __umulhi(n, ceil(2^32 / R)), n for
    R = 1."""
    q = (n.astype(np.uint64) * rdiv.astype(np.uint64)) >> np.uint64(32)
    return np.where(R == 1, n, q.astype(np.int64))


def _one_barrier_windows(cand, budget, M, K):
    """The kernel's windows for a (n, L) block of insertion candidates
    (L = threads * K, lanes past M garbage) with budgets (n,) >= 1.
    Returns (win (n, T, K+1): the windows ending at lanes lane0-2 ..
    lane0+K-2 of each thread, rows (n, 32 K + 4 + L): the S row as
    written, behind its guard)."""
    n, L = cand.shape
    T, W = L // K, 32 * K
    nwarps = T // 32
    lgW = W.bit_length() - 1
    R = np.minimum(budget, M).astype(np.int64)[:, None]
    rdiv = np.where(R > 1, (0xFFFFFFFF + R) // R, 0)

    def div(x):
        return _magic_div(np.broadcast_to(x, np.broadcast_shapes(np.shape(x), R.shape)), R, rdiv)

    t = np.arange(T)
    lane0 = (t * K)[None, :]
    warp, wl = (t // 32)[None, :], (t % 32)[None, :]
    wlane0 = lane0 - wl * K
    sw = div(wlane0) * R
    pe = np.where(sw < wlane0, sw + R, wlane0)
    r0 = lane0 - div(lane0) * R
    # pl[..., j]: the place of lane lane0-2+j in its segment
    pl = np.zeros((n, T, K + 3), np.int64)
    pl[..., 1] = np.where(r0 == 0, R - 1, r0 - 1)
    pl[..., 0] = np.where(pl[..., 1] == 0, R - 1, pl[..., 1] - 1)
    pl_m2 = pl[..., 0]
    r = r0.copy()
    for k in range(K + 1):
        pl[..., k + 2] = r
        r = np.where(r + 1 == R, 0, r + 1)
    head = pl[..., 2:K + 2] == 0
    s_last = lane0 + K - 1 - pl[..., K + 1]
    e_first = lane0 - r0 + R - 1
    c3 = cand.reshape(n, T, K)
    P, S = np.empty_like(c3), np.empty_like(c3)
    P[..., 0] = c3[..., 0]
    for k in range(1, K):
        P[..., k] = np.where(head[..., k], c3[..., k], np.minimum(P[..., k - 1], c3[..., k]))
    S[..., K - 1] = c3[..., K - 1]
    for k in range(K - 2, -1, -1):
        S[..., k] = np.where(head[..., k + 1], c3[..., k], np.minimum(S[..., k + 1], c3[..., k]))
    # a segment touches at most reach + 1 threads: the rounds stop at reach
    reach = (R + K - 2) // K
    fi, bi = P[..., K - 1].copy(), S[..., 0].copy()
    for off in (1, 2, 4, 8, 16):
        fo, bo = _shfl_up(fi, off), _shfl_down(bi, off)
        fi = np.where((off < reach) & (lane0 + K - 1 - off * K >= s_last), np.minimum(fi, fo), fi)
        bi = np.where((off < reach) & (lane0 + off * K <= e_first), np.minimum(bi, bo), bi)
    fe, be = _shfl_up(fi, 1), _shfl_down(bi, 1)
    c = np.where(head[..., 0] | (wl == 0), _INF, fe)
    for k in range(K):
        c = np.where(head[..., k], _INF, c)
        P[..., k] = np.minimum(P[..., k], c)
    c = np.where((pl[..., K + 2] == 0) | (wl == 31), _INF, be)
    for k in range(K - 1, -1, -1):
        S[..., k] = np.minimum(S[..., k], c)
        c = np.where(head[..., k], _INF, c)
    # the S row behind its guard of BIG (window starts left of lane 0)
    G = W + 4
    rows = np.full((n, G + L), np.nan, np.float32)
    rows[:, :G] = _KBIG
    rows[:, G:] = S.reshape(n, L)
    fwd, plast = P[:, 31::32, K - 1], P[:, 31::32, K - 2]
    bwd = bi[:, 0::32]
    bown = _shfl_idx(bi, np.zeros((n, T), np.int64))
    px = np.empty((n, T, K + 1), np.float32)
    px[..., 0] = _shfl_up(P[..., K - 2], 1)
    px[..., 1] = _shfl_up(P[..., K - 1], 1)
    px[..., 2:] = P[..., :K - 1]
    # --- the barrier: everything below reads only what is above ---
    i = np.arange(K + 1)
    x = lane0[..., None] - 2 + i
    yb = lane0 - 1 - R
    y = yb[..., None] + i
    take = (x < pe[..., None]) & ((i >= 2) | (wl > 0)[..., None])
    prev = np.broadcast_to(np.maximum(warp - 1, 0), (n, T))
    plast_prev = np.take_along_axis(plast, prev, axis=1)

    def read(yy):
        return np.take_along_axis(rows, (G + yy).reshape(n, -1), axis=1).reshape(yy.shape)

    # R <= W: the previous warp's slot, and the own warp's first-lane S
    # where y's segment reaches into the own warp
    cw = np.where(warp > 0, np.take_along_axis(fwd, prev, axis=1), _INF)
    pxn = px.copy()
    pxn[..., 0] = np.where(wl == 0, np.where(warp > 0, plast_prev, _INF), px[..., 0])
    pxn[..., 1] = np.where(wl == 0, cw, px[..., 1])
    s = read(y)
    s = np.where((y >= sw[..., None]) & (y < wlane0[..., None]), np.minimum(s, bown[..., None]), s)
    near = np.minimum(s, np.where(take, np.minimum(pxn, cw[..., None]), pxn))

    # any R (wide_carries): lane l of a warp stands for warp l; Fw (P at
    # its last lane) and Bw (S at its first) by segmented scans over the
    # warps' slots, as the lanes were scanned over the threads
    def lanes_of(v, src):  # __shfl_sync of a (n, 32) warp value from lane src (n, T)
        return np.take_along_axis(v, np.broadcast_to(src, (n, T)), axis=1)

    lw = np.arange(32)[None, :]
    live = lw < nwarps
    F = np.where(live, np.pad(fwd, ((0, 0), (0, 32 - nwarps))), _INF)
    Bv = np.where(live, np.pad(bwd, ((0, 0), (0, 32 - nwarps))), _INF)
    fl = lw * W
    ll = fl + W - 1
    sl = div(ll) * R
    el = div(fl) * R + R - 1
    for off in (1, 2, 4, 8, 16):
        fo, bo = _shfl_up(F, off), _shfl_down(Bv, off)
        F = np.where(ll - off * W >= sl, np.minimum(F, fo), F)
        Bv = np.where(fl + off * W <= el, np.minimum(Bv, bo), Bv)
    wlo = np.maximum(yb, 0) >> lgW
    fcw = np.where(warp > 0, lanes_of(F, np.maximum(warp - 1, 0)), _INF)
    pw2 = np.where(pl_m2 > W - 2, lanes_of(F, np.maximum(warp - 2, 0)), _INF)
    bA = lanes_of(Bv, np.minimum(wlo + 1, 31))
    bB = lanes_of(Bv, np.minimum(wlo + 2, 31))
    pxf = px.copy()
    pxf[..., 0] = np.where(wl == 0, np.where(warp > 0, np.minimum(plast_prev, pw2), _INF),
                           px[..., 0])
    pxf[..., 1] = np.where(wl == 0, fcw, px[..., 1])
    # y's segment (ending at x - the place of lane x+1) reaches past y's warp
    wy = np.maximum(y, 0) >> lgW
    need = (y >= 0) & (x - pl[..., 1:K + 2] >= (wy + 1) * W)
    s = read(np.maximum(y, -1))
    s = np.where(need, np.minimum(s, np.where(wy == wlo[..., None], bA[..., None],
                                              bB[..., None])), s)
    far = np.minimum(s, np.where(take, np.minimum(pxf, fcw[..., None]), pxf))
    return np.where((R <= W)[..., None], near, far), rows


@functools.lru_cache(maxsize=None)
def _jax_windowed_min(M: int):
    return jax.jit(jax.vmap(lambda w, r: _windowed_min(w, r, M)))


@pytest.mark.parametrize("pattern", ["random", "heads", "ends"])
@pytest.mark.parametrize("K", [4, 8, 16])
@pytest.mark.parametrize("M", [8, 132, 1536])
def test_one_barrier_window_algebra_matches_windowed_min(M, K, pattern):
    """The model of the forbid kernel's one-barrier windows against the
    JAX package's _windowed_min for every R in 1..M+2 (R > M clips to
    M), with lanes past M holding garbage: every window a real lane
    reads, the one of lane lane0-1 (prefix) and of lane0-2 (the
    thread's iprev0).  The data: few distinct values (ties), or each
    segment's minimum at its head (what P's carries bring in) or at its
    last lane (S's carries)."""
    rng = np.random.default_rng(M * 100 + K)
    T = (-(-M // K) + 31) // 32 * 32
    L = T * K
    budget = np.arange(1, M + 3)
    place = np.arange(L)[None, :] % np.minimum(budget, M)[:, None]
    cand = {"random": rng.integers(-40, 40, (len(budget), L)),
            "heads": place,
            "ends": np.minimum(budget, M)[:, None] - 1 - place}[pattern].astype(np.float32)
    cand[:, M:] = rng.standard_normal((len(budget), L - M)).astype(np.float32) * -1e3
    win, rows = _one_barrier_windows(cand, budget, M, K)
    assert not np.isnan(rows).any()
    want = np.concatenate([
        np.asarray(_jax_windowed_min(M)(jnp.asarray(cand[i:i + 256, :M]),
                                        jnp.asarray(budget[i:i + 256])))
        for i in range(0, len(budget), 256)])
    assert want.dtype == np.float32
    real = np.arange(1, M)
    # prefix[k] of lane x = lane0 + k is the window ending at x - 1
    np.testing.assert_array_equal(win[:, real // K, real % K + 1], want[:, real - 1])
    t = np.arange(1, T)
    t = t[t * K < M]
    np.testing.assert_array_equal(win[:, t, 0], want[:, t * K - 2])


def test_one_barrier_magic_division_is_exact():
    """n / R = __umulhi(n, ceil(2^32 / R)) for every R in 2..16384 at
    every n < 2^16 where the quotient steps (n = qR - 1 and qR), the
    only places an over-estimate can show."""
    for R in range(2, 16385):
        rdiv = np.uint64((0xFFFFFFFF + R) // R)
        n = np.concatenate([np.arange(R - 1, 1 << 16, R), np.arange(R, 1 << 16, R)])
        got = (n.astype(np.uint64) * rdiv) >> np.uint64(32)
        np.testing.assert_array_equal(got.astype(np.int64), n // R)


@pytest.mark.parametrize("K", [4, 8, 16])
def test_window_starts_stay_inside_the_s_row_guard(K):
    """Where R <= 32 K the kernel reads each window's start unclamped, so
    every start left of lane 0 must land in the S row's guard of 32 K + 4
    floats in front of it; wider windows clamp their starts to -1."""
    W = 32 * K
    for M in (8, 132, 1536, 16384):
        T = (-(-M // K) + 31) // 32 * 32
        lane0 = np.arange(T)[:, None] * K
        R = np.arange(1, min(W, M) + 1)[None, :]
        starts = lane0 - 1 - R  # the thread's first window start, the lowest
        assert starts.min() >= -(W + 4)
        assert (starts + K < T * K).all()  # and the last stays inside the row
