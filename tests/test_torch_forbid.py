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

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sina_tpu.align import AlignerConfig as JaxAlignerConfig
from sina_tpu.align import align_sequence as jax_align_sequence
from sina_tpu.ops import profile as jax_profile
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
