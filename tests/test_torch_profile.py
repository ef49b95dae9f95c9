"""The port's profile DP and chain traceback against the JAX package.

The plain PyTorch DP keeps every f32 operation of the Pallas kernel in
the kernel's order, so the backpointer plane, the end cell and the raw
score are compared exactly (raw bit for bit).  The JAX side runs the
Pallas kernel in interpret mode on the CPU.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sina_tpu.ops.align_kernel import DpParams as JaxDpParams
from sina_tpu.ops.profile import (
    _device_unpack_fgq,
    _profile_batched_fn,
    _profile_pallas_fn,
    _unpack_log_result,
    _unpack_result,
)
from sina_tpu.ops.profile_pallas import chain_dp_pallas_fused
from sina_tpu_torch.ops import profile_kernel as pk
from sina_tpu_torch.ops.align_kernel import DpParams
from sina_tpu_torch.ops.profile import (
    _pack_fgq,
    profile_dp_dispatch,
    profile_dp_fetch,
)

PARAMS = {
    "default": dict(match=-2.0, mismatch=1.0, gap_open=5.0, gap_ext=2.0),
    # constants that f32 cannot hold: each must round from its double
    # as the Pallas kernel's static floats do
    "inexact": dict(match=-2.3, mismatch=1.1, gap_open=5.3, gap_ext=2.1),
}

# A, G, C, U and the ambiguity codes R (A|G), Y (C|U), N
_CODES = np.array([1, 2, 4, 8, 3, 12, 15], np.uint8)


def _case(seed: int, B: int = 7, C: int = 56, M: int = 64, params=None):
    """Quantised profiles with a dominant base per column and sparsely
    occupied insertion columns; queries evolved from the consensus
    (substitutions, deletions, insertions, ambiguity codes).  Rows
    have qlen < M and c_real < C; the last two rows are padding rows
    with lens (1, 1)."""
    rng = np.random.default_rng(seed)
    p = DpParams(**(params or PARAMS["default"]))
    cons = rng.integers(0, 4, (B, C))
    sparse = rng.random((B, C)) < 0.25
    freqs = (rng.random((B, C, 4)) * 0.1).astype(np.float32)
    np.put_along_axis(freqs, cons[..., None], 0.85, axis=2)
    freqs *= np.where(sparse, 0.05, rng.uniform(0.6, 1.0, (B, C)))[..., None].astype(np.float32)
    gapcost = (rng.random((B, C)) * 0.5).astype(np.float32)
    fgq = _pack_fgq(freqs, gapcost, p)
    qmask = np.zeros((B, M), np.uint8)
    qlen = np.ones(B, np.int32)
    cr = np.ones(B, np.int32)
    for b in range(B - 2):
        cr[b] = C - rng.integers(0, C // 4)
        keep = rng.random(cr[b]) < np.where(sparse[b, : cr[b]], 0.1, 0.95)
        base = np.where(rng.random(cr[b]) < 0.15,
                        rng.integers(0, 4, cr[b]), cons[b, : cr[b]])[keep]
        base = np.insert(base, np.nonzero(rng.random(len(base)) < 0.04)[0], 0)
        m = (1 << base).astype(np.uint8)
        amb = rng.random(len(m)) < 0.05
        m[amb] = _CODES[rng.integers(0, len(_CODES), int(amb.sum()))]
        m = m[: M - 3]
        qmask[b, : len(m)] = m
        qlen[b] = len(m)
    lens = np.stack([qlen, cr], axis=1).astype(np.int32)
    return p, fgq, qmask, lens


def _jax_params(p: DpParams) -> JaxDpParams:
    return JaxDpParams(p.match, p.mismatch, p.gap_open, p.gap_ext)


def _port_dp(p, fgq, qmask, lens, fam_idx=None):
    t = torch.from_numpy
    return pk.profile_dp(t(fgq), t(qmask), t(lens), p,
                         None if fam_idx is None else t(fam_idx))


@pytest.mark.parametrize("dedup", [False, True])
@pytest.mark.parametrize("pname", sorted(PARAMS))
def test_plain_dp_matches_pallas_interpret(pname, dedup):
    p, fgq, qmask, lens = _case(3, params=PARAMS[pname])
    B, C, M = qmask.shape[0], fgq.shape[1], qmask.shape[1]
    fam_idx = None
    if dedup:
        fam_idx = np.array([2, 0, 2, 1, 0, 1, 0], np.int32)[:B]
        fgq = fgq[:3].copy()
    fq, gc = _device_unpack_fgq(jnp.asarray(fgq), _jax_params(p))
    if dedup:
        fq, gc = fq[fam_idx], gc[fam_idx]
    want = chain_dp_pallas_fused(
        fq, gc, jnp.asarray(qmask), jnp.asarray(lens[:, 0]),
        jnp.asarray(lens[:, 1]), p.gap_open, p.gap_ext, p.match,
        p.mismatch, C, M, interpret=True,
    )
    got = _port_dp(p, fgq, qmask, lens, fam_idx)
    bp, bc, bi, raw = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(got[0].numpy(), bp)
    np.testing.assert_array_equal(got[1].numpy(), bc)
    np.testing.assert_array_equal(got[2].numpy(), bi)
    np.testing.assert_array_equal(got[3].numpy().view(np.int32), raw.view(np.int32))
    if not dedup:
        # the case is not degenerate: a query against the profile it
        # was evolved from aligns most of its bases
        emit = pk.chain_traceback(*got[:3]).numpy()
        real = lens[:, 1] > 1
        assert ((emit[real] >= 0).sum(axis=1) > 0.8 * lens[real, 0]).all()


@pytest.mark.parametrize("dedup", [False, True])
def test_plain_traceback_matches_pallas_log(dedup):
    p, fgq, qmask, lens = _case(5, B=8, C=72, M=80)
    C, M = fgq.shape[1], qmask.shape[1]
    fam_idx = np.array([3, 1, 0, 2, 1, 3, 0, 0], np.int32) if dedup else None
    if dedup:
        fgq = fgq[:4].copy()
    fn = _profile_pallas_fn(C, M, _jax_params(p), dedup=dedup)
    args = [jnp.asarray(a) for a in (fgq, qmask, lens)]
    if dedup:
        args.append(jnp.asarray(fam_idx))
    e_ref, c_ref, i_ref, r_ref = _unpack_log_result(np.asarray(fn(*args)), M)
    bp, bc, bi, raw = _port_dp(p, fgq, qmask, lens, fam_idx)
    emit = pk.chain_traceback(bp, bc, bi).numpy()
    np.testing.assert_array_equal(emit, e_ref)
    np.testing.assert_array_equal(bc.numpy(), c_ref)
    np.testing.assert_array_equal(bi.numpy(), i_ref)
    np.testing.assert_array_equal(raw.numpy().view(np.int32), r_ref.view(np.int32))


def test_against_xla_path_reports_ins_opened_rows():
    """The XLA chain_dp (what the JAX package runs on the CPU) also
    marks an insertion open where `Irow + 1e-4 < Iprev + ge`; the port
    follows the Pallas kernel.  The DP values and end cells agree
    exactly either way; rows whose traceback differs are reported."""
    p, fgq, qmask, lens = _case(11, B=8, C=72, M=80)
    C, M = fgq.shape[1], qmask.shape[1]
    fn = _profile_batched_fn(C, M, _jax_params(p))
    e_x, c_x, i_x, r_x = _unpack_result(
        np.asarray(fn(*(jnp.asarray(a) for a in (fgq, qmask, lens))))
    )
    bp, bc, bi, raw = _port_dp(p, fgq, qmask, lens)
    emit = pk.chain_traceback(bp, bc, bi).numpy()
    np.testing.assert_array_equal(bc.numpy(), c_x)
    np.testing.assert_array_equal(bi.numpy(), i_x)
    np.testing.assert_array_equal(raw.numpy().view(np.int32), r_x.view(np.int32))
    rows = [b for b in range(len(emit)) if not np.array_equal(emit[b], e_x[b])]
    if rows:
        warnings.warn(f"emit differs from the XLA path (ins_opened) in rows {rows}")


@pytest.mark.parametrize("dedup", [False, True])
def test_dispatch_pads_rows_and_fetches(dedup):
    """profile_dp_dispatch pads the batch to its row bucket (rows of
    lens (1, 1); dedup padding gathers unique row 0); the fetched
    result equals the unpadded Pallas-path result."""
    p, fgq, qmask, lens = _case(13, B=5, C=40, M=48)
    C, M = fgq.shape[1], qmask.shape[1]
    fam_idx = np.array([1, 0, 1, 1, 0], np.int32) if dedup else None
    if dedup:
        fgq = fgq[:2].copy()
    fn = _profile_pallas_fn(C, M, _jax_params(p), dedup=dedup)
    args = [jnp.asarray(a) for a in (fgq, qmask, lens)]
    if dedup:
        args.append(jnp.asarray(fam_idx))
    want = _unpack_log_result(np.asarray(fn(*args)), M)
    handle = profile_dp_dispatch(
        fgq, qmask, lens[:, 0], lens[:, 1], p, torch.device("cpu"),
        fam_idx=fam_idx,
    )
    assert handle[0].shape == (16, M + 3)
    got = profile_dp_fetch(handle)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a).view(np.int32), np.asarray(b).view(np.int32))


# -- the per-family API (sina_tpu/ops/profile.py Profile, build_profile,
# query_profile_weights), on the cases of tests/test_profile.py:24-62 and
# tests/test_profile_batch_build.py


def _both(name: str, aligned: str):
    from sina_tpu.sequence import Sequence as JaxSequence
    from sina_tpu_torch.sequence import Sequence as PortSequence

    return JaxSequence.from_string(name, aligned), PortSequence.from_string(name, aligned)


def _profiles_equal(got, want):
    np.testing.assert_array_equal(got.cols, want.cols)
    for a, b in ((got.freqs, want.freqs), (got.gap_open, want.gap_open),
                 (got.gap_ext, want.gap_ext)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    assert got.width == want.width and got.n_cols == want.n_cols


def test_build_profile_semantics():
    from sina_tpu.ops.profile import build_profile as jax_build_profile
    from sina_tpu_torch.ops.profile import build_profile

    ja, a = _both("a", "AG-CU")
    jb, b = _both("b", "AGGC-")
    p = build_profile([a, b])
    _profiles_equal(p, jax_build_profile([ja, jb]))
    assert p.cols.tolist() == [0, 1, 2, 3, 4]
    assert p.freqs[0, 0] == pytest.approx(1.0)
    total2 = 12 + 12  # one G + one gap-open
    assert p.freqs[2, 1] == pytest.approx(12 / total2)
    assert p.gap_open[2] == pytest.approx(12 / total2)
    assert p.gap_open[4] > 0
    with pytest.raises(ValueError):
        build_profile([a, _both("c", "AG")[1]])


@pytest.mark.parametrize("bases", ["AR", "ACGUNRYKMSWBDHV"])
def test_query_profile_weights_ambig(bases):
    from sina_tpu.ops.profile import query_profile_weights as jax_weights
    from sina_tpu_torch.ops.profile import query_profile_weights

    jq, q = _both("q", bases)
    w = query_profile_weights(q.masks)
    np.testing.assert_array_equal(w, jax_weights(jq.masks))
    assert w[0].tolist() == [1, 0, 0, 0]
    if bases == "AR":
        assert w[1, 0] == pytest.approx(0.5) and w[1, 1] == pytest.approx(0.5)


def _families(seed: int, n_fams: int):
    """The JAX package's and the port's references from the same seed,
    and random families of 3-11 of their sequences."""
    from sina_tpu import testing as jax_testing
    from sina_tpu_torch import testing as port_testing

    jdb = jax_testing.make_reference(n_seqs=60, n_core=250, width=400, seed=seed)
    db = port_testing.make_reference(n_seqs=60, n_core=250, width=400, seed=seed)
    rng = np.random.default_rng(0)
    fams = []
    for _ in range(n_fams):
        ids = rng.choice(len(db), size=rng.integers(3, 12), replace=False)
        fams.append(ids)
    return ([[jdb.sequences[int(i)] for i in f] for f in fams],
            [[db.sequences[int(i)] for i in f] for f in fams])


def test_batched_build_matches_single():
    """tests/test_profile_batch_build.py on the port: the batched build
    equals the per-family one, which equals the JAX package's."""
    from sina_tpu.ops.profile import build_profile as jax_build_profile
    from sina_tpu_torch.ops.profile import build_profile, build_profiles_batch

    jfams, fams = _families(2, 5)
    cpad = max(build_profile(f).n_cols for f in fams)
    cpad = -(-cpad // 64) * 64
    freqs, gapo, gape, cols = build_profiles_batch(fams, cpad)
    for b, (jfam, fam) in enumerate(zip(jfams, fams)):
        p = build_profile(fam)
        _profiles_equal(p, jax_build_profile(jfam))
        C = p.n_cols
        assert np.array_equal(cols[b], p.cols)
        np.testing.assert_allclose(freqs[b, :C], p.freqs, atol=1e-6)
        np.testing.assert_allclose(gapo[b, :C], p.gap_open, atol=1e-6)
        np.testing.assert_allclose(gape[b, :C], p.gap_ext, atol=1e-6)
        assert (freqs[b, C:] == 0).all()


def test_profile_alignment_realistic():
    """tests/test_profile.py test_profile_alignment_realistic on the
    port (profile engine, realign, the plain versions): each query's
    bases come back in the reference's width, within the reference's
    identity bar, and the aligned row equals the JAX package's."""
    from sina_tpu import testing as jax_testing
    from sina_tpu.align import AlignerConfig as JaxConfig
    from sina_tpu.align import align_sequence as jax_align
    from sina_tpu_torch import testing as port_testing
    from sina_tpu_torch.align import AlignerConfig, align_sequence
    from sina_tpu_torch.comparator import COVER_QUERY, IUPAC_EXACT, Comparator

    jdb = jax_testing.make_reference(n_seqs=60, n_core=300, width=500, seed=9)
    db = port_testing.make_reference(n_seqs=60, n_core=300, width=500, seed=9)
    jqs = jax_testing.make_queries(jdb, n=4, seed=2, branch_len=0.4)
    qs = port_testing.make_queries(db, n=4, seed=2, branch_len=0.4)
    cmp_exact = Comparator(IUPAC_EXACT, "none", COVER_QUERY, False)
    for jtrue, true_q in zip(jqs, qs):
        pid = db.index_of(true_q.get_attr("parent"))
        fam = [(1.0, db.sequences[(pid + k) % len(db)]) for k in range(12)]
        jfam = [(1.0, jdb.sequences[(pid + k) % len(jdb)]) for k in range(12)]
        out = align_sequence(port_testing.unaligned_copy(true_q), fam,
                             AlignerConfig(realign=True, engine="profile"), device="cpu")
        want = jax_align(jax_testing.unaligned_copy(jtrue), jfam,
                         JaxConfig(realign=True, engine="profile"))
        assert out is not None
        assert out.get_bases().upper() == true_q.get_bases().upper()
        assert cmp_exact(true_q, out) > 0.85
        assert out.get_aligned() == want.get_aligned()
