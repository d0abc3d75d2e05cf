"""Parity of the port's bin-top-2 scan with the Pallas kernels.

The JAX side runs the Pallas kernels in interpret mode on the CPU, as
tests/test_pallas_scan.py does; the port runs its plain PyTorch version on
CPU tensors. Bin minima are compared at rtol = atol = 1e-4: both sum
|q|^2 + |x|^2 - 2 q.x in f32, in different orders. Ids are compared through
the exact distance of the row they name, because near-ties may resolve
either way. Tests that need the CUDA kernel are marked ``gpu``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpann_tpu.search import pallas_scan as jps
from gpann_tpu_torch.search import bin_scan as tbs

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda:0")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(555)
    base = rng.standard_normal((15900, 32)).astype(np.float32)
    qs = rng.standard_normal((256, 32)).astype(np.float32)
    return qs, base


def _dist(qs, rows, metric):
    """Exact f32 distances of ``rows`` [m, c, d] to ``qs`` [m, d]."""
    if metric == "mips":
        return 1.0 - np.einsum("md,mcd->mc", qs, rows)
    return ((qs[:, None, :] - rows) ** 2).sum(-1)


def _check_ids(mins, ids, qs, base, row_base):
    """Every finite entry's id names a row at the reported distance (L2
    summaries via the |q|^2+|x|^2-2q.x form, like the kernels)."""
    fin = np.isfinite(mins)
    rows = base[np.clip(ids + row_base[:, None], 0, len(base) - 1)]
    d = ((qs * qs).sum(1)[:, None] + (rows * rows).sum(2)
         - 2.0 * np.einsum("md,mcd->mc", qs, rows))
    np.testing.assert_allclose(d[fin], mins[fin], **TOL)


@pytest.fixture(scope="module", params=["l2", "mips"])
def binmin_pair(request, data):
    metric = request.param
    qs, base = data
    padded, n_valid = jps.pad_base_for_scan(base, metric, tc=16384)
    jm, ja = jps.binmin_scan(jnp.asarray(qs), jnp.asarray(padded), n_valid,
                             metric, tq=128, tc=16384, interpret=True)
    tm, ta = tbs.binmin_scan(torch.from_numpy(qs), torch.from_numpy(base),
                             len(base), metric)
    return metric, (np.asarray(jm), np.asarray(ja)), (tm.numpy(), ta.numpy())


def test_binmin_scan_matches_pallas(binmin_pair, data):
    metric, (jm, ja), (tm, ta) = binmin_pair
    qs, base = data
    L, LJ = tm.shape[1] // 2, jm.shape[1] // 2
    assert L == -(-len(base) // tbs.BIN)          # no 16384-row padding
    assert ta.dtype == np.int32 and tm.dtype == np.float32
    for h in range(2):  # min1 and min2 halves, over the bins both have
        want, got = jm[:, h * LJ : h * LJ + L], tm[:, h * L : (h + 1) * L]
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], **TOL)
        # the Pallas padding bins past the base are all +inf
        assert np.isinf(jm[:, h * LJ + L : (h + 1) * LJ]).all()
    if metric == "l2":
        _check_ids(tm, ta, qs, base, np.zeros(len(qs), np.int64))
    else:
        fin = np.isfinite(tm)
        d = 1.0 - np.einsum("md,mcd->mc", qs, base[np.clip(ta, 0, len(base) - 1)])
        np.testing.assert_allclose(d[fin], tm[fin], **TOL)


@pytest.mark.parametrize("metric", ["l2", "mips"])
def test_fused_topk_matches_pallas(data, metric):
    qs, base = data
    padded, n_valid = jps.pad_base_for_scan(base, metric, tc=16384)
    jd, ji = jps.fused_topk(jnp.asarray(qs), jnp.asarray(padded), n_valid, 10,
                            metric=metric, interpret=True, tq=128, tc=16384)
    td, ti = tbs.fused_topk(torch.from_numpy(qs), torch.from_numpy(base),
                            len(base), 10, metric=metric)
    jd, ji, td, ti = np.asarray(jd), np.asarray(ji), td.numpy(), ti.numpy()
    assert ti.dtype == np.int32 and (ti < len(base)).all()
    np.testing.assert_allclose(td, jd, **TOL)
    np.testing.assert_allclose(_dist(qs, base[ti], metric), td, **TOL)
    # the same threshold recall against the exact top-10
    dm = _dist(qs, np.broadcast_to(base, (len(qs),) + base.shape), metric)
    kth = np.sort(dm, axis=1)[:, 9]
    thresh = kth[:, None] + 1e-5 + 1e-4 * np.abs(kth[:, None])
    assert (td <= thresh).sum() == (jd <= thresh).sum()


def test_fused_topk_phase2_and_nc(data):
    """phase2="approx" is exact top-k in the port; a wider candidate pool
    never loses a neighbour."""
    qs, base = data
    q, b = torch.from_numpy(qs), torch.from_numpy(base)
    d0, i0 = tbs.fused_topk(q, b, len(base), 10)
    d1, i1 = tbs.fused_topk(q, b, len(base), 10, phase2="approx")
    torch.testing.assert_close(d1, d0, rtol=0, atol=0)
    d2, _ = tbs.fused_topk(q, b, len(base), 10, num_candidate_bins=64)
    assert (d2 <= d0 + 1e-5).all()
    with pytest.raises(ValueError):
        tbs.fused_topk(q, b, len(base), 10, phase2="sorting")


def test_fused_topk_exhaustive_bins_is_exact(data):
    qs, base = data
    L = -(-len(base) // tbs.BIN)
    _, i = tbs.fused_topk(torch.from_numpy(qs), torch.from_numpy(base),
                          len(base), 1, num_candidate_bins=2 * L)
    dm = ((qs[:, None] - base[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(i.numpy()[:, 0], dm.argmin(1))


@pytest.fixture(scope="module")
def blocks_case():
    """3 probe blocks over a flat base of 3 windows: one full, one empty,
    one partial; windows visited out of order."""
    rng = np.random.default_rng(9)
    cap, qb, d = 16384, 128, 32
    base = rng.standard_normal((3 * cap, d)).astype(np.float32)
    qrows = rng.standard_normal((3 * qb, d)).astype(np.float32)
    row_off = np.array([2 * cap, 0, cap], np.int32)
    sizes = np.array([cap, 0, 5000], np.int32)
    return base, qrows, row_off, sizes, qb, cap


@pytest.mark.parametrize("metric", ["l2", "mips"])
def test_fused_topk_blocks_matches_pallas(blocks_case, metric):
    base, qrows, row_off, sizes, qb, cap = blocks_case
    jd, ji = jps.fused_topk_blocks(
        jnp.asarray(qrows), jnp.asarray(base), jnp.asarray(row_off),
        jnp.asarray(sizes), 10, metric, qb=qb, cap=cap, interpret=True, tq=128)
    td, ti = tbs.fused_topk_blocks(
        torch.from_numpy(qrows), torch.from_numpy(base),
        torch.from_numpy(row_off), torch.from_numpy(sizes), 10, metric,
        qb=qb, cap=cap)
    jd, td, ti = np.asarray(jd), td.numpy(), ti.numpy()
    np.testing.assert_array_equal(np.isfinite(td), np.isfinite(jd))
    assert np.isinf(td[qb : 2 * qb]).all()            # the empty block
    fin = np.isfinite(td)
    np.testing.assert_allclose(td[fin], jd[fin], **TOL)
    row_base = np.repeat(row_off.astype(np.int64), qb)
    assert (ti[fin.all(1)] < np.repeat(sizes, qb)[fin.all(1), None]).all()
    rows = base[np.clip(row_base[:, None] + ti, 0, len(base) - 1)]
    np.testing.assert_allclose(_dist(qrows, rows, metric)[fin], td[fin], **TOL)


def test_bintop2_blocks_summaries_match_pallas(blocks_case):
    """Phase 1 alone: the block summaries, bin by bin, against the Pallas
    kernel's (the JAX wrapper exposes no phase-1 entry, so this reuses its
    one-block form for each live window)."""
    base, qrows, row_off, sizes, qb, cap = blocks_case
    tm, ta = tbs.bintop2_blocks(torch.from_numpy(qrows), torch.from_numpy(base),
                                torch.from_numpy(row_off),
                                torch.from_numpy(sizes), qb, cap)
    tm, ta = tm.numpy(), ta.numpy()
    assert tm.shape == (3 * qb, 2 * cap // tbs.BIN)
    assert np.isinf(tm[qb : 2 * qb]).all() and (ta[qb : 2 * qb] == 0).all()
    for b in (0, 2):
        sl = slice(b * qb, (b + 1) * qb)
        window = base[row_off[b] : row_off[b] + cap]
        jm, _ = jps.binmin_scan(jnp.asarray(qrows[sl]), jnp.asarray(window),
                                int(sizes[b]), "l2", tq=128, tc=16384,
                                interpret=True)
        jm = np.asarray(jm)
        np.testing.assert_array_equal(np.isfinite(tm[sl]), np.isfinite(jm))
        fin = np.isfinite(jm)
        np.testing.assert_allclose(tm[sl][fin], jm[fin], **TOL)
    _check_ids(tm, ta, qrows, base, np.repeat(row_off.astype(np.int64), qb))


def test_wrappers_check_inputs(blocks_case):
    base, qrows, row_off, sizes, qb, cap = blocks_case
    q, b = torch.from_numpy(qrows), torch.from_numpy(base)
    with pytest.raises(ValueError):   # rows != nb * qb
        tbs.fused_topk_blocks(q[:-1], b, torch.from_numpy(row_off),
                              torch.from_numpy(sizes), 10, qb=qb, cap=cap)
    with pytest.raises(ValueError):   # cap not whole bins
        tbs.fused_topk_blocks(q, b, torch.from_numpy(row_off),
                              torch.from_numpy(sizes), 10, qb=qb, cap=cap - 1)
    with pytest.raises(ValueError):   # neither CPU nor CUDA
        tbs.binmin_scan(q.to("meta"), b.to("meta"), 10)


def test_scan_order_puts_rows_in_id_order():
    """Rows are laid out for the binned scan in ascending id order, whatever
    order their producer lists them in (a cover: the members, then the
    extra points cheapest first); rows already in id order stay put."""
    rng = np.random.default_rng(3)
    members = np.sort(rng.choice(10_000, 500, replace=False))
    extras = rng.choice(np.setdiff1d(np.arange(10_000), members), 100,
                        replace=False)
    shard = np.concatenate([members, extras])
    np.testing.assert_array_equal(shard[tbs.scan_order(shard)], np.sort(shard))
    np.testing.assert_array_equal(tbs.scan_order(members), np.arange(500))


# -- the CUDA kernel's arithmetic, rehearsed on the CPU --------------------------

SPLIT_TOL = dict(rtol=1e-4, atol=1e-3)   # the card's kernel-vs-plain tolerance


@pytest.fixture(scope="module", params=[96, 100])
def blob_case(request):
    """Data drawn like the bench's: 64 Gaussian blobs, centres 2*N(0,1),
    noise 0.6."""
    d = request.param
    rng = np.random.default_rng(555 + d)
    centers = 2.0 * rng.standard_normal((64, d)).astype(np.float32)
    base = (centers[rng.integers(0, 64, 4096)]
            + 0.6 * rng.standard_normal((4096, d))).astype(np.float32)
    qs = (centers[rng.integers(0, 64, 128)]
          + 0.6 * rng.standard_normal((128, d))).astype(np.float32)
    return qs, base


def _dist64(qs, base, metric):
    q, b = qs.astype(np.float64), base.astype(np.float64)
    if metric == "mips":
        return 1.0 - q @ b.T
    return (q * q).sum(1)[:, None] + (b * b).sum(1)[None, :] - 2.0 * q @ b.T


def _dist_split(qs, base, metric, rounding, passes):
    """Distances as the kernel forms them: f32 norms of the unsplit values,
    the product from ``split_tf32_dots``."""
    q, b = torch.from_numpy(qs), torch.from_numpy(base)
    dots = tbs.split_tf32_dots(q, b, rounding, passes)
    if metric == "mips":
        return (1.0 - dots).numpy()
    return ((q * q).sum(1)[:, None] + (b * b).sum(1)[None, :] - 2.0 * dots).numpy()


@pytest.mark.parametrize("rounding", ["nearest", "truncate"])
@pytest.mark.parametrize("metric", ["l2", "mips"])
def test_split_tf32_distances_hold_the_f32_tolerance(blob_case, metric, rounding):
    qs, base = blob_case
    hi, lo = tbs.split_tf32(torch.from_numpy(base), rounding)
    for part in (hi, lo):   # TF32 values: the low 13 bits are zero
        assert not (part.view(torch.int32) & 0x1FFF).any()
    # hi + lo keeps 21+ bits of x
    assert ((hi + lo).numpy() - base <= 2.0 ** -20 * np.abs(base)).all()
    got = _dist_split(qs, base, metric, rounding, passes=3)
    np.testing.assert_allclose(got, _dist64(qs, base, metric), **SPLIT_TOL)


@pytest.mark.parametrize("metric", ["l2", "mips"])
def test_single_tf32_pass_breaks_the_f32_tolerance(blob_case, metric):
    qs, base = blob_case
    want = _dist64(qs, base, metric)
    got = _dist_split(qs, base, metric, "nearest", passes=1)
    bad = np.abs(got - want) > SPLIT_TOL["atol"] + SPLIT_TOL["rtol"] * np.abs(want)
    assert bad.mean() > 0.01, bad.mean()


@pytest.mark.parametrize("metric", ["l2", "mips"])
def test_fused_topk_on_split_tf32_summaries(blob_case, metric):
    """Phase 1 in the kernel's arithmetic picks the candidates the f32
    phase 1 picks: after the exact rescore the top-10 is the same."""
    qs, base = blob_case
    q, b = torch.from_numpy(qs), torch.from_numpy(base)
    mins, ids = tbs.binmin_scan_plain(q, b, len(base), metric,
                                      dots_fn=tbs.split_tf32_dots)
    pm, _ = tbs.binmin_scan_plain(q, b, len(base), metric)
    torch.testing.assert_close(mins, pm, **SPLIT_TOL)
    sd, si = tbs._select_and_rescore(q, b, mins, ids, None, 10, 16, metric,
                                     "exact")
    fd, fi = tbs.fused_topk(q, b, len(base), 10, metric=metric)
    torch.testing.assert_close(sd, fd, rtol=0, atol=0)
    assert torch.equal(si, fi)
    with pytest.raises(ValueError):
        tbs.split_tf32(b, "stochastic")


# -- the CUDA kernel (skips without a GPU) --------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["l2", "mips"])
def test_kernel_matches_plain_on_gpu(cuda_device, blocks_case, data, metric):
    from gpann_tpu_torch import kernels

    qs, base = data
    q, b = torch.from_numpy(qs).to(cuda_device), torch.from_numpy(base).to(cuda_device)
    before = dict(kernels.LAUNCHES)
    km, ka = tbs.binmin_scan(q, b, 15000, metric)
    pm, _ = tbs.binmin_scan_plain(q, b, 15000, metric)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["binmin_scan"] == before["binmin_scan"] + 1
    fin = torch.isfinite(pm)
    assert torch.equal(fin, torch.isfinite(km))
    torch.testing.assert_close(km[fin], pm[fin], **TOL)
    assert (ka[fin] < 15000).all()
    km2, ka2 = tbs.binmin_scan(q, b, 15000, metric)   # bit-repeatable
    assert torch.equal(km, km2) and torch.equal(ka, ka2)

    fb, qrows, row_off, sizes, qb, cap = blocks_case
    args = (torch.from_numpy(qrows).to(cuda_device),
            torch.from_numpy(fb).to(cuda_device),
            torch.from_numpy(row_off).to(cuda_device),
            torch.from_numpy(sizes).to(cuda_device), qb, cap, metric)
    km, ka = tbs.bintop2_blocks(*args)
    pm, _ = tbs.bintop2_blocks_plain(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["bintop2_blocks"] == before["bintop2_blocks"] + 1
    fin = torch.isfinite(pm)
    assert torch.equal(fin, torch.isfinite(km))
    torch.testing.assert_close(km[fin], pm[fin], **TOL)
    assert (ka[qb : 2 * qb] == 0).all()


RAGGED = {
    # name: (nb, qb, cap, d, sizes, row_off, base rows, metric)
    "d100_qb96_empty_block": (3, 96, 1280, 100, [1280, 0, 77], [1280, 0, 2000],
                              2560, "l2"),
    "d17_qb8_padded_copy": (3, 8, 1280, 17, [1280, 5, 1279], [0, 640, 1000],
                            2280, "mips"),
    "size_eq_cap_window_at_base_end": (3, 300, 2560, 96, [2560, 1300, 1000],
                                       [140, 0, 1700], 2700, "l2"),
    "d200_streamed_query_tile": (2, 130, 1280, 200, [1280, 700], [0, 1280],
                                 2560, "l2"),
    "more_blocks_than_2x_sms": (301, 16, 640, 24, None, None, 5640, "l2"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(RAGGED))
def test_kernel_ragged_shapes_on_gpu(cuda_device, name):
    """Shapes the kernel's tiling can get wrong, against the plain version;
    two launches give bit-equal summaries."""
    nb, qb, cap, d, sizes, row_off, rows, metric = RAGGED[name]
    rng = np.random.default_rng(7)
    if sizes is None:
        sizes = rng.integers(0, cap + 1, nb).tolist()
        row_off = rng.integers(0, rows - cap, nb).tolist()
    base = torch.from_numpy(
        2 * rng.standard_normal((rows, d)).astype(np.float32)).to(cuda_device)
    q = torch.from_numpy(
        2 * rng.standard_normal((nb * qb, d)).astype(np.float32)).to(cuda_device)
    ro = torch.tensor(row_off, dtype=torch.int64, device=cuda_device)
    sz = torch.tensor(sizes, dtype=torch.int32, device=cuda_device)
    km, ka = tbs.bintop2_blocks(q, base, ro, sz, qb, cap, metric)
    km2, ka2 = tbs.bintop2_blocks(q, base, ro, sz, qb, cap, metric)
    torch.cuda.synchronize()
    assert torch.equal(km, km2) and torch.equal(ka, ka2)
    # a window's cap may run past the base; those rows are dead
    padded = torch.cat([base, base.new_zeros((cap, d))])
    pm, _ = tbs.bintop2_blocks_plain(q, padded, ro, sz, qb, cap, metric)
    fin = torch.isfinite(pm)
    assert torch.equal(fin, torch.isfinite(km))
    torch.testing.assert_close(km[fin], pm[fin], **SPLIT_TOL)
    assert (ka < sz.repeat_interleave(qb)[:, None])[fin].all()
    if metric == "l2":
        _check_ids(km.cpu().numpy(), ka.cpu().numpy(), q.cpu().numpy(),
                   padded.cpu().numpy(),
                   np.repeat(np.asarray(row_off, np.int64), qb))


@pytest.mark.gpu
def test_kernel_ties_report_lowest_ids_on_gpu(cuda_device):
    rng = np.random.default_rng(3)
    base = torch.from_numpy(rng.standard_normal((256, 96)).astype(np.float32))
    base[7] = base[3]
    base[100] = base[3]
    base[200] = base[130]
    base = base.to(cuda_device)
    q = base[[3, 130]].repeat(64, 1).contiguous()
    for metric in ("l2", "mips"):
        m, a = tbs.binmin_scan(q, base, 256, metric)
        assert a[0].tolist()[0::2] == [3, 7] and a[1].tolist()[1::2] == [130, 200]
        assert m[0, 0] == m[0, 2] and m[1, 1] == m[1, 3]


@pytest.mark.gpu
def test_kernel_rejects_bad_inputs(cuda_device):
    from gpann_tpu_torch import kernels

    q = torch.zeros((128, 8), device=cuda_device)
    b = torch.zeros((256, 8), device=cuda_device)
    off = torch.zeros(1, dtype=torch.int64, device=cuda_device)
    size = torch.full((1,), 256, dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        kernels.bintop2(q.double(), b, off, size, 128, 256, "l2", "binmin_scan")
    with pytest.raises(ValueError):
        kernels.bintop2(q, b.t(), off, size, 128, 256, "l2", "binmin_scan")
    with pytest.raises(ValueError):
        kernels.bintop2(q, b, off, size, 128, 200, "l2", "binmin_scan")
    with pytest.raises(ValueError):   # query rows != nb * qb
        kernels.bintop2(q, b, off, size, 64, 256, "l2", "binmin_scan")
    with pytest.raises(ValueError):   # TMA row coordinates are int32
        kernels.bintop2(q, b, off, size, 128, 2**31 - 128, "l2", "binmin_scan")
    with pytest.raises(ValueError):
        kernels.bintop2(q, b, off, size, 128, 256, "cosine", "binmin_scan")
    with pytest.raises(ValueError):   # CPU tensors never reach the kernel
        kernels.bintop2(q.cpu(), b.cpu(), off.cpu(), size.cpu(), 128, 256,
                        "l2", "binmin_scan")
    before = dict(kernels.LAUNCHES)
    # more probe blocks than the old grid's 65535, and a d that needs padding
    nb = 70_000
    mins, ids = kernels.bintop2(
        torch.ones((nb, 3), device=cuda_device), torch.ones((256, 3), device=cuda_device),
        torch.zeros(nb, dtype=torch.int64, device=cuda_device),
        torch.full((nb,), 129, dtype=torch.int32, device=cuda_device), 1, 256,
        "l2", "binmin_scan")
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["binmin_scan"] == before["binmin_scan"] + 1
    assert (mins[:, :2] == 0).all() and torch.isinf(mins[:, 3]).all()
    assert (ids[:, 0] == 0).all() and (ids[:, 2] == 1).all() and (ids[:, 1] == 128).all()
