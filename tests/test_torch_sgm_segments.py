"""The SGM segments of the multi-device and batched paths against
kangaroo_tpu: ``stereo.sgm.sgm_aggregate_block`` (a vertical row segment
with a carry), ``sgm_aggregate_diag_block`` (a diagonal one),
``sgm_aggregate_scan`` at a lane offset, and ``semi_global_matching``'s
seam period, each against the Pallas kernels in interpret mode and the
lax.scan carry twins.

The port's plain versions repeat the Pallas kernels' float32 operations in
the same order, so the segments are held exactly (0), carries included.
The JAX package scans an upward segment forward over row-reversed inputs;
the port scans it upward (``reverse``), so those cases flip the JAX
side's rows. The lax.scan twins keep the carry's prev as (N, D), the port
as (D, N).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from kangaroo_tpu.stereo import sgm as jsgm
from kangaroo_tpu.stereo import sgm_pallas as sp
from kangaroo_tpu_torch.stereo import dispatch, sgm_cuda
from kangaroo_tpu_torch.stereo import sgm as tsgm

D, H, W = 8, 32, 128
P1, P2 = 0.01, 0.02


@pytest.fixture(scope="module")
def interpret():
    with pltpu.force_tpu_interpret_mode():
        yield


def _inputs(seed, shape=(D, H, W)):
    rng = np.random.default_rng(seed)
    return (rng.random(shape).astype(np.float32),
            rng.random((shape[1], shape[2])).astype(np.float32))


def _t(*arrays):
    """Tensors holding copies of the arrays (acc is updated in place)."""
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _np(*tensors):
    return [np.asarray(t) for t in tensors]


def _zero_carry(n=W, d=D):
    """The seed carry of a diagonal segment: prev 1e30, best, has, last 0."""
    return (np.full((d, n), 1e30, np.float32), np.zeros(n, np.float32),
            np.zeros(n, np.float32), np.zeros(n, np.float32))


@pytest.fixture(scope="module")
def pallas_blocks(interpret):
    """The JAX package's segments, once per case: two chained straight
    segments (downward, and upward over reversed rows) per mask mode."""
    vol, img = _inputs(0)
    out = {}
    for mode in ("left", "right"):
        for rev in (False, True):
            v, i = (vol[:, ::-1], img[::-1]) if rev else (vol, img)
            top = sp.sgm_aggregate_block(jnp.asarray(v[:, :16]), jnp.asarray(i[:16]), P1, P2,
                                         mode, width=W)
            bot = sp.sgm_aggregate_block(jnp.asarray(v[:, 16:]), jnp.asarray(i[16:]), P1, P2,
                                         mode, width=W, seed=False, carry_prev=top[1],
                                         carry_best=top[2], last_img=top[3])
            out[mode, rev] = (_np(*top), _np(*bot))
    return vol, img, out


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("mode", ["left", "right"])
def test_block_matches_pallas(pallas_blocks, mode, reverse):
    """Two carry-chained segments, their carries and last rows, equal to
    the Pallas segment kernel's."""
    vol, img, out = pallas_blocks
    (jtop, jbot) = out[mode, reverse]
    tv, ti = _t(vol, img)
    top_rows, bot_rows = (slice(16, None), slice(None, 16)) if reverse else (slice(None, 16),
                                                                             slice(16, None))
    top = tsgm.sgm_aggregate_block(tv[:, top_rows], ti[top_rows], P1, P2, mode, width=W,
                                   reverse=reverse)
    bot = tsgm.sgm_aggregate_block(tv[:, bot_rows], ti[bot_rows], P1, P2, mode, width=W,
                                   seed=False, carry_prev=top[1], carry_best=top[2],
                                   last_img=top[3], reverse=reverse)
    flip = (lambda a: a[:, ::-1]) if reverse else (lambda a: a)
    for got, want in ((top, jtop), (bot, jbot)):
        np.testing.assert_array_equal(flip(got[0].numpy()), want[0])
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("mode", ["left", "right"])
def test_chained_segments_equal_one_pass(mode):
    vol, img = _inputs(1)
    tv, ti = _t(vol, img)
    whole, wp, wb, wl = tsgm.sgm_aggregate_block(tv, ti, P1, P2, mode, width=W)
    top = tsgm.sgm_aggregate_block(tv[:, :12], ti[:12], P1, P2, mode, width=W)
    bot = tsgm.sgm_aggregate_block(tv[:, 12:], ti[12:], P1, P2, mode, width=W, seed=False,
                                   carry_prev=top[1], carry_best=top[2], last_img=top[3])
    np.testing.assert_array_equal(torch.cat([top[0], bot[0]], 1).numpy(), whole.numpy())
    for g, w in zip(bot[1:], (wp, wb, wl)):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_block_matches_scan_carry_twin():
    """The segment against sgm._scan_direction's carry_in/return_carry."""
    vol, img = _inputs(2, (D, 16, W))
    d = np.arange(D)[None, None, :]
    x = np.arange(W)[None, :, None]
    dmask = jnp.asarray(np.broadcast_to(d <= x, (16, W, D)))
    v = jnp.asarray(np.moveaxis(vol, 0, -1))
    lr1, fin = jsgm._scan_direction(v[:8], jnp.asarray(img[:8]), dmask[:8], P1, P2, False,
                                    return_carry=True)
    lr2, fin2 = jsgm._scan_direction(v[8:], jnp.asarray(img[8:]), dmask[8:], P1, P2, False,
                                     carry_in=fin, return_carry=True)
    want = np.moveaxis(np.concatenate([np.asarray(lr1), np.asarray(lr2)], 0), -1, 0)
    tv, ti = _t(vol, img)
    top = tsgm.sgm_aggregate_block(tv[:, :8], ti[:8], P1, P2, "left", width=W)
    bot = tsgm.sgm_aggregate_block(tv[:, 8:], ti[8:], P1, P2, "left", width=W, seed=False,
                                   carry_prev=top[1], carry_best=top[2], last_img=top[3])
    np.testing.assert_allclose(torch.cat([top[0], bot[0]], 1).numpy(), want, atol=1e-6)
    np.testing.assert_allclose(bot[1].numpy(), np.asarray(fin2[0]).T, atol=1e-6)
    np.testing.assert_allclose(bot[2].numpy(), np.asarray(fin2[1]), atol=1e-6)


def test_block_acc_chaining():
    """With acc the segment is added onto acc in place; the carry is the
    same as without it."""
    vol, img = _inputs(3, (D, 16, W))
    acc = np.random.default_rng(30).random((D, 16, W)).astype(np.float32)
    tv, ti, tacc = _t(vol, img, acc)
    plain, cp, cb, _ = tsgm.sgm_aggregate_block(tv, ti, P1, P2, "left", width=W)
    got, cp2, cb2, _ = dispatch.sgm_aggregate_block(tv, ti, P1, P2, "left", width=W, acc=tacc)
    assert got is tacc
    np.testing.assert_array_equal(got.numpy(), acc + plain.numpy())
    np.testing.assert_array_equal(cp.numpy(), cp2.numpy())
    np.testing.assert_array_equal(cb.numpy(), cb2.numpy())


@pytest.fixture(scope="module")
def pallas_diag(interpret):
    """The JAX package's diagonal segments: two chained ones per dx, down
    and (over reversed rows) up."""
    vol, img = _inputs(4)
    out = {}
    for dx in (1, -1):
        for rev in (False, True):
            v, i = (vol[:, ::-1], img[::-1]) if rev else (vol, img)
            c0 = [jnp.asarray(a) for a in _zero_carry()]
            top = sp.sgm_aggregate_diag_block(jnp.asarray(v[:, :16]), jnp.asarray(i[:16]),
                                              c0[0], c0[1], c0[2], c0[3], P1, P2, "left",
                                              dx=dx, width=W)
            bot = sp.sgm_aggregate_diag_block(jnp.asarray(v[:, 16:]), jnp.asarray(i[16:]),
                                              top[1], top[2], top[4], top[3], P1, P2, "left",
                                              dx=dx, width=W)
            out[dx, rev] = (_np(*top), _np(*bot))
    return vol, img, out


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dx", [1, -1])
def test_diag_block_matches_pallas(pallas_diag, dx, reverse):
    vol, img, out = pallas_diag
    jtop, jbot = out[dx, reverse]
    tv, ti = _t(vol, img)
    top_rows, bot_rows = (slice(16, None), slice(None, 16)) if reverse else (slice(None, 16),
                                                                             slice(16, None))
    c0 = _t(*_zero_carry())
    top = tsgm.sgm_aggregate_diag_block(tv[:, top_rows], ti[top_rows], c0[0], c0[1], c0[2],
                                        c0[3], P1, P2, "left", dx=dx, width=W, reverse=reverse)
    bot = tsgm.sgm_aggregate_diag_block(tv[:, bot_rows], ti[bot_rows], top[1], top[2], top[4],
                                        top[3], P1, P2, "left", dx=dx, width=W,
                                        reverse=reverse)
    flip = (lambda a: a[:, ::-1]) if reverse else (lambda a: a)
    for got, want in ((top, jtop), (bot, jbot)):
        np.testing.assert_array_equal(flip(got[0].numpy()), want[0])
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("dx", [1, -1])
def test_diag_chained_segments_equal_one_pass(dx):
    """The all-zero has mask is the seed: two chained segments equal one."""
    vol, img = _inputs(5)
    tv, ti = _t(vol, img)
    c0 = _t(*_zero_carry())
    whole = tsgm.sgm_aggregate_diag_block(tv, ti, *c0, P1, P2, "right", dx=dx)
    top = tsgm.sgm_aggregate_diag_block(tv[:, :20], ti[:20], *c0, P1, P2, "right", dx=dx)
    bot = tsgm.sgm_aggregate_diag_block(tv[:, 20:], ti[20:], top[1], top[2], top[4], top[3],
                                        P1, P2, "right", dx=dx)
    np.testing.assert_array_equal(torch.cat([top[0], bot[0]], 1).numpy(), whole[0].numpy())
    np.testing.assert_array_equal(bot[1].numpy(), whole[1].numpy())


@pytest.mark.parametrize("dx", [1, -1])
def test_diag_block_matches_scan_diagonal_carry(dx):
    """The segment against sgm._scan_diagonal's carry_in/return_carry."""
    vol, img = _inputs(6, (D, 16, W))
    d = np.arange(D)[None, None, :]
    x = np.arange(W)[None, :, None]
    dmask = jnp.asarray(np.broadcast_to(d <= x, (16, W, D)))
    v = jnp.asarray(np.moveaxis(vol, 0, -1))
    lr1, fin = jsgm._scan_diagonal(v[:8], jnp.asarray(img[:8]), dmask[:8], P1, P2, dx=dx,
                                   return_carry=True)
    lr2 = jsgm._scan_diagonal(v[8:], jnp.asarray(img[8:]), dmask[8:], P1, P2, dx=dx,
                              carry_in=fin)
    want = np.moveaxis(np.concatenate([np.asarray(lr1), np.asarray(lr2)], 0), -1, 0)
    tv, ti = _t(vol, img)
    c0 = _t(*_zero_carry())
    top = tsgm.sgm_aggregate_diag_block(tv[:, :8], ti[:8], *c0, P1, P2, "left", dx=dx)
    bot = tsgm.sgm_aggregate_diag_block(tv[:, 8:], ti[8:], top[1], top[2], top[4], top[3],
                                        P1, P2, "left", dx=dx)
    np.testing.assert_allclose(torch.cat([top[0], bot[0]], 1).numpy(), want, atol=1e-6)


@pytest.mark.parametrize("dx", [1, -1])
def test_diag_block_padded_acc_matches_unpadded(dx):
    """On a padded lane block with ``width`` the image's, the predecessor
    test keeps pad lanes out of lane W-1 (dx = -1) and the in-image lanes
    equal the unpadded segment's; acc is added in place."""
    vol, img = _inputs(7, (D, 16, W))
    pad = 16
    acc = np.random.default_rng(70).random((D, 16, W + pad)).astype(np.float32)
    tv, ti = _t(vol, img)
    want = tsgm.sgm_aggregate_diag_block(tv, ti, *_t(*_zero_carry()), P1, P2, "left", dx=dx)[0]
    tvp, tip, tacc = _t(np.pad(vol, ((0, 0), (0, 0), (0, pad)), constant_values=7.0),
                        np.pad(img, ((0, 0), (0, pad)), constant_values=3.0), acc)
    got = tsgm.sgm_aggregate_diag_block(tvp, tip, *_t(*_zero_carry(W + pad)), P1, P2, "left",
                                        dx=dx, width=W, acc=tacc)[0]
    np.testing.assert_array_equal(got.numpy()[:, :, :W], acc[:, :, :W] + want.numpy())


@pytest.fixture(scope="module")
def pallas_offset(interpret):
    """TestSgmLaneOffset's construction: two column halves of a 256-wide
    image, each aggregated at its lane offset by the Pallas kernel."""
    vol, img = _inputs(8, (16, 16, 256))
    halves = [np.asarray(sp.sgm_aggregate_scan(
        jnp.asarray(vol[:, :, off:off + 128]), jnp.asarray(img[:, off:off + 128]), P1, P2, True,
        mode, scan_is_x=False, width=256, lane_offset=off))
        for mode in ("left", "right") for off in (0, 128)]
    return vol, img, halves


@pytest.mark.parametrize("mode", ["left", "right"])
def test_lane_offset_matches_pallas_and_full_image(pallas_offset, mode):
    vol, img, halves = pallas_offset
    tv, ti = _t(vol, img)
    got = [tsgm.sgm_aggregate_scan(tv[:, :, off:off + 128], ti[:, off:off + 128], P1, P2, True,
                                   mode, width=256, lane_offset=off) for off in (0, 128)]
    want = halves[:2] if mode == "left" else halves[2:]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    # the two halves are the full image's vertical pair
    whole = tsgm.semi_global_matching(tv, ti, P1, P2, do_horiz=False,
                                      sd=-1 if mode == "left" else 1)
    np.testing.assert_array_equal(torch.cat(got, 2).numpy(), whole.numpy())


@pytest.fixture(scope="module")
def pallas_seams(interpret):
    rng = np.random.default_rng(9)
    vols = rng.random((3, D, 16, W)).astype(np.float32)
    imgs = rng.random((3, 16, W)).astype(np.float32)
    stacked = np.asarray(sp.semi_global_matching(
        jnp.asarray(np.concatenate(list(vols), 1)), jnp.asarray(np.concatenate(list(imgs), 0)),
        P1, P2, seam_period=16))
    return vols, imgs, stacked


def test_seam_period_equals_per_frame(pallas_seams):
    """A stacked batch equals its frames aggregated one by one, exactly;
    and the Pallas seam pass to 1e-6 (it adds the vertical and the
    horizontal pairs in another order)."""
    vols, imgs, stacked = pallas_seams
    got = dispatch.semi_global_matching(*_t(np.concatenate(list(vols), 1),
                                            np.concatenate(list(imgs), 0)), P1, P2,
                                        seam_period=16).numpy()
    for k in range(3):
        want = tsgm.semi_global_matching(*_t(vols[k], imgs[k]), P1, P2).numpy()
        np.testing.assert_array_equal(got[:, 16 * k:16 * (k + 1)], want)
    np.testing.assert_allclose(got, stacked, atol=1e-6)


def test_seam_scan_equals_per_frame_scan():
    rng = np.random.default_rng(10)
    vol, img = rng.random((D, 24, 40)).astype(np.float32), rng.random((24, 40)).astype(np.float32)
    tv, ti = _t(vol, img)
    got = tsgm.sgm_aggregate_scan(tv, ti, P1, P2, seam_period=8)
    for k in range(3):
        want = tsgm.sgm_aggregate_scan(tv[:, 8 * k:8 * (k + 1)], ti[8 * k:8 * (k + 1)], P1, P2)
        np.testing.assert_array_equal(got[:, 8 * k:8 * (k + 1)].numpy(), want.numpy())


def test_segments_check_their_arguments():
    vol, img = _t(*_inputs(11, (D, 8, 16)))
    with pytest.raises(ValueError, match="seam_period"):
        tsgm.semi_global_matching(vol, img, seam_period=3)
    with pytest.raises(ValueError, match="4 paths"):
        tsgm.semi_global_matching(vol, img, do_diagonal=True, seam_period=4)
    with pytest.raises(ValueError, match="carry_prev"):
        tsgm.sgm_aggregate_block(vol, img, seed=False)
    with pytest.raises(ValueError, match="dx"):
        tsgm.sgm_aggregate_diag_block(vol, img, *_t(*_zero_carry(16)), dx=0)
    with pytest.raises(ValueError, match="mask_mode"):
        tsgm.sgm_aggregate_block(vol, img, mask_mode="up")
    with pytest.raises(RuntimeError, match="no gradient"):
        tsgm.sgm_aggregate_block(vol.clone().requires_grad_(True), img)


def test_kernel_wrappers_refuse_cpu_tensors():
    """On the CPU the dispatch takes the plain versions; the kernel
    wrappers themselves raise there and count no launch."""
    vol, img = _t(*_inputs(12, (D, 8, 16)))
    counts = lambda: (sgm_cuda.launches, sgm_cuda.segment_launches,
                      sgm_cuda.diag_segment_launches)
    before = counts()
    calls = [lambda: sgm_cuda.sgm_aggregate_scan(vol, img, lane_offset=0),
             lambda: sgm_cuda.sgm_aggregate_block(vol, img),
             lambda: sgm_cuda.sgm_aggregate_diag_block(vol, img, *_t(*_zero_carry(16))),
             lambda: sgm_cuda.semi_global_matching(vol, img, seam_period=4)]
    for call in calls:
        with pytest.raises(RuntimeError, match="sm_90"):
            call()
    dispatch.sgm_aggregate_block(vol, img)
    dispatch.sgm_aggregate_diag_block(vol, img, *_t(*_zero_carry(16)))
    dispatch.sgm_aggregate_scan(vol, img, lane_offset=0)
    assert counts() == before
