"""The multi-device and batched SGM paths against kangaroo_tpu:
``parallel.mesh``, the wavefront and reshard aggregations and the sharded
tail of ``parallel.sharding`` on a virtual 8-shard CPU mesh
(``make_mesh(devices=["cpu"] * 8)``) against the JAX package's on its
8-device CPU mesh (its XLA twins: Pallas in interpret mode deadlocks under
a multi-device shard_map), ``sgm_pipeline(mesh=)`` and
``sgm_pipeline_batched``.

Tolerances: the aggregates on the disparity lattice at rtol 1e-4 / atol
1e-5, as the JAX package holds its own mesh to its single device (the two
sum the directions in other orders); the one-shard mesh and the sharded
tail bit-equal to the port's single-device aggregation and tail; the mesh
frames at the JAX package's own mesh-frame thresholds (``TestShardedSgmApp``)
and >= 99.5 % agreement; the batched frames equal to the port's frames one
by one exactly, and >= 99.5 % in agreement with the JAX package's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kangaroo_tpu.apps import stereo_sgm as jss
from kangaroo_tpu.apps import synthetic as jsyn
from kangaroo_tpu.parallel import mesh as jmesh
from kangaroo_tpu.parallel import sharding as jsh
from kangaroo_tpu_torch.apps import stereo_sgm as tss
from kangaroo_tpu_torch.parallel import mesh as tmesh
from kangaroo_tpu_torch.parallel import sharding as tsh
from kangaroo_tpu_torch.stereo import costvolume as tcv
from kangaroo_tpu_torch.stereo import dispatch
from kangaroo_tpu_torch.stereo import sgm as tsgm

P1, P2 = 0.03, 0.1


@pytest.fixture(scope="module")
def jax_mesh():
    assert jax.device_count() >= 8, "conftest must provide 8 virtual devices"
    return jmesh.make_mesh(8)


@pytest.fixture(scope="module")
def mesh():
    return tmesh.make_mesh(devices=["cpu"] * 8)


def _inputs(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.random(shape).astype(np.float32),
            rng.random(shape[1:]).astype(np.float32))


def _lattice(shape, sd):
    D, H, W = shape
    d = np.arange(D)[:, None, None]
    x = np.arange(W)[None, None, :]
    return np.broadcast_to((d <= x) if sd < 0 else (x + d < W), shape)


def _agreement(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    return float(((np.isnan(a) & np.isnan(b)) | (np.abs(a - b) <= tol)).mean())


def test_make_mesh():
    m = tmesh.make_mesh(devices=["cpu"] * 4)
    assert m.size == 4 and m.axis == "shard" and m.devices == (torch.device("cpu"),) * 4
    with pytest.raises(ValueError, match="n_devices"):
        tmesh.make_mesh(2, devices=["cpu"] * 4)
    # no silent virtual mesh: more cards than there are raises
    with pytest.raises(RuntimeError, match="found"):
        tmesh.make_mesh(torch.cuda.device_count() + 1)
    x = torch.arange(24.0).reshape(8, 3)
    blocks = tmesh.shard_leading(x, m)
    assert [tuple(b.shape) for b in blocks] == [(2, 3)] * 4
    assert torch.equal(torch.cat(blocks), x)
    with pytest.raises(ValueError, match="divide"):
        tmesh.shard_leading(x[:6], tmesh.make_mesh(devices=["cpu"] * 4))
    assert all(torch.equal(r, x) for r in tmesh.replicate(x, m))


def test_halo_exchange_rows(mesh):
    img = torch.arange(32.0 * 3).reshape(32, 3)
    blocks = list(img.chunk(8))
    padded = tsh.halo_exchange_rows(blocks, 2, mesh)
    edge = torch.cat([img[:1], img[:1], img, img[-1:], img[-1:]])
    for k, p in enumerate(padded):
        assert torch.equal(p, edge[4 * k:4 * k + 8])


def _held(got, want, shape, sd):
    m = _lattice(shape, sd)
    np.testing.assert_allclose(got[m], want[m], rtol=1e-4, atol=1e-5)


# (strategy, sd, do_diagonal, (D, H, W)): the cases held to the JAX
# package's 8-device mesh; W = 21 does not divide the mesh
JAX_CASES = {"wavefront_4path_w21": ("wavefront", -1, False, (8, 32, 21)),
             "wavefront_8path": ("wavefront", -1, True, (8, 32, 16)),
             "reshard_left": ("reshard", -1, False, (8, 32, 16)),
             "reshard_right": ("reshard", 1, False, (8, 32, 16))}


def _port(strategy, vol, img, mesh, sd, diag):
    v, i = torch.from_numpy(vol), torch.from_numpy(img)
    if strategy == "wavefront":
        blocks = tsh.sharded_semi_global_matching(v, i, P1, P2, mesh, sd=sd, do_diagonal=diag)
    else:
        blocks = tsh.sharded_semi_global_matching_reshard(v, i, P1, P2, mesh, sd=sd)
    assert len(blocks) == mesh.size
    return torch.cat(blocks, dim=1).numpy()


@pytest.fixture(scope="module")
def jax_aggregates(jax_mesh):
    out = {}
    for seed, (name, (strategy, sd, diag, shape)) in enumerate(JAX_CASES.items()):
        vol, img = _inputs(seed, shape)
        v, i = jnp.asarray(vol), jnp.asarray(img)
        if strategy == "wavefront":
            got = jsh.sharded_semi_global_matching(v, i, P1, P2, jax_mesh, sd=sd,
                                                   do_diagonal=diag)
        else:
            got = jsh.sharded_semi_global_matching_reshard(v, i, P1, P2, jax_mesh, sd=sd)
        out[name] = (vol, img, np.asarray(got))
    return out


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_aggregation_matches_jax_mesh(jax_aggregates, mesh, name):
    """Each strategy on the virtual 8-shard mesh against the JAX package's
    on its 8-device mesh, and against the port's single-device aggregate."""
    strategy, sd, diag, shape = JAX_CASES[name]
    vol, img, want = jax_aggregates[name]
    got = _port(strategy, vol, img, mesh, sd, diag)
    _held(got, want, shape, sd)
    single = tsgm.semi_global_matching(torch.from_numpy(vol), torch.from_numpy(img), P1, P2,
                                       do_diagonal=diag, sd=sd).numpy()
    _held(got, single, shape, sd)


@pytest.mark.parametrize("sd,diag,n", [(1, False, 8), (1, True, 4), (-1, True, 3)])
def test_wavefront_matches_single_device(sd, diag, n):
    """The right lattice, and meshes of 4 and 3 shards (3 does not divide W,
    whose last column block is narrower)."""
    shape = (8, 24, 16)
    vol, img = _inputs(10 + n, shape)
    m = tmesh.make_mesh(devices=["cpu"] * n)
    got = _port("wavefront", vol, img, m, sd, diag)
    want = tsgm.semi_global_matching(torch.from_numpy(vol), torch.from_numpy(img), P1, P2,
                                     do_diagonal=diag, sd=sd).numpy()
    _held(got, want, shape, sd)


@pytest.mark.parametrize("do_diagonal", [False, True])
def test_one_shard_specialization(do_diagonal):
    """A one-shard mesh runs the single-device aggregation: bit-equal."""
    vol, img = _inputs(20, (8, 16, 24))
    m = tmesh.make_mesh(devices=["cpu"])
    got = tsh.sharded_semi_global_matching(torch.from_numpy(vol), torch.from_numpy(img), P1, P2,
                                           m, do_diagonal=do_diagonal)
    want = tsgm.semi_global_matching(torch.from_numpy(vol), torch.from_numpy(img), P1, P2,
                                     do_diagonal=do_diagonal)
    assert len(got) == 1 and torch.equal(got[0], want)


def _single_tail(agg, D, subpix=True, lr_check=True):
    wta = ((lambda a, sd: dispatch.cost_vol_minimum_subpix(a, sd)) if subpix
           else (lambda a, sd: tcv.cost_vol_minimum(a, D).to(torch.float32)))
    disp_l = dispatch.median_filter_reject_invalid(wta(agg, -1), 12, rad=2)
    if not lr_check:
        return disp_l
    disp_r = dispatch.median_filter_reject_invalid(wta(tcv.reanchor_right(agg), 1), 12, rad=2)
    disp_r = dispatch.left_right_check(disp_r, disp_l, 1, 1.0, max_disp=D)
    return dispatch.left_right_check(disp_l, disp_r, -1, 1.0, max_disp=D)


@pytest.mark.parametrize("subpix,lr_check", [(True, True), (False, False)])
def test_tail_bit_equal_to_single_device(mesh, subpix, lr_check):
    D, H, W = 16, 32, 64
    agg = torch.from_numpy(np.random.default_rng(3).random((D, H, W)).astype(np.float32))
    want = _single_tail(agg, D, subpix, lr_check)
    blocks = tsh.sharded_sgm_tail(list(agg.chunk(8, dim=1)), mesh, D, subpix=subpix,
                                  lr_check=lr_check)
    got = tsh.gather_rows(blocks, mesh)
    assert got.shape == (H, W)
    assert bool(((torch.isnan(got) & torch.isnan(want)) | (got == want)).all())


@pytest.fixture(scope="module")
def jax_frames():
    """The JAX package's frames of TestShardedSgmApp's pair."""
    W, H, D = 64, 32, 16
    left, right, _ = jsyn.stereo_pair(W, H, D, seed=5)
    out = {}
    for diag in (False, True):
        jcfg = jss.SgmConfig(max_disp=D, census_window="9x7", do_diagonal=diag)
        out[diag] = np.asarray(jax.jit(lambda a, b: jss.sgm_pipeline(a, b, jcfg))(left, right))
    return np.array(left), np.array(right), out


@pytest.mark.parametrize("do_diagonal", [False, True])
def test_pipeline_mesh_matches(jax_frames, mesh, do_diagonal):
    """The mesh frame (reshard for 4-path, wavefront for 8-path) against the
    JAX package's frame at its mesh-frame thresholds, and against the
    port's single-device frame."""
    left, right, frames = jax_frames
    cfg = tss.SgmConfig(max_disp=16, census_window="9x7", do_diagonal=do_diagonal)
    tl, tr = torch.from_numpy(left), torch.from_numpy(right)
    got = tss.sgm_pipeline(tl, tr, cfg, mesh=mesh)
    assert got.dtype == torch.float32 and got.shape == left.shape
    got = got.numpy()
    want = frames[do_diagonal]
    nan = np.isnan(want) & np.isnan(got)
    assert (nan | (np.abs(want - got) < 0.1)).mean() > 0.99
    both = np.isfinite(want) & np.isfinite(got)
    assert np.median(np.abs(want[both] - got[both])) < 0.01
    assert _agreement(got, want, 1e-4) >= 0.995
    assert _agreement(got, tss.sgm_pipeline(tl, tr, cfg).numpy(), 1e-4) >= 0.995


def test_mesh_config_errors(mesh):
    left = torch.zeros(16, 32, dtype=torch.uint8)
    for cfg in (tss.SgmConfig(max_disp=8, do_horiz=False),
                tss.SgmConfig(max_disp=8, do_reverse=False),
                tss.SgmConfig(max_disp=8, lr_from_left=False)):
        with pytest.raises(ValueError):
            tss.sgm_pipeline(left, left, cfg, mesh=mesh)
    odd = torch.zeros(16, 36, dtype=torch.uint8)  # 36 columns over 8 shards
    with pytest.raises(ValueError, match="divide"):
        tss.sgm_pipeline(odd, odd, tss.SgmConfig(max_disp=8), mesh=mesh)
    with pytest.raises(TypeError, match="Mesh"):
        tss.sgm_pipeline(left, left, tss.SgmConfig(max_disp=8), mesh=jmesh.make_mesh(8))
    vol, img = torch.zeros(8, 12, 16), torch.zeros(12, 16)
    with pytest.raises(ValueError, match="divide H"):
        tsh.sharded_semi_global_matching(vol, img, P1, P2, mesh)


@pytest.fixture(scope="module")
def batch():
    B, W, H, D = 2, 96, 64, 16
    pairs = [jsyn.stereo_pair(W, H, D, seed=k) for k in range(B)]
    lefts = jnp.stack([p[0] for p in pairs])
    rights = jnp.stack([p[1] for p in pairs])
    jcfg = jss.SgmConfig(max_disp=D, census_window="9x7")
    want = np.asarray(jss.sgm_pipeline_batched(lefts, rights, jcfg))
    return np.array(lefts), np.array(rights), jcfg, want


def test_batched_matches_jax_and_per_frame(batch):
    lefts, rights, jcfg, want = batch
    cfg = tss.SgmConfig.from_dict(dataclasses.asdict(jcfg))
    tl, tr = torch.from_numpy(lefts), torch.from_numpy(rights)
    got = tss.sgm_pipeline_batched(tl, tr, cfg)
    assert got.shape == tuple(lefts.shape) and got.dtype == torch.float32
    assert _agreement(got.numpy(), want, 1e-4) >= 0.995
    for k in range(len(lefts)):
        frame = tss.sgm_pipeline(tl[k], tr[k], cfg)
        assert bool(((torch.isnan(got[k]) & torch.isnan(frame)) | (got[k] == frame)).all())


@pytest.mark.parametrize("overrides", [dict(do_diagonal=True), dict(lr_from_left=False),
                                       dict(subpix=False, lr_check=False, median_its=2)])
def test_batched_configs_equal_per_frame(batch, overrides):
    """The configurations the stacked pass lacks run frame by frame; the
    others stack; both equal the frames one by one."""
    lefts, rights, _, _ = batch
    cfg = tss.SgmConfig(max_disp=16, census_window="9x7", **overrides)
    tl, tr = torch.from_numpy(lefts[:, :32]), torch.from_numpy(rights[:, :32])
    got = tss.sgm_pipeline_batched(tl, tr, cfg)
    for k in range(len(tl)):
        frame = tss.sgm_pipeline(tl[k], tr[k], cfg)
        assert bool(((torch.isnan(got[k]) & torch.isnan(frame)) | (got[k] == frame)).all())
