"""The port's mesh sharding (tpuh264_torch.dist.mesh) over gloo processes
on the CPU: every result identical to the JAX package's UNSHARDED encode
of the same inputs -- the counterparts of tests/test_dist.py's three
cases, plus the fused halo against the per-plane one.

One job of 8 ranks (a `file://` rendezvous under the test's temporary
directory, a timeout on every process, all killed on a failure) runs
every case in turn, (4,2), (8,1) and (2,4) meshes, and rank 0 writes the
gathered results; the tests compare them."""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 8
QP_I4, QP_S8, QP_GOP = 30, 26, 30


def _batch(s, h, w):
    from tpuh264_torch.engine import sources

    frames = [sources.yuv_frame(w, h, t) for t in range(s)]
    return tuple(np.stack([f[i] for f in frames]).astype(np.int32)
                 for i in range(3))


def _gop_inputs():
    """moving_sequence(128, 64, 3, seed=7), as tests/test_dist.py: 2
    streams (frames 0, 1 then 1, 2), 8 MB rows over 4 row shards."""
    from tests.test_golden_pframe import moving_sequence

    frames = moving_sequence(128, 64, 3, seed=7)
    return [tuple(np.stack([frames[t][p], frames[t + 1][p]]).astype(
        np.int32) for p in range(3)) for t in (0, 1)]


def _worker(rank: int, init: str, inputs: str, out: str) -> None:
    """One rank: every case over the world, in the same order as every
    other rank; rank 0 saves what the tests check."""
    import torch
    import torch.distributed as dist

    from tpuh264_torch.dist import mesh as dm

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=WORLD)
    arrays = dict(np.load(inputs))
    res = {}

    mesh = dm.make_codec_mesh(4, 2, device="cpu")
    sym, rec, stats = dm.sharded_encode_step(mesh)(
        *dm.shard_inputs(mesh, *(arrays[f"a_{p}"] for p in "yuv")), QP_I4)
    res.update(a_recon_y=dm.gather(mesh, rec[0]),
               a_luma_dc=dm.gather(mesh, sym.luma_dc),
               a_luma_ac=dm.gather(mesh, sym.luma_ac), a_stats=stats)
    res["a_shape"] = torch.tensor(mesh.shape)

    mesh = dm.make_codec_mesh(8, 1, device="cpu")
    sym, _, _ = dm.sharded_encode_step(mesh)(
        *dm.shard_inputs(mesh, *(arrays[f"b_{p}"] for p in "yuv")), QP_S8)
    res["b_luma_dc"] = dm.gather(mesh, sym.luma_dc)

    mesh = dm.make_codec_mesh(2, 4, device="cpu")
    for fused in (True, False):
        i_fn, p_fn = dm.sharded_gop_step(mesh, fused_halo=fused)
        _, rec = i_fn(*dm.shard_inputs(
            mesh, *(arrays[f"g0_{p}"] for p in "yuv")), QP_GOP)
        res[f"c{fused:d}_irecon_y"] = dm.gather(mesh, rec[0])
        sym, rec, mv = p_fn(*dm.shard_inputs(
            mesh, *(arrays[f"g1_{p}"] for p in "yuv")), *rec, QP_GOP)
        for i, p in enumerate("yuv"):
            res[f"c{fused:d}_recon_{p}"] = dm.gather(mesh, rec[i])
        for name in sym._fields:
            res[f"c{fused:d}_sym_{name}"] = dm.gather(mesh,
                                                      getattr(sym, name))
        res[f"c{fused:d}_mvy"] = dm.gather(mesh, mv[1])
    if rank == 0:
        np.savez(out, **{k: v.numpy() for k, v in res.items()})
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """Run the 8-rank job once; returns the gathered results."""
    tmp = tmp_path_factory.mktemp("torch_dist")
    a, b, (g0, g1) = _batch(4, 64, 64), _batch(8, 32, 48), _gop_inputs()
    arrays = {}
    for tag, planes in (("a", a), ("b", b), ("g0", g0), ("g1", g1)):
        arrays.update({f"{tag}_{p}": x for p, x in zip("yuv", planes)})
    np.savez(tmp / "inputs.npz", **arrays)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    init = f"file://{tmp / 'rendezvous'}"
    code = ("import sys; from tests.test_torch_dist import _worker; "
            "_worker(int(sys.argv[1]), *sys.argv[2:])")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), init, str(tmp / "inputs.npz"),
         str(tmp / "out.npz")], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            assert p.returncode == 0, f"rank failed:\n{out[-3000:]}"
    finally:
        for p in procs:
            p.kill()
            p.wait()
    return arrays, dict(np.load(tmp / "out.npz"))


def test_streams_by_rows_mesh_matches_single_device(sharded):
    import jax.numpy as jnp
    from tpuh264.kernels import iframe

    arrays, res = sharded
    assert tuple(res["a_shape"]) == (4, 2)
    ref_sym, ref_rec = iframe.encode_iframe_rows(
        *(arrays[f"a_{p}"] for p in "yuv"), jnp.int32(QP_I4))
    np.testing.assert_array_equal(res["a_recon_y"], np.asarray(ref_rec[0]))
    np.testing.assert_array_equal(res["a_luma_dc"],
                                  np.asarray(ref_sym.luma_dc))
    np.testing.assert_array_equal(res["a_luma_ac"],
                                  np.asarray(ref_sym.luma_ac))
    # the stats' sums over the mesh equal the global sums
    levels = [np.asarray(x) for x in (ref_sym.luma_dc, ref_sym.luma_ac,
                                      ref_sym.chroma_dc, ref_sym.chroma_ac)]
    assert int(res["a_stats"][1]) == sum(np.count_nonzero(x)
                                         for x in levels)
    assert int(res["a_stats"][0]) == sum(int(np.abs(x.astype(np.int64))
                                             .sum()) for x in levels)


def test_streams_only_mesh(sharded):
    import jax.numpy as jnp
    from tpuh264.kernels import iframe

    arrays, res = sharded
    ref_sym, _ = iframe.encode_iframe_rows(
        *(arrays[f"b_{p}"] for p in "yuv"), jnp.int32(QP_S8))
    np.testing.assert_array_equal(res["b_luma_dc"],
                                  np.asarray(ref_sym.luma_dc))


def _jax_gop(arrays):
    import jax.numpy as jnp
    from tpuh264.kernels import iframe, pframe

    _, rec0 = iframe.encode_iframe_rows(
        *(jnp.asarray(arrays[f"g0_{p}"]) for p in "yuv"), jnp.int32(QP_GOP))
    sym, rec, mv = pframe.encode_pframe_rows(
        *(jnp.asarray(arrays[f"g1_{p}"]) for p in "yuv"), *rec0,
        jnp.int32(QP_GOP))
    return rec0, sym, rec, mv


def test_sharded_gop_halo_exchange_bit_exact(sharded):
    """Row-sharded IPPP over the (2,4) mesh: the P step exchanges the
    reference halos between ranks; every symbol and sample equals the
    JAX package's unsharded encode (inter prediction crossing band edges
    correctly)."""
    arrays, res = sharded
    rec0, sym, rec, mv = _jax_gop(arrays)
    np.testing.assert_array_equal(res["c1_irecon_y"], np.asarray(rec0[0]))
    for i, p in enumerate("yuv"):
        np.testing.assert_array_equal(res[f"c1_recon_{p}"],
                                      np.asarray(rec[i]))
    for name in sym._fields:
        if getattr(sym, name) is not None:
            np.testing.assert_array_equal(res[f"c1_sym_{name}"],
                                          np.asarray(getattr(sym, name)),
                                          err_msg=name)
    np.testing.assert_array_equal(res["c1_mvy"], np.asarray(mv[1]))
    # MVs cross the band edges (every 2 MB rows) for the test to mean much
    mvy = res["c1_mvy"]
    assert (mvy[:, 1:-1:2] > 0).any() or (mvy[:, 2::2] < 0).any()


def test_fused_halo_equals_per_plane(sharded):
    """The fused uint8 halo and the per-plane int32 one: identical."""
    _, res = sharded
    keys = [k[3:] for k in res if k.startswith("c1_")]
    assert len(keys) > 10
    for k in keys:
        np.testing.assert_array_equal(res[f"c1_{k}"], res[f"c0_{k}"],
                                      err_msg=k)
