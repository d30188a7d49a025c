"""Sharded scoring (minimodem_tpu_torch/parallel/sharding.py) and the
multi-device dry run (parallel/dryrun.py) against the JAX package's, on
the CPU.

The port side runs once for the module in a world of 4 gloo processes
(tests/torch_fleet.py::sharding_world); the JAX side runs here on the 8
virtual CPU devices of the root conftest.py, as tests/test_sharding.py
runs it.  sharded_decode_step's channels equal the port's unsharded
scorer (ops/demod.py::_build_score_fn) bit for bit; against JAX's, bits
are equal and conf/ampl within RTOL / ATOL (the drift the port states:
sqrt vs hypot, tap-order sums), mean_conf within relative MEAN_RTOL (a
float sum in another order).
"""

import numpy as np
import pytest
import torch

from . import torch_fleet as F

RTOL, ATOL = 2e-6, 1e-5
MEAN_RTOL = 1e-6


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The suite runs in several pytest workers on a few cores; PyTorch's
    own CPU thread pool in each of them would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port():
    from minimodem_tpu_torch.parallel.launch import spawn_world

    return spawn_world(F.sharding_world, 4, timeout=300)


@pytest.fixture(scope="module")
def jax_mesh():
    import jax

    from minimodem_tpu.parallel.sharding import make_mesh

    if len(jax.devices()) < 4:
        pytest.skip("needs the virtual CPU mesh (conftest re-exec)")
    return make_mesh


def case(port, name):
    r = port[0][name]
    if isinstance(r, tuple) and len(r) == 2 and r[0] == "error":
        pytest.fail(f"the port's {name} raised:\n{r[1]}")
    return r


def _jax_error(fn):
    try:
        fn()
    except (ValueError, AssertionError) as e:
        return type(e).__name__, str(e)
    return None


def test_every_rank_returns_whole_arrays(port):
    assert len(port) == 4
    for rank in range(1, 4):
        for name in ("step_dp2_sp2", "step_dp4_sp1"):
            a, b = port[rank][name], port[0][name]
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_rank_device_is_cuda_local_rank(port):
    """Each rank's device is cuda:{LOCAL_RANK} (the launcher's local
    rank; spawn_world gives rank r local rank r on a host without
    cards), never cuda:0 for every rank."""
    for rank, res in enumerate(port):
        assert res["devices"] == (rank, rank, f"cuda:{rank}", "cpu")


def test_mesh_shapes_and_assert(port, jax_mesh):
    """make_mesh's dp/sp resolution and its assert, as JAX's; a mesh
    other than the world raises."""
    r = case(port, "mesh")
    assert r["default"] == (2, 2)
    assert r["dp4"] == (4, 1)
    assert r["sp4"] == (1, 4)
    for k, kw in (("dp3", {"dp": 3}), ("dp1sp1", {"dp": 1, "sp": 1})):
        assert r[k] == _jax_error(lambda: jax_mesh(4, **kw)), k
    assert r["n8"][0] == "ValueError"


@pytest.mark.parametrize("name,dp,sp", [("step_dp2_sp2", 2, 2),
                                        ("step_dp4_sp1", 4, 1)])
def test_sharded_step_matches_unsharded_and_jax(port, jax_mesh, name, dp,
                                                sp):
    """(2, 2): two streams a rank (K3's several-row form), halos across
    the sp group; (4, 1): one stream a rank (the one-row form)."""
    from minimodem_tpu.models.modem import FskModem as JaxModem
    from minimodem_tpu.parallel.sharding import sharded_decode_step
    from minimodem_tpu_torch.ops.demod import (CHANNELS, _build_score_fn,
                                               geometry_from_config)

    out = case(port, name)
    t_local = 1 << 12
    x = F.step_samples(4, sp * t_local)
    geo = geometry_from_config(F.modem().cfg, "float32")
    xs = np.zeros((4, sp * t_local + geo.halo), np.float32)
    xs[:, :sp * t_local] = x
    ref = _build_score_fn(geo, sp * t_local, "cpu")(
        torch.from_numpy(xs)).numpy()
    for i, k in enumerate(CHANNELS):
        assert out[k].shape == (4, sp * t_local)
        np.testing.assert_array_equal(out[k].view(np.int32), ref[:, i],
                                      err_msg=k)

    jx = sharded_decode_step(JaxModem("1200").cfg, jax_mesh(4, dp=dp, sp=sp),
                             x, t_local, "float32")
    for k in CHANNELS:
        if k.startswith("bits"):
            np.testing.assert_array_equal(out[k], jx[k], err_msg=k)
        else:
            np.testing.assert_allclose(out[k], jx[k], rtol=RTOL, atol=ATOL,
                                       err_msg=k)
    assert np.isfinite(out["mean_conf"])
    np.testing.assert_allclose(out["mean_conf"], jx["mean_conf"],
                               rtol=MEAN_RTOL)


def test_step_errors_match_jax(port, jax_mesh):
    """The JAX ValueErrors, same texts: a halo longer than t_local, a
    stream longer than sp * t_local; and a batch that does not divide
    over dp."""
    from minimodem_tpu.models.modem import FskModem as JaxModem
    from minimodem_tpu.parallel.sharding import sharded_decode_step

    r = case(port, "errors")
    cfg, mesh = JaxModem("1200").cfg, jax_mesh(4, dp=2, sp=2)
    assert r["halo"] == _jax_error(lambda: sharded_decode_step(
        cfg, mesh, np.zeros((2, 32), np.float32), 16, "float32"))
    assert r["length"] == _jax_error(lambda: sharded_decode_step(
        cfg, mesh, np.zeros((2, 9000), np.float32), 4096, "float32"))
    assert r["batch"][0] == "ValueError"


def test_dryrun_multichip_matches_jax(capsys, jax_mesh):
    """The port's dry run on a world of 4 gloo ranks (device="cpu")
    prints the JAX dry run's line on 4 virtual devices, character for
    character, then the device."""
    import __graft_entry__ as g
    from minimodem_tpu_torch.parallel.dryrun import dryrun_multichip

    dryrun_multichip(4, device="cpu")
    got = capsys.readouterr().out.strip().splitlines()
    g._dryrun_impl(4)
    want = capsys.readouterr().out.strip().splitlines()
    assert got[-1].startswith("dryrun_multichip OK: ")
    assert got[-1] == want[-1] + " device=cpu"
