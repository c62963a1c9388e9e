"""The port's device mesh (``nsof_tpu_torch/parallel/mesh.py``) against the JAX
package's ``make_mesh``, ``data_sharding`` and ``shard_params_conv_tp``.

The JAX side runs on a virtual 4-device CPU mesh in a subprocess
(``run_in_cpu_subprocess``); the port's in 4 gloo ranks (``tests/torch_dist.py``).
Both lay ranks out row-major over ('data', 'model'), so rank r of the port
sits where device r sits in JAX's mesh; both raise ``ValueError`` for too
few devices and for a count ``model_parallel`` does not divide.  The
tensor-parallel layout is compared parameter by parameter on RAFT-small and
RAFT-basic: JAX's shardings of the Flax tree, carried to torch's names by
``params_from_jax``, against the port's dims.
"""

import json

import jax
import numpy as np
import pytest
import torch

from nsof_tpu.models import raft as jraft
from nsof_tpu.parallel import mesh as jmesh
from nsof_tpu_torch.models import raft as traft
from nsof_tpu_torch.models.convert import params_from_jax
from nsof_tpu_torch.parallel import mesh as tmesh
from tests.conftest import run_in_cpu_subprocess
from tests.torch_deep_weights import raft_params
from tests.torch_dist import run_ranks
from torch_single_thread import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def jax_meshes():
    proc = run_in_cpu_subprocess(
        """
        import json, jax, numpy as np
        from nsof_tpu.parallel.mesh import make_mesh

        def ids(mesh):
            return np.vectorize(lambda d: d.id)(mesh.devices).tolist()

        def raises(fn):
            try:
                fn()
            except ValueError as e:
                return str(e)
            raise AssertionError("expected ValueError")

        m22, m41, m21 = make_mesh(4, model_parallel=2), make_mesh(4), make_mesh(2)
        print(json.dumps({
            "shape_22": dict(m22.shape), "shape_41": dict(m41.shape),
            "ranks_22": ids(m22), "ranks_41": ids(m41), "ranks_21": ids(m21),
            "too_many": raises(lambda: make_mesh(8)),
            "not_divisible": raises(lambda: make_mesh(4, model_parallel=3)),
        }))
        """,
        n_devices=4, timeout=120)
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def port_meshes():
    return run_ranks(4, "mesh_shapes")


def test_mesh_shapes_match_jax(jax_meshes, port_meshes):
    assert dict(zip(("data", "model"), port_meshes["shape_22"])) == jax_meshes["shape_22"] \
        == {"data": 2, "model": 2}
    assert dict(zip(("data", "model"), port_meshes["shape_41"])) == jax_meshes["shape_41"] \
        == {"data": 4, "model": 1}
    for key in ("ranks_22", "ranks_41", "ranks_21"):
        np.testing.assert_array_equal(port_meshes[key], np.array(jax_meshes[key]), key)
    # rank r's coordinates are its place in the row-major mesh
    np.testing.assert_array_equal(port_meshes["coords"], [[0, 0], [0, 1], [1, 0], [1, 1]])


def test_rows_follow_data_sharding(port_meshes):
    """Shard(0) over 'data': ranks that differ only in 'model' hold the same
    rows; the placements are (Shard(0), Replicate()) and (Replicate(),) · 2."""
    np.testing.assert_array_equal(port_meshes["rows_22"],
                                  [[0, 1, 2, 3], [0, 1, 2, 3], [4, 5, 6, 7], [4, 5, 6, 7]])
    np.testing.assert_array_equal(port_meshes["rows_41"], np.arange(8).reshape(4, 2))
    placements = [str(p) for p in port_meshes["placements"]]
    assert "Shard(dim=0)" in placements[0] and "Replicate()" in placements[0]
    assert placements[1].count("Replicate()") == 2
    assert "does not divide" in str(port_meshes["rows_not_divisible"])


def test_mesh_errors_match_jax(jax_meshes, port_meshes):
    for key, needle in (("too_many", "requested 8 devices"),
                        ("not_divisible", "not divisible by model_parallel=3")):
        assert needle in jax_meshes[key] and needle in str(port_meshes[key]), key


def test_no_device_no_fallback():
    """Without a CUDA device and without ``device='cpu'``, ``make_mesh``
    raises before it starts a process group: no rank drops to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh(1)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("kind", ["small", "basic"])
@pytest.mark.parametrize("min_features", [128, 64])
def test_shard_params_conv_tp_matches_jax(kind, min_features):
    jcfg = jraft.RaftConfig(small=kind == "small")
    tcfg = traft.RaftConfig(small=kind == "small")
    params = raft_params(jcfg, seed=0)
    specs = jmesh.shard_params_conv_tp(params, jmesh.make_mesh(1), min_features=min_features)
    # 1 where JAX shards the leaf over 'model', 0 where it replicates it
    marks = jax.tree.map(lambda p, s: np.full(p.shape, float("model" in tuple(s.spec)),
                                              np.float32), params, specs)
    want = params_from_jax(marks, tcfg)
    got = tmesh.shard_params_conv_tp(traft.RAFT(tcfg), None, min_features=min_features)
    assert set(got) >= set(want)
    for name, mark in want.items():
        assert mark.min() == mark.max(), name
        assert (got[name] == 0) == bool(mark.max()), (name, got[name])
    assert 0 < sum(v == 0 for v in got.values()) < len(got)
