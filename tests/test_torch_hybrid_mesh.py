"""``make_hybrid_mesh`` (ROADMAP A.9.3, ``s2v_torch/parallel/multihost.py``)
on 4 gloo ranks posing as 2 hosts of 2 (``LOCAL_WORLD_SIZE=2``,
``tests/_torch_mesh_worker.py``), against the JAX package's single-process
layout on virtual CPU devices: the dim names in order (cross-host dims
outermost) and each rank's coordinates equal to those of JAX's device of
the same index.  A DCN product that is not the host count raises."""

import jax
import numpy as np
import pytest

from _torch_mesh_worker import run_mesh_ranks
from s2v_tpu.parallel.multihost import make_hybrid_mesh as j_make_hybrid_mesh

LAYOUTS = {"data_model": ({"data": 2}, {"model": 2}), "data_seq": ({"data": 2}, {"seq": 2}),
           "seq_model_data1": ({"seq": 2}, {"model": 2, "data": 1})}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cases = {name: ("hybrid", "dp4", dict(dcn=dcn, ici=ici, local_world_size=2))
             for name, (dcn, ici) in LAYOUTS.items()}
    cases["wrong_dcn"] = ("hybrid", "dp4", dict(dcn={"data": 4}, ici={"model": 1}, local_world_size=2))
    return run_mesh_ranks(4, cases, tmp_path_factory.mktemp("hybrid"), timeout_s=120)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_hybrid_mesh_matches_jax_single_process_layout(ranks, name):
    dcn, ici = LAYOUTS[name]
    mesh = j_make_hybrid_mesh(dcn, ici, jax.devices()[:4])
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    for res in ranks:
        got = res[name]
        assert got["names"] == list(mesh.axis_names)
        assert got["shape"] == list(ids.shape)
        assert got["coords"] == [int(c) for c in np.argwhere(ids == got["rank"])[0]]


def test_hybrid_mesh_refuses_dcn_dims_that_are_not_the_hosts(ranks):
    for res in ranks:
        assert "do not match the host count (2)" in res["wrong_dcn"]["error"]
