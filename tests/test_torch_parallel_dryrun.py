"""tools/dryrun_multichip.py, the counterpart of
``__graft_entry__.py::dryrun_multichip``, over four gloo ranks on the CPU
(tests/torch_ranks.py's ``dryrun`` job): its 15 stages, dp through
``cert_dp_multistep``, each run, its loss held by the tool to the
single-process loss of the same weights and batch, and the same stages in
the same order as the JAX dryrun's."""

import torch_cpu  # noqa: F401  (first: torch's threads a worker)

import inspect
import re

import pytest

import __graft_entry__
from torch_ranks import Ranks

STAGES = ["dp", "tp", "sp", "pp", "dp_x_pp", "dp_x_sp", "ssg_sp", "bristrunet_sp",
          "windowed_ptv3_sp", "ep", "fsdp", "pooled_sp", "engine_tp", "cert_dp_equality",
          "cert_dp_multistep"]


@pytest.fixture(scope="module")
def dryrun(tmp_path_factory):
    return Ranks("dryrun", 4, tmp_path_factory.mktemp("dryrun"), timeout=240).start().join()


def test_the_stages_are_the_jax_dryruns():
    src = inspect.getsource(__graft_entry__._dryrun_inner)
    body = src[src.index("stages = ["):]
    assert re.findall(r'\("(\w+)", (?:mode|cert)_\w+\)', body) == STAGES


@pytest.mark.parametrize("stage", STAGES)
def test_every_stage_runs_and_holds(dryrun, stage):
    for r in dryrun:
        rec = r[stage]
        assert rec["wall"] is not None and rec["wall"] > 0, rec
        assert "ok" in rec["msg"], rec["msg"]
    assert list(dryrun[0]) == STAGES
