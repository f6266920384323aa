"""The port's circuit IR and library equal the JAX package's, gate for gate."""

import dataclasses

import numpy as np
import pytest

from dqgp_tpu.models.circuits import ENCODING_TYPES, build_circuit as jax_build
from dqgp_tpu_torch.convert import circuit_from_jax
from dqgp_tpu_torch.models.circuits import (
    ENCODING_TYPES as TORCH_ENCODING_TYPES,
    build_circuit as torch_build,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def test_same_families():
    assert TORCH_ENCODING_TYPES == ENCODING_TYPES


@pytest.mark.parametrize("n", [2, 3, 4, 5, 6])
@pytest.mark.parametrize("enc", ENCODING_TYPES)
def test_gates_and_static_arrays_equal(enc, n):
    for layers in (1, 2, 3):
        cj = jax_build(enc, n, 2, layers)
        ct = torch_build(enc, n, 2, layers)
        assert [dataclasses.astuple(g) for g in ct.gates] == \
            [dataclasses.astuple(g) for g in cj.gates]
        assert (ct.num_qubits, ct.num_features, ct.num_parameters, ct.name,
                ct.requires_clipping) == (cj.num_qubits, cj.num_features,
                                          cj.num_parameters, cj.name,
                                          cj.requires_clipping)
        aj, at = cj.static_arrays(), ct.static_arrays()
        assert aj.keys() == at.keys()
        for k in aj:
            # exact: the coefficient arrays stay float32 in both packages
            assert at[k].dtype == aj[k].dtype, k
            np.testing.assert_array_equal(at[k], aj[k])


def test_circuit_from_jax_round_trips():
    cj = jax_build("multi_control", 3, 2, 2)
    assert circuit_from_jax(cj) == torch_build("multi_control", 3, 2, 2)
