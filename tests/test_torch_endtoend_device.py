"""The whole default path with the device extension path forced: block
extraction, per-block device bipartitions and assembly stay on the device
(the size thresholds lowered in both packages), with delta rounds in LP
and Jet.  The port's partition must equal the JAX package's bitwise.
"""

import jax
import numpy as np
import pytest

import kaminpar_tpu.ops.jet as jjet
import kaminpar_tpu.ops.lp as jlp
import kaminpar_tpu.partitioning.deep as jdeep
import kaminpar_tpu_torch.ops.jet as tjet
import kaminpar_tpu_torch.ops.lp as tlp
import kaminpar_tpu_torch.partitioning.deep as tdeep
from test_torch_endtoend import CASES, run_both
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture
def device_extension(monkeypatch):
    monkeypatch.setenv("KAMINPAR_TPU_NO_NATIVE_IP", "1")
    for mod in (jdeep, tdeep):
        monkeypatch.setattr(mod, "DEVICE_EXTEND_MIN_EDGE_SLOTS", 1)
    for mod in (jlp, tlp, jjet, tjet):
        monkeypatch.setattr(mod, "DELTA_MIN_EDGE_SLOTS", 1)
    jax.clear_caches()  # thresholds are read when programs are traced
    calls = []
    real = tdeep.DeepMultilevelPartitioner._extend_partition_device

    def spy(self, *args, **kwargs):
        calls.append(1)
        return real(self, *args, **kwargs)

    monkeypatch.setattr(tdeep.DeepMultilevelPartitioner,
                        "_extend_partition_device", spy)
    yield calls
    jax.clear_caches()


@pytest.mark.parametrize("case", sorted(CASES))
def test_default_path_device_extension_bitwise_equal(case, device_extension):
    make, k = CASES[case]
    host = make()
    jpart, tpart = run_both(host, k, device_bipartition_threshold=64)
    assert device_extension, "the device extension path did not run"
    np.testing.assert_array_equal(jpart, tpart)
