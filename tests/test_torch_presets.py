"""The presets: every preset's context equals the JAX package's field by
field (compared as nested dicts; test_torch_schemes.JAX_ONLY, the fields
the port lacks, is empty), the `terapart*` presets switch
on compressed-graph mode, and `strong` (native FM), `fast` and
`noref` partition bitwise as the JAX package does on
make_rmat(1 << 12, 30_000, seed=3) at k=8.  The other presets' end-to-end
runs are in test_torch_presets_refiners.py.
"""

import numpy as np
import pytest

from kaminpar_tpu.context import context_to_dict as jax_context_to_dict
from kaminpar_tpu.presets import create_context_by_preset_name as jax_preset
from kaminpar_tpu_torch import native, presets
from kaminpar_tpu_torch.context import context_to_dict
from test_torch_schemes import CASES, run_preset, split_jax_dict
from torch_threads import one_torch_thread  # noqa: F401

PORTED = sorted(presets.get_preset_names())


@pytest.mark.parametrize("name", PORTED)
def test_preset_context_equals_the_jax_presets(name):
    kept, _ = split_jax_dict(jax_context_to_dict(jax_preset(name)))
    assert context_to_dict(presets.create_context_by_preset_name(name)) == kept


@pytest.mark.parametrize("name",
                         ["terapart", "terapart-largek", "terapart-strong"])
def test_terapart_presets_raise(name):
    """They used to raise; now each builds compressed-graph mode on the
    base preset the JAX package uses."""
    ctx = presets.create_context_by_preset_name(name)
    assert ctx.compression.enabled and ctx.preset_name == name
    base = {"terapart": "default", "terapart-largek": "largek",
            "terapart-strong": "strong"}[name]
    kept, _ = split_jax_dict(jax_context_to_dict(jax_preset(name)))
    kept_base, _ = split_jax_dict(jax_context_to_dict(jax_preset(base)))
    kept["compression"]["enabled"] = False
    kept["preset_name"] = base
    kept["coarsening"]["clustering"]["forced_kc_level"] = False
    assert kept == kept_base


@pytest.mark.parametrize("preset", ["fast", "noref", "strong"])
def test_preset_bitwise_equal(preset, monkeypatch):
    monkeypatch.delenv(native.NO_NATIVE_FM_ENV, raising=False)
    make, k = CASES["rmat-k8"]
    before = native.fm_refine.calls
    jpart, tpart = run_preset(preset, make(), k)
    np.testing.assert_array_equal(jpart, tpart)
    if preset == "strong":
        assert native.fm_refine.calls > before
