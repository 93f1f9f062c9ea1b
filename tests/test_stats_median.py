"""Radix-select median cross-check: value-identical to the sort path.

(The selection path measured slower than the sort on the earlier chip and
is kept only as an independent implementation cross-checking the sort;
see ops/stats.py.)
"""

import numpy as np
import pytest
import jax.numpy as jnp

from apda_fft_tpu.ops.stats import median_lastaxis


def test_select_matches_sort_randomized():
    rng = np.random.default_rng(0)
    for trial in range(40):
        b = int(rng.integers(1, 6))
        n = int(rng.choice([7, 16, 127, 1024, 1025, 4096]))
        x = rng.standard_normal((b, n)).astype(np.float32) * rng.uniform(1e-3, 1e3)
        kind = trial % 4
        if kind == 1:
            x = np.round(x)  # heavy ties
        elif kind == 2:
            x = np.abs(x)
        elif kind == 3:
            x[:, ::3] = -0.0
            x[:, 1::3] = 0.0
        ref = np.asarray(median_lastaxis(jnp.asarray(x), method="sort"))
        got = np.asarray(median_lastaxis(jnp.asarray(x), method="select"))
        assert np.array_equal(ref, got), (trial, b, n, kind)
        lengths = jnp.asarray(rng.integers(1, n + 1, size=b).astype(np.int32))
        refl = np.asarray(median_lastaxis(jnp.asarray(x), lengths, method="sort"))
        gotl = np.asarray(median_lastaxis(jnp.asarray(x), lengths, method="select"))
        assert np.array_equal(refl, gotl), (trial, "ragged", b, n)


def test_method_validation():
    x = jnp.zeros((2, 8), jnp.float32)
    with pytest.raises(ValueError, match="unknown method"):
        median_lastaxis(x, method="quickselect")
    with pytest.raises(ValueError, match="float32 only"):
        median_lastaxis(jnp.zeros((2, 8), jnp.float64), method="select")
