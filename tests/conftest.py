"""Test configuration: the CPU backend with 8 virtual devices, so the
multi-device sharding paths run without a GPU. The traversal kernel runs
here in Pallas interpret mode; `python chip_smoke.py` covers it on the card.
"""
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)
