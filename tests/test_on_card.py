"""Checks that need an NVIDIA GPU: the compiled flagship against its plain
reference at full width. They skip elsewhere; run them on the card with

    python -m pytest tests/test_on_card.py -m gpu
"""

import jax
import pytest

import chip_smoke

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs an NVIDIA GPU")
    return devs[0]


def test_flagship_matches_reference_on_card(gpu):
    with jax.default_device(gpu):
        chip_smoke.compare_reference(jax.devices("cpu")[0])
        chip_smoke.compare_deconv()
