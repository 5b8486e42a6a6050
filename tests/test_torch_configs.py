"""The port's copies of the configs equal the JAX package's."""

import dataclasses

import pytest

pytest.importorskip("torch")

from repro.configs import ARCH_IDS as JAX_ARCH_IDS  # noqa: E402
from repro.configs import SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro_torch.configs import ARCH_IDS, SHAPES, get_config  # noqa: E402


def test_same_archs_and_shapes():
    assert ARCH_IDS == JAX_ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JAX_SHAPES.items()}


@pytest.mark.parametrize("arch", JAX_ARCH_IDS)
def test_config_and_smoke_equal(arch):
    mine, ref = get_config(arch), jax_get_config(arch)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert dataclasses.asdict(mine.smoke()) == dataclasses.asdict(ref.smoke())
    assert mine.param_count() == ref.param_count()


def test_unknown_arch_raises():
    with pytest.raises(KeyError):
        get_config("no-such-arch")
