"""The port's arch registry equals the JAX package's, field by field.

Tolerance: exact. Configs are data; every field, nested dataclasses
included, must compare equal, for the published config and its
``reduced()`` smoke variant.
"""
import dataclasses

import pytest

pytest.importorskip("torch")

from repro import configs as ref_configs  # noqa: E402
from repro_torch import configs as port_configs  # noqa: E402

ARCH_NAMES = sorted(ref_configs.ARCHS)


def test_registry_names_match():
    assert sorted(port_configs.ARCHS) == ARCH_NAMES


@pytest.mark.parametrize("variant", ["published", "reduced"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_config_fields_equal(arch, variant):
    ref = ref_configs.get_arch(arch)
    port = port_configs.get_arch(arch)
    if variant == "reduced":
        ref, port = ref.reduced(), port.reduced()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert type(port).__name__ == type(ref).__name__
    assert port.layer_kinds() == ref.layer_kinds()
    assert port.n_params() == ref.n_params()
    assert ([port.is_local_layer(i) for i in range(port.n_layers)]
            == [ref.is_local_layer(i) for i in range(ref.n_layers)])


def test_shapes_equal():
    assert ({k: dataclasses.asdict(v) for k, v in port_configs.SHAPES.items()}
            == {k: dataclasses.asdict(v) for k, v in ref_configs.SHAPES.items()})


def test_unknown_arch_raises():
    with pytest.raises(KeyError):
        port_configs.get_arch("no-such-arch")
