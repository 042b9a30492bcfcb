"""The port's config registry against the JAX package's, field for field."""

import dataclasses

import pytest

from repro.configs import ALL_ARCHS, get_config, get_smoke_config
from repro_torch import configs as tconfigs


def _fields(cfg):
    return dataclasses.asdict(cfg)


def test_same_registry():
    from repro import configs as jconfigs

    assert tconfigs.ALL_ARCHS == ALL_ARCHS
    assert tconfigs.ASSIGNED_ARCHS == jconfigs.ASSIGNED_ARCHS
    assert tconfigs.EXPECTED_PARAMS == jconfigs.EXPECTED_PARAMS


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_config_matches_jax(arch, smoke):
    jcfg = get_smoke_config(arch) if smoke else get_config(arch)
    tcfg = tconfigs.get_smoke_config(arch) if smoke else tconfigs.get_config(arch)
    assert _fields(tcfg) == _fields(jcfg)
    assert str(tcfg.compute_dtype).removeprefix("torch.") == str(jcfg.compute_dtype)
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()
    assert (tcfg.num_groups, tcfg.remainder) == (jcfg.num_groups, jcfg.remainder)
    assert (tcfg.attn_free, tcfg.subquadratic) == (jcfg.attn_free, jcfg.subquadratic)


def test_unknown_arch_raises():
    with pytest.raises(KeyError):
        tconfigs.get_config("no-such-arch")
