"""The port's model configurations (``repro_torch.configs``,
``repro_torch.models.config``) against the reference's: field for field
for every architecture, full and smoke, the shape set and its cells, and
the schema's derived counts. The reference's modules import no JAX; its
configs are read as tests/test_models_smoke.py and the launch CLIs read
them (``get_config``, ``get_smoke_config``)."""

import dataclasses

import pytest

from repro import configs as jconfigs
from repro_torch import configs
from repro_torch.models.config import ModelConfig


def test_archs_and_modules_match():
    assert configs.ARCHS == jconfigs.ARCHS
    assert set(configs._MODULES) == set(jconfigs._MODULES)
    for name, mod in configs._MODULES.items():
        assert mod == jconfigs._MODULES[name].replace("repro.",
                                                      "repro_torch.", 1)


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_config_fields_match_reference(arch):
    for get in ("get_config", "get_smoke_config"):
        got = getattr(configs, get)(arch)
        want = getattr(jconfigs, get)(arch)
        assert isinstance(got, ModelConfig)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), get
        assert [f.name for f in dataclasses.fields(got)] == \
            [f.name for f in dataclasses.fields(want)]
        assert got.is_encdec == want.is_encdec
        assert got.pattern_periods == want.pattern_periods
        assert got.ssm_inner == want.ssm_inner
        assert got.param_count() == want.param_count()
        assert got.active_param_count() == want.active_param_count()


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_cells_match_reference(arch):
    assert configs.cells(arch) == jconfigs.cells(arch)


def test_shapes_match_reference():
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    assert configs.LONG_CONTEXT_ARCHS == jconfigs.LONG_CONTEXT_ARCHS
    assert dataclasses.asdict(configs.ShapeSpec("x", 1, 2, "train")) == \
        dataclasses.asdict(jconfigs.ShapeSpec("x", 1, 2, "train"))


def test_all_configs_and_scale_down():
    got = configs.all_configs()
    assert list(got) == list(jconfigs.all_configs())
    small = configs.scale_down(got["gemma2-9b"], num_layers=2)
    want = jconfigs.scale_down(jconfigs.get_config("gemma2-9b"),
                               num_layers=2)
    assert dataclasses.asdict(small) == dataclasses.asdict(want)


def test_schema_checks_match_reference():
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("no-such-arch")
    with pytest.raises(ValueError, match="num_kv_heads"):
        ModelConfig(name="x", family="dense", num_heads=6, num_kv_heads=4)
    with pytest.raises(ValueError, match="moe family"):
        ModelConfig(name="x", family="moe")
