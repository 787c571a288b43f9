"""The port's architecture registry against the JAX package's: the same
ids in the same order, every config equal field by field (``param_dtype``
mapped from JAX's dtype to torch's), and the same shape cells."""

import dataclasses

import pytest
import torch

jax = pytest.importorskip("jax")

from repro import configs as ref_configs  # noqa: E402
from repro.configs import shapes as ref_shapes  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import shapes  # noqa: E402

DTYPES = {jax.numpy.float32: torch.float32,
          jax.numpy.bfloat16: torch.bfloat16}


def _plain(obj):
    """A config as nested plain values, JAX dtypes mapped to torch's."""
    if dataclasses.is_dataclass(obj):
        return (type(obj).__name__,
                {f.name: _plain(getattr(obj, f.name))
                 for f in dataclasses.fields(obj)})
    if isinstance(obj, (tuple, list)):
        return tuple(_plain(v) for v in obj)
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    return DTYPES.get(obj, obj)


def test_arch_ids_equal_in_order():
    assert configs.ARCH_IDS == ref_configs.ARCH_IDS
    assert len(configs.ARCH_IDS) == 10
    assert list(configs.REGISTRY) == list(ref_configs.REGISTRY)


@pytest.mark.parametrize("arch_id", ref_configs.ARCH_IDS)
@pytest.mark.parametrize("which", ["get_config", "reduced_config"])
def test_config_equals_reference(arch_id, which):
    got = getattr(configs, which)(arch_id)
    want = getattr(ref_configs, which)(arch_id)
    assert _plain(got) == _plain(want)
    assert isinstance(got.model.param_dtype, torch.dtype)


@pytest.mark.parametrize("arch_id", [
    a for a in ref_configs.ARCH_IDS
    if ref_configs.get_config(a).family == "lm"])
def test_param_counts_equal_reference(arch_id):
    got, want = configs.get_config(arch_id).model, \
        ref_configs.get_config(arch_id).model
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()


@pytest.mark.parametrize("family", ["lm_cells", "gnn_cells", "recsys_cells"])
def test_cells_equal_reference(family):
    assert _plain(getattr(shapes, family)()) == \
        _plain(getattr(ref_shapes, family)())


@pytest.mark.parametrize("n,mult", [(1, 512), (512, 512), (513, 512),
                                    (2_449_029, 512), (61_859_140, 512),
                                    (100, 7)])
def test_pad_to_equals_reference(n, mult):
    assert shapes.pad_to(n, mult) == ref_shapes.pad_to(n, mult)


def test_unknown_arch_raises():
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("gpt-5")
    with pytest.raises(KeyError, match="no shape cell"):
        configs.get_config("pna").cell("decode_32k")
