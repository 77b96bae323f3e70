"""repro_torch.configs.shapes against the reference's: the same shapes and
the same runnable cells for every architecture (32 in all)."""

import pytest

from repro.configs import base as ref_base
from repro.configs import shapes as ref_shapes
from repro_torch.configs import base, shapes


def test_shapes_equal_the_reference():
    assert list(shapes.SHAPES) == list(ref_shapes.SHAPES)
    for name, s in shapes.SHAPES.items():
        r = ref_shapes.get_shape(name)
        assert (s.name, s.seq_len, s.global_batch, s.kind) == \
            (r.name, r.seq_len, r.global_batch, r.kind)
        assert shapes.get_shape(name) is s
    with pytest.raises(KeyError):
        shapes.get_shape("train_8k")


@pytest.mark.parametrize("arch", base.list_archs())
def test_cells_for_equal_the_reference(arch):
    cells = shapes.cells_for(base.get_config(arch))
    assert cells == ref_shapes.cells_for(ref_base.get_config(arch))
    assert ("long_500k" in cells) == (arch in ("recurrentgemma-2b", "xlstm-125m"))


def test_32_cells_over_10_archs():
    archs = base.list_archs()
    assert archs == ref_base.list_archs() and len(archs) == 10
    assert sum(len(shapes.cells_for(base.get_config(a))) for a in archs) == 32
