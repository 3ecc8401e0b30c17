"""The port's copy of the paper's CLS cases (``configs/cls_paper.py``)
against the JAX package's, field by field."""
import dataclasses

import pytest

from repro.configs import cls_paper as j_cases
from repro_torch.configs import cls_paper as t_cases


@pytest.mark.parametrize("table", ["EXAMPLE1", "EXAMPLE2", "EXAMPLE3",
                                   "EXAMPLE4"])
def test_cls_paper_tables_equal_reference(table):
    port, ref = getattr(t_cases, table), getattr(j_cases, table)
    assert len(port) == len(ref) > 0
    fields = [f.name for f in dataclasses.fields(j_cases.CLSCase)]
    assert [f.name for f in dataclasses.fields(t_cases.CLSCase)] == fields
    for a, b in zip(port, ref):
        assert isinstance(a, t_cases.CLSCase)
        for f in fields:
            assert getattr(a, f) == getattr(b, f), (a.name, f)
