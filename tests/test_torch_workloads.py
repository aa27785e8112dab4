"""The port's ``core/workloads.py`` (a copy: the reference's imports
nothing of JAX) against ``repro/core/workloads.py``: the paper's models,
Table 3 and every GEMM and elementwise op of their workloads, field by
field, and the system model's Table 3 speedups computed from each."""
from __future__ import annotations

import torch_threads  # noqa: F401  (one intra-op thread a process)
import dataclasses

import pytest

from repro.core import sysmodel as JSM
from repro.core import workloads as JW
from repro_torch.core import sysmodel as SM
from repro_torch.core import workloads as W


def _fields(workload):
    gemms, elems = workload
    return ([dataclasses.asdict(g) for g in gemms],
            [dataclasses.asdict(e) for e in elems])


def test_paper_tables_equal_reference():
    assert W.PAPER_TABLE3 == JW.PAPER_TABLE3
    assert W.PAPER_MODELS == JW.PAPER_MODELS


@pytest.mark.parametrize("model", sorted(JW.PAPER_MODELS))
def test_paper_workload_equals_reference(model):
    got, want = W.paper_workload(model), JW.paper_workload(model)
    assert _fields(got) == _fields(want)
    assert SM.speedup_table(got, "int32") == JSM.speedup_table(want, "int32")


def test_transformer_workload_options_equal_reference():
    kw = dict(n_layers=3, d_model=256, n_heads=8, seq=100, d_ff=640,
              n_kv_heads=2, vocab=1000, batch=2)
    assert _fields(W.transformer_workload(**kw)) == \
        _fields(JW.transformer_workload(**kw))
