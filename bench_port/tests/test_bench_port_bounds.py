"""The benchmark's own arithmetic at the flagship's shapes, batch 16: K1's
least time 0.109 ms a forward and K2's 0.212 ms a step (PERF.md §6), the
attention calls the FLOP count records equal to ``stage_geometry``'s, and
the models' FLOPs."""

import json

import pytest

from conftest import ROOT

from bench_port.metrics import yardstick as y

CONFIGS = {n: json.loads((ROOT / f"bench_port/configs/{n}.json").read_text())["train_config"]
           for n in ("fpn_tiny", "upn_tiny")}


def test_k1_and_k2_bounds_at_the_flagship():
    stages = y.stage_geometry(CONFIGS["fpn_tiny"]["model"]["backbone"], 512)
    assert y.k1_bound_s(stages, 16) * 1e3 == pytest.approx(0.109, abs=5e-4)
    assert y.k2_bound_s(stages, 16) * 1e3 == pytest.approx(0.212, abs=5e-4)
    assert y.k1_bound_s(stages, 16, lse=True) > y.k1_bound_s(stages, 16)


@pytest.mark.parametrize("name,fwd,train",
                         [("fpn_tiny", 84.38, 253.15), ("upn_tiny", 459.05, 1381.0)])
def test_counted_work(name, fwd, train):
    mc = CONFIGS[name]["model"]
    work = y.count_work(mc, 1, (512, 512), False)
    assert work["flops"] / 1e9 == pytest.approx(fwd, rel=1e-3)
    assert y.count_work(mc, 1, (512, 512), True)["flops"] / 1e9 == pytest.approx(train, rel=1e-3)
    stages = y.stage_geometry(mc["backbone"], 512)
    assert len(work["calls"]) == sum(s["launches"] for s in stages) == 14
    assert y.k1_bound_s(work["calls"], 16) == pytest.approx(y.k1_bound_s(stages, 16))
    assert y.k2_bound_s(work["calls"], 16) == pytest.approx(y.k2_bound_s(stages, 16))
