"""Whole runs of small cells on the CPU, past the harness's look for a card:
a sound run comes out correct; with the timed path broken underneath, or
with the control in the program's place, ``correct`` comes out false.

The faults a one-chip cell can have: a serving request with half of its
batch left out (the other half's logits in their place) or one image's
logits altered where they are produced; a train step that returns its state
unchanged, or that steps on half of its batch, the mean over the rest. The
small cells' limits (``data/limits_*.json``) were set from the small runs'
readings as the cells' own were from theirs (PERF.md)."""

import json
import time

import pytest
import torch

from conftest import tiny_files

from bench_port import control, harness

CELLS = {"serve": ("fpn_tiny.serve.b16", "tiny_fpn", "serve", "serve"),
         "exact": ("fpn_tiny.serve.exact_b16", "tiny_fpn", "serve_exact", "serve"),
         "upn_serve": ("upn_tiny.serve.b16", "tiny_upn", "serve", "serve"),
         "train": ("upn_tiny.train.b16", "tiny_upn", "train", "train")}


def run(kind, seed=2 ** 31 + 11, trace=False, patch=None):
    workload, conf, traffic, limits = CELLS[kind]
    cell = harness.load_cell(workload, seed, 0.3, trace, "cpu", time.perf_counter(),
                             files=tiny_files(conf, traffic, limits))
    return harness.run_cell(cell, patch)[0]


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_a_sound_run_is_correct(kind):
    out = run(kind)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert "setup_s" in out["metrics"]


@pytest.mark.parametrize("kind", ["serve", "train"])
def test_a_traced_run_reads_its_per_layer_metrics(kind):
    out = run(kind, trace=True)
    assert out["correct"]
    assert "breakdown" in out and out["device"]["window_s"] > 0
    # the CPU runs no kernel: the trace's device metrics find nothing to read
    want = {"serve": {"dispatch_ms.serve", "mfu.serve"}, "train": {"mfu.train"}}[kind]
    assert set(out["metrics"]) == want


def serve_fault(fault):
    def patch(driver):
        real = driver.build_server

        def build(cell, device):
            server = real(cell, device)
            forward = server.forward_batch

            def broken(x, valid_hw=None):
                out = forward(x, valid_hw)
                half = out.shape[0] // 2
                if fault == "half_batch":  # half left out: the other half's logits there
                    out = torch.cat([out[:half], out[:out.shape[0] - half]])
                else:  # one image's logits altered where they are produced
                    out = out.clone()
                    out[0] += 0.2 * out[0].std()
                return out

            server.forward_batch = broken
            return server

        driver.build_server = build
    return patch


@pytest.mark.parametrize("kind", ["serve", "exact"])
@pytest.mark.parametrize("fault", ["half_batch", "altered"])
def test_a_broken_serving_path_is_not_correct(kind, fault):
    out = run(kind, patch=serve_fault(fault))
    assert not out["correct"], out["checks"]


def train_fault(fault):
    def patch(driver):
        real = driver.build_step

        def build(cell, device):
            model, state, step = real(cell, device)

            def broken(st, batch):
                if fault == "unchanged":  # the loss and metrics, but no update
                    saved = [p.detach().clone() for p in model.parameters()]
                    st, metrics = step(st, batch)
                    with torch.no_grad():
                        for p, s in zip(model.parameters(), saved):
                            p.copy_(s)
                    return st, metrics
                half = batch["image"].shape[0] // 2
                return step(st, {k: v[:half] for k, v in batch.items()})

            return model, state, broken

        driver.build_step = build
    return patch


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_a_broken_train_step_is_not_correct(fault):
    out = run("train", patch=train_fault(fault))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_the_control_fails_a_limit(kind):
    workload, conf, traffic, limits = CELLS[kind]
    files = tiny_files(conf, traffic, limits)
    lim = json.loads(files["limits"].read_text())
    r = control.readings(workload, 2 ** 31 + 12, "cpu", files=files)
    assert all(r["program"][k] <= v for k, v in lim.items()), r["program"]
    assert any(r["control"][k] > v for k, v in lim.items()), r["control"]
    if kind == "train":
        assert any(r["half_batch"][k] > v for k, v in lim.items()), r["half_batch"]


@pytest.mark.cuda
def test_the_control_fails_at_the_cells_size_on_the_card(card):
    for w in ("fpn_tiny.serve.b16", "upn_tiny.train.b16"):
        lim = json.loads((harness.HERE / "limits" / f"{w}.json").read_text())
        r = control.readings(w, 2 ** 31 + 13, card)
        assert any(r["control"][k] > v for k, v in lim.items()), r["control"]
