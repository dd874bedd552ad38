"""The plain reference agrees with the port's CPU path (its kernels' plain
versions) at small copies of the two presets, float32: the forward, the
exact padded forward of a zero-padded batch against each image at its true
size, and three train steps with drop path and dropout drawn alike."""

import json
import time

import numpy as np
import pytest
import torch

from conftest import DATA, tiny_files

from bench_port import check, harness
from bench_port.reference.train import run_steps


def both(name):
    """The reference and the port's model of a small config, one set of weights."""
    from dat_segmentation_tpu_torch.models.builder import build_model

    conf = json.loads((DATA / f"{name}.json").read_text())
    cell = harness.load_cell("fpn_tiny.serve.b16", 1, 1.0, False, "cpu", 0.0,
                             files={"config": DATA / f"{name}.json"})
    with torch.device("meta"):
        prog = build_model(cell.program_config().model, device="meta")
    ref = check.reference_model(conf, "cpu", 7, None)
    prog = prog.to_empty(device="cpu")
    prog.load_state_dict(ref.state_dict())
    return conf, ref.eval(), prog.eval()


@pytest.mark.parametrize("name", ["tiny_fpn", "tiny_upn"])
def test_forward(name):
    _, ref, prog = both(name)
    x = torch.randn(2, 64, 96, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        a, b = ref(x, upsample=False), prog(x, upsample=False)
        assert check.rel_l2(b, a) < 1e-5
        assert check.rel_l2(prog(x), ref(x)) < 1e-5


def test_exact_padded_forward_is_each_image_at_its_true_size():
    _, ref, prog = both("tiny_fpn")
    gen = torch.Generator().manual_seed(1)
    sizes = [(57, 83), (64, 96), (49, 90)]
    x = torch.zeros(3, 64, 96, 3)
    for i, (h, w) in enumerate(sizes):
        x[i, :h, :w] = torch.randn(h, w, 3, generator=gen)
    with torch.no_grad():
        out = prog(x, upsample=False, valid_hw=torch.tensor(sizes))
        for i, (h, w) in enumerate(sizes):
            r = ref(x[i:i + 1, :h, :w], upsample=False)[0]
            assert check.rel_l2(out[i, :r.shape[0], :r.shape[1]], r) < 1e-5


def test_three_train_steps():
    cell = harness.load_cell("upn_tiny.train.b16", 3, 1.0, False, "cpu", time.perf_counter(),
                             files=tiny_files("tiny_upn", "train", "train"))
    drv = harness.load_file(harness.HERE / "drivers" / "train.py")
    images, labels = drv.make_pool(cell, "cpu")
    B = cell.traffic["batch"]
    batches = [(images[i * B:(i + 1) * B], labels[i * B:(i + 1) * B]) for i in range(3)]
    model, state, _ = drv.build_step(cell, "cpu")
    from dat_segmentation_tpu_torch.train.train_step import make_train_step

    step = make_train_step(model, compute_dtype=torch.float32)  # the program in float32
    prog = drv.first_steps(model, state, step, [{"image": x, "label": y} for x, y in batches])
    ref = check.reference_model(cell.config, "cpu", cell.seed_for("weights"), None)
    r = run_steps(ref, cell.config["train_config"], batches, cell.traffic["start_step"],
                  cell.seed_for("masks"), "cpu")
    np.testing.assert_allclose(prog["losses"], r["losses"], rtol=1e-5)
    gaps = check.train_gaps(prog, r)
    assert gaps["grad_gap_median"] < 1e-4 and gaps["change_gap_median"] < 1e-3
